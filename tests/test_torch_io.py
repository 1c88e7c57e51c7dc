"""The port's y4m and raw I/O (sangnom_tpu_torch.io) against sangnom_tpu.io.

The same numpy planes, made from a seed, go through both packages: the
port's writers give JAX's bytes, its readers give JAX's planes, props and
parity, and both raise the same errors.  Readers take a ``device``, "cuda"
unless the caller asks for another.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
import sangnom_tpu.io as jio  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
import sangnom_tpu_torch.io as tio  # noqa: E402
from sangnom_tpu_torch.io import common as tcommon  # noqa: E402

from conftest import make_planes  # noqa: E402


def _stacked(rng, fmt_name, w, h, n):
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    return [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]


def _same_clip(tclip, jclip):
    assert tclip.format.name == jclip.format.name
    assert tclip.tff == jclip.tff
    assert tclip.props == jclip.props
    assert tclip.num_planes == jclip.num_planes
    for i, (a, b) in enumerate(zip(tclip.to_numpy(), jclip.planes)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"plane {i}")


@pytest.mark.parametrize(
    "fmt_name", ["GRAY8", "YUV420P8", "YUV422P10", "YUV444P16", "YUV411P8"])
def test_y4m_matches_jax(rng, fmt_name):
    """write_y4m bytes equal JAX's; read_y4m planes, props and parity equal
    JAX's and the input."""
    planes = _stacked(rng, fmt_name, 32, 16, 3)
    tb, jb = io.BytesIO(), io.BytesIO()
    tio.write_y4m(tb, T.Clip.from_numpy(planes, fmt_name, device="cpu"),
                  fps=(30000, 1001), interlace="b")
    jio.write_y4m(jb, J.Clip.from_numpy(planes, fmt_name),
                  fps=(30000, 1001), interlace="b")
    assert tb.getvalue() == jb.getvalue()
    back = tio.read_y4m(io.BytesIO(tb.getvalue()), device="cpu")
    _same_clip(back, jio.read_y4m(io.BytesIO(jb.getvalue())))
    assert back.tff is False and back.device.type == "cpu"
    for got, want in zip(back.to_numpy(), planes):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt_name", ["GRAYS", "YUVA444P16", "YUV420P8"])
def test_raw_matches_jax(rng, fmt_name):
    planes = _stacked(rng, fmt_name, 16, 8, 2)
    tb, jb = io.BytesIO(), io.BytesIO()
    tio.write_raw(tb, T.Clip.from_numpy(planes, fmt_name, device="cpu"))
    jio.write_raw(jb, J.Clip.from_numpy(planes, fmt_name))
    assert tb.getvalue() == jb.getvalue()
    fmt = T.get_format(fmt_name)
    assert tio.frame_size_bytes(fmt, 16, 8) * 2 == len(tb.getvalue())
    back = tio.read_raw(io.BytesIO(tb.getvalue()), fmt_name, 16, 8,
                        device="cpu")
    jback = jio.read_raw(io.BytesIO(jb.getvalue()), fmt_name, 16, 8)
    _same_clip(back, jback)
    for got, want in zip(back.to_numpy(), planes):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_frames", [None, 5])
def test_iter_y4m_matches_jax(rng, max_frames):
    planes = _stacked(rng, "YUV420P8", 32, 16, 7)
    buf = io.BytesIO()
    tio.write_y4m(buf, T.Clip.from_numpy(planes, "YUV420P8", device="cpu"),
                  fps=(30, 1))
    data = buf.getvalue()
    got = list(tio.iter_y4m(io.BytesIO(data), window=3,
                            max_frames=max_frames, device="cpu"))
    want = list(jio.iter_y4m(io.BytesIO(data), window=3,
                             max_frames=max_frames))
    assert [w.num_frames for w in got] == [w.num_frames for w in want]
    for t, j in zip(got, want):
        _same_clip(t, j)
    joined = np.concatenate([w.to_numpy()[0] for w in got])
    np.testing.assert_array_equal(joined, planes[0][:max_frames])


def _gray(n=1):
    return [np.zeros((n, 8, 16), np.uint8)]


def _y4m_bytes(planes, fmt_name="GRAY8", **kw):
    buf = io.BytesIO()
    jio.write_y4m(buf, J.Clip.from_numpy(planes, fmt_name), **kw)
    return buf.getvalue()


ERROR_CASES = {
    "float-write": lambda m, C, kw: m.write_y4m(
        io.BytesIO(), C.from_numpy([np.zeros((1, 8, 16), np.float32)],
                                   "GRAYS", **kw)),
    "garbage": lambda m, C, kw: m.read_y4m(io.BytesIO(b"RIFF....WEBP"), **kw),
    "no-size": lambda m, C, kw: m.read_y4m(io.BytesIO(b"YUV4MPEG2 W16\n"), **kw),
    "colorspace": lambda m, C, kw: m.read_y4m(
        io.BytesIO(b"YUV4MPEG2 W16 H8 C420p9\n"), **kw),
    "no-frames": lambda m, C, kw: m.read_y4m(
        io.BytesIO(b"YUV4MPEG2 W16 H8 Cmono\n"), **kw),
    "marker": lambda m, C, kw: m.read_y4m(
        io.BytesIO(b"YUV4MPEG2 W16 H8 Cmono\nFRAMX\n"), **kw),
    "y4m-truncated": lambda m, C, kw: m.read_y4m(
        io.BytesIO(_y4m_bytes(_gray(2))[:-3]), **kw),
    "raw-truncated": lambda m, C, kw: m.read_raw(
        io.BytesIO(b"\0" * (128 + 3)), "GRAY8", 16, 8, **kw),
    "raw-empty": lambda m, C, kw: m.read_raw(io.BytesIO(b""), "GRAY8", 16, 8,
                                             **kw),
    "window": lambda m, C, kw: next(m.iter_y4m(io.BytesIO(b""), 0, **kw)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_jax(case):
    """Each malformed input raises ValueError with JAX's message."""
    fn = ERROR_CASES[case]
    kw = {"device": "cpu"}
    with pytest.raises(ValueError) as te:
        fn(tio, T.Clip, kw)
    with pytest.raises(ValueError) as je:
        fn(jio, J.Clip, {})
    assert str(te.value) == str(je.value)


def test_y4m_preserves_framerate_aspect_and_siting(rng):
    """fps and aspect survive a round trip; the 420mpeg2 siting tag
    survives read -> filter -> write."""
    clip = T.Clip.from_numpy(_gray(), "GRAY8", device="cpu",
                             props={"y4m_fps": (30000, 1001),
                                    "y4m_aspect": "4:3"})
    buf = io.BytesIO()
    tio.write_y4m(buf, clip)
    head = bytes(buf.getbuffer()[:64])
    assert b"F30000:1001" in head and b"A4:3" in head
    back = tio.read_y4m(io.BytesIO(buf.getvalue()), device="cpu")
    assert back.props["y4m_fps"] == (30000, 1001)
    assert back.props["y4m_aspect"] == "4:3"

    planes = [p[None] for p in make_planes(rng, 16, 8, J.get_format("YUV420P8"))]
    raw = _y4m_bytes(planes, "YUV420P8").replace(b"C420\n", b"C420mpeg2\n")
    back = tio.read_y4m(io.BytesIO(raw), device="cpu")
    assert back.props["y4m_colorspace"] == "420mpeg2"
    out = io.BytesIO()
    tio.write_y4m(out, T.sangnom2(back, order=1))
    assert b"C420mpeg2" in bytes(out.getbuffer()[:64])


@pytest.mark.parametrize("n_frames", [7, 6])  # 6: EOF exactly at a chunk end
def test_y4m_multichunk_read(rng, monkeypatch, n_frames):
    """The multi-chunk concatenate path (chunk budget of 3 frames)."""
    planes = [rng.integers(0, 256, (n_frames, 16 >> s, 32 >> s), dtype=np.uint8)
              for s in (0, 1, 1)]
    data = _y4m_bytes(planes, "YUV420P8")
    monkeypatch.setattr(tcommon, "CHUNK_BYTES", 3 * 32 * 16 * 3 // 2)
    back = tio.read_y4m(io.BytesIO(data), device="cpu")
    for got, want in zip(back.to_numpy(), planes):
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tcommon, "CHUNK_BYTES", 2 * 32 * 16 * 3 // 2)
    with pytest.raises(ValueError, match="truncated y4m frame"):
        tio.read_y4m(io.BytesIO(data[:-10]), device="cpu")


def test_raw_multichunk_read(rng, monkeypatch):
    planes = [rng.integers(0, 256, (9, 8, 16), dtype=np.uint8)]
    buf = io.BytesIO()
    tio.write_raw(buf, T.Clip.from_numpy(planes, "GRAY8", device="cpu"))
    monkeypatch.setattr(tcommon, "CHUNK_BYTES", 2 * 8 * 16)
    back = tio.read_raw(io.BytesIO(buf.getvalue()), "GRAY8", 16, 8,
                        device="cpu")
    np.testing.assert_array_equal(back.to_numpy()[0], planes[0])


class _ReadOnlyDribble:
    """File-like with NO readinto and bounded short read()s: the
    readinto_full fallback path (None at exhaustion is the non-blocking EOF
    contract)."""

    def __init__(self, data, max_read=7):
        self._fh = io.BytesIO(data)
        self._max = max_read

    def readline(self):
        return self._fh.readline()

    def read(self, n=-1):
        out = self._fh.read(min(n, self._max) if n >= 0 else self._max)
        return out if out else None


def test_y4m_read_fallback_short_reads(rng):
    planes = [rng.integers(0, 256, (3, 16 >> s, 32 >> s), dtype=np.uint8)
              for s in (0, 1, 1)]
    back = tio.read_y4m(_ReadOnlyDribble(_y4m_bytes(planes, "YUV420P8")),
                        device="cpu")
    for got, want in zip(back.to_numpy(), planes):
        np.testing.assert_array_equal(got, want)


def test_readers_default_to_cuda():
    """No device argument means CUDA: on a machine without a card every
    reader fails loudly instead of reading onto the CPU."""
    data = _y4m_bytes(_gray(2))
    readers = {
        "read_y4m": lambda: tio.read_y4m(io.BytesIO(data)),
        "iter_y4m": lambda: next(tio.iter_y4m(io.BytesIO(data), 1)),
        "read_raw": lambda: tio.read_raw(io.BytesIO(b"\0" * 128), "GRAY8",
                                         16, 8),
    }
    for name, read in readers.items():
        if torch.cuda.is_available():
            assert read().device.type == "cuda", name
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                read()
