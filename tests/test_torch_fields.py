"""The port's field utilities and bob against sangnom_tpu and the oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
from sangnom_tpu.core import fields as jfields  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core import fields as tfields  # noqa: E402
from sangnom_tpu_torch.oracle import sangnom2_frame_oracle  # noqa: E402

from conftest import make_planes  # noqa: E402


def _both(fmt_name="GRAY8", w=32, h=16, n=2, tff=True, seed=3):
    rng = np.random.default_rng(seed)
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    return (J.Clip.from_numpy(planes, fmt, tff=tff),
            T.Clip.from_numpy(planes, fmt_name, device="cpu", tff=tff))


def _same(jclip, tclip, parity=True):
    for i, (a, b) in enumerate(zip(jclip.planes, tclip.to_numpy())):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"plane {i}")
    if parity:
        np.testing.assert_array_equal(tclip.parity_array(),
                                      np.asarray(jclip.parity_array()))
    assert tclip.tff == jclip.tff and tclip.props == jclip.props


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("fmt_name", ["GRAY8", "YUV420P10", "YUV444PS"])
def test_field_utilities_match(fmt_name, tff):
    jc, tc = _both(fmt_name, tff=tff)
    jf, tf = jfields.separate_fields(jc), tfields.separate_fields(tc)
    _same(jf, tf)
    _same(jfields.weave(jf), tfields.weave(tf))
    _same(jfields.double_weave(jf), tfields.double_weave(tf))
    for a, b in zip(tfields.weave(tf).to_numpy(), tc.to_numpy()):
        np.testing.assert_array_equal(a, b)  # weave inverts separate_fields


def test_field_errors():
    _, tc = _both(h=16, n=3)
    with pytest.raises(ValueError, match="field count must be even"):
        tfields.weave(tc)
    _, odd = _both(h=15, n=1)
    with pytest.raises(ValueError, match="height must be even"):
        tfields.separate_fields(odd)


BOBS = [
    pytest.param("YUV420P8", dict(), True, id="fused-420P8-tff"),
    pytest.param("YUV420P8", dict(tff=False), True, id="fused-420P8-bff-arg"),
    pytest.param("YUV422P10", dict(aa=64, aac=32), False, id="fused-422P10-bff"),
    pytest.param("GRAY8", dict(chroma=False), True, id="fused-gray-chroma-off"),
    pytest.param("YUV444PS", dict(numerics="sse2"), True, id="fused-444PS"),
    pytest.param("YUV420P8", dict(chroma=False), True, id="explicit-chroma-off"),
    pytest.param("YUV420P16", dict(luma=False), False, id="explicit-luma-off"),
    pytest.param("YUVA420P8", dict(), True, id="explicit-alpha"),
]


@pytest.mark.parametrize("fmt_name,kw,tff", BOBS)
def test_bob_matches_jax(fmt_name, kw, tff):
    jc, tc = _both(fmt_name, w=40, h=16, n=2, tff=tff)
    want = J.bob(jc, opt=0, **kw)
    got = T.bob(tc, **kw)
    assert got.num_frames == 4 and got.height == 16
    _same(want, got)


def test_bob_against_oracle():
    """Each output frame of the double-rate pipeline against the native
    oracle on the woven frame it is defined to equal."""
    _, tc = _both("YUV420P8", w=32, h=16, n=2)
    out = T.bob(tc).to_numpy()
    woven = tfields.double_weave(tfields.separate_fields(tc))
    woven_np = woven.to_numpy()
    for n in range(4):
        want = sangnom2_frame_oracle([p[n] for p in woven_np], tc.format,
                                     order=0, frame_parity=woven.get_parity(n))
        for i in range(3):
            np.testing.assert_array_equal(out[i][n], want[i],
                                          err_msg=f"frame {n} plane {i}")


def test_bob_keeps_source_fields():
    _, tc = _both(n=1)
    out = T.bob(tc).to_numpy()[0]
    src = tc.to_numpy()[0][0]
    np.testing.assert_array_equal(out[0][0::2], src[0::2])  # top field kept
    np.testing.assert_array_equal(out[1][1::2], src[1::2])  # bottom field kept
