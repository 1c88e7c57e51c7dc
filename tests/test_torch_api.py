"""The port's public API (sangnom_tpu_torch) against sangnom_tpu.

The five BASELINE.json configurations at small sizes, the legacy surface,
the filter object, the verbatim error strings, the opt=1 device gate, the
four entry points with pool_compat, the Clip container, and an import check:
the port imports neither JAX nor sangnom_tpu, and its oracle source is a
byte-identical copy of the TPU package's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.api import SangNomError  # noqa: E402

from conftest import make_planes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _planes(fmt_name, w, h, n, seed=7):
    rng = np.random.default_rng(seed)
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    return [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]


def _both(fmt_name, w, h, n=2, parity=None, seed=7):
    planes = _planes(fmt_name, w, h, n, seed)
    jc = J.Clip.from_numpy(planes, fmt_name, parity=parity)
    tc = T.Clip.from_numpy(planes, fmt_name, device="cpu", parity=parity)
    return jc, tc


def _same(jclip, tclip):
    assert tclip.num_planes == jclip.num_planes
    for i, (a, b) in enumerate(zip(jclip.planes, tclip.to_numpy())):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"plane {i}")


# The BASELINE.json configurations, cut to a few small frames.
BASELINE = [
    pytest.param("GRAY8", 64, 48, dict(order=1), None, id="order1-Y8"),
    pytest.param("YUV420P8", 48, 24, dict(order=2), None, id="order2-420P8"),
    pytest.param("YUV420P8", 40, 16, dict(order=1, dh=True, aa=48, aac=0), None,
                 id="dh-420P8"),
    pytest.param("YUV422P10", 40, 20, dict(order=0), [True, False, True],
                 id="order0-422P10"),
    pytest.param("GRAY16", 40, 16, dict(order=1, aa=128, aac=64), None, id="Y16"),
    pytest.param("YUV444PS", 40, 16, dict(order=2, aa=48, aac=48), None,
                 id="444PS"),
]


@pytest.mark.parametrize("opt", [0, -1])
@pytest.mark.parametrize("fmt_name,w,h,kw,parity", BASELINE)
def test_sangnom2_matches_jax(fmt_name, w, h, kw, parity, opt):
    n = len(parity) if parity else 2
    jc, tc = _both(fmt_name, w, h, n, None if parity is None else np.array(parity))
    _same(J.sangnom2(jc, opt=0, **kw), T.sangnom2(tc, opt=opt, **kw))


@pytest.mark.parametrize("kw", [
    dict(order=1, numerics="sse2"),
    dict(order=2, luma=False),
    dict(order=1, chroma=False, aac=20),
    dict(order=1, dh=True, chroma=False),
], ids=str)
def test_sangnom2_options_match_jax(kw):
    for fmt_name in ("YUV420P16", "YUVA422P8"):  # alpha passthrough too
        jc, tc = _both(fmt_name, 32, 16)
        _same(J.sangnom2(jc, opt=0, **kw), T.sangnom2(tc, **kw))


def test_order0_uniform_parity_collapses(rng):
    """A uniform-parity order=0 batch equals order 1 (all top) / 2 (all
    bottom)."""
    for par, order in ((True, 1), (False, 2)):
        _, tc = _both("GRAY8", 24, 12, 3)
        tc = tc.with_planes(tc.planes)
        tc.parity = np.full(3, par)
        a = T.sangnom2(tc, order=0)
        b = T.sangnom2(tc, order=order)
        for x, y in zip(a.planes, b.planes):
            assert torch.equal(x, y)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_legacy_sangnom_matches_jax(order):
    jc, tc = _both("YUV420P8", 32, 16)
    _same(J.sangnom(jc, order=order, aa=30, opt=0), T.sangnom(tc, order=order, aa=30))


def test_filter_object_matches_jax():
    jc, tc = _both("YUV420P10", 32, 16)
    jf = J.SangNom2Filter(order=2, aa=64, aac=16, dh=True, opt=0)
    tf = T.SangNom2Filter(order=2, aa=64, aac=16, dh=True)
    _same(jf(jc), tf(tc))
    assert repr(tf) == repr(jf).replace("opt=0", "opt=-1")
    with pytest.raises(SangNomError, match=r"SangNom2: aa must be between 0\.\.128\."):
        T.SangNom2Filter(aa=200)


def test_register_plugin_functions():
    reg = {}
    assert T.register_plugin_functions(reg) == "SangNom2"
    assert reg == {"SangNom2": T.sangnom2, "SangNom": T.sangnom}


BAD = [
    (dict(order=-1), "order"), (dict(order=3), "order"), (dict(aa=-1), "aa"),
    (dict(aa=129), "aa"), (dict(aac=-1), "aac"), (dict(aac=129), "aac"),
    (dict(opt=-2), "opt"), (dict(opt=2), "opt"),
]


@pytest.mark.parametrize("kw,_", BAD, ids=str)
def test_error_strings_verbatim(kw, _):
    jc, tc = _both("YUV420P8", 32, 16, 1)
    with pytest.raises(J.api.SangNomError) as want:
        J.sangnom2(jc, **kw)
    with pytest.raises(SangNomError) as got:
        T.sangnom2(tc, **kw)
    assert str(got.value) == str(want.value)
    if "aac" not in kw:
        with pytest.raises(J.api.SangNomError) as want:
            J.sangnom(jc, **kw)
        with pytest.raises(SangNomError) as got:
            T.sangnom(tc, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fmt_name,h,msg", [
    ("RGBP8", 16, "SangNom2: clip must be in Y/YUV planar format."),
    ("YUY2", 16, "SangNom2: clip must be in Y/YUV planar format."),
    ("GRAY8", 15, "SangNom2: height must be even."),
    ("YUV420P8", 18, "SangNom2: height must be mod4."),
])
def test_geometry_errors_verbatim(fmt_name, h, msg):
    fmt = T.get_format(fmt_name)
    planes = [np.zeros((1,) + fmt.plane_dims(32, h, i)[::-1], fmt.np_dtype)
              for i in range(fmt.num_planes)]
    with pytest.raises(SangNomError) as got:
        T.sangnom2(T.Clip.from_numpy(planes, fmt, device="cpu"))
    assert str(got.value) == msg
    assert J.api.SangNomError.__name__ == SangNomError.__name__


def test_numerics_error_verbatim():
    jc, tc = _both("GRAY8", 16, 8, 1)
    with pytest.raises(J.api.SangNomError) as want:
        J.sangnom2(jc, numerics="avx")
    with pytest.raises(SangNomError) as got:
        T.sangnom2(tc, numerics="avx")
    assert str(got.value) == str(want.value)


def test_opt1_needs_cuda_tensors():
    _, tc = _both("GRAY8", 16, 8, 1)
    with pytest.raises(SangNomError, match=r"^SangNom2: opt=1 requires a CUDA backend\.$"):
        T.sangnom2(tc, opt=1)
    with pytest.raises(SangNomError, match=r"^SangNom: opt=1 requires a CUDA backend\.$"):
        T.sangnom(tc, opt=1)
    with pytest.raises(SangNomError, match=r"opt=1 requires a CUDA backend"):
        T.SangNom2Filter(opt=1)(tc)
    with pytest.raises(SangNomError, match=r"opt=1 requires a CUDA backend"):
        T.bob(tc, opt=1)
    from sangnom_tpu_torch.ops.sangnom import sangnom2_op

    with pytest.raises(SangNomError, match=r"opt=1 requires a CUDA backend"):
        sangnom2_op(tc, opt=1)


POOL_ENTRY_POINTS = [
    ("sangnom2", lambda M, c, opt: M.sangnom2(c, pool_compat=True, order=2, aac=40, opt=opt)),
    ("sangnom", lambda M, c, opt: M.sangnom(c, pool_compat=True, order=0, aa=30, opt=opt)),
    ("filter", lambda M, c, opt: M.SangNom2Filter(pool_compat=True, dh=True, opt=opt)(c)),
    ("bob", lambda M, c, opt: M.bob(c, pool_compat=True, aac=20, opt=opt)),
]


@pytest.mark.parametrize("name,call", POOL_ENTRY_POINTS, ids=[e[0] for e in POOL_ENTRY_POINTS])
@pytest.mark.parametrize("opt", [0, -1])
def test_pool_compat_entry_points_match_jax(name, call, opt):
    """sangnom2, sangnom, SangNom2Filter and bob with pool_compat=True, an
    unaligned 4:2:0 clip (luma pad columns and chroma carry across frames)."""
    jc, tc = _both("YUV420P8", 44, 16, 3, np.array([True, False, False]))
    _same(call(J, jc, 0), call(T, tc, opt))


def test_oracle_source_is_a_copy():
    """The port compiles its own copy of the oracle; it must not drift from
    the TPU package's."""
    port = REPO / "sangnom_tpu_torch" / "native" / "oracle.cpp"
    assert port.read_bytes() == (REPO / "sangnom_tpu" / "oracle" / "oracle.cpp").read_bytes()


def test_clip_container():
    planes = _planes("YUV420P10", 16, 8, 3)
    c = T.Clip.from_numpy(planes, "YUV420P10", device="cpu",
                          parity=np.array([True, False, True]), props={"k": 1})
    assert (c.num_frames, c.height, c.width, c.num_planes) == (3, 8, 16, 3)
    assert c.planes[0].dtype == torch.uint16 and c.device.type == "cpu"
    for a, b in zip(c.to_numpy(), planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    one = c[-2]
    assert one.num_frames == 1 and one.get_parity(0) is False
    np.testing.assert_array_equal(one.to_numpy()[1][0], planes[1][1])
    with pytest.raises(IndexError):
        c[3]
    cat = T.Clip.concat(c[0:1], c[1:3])
    for a, b in zip(cat.to_numpy(), planes):
        np.testing.assert_array_equal(a, b)
    assert list(cat.parity_array()) == [True, False, True]
    assert c.with_planes(c.planes).props == {"k": 1}
    assert list(T.Clip(c.planes, "YUV420P10", tff=False).parity_array()) == [False] * 3
    with pytest.raises(ValueError, match="mismatched formats"):
        T.Clip.concat(c, T.Clip.from_numpy([p.astype(np.uint8) for p in planes],
                                           "YUV420P8", device="cpu"))


def test_clip_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a GPU")
    with pytest.raises((RuntimeError, AssertionError)):
        T.Clip.from_numpy([np.zeros((1, 4, 4), np.uint8)], "GRAY8")


def test_public_names_match():
    assert set(T.__all__) == set(J.__all__)
    for name in T.__all__:
        assert hasattr(T, name)


def test_port_imports_no_jax():
    """The port runs where JAX is absent: importing it and running a tiny
    bob on the CPU loads neither jax nor sangnom_tpu."""
    code = (
        "import sys, numpy as np, sangnom_tpu_torch as T\n"
        "p = np.arange(2 * 8 * 16, dtype=np.uint8).reshape(2, 8, 16)\n"
        "out = T.bob(T.Clip.from_numpy([p], 'GRAY8', device='cpu'))\n"
        "assert out.num_frames == 4 and out.height == 8\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'sangnom_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
