"""The port's pool-compat mode (sangnom_tpu_torch.ops.pool_carry) against
sangnom_tpu, bit for bit, float included.

The same numpy inputs go through the TPU package's ``sangnom2(pool_compat=
True)`` (``opt=0``, and ``opt=1``: the Pallas pool kernels in interpret
mode), the native oracle with a carried pool, and the port on CPU tensors:
the plain pass (``opt=0``) and the kernel route (``opt=-1``), whose wrappers
run their plain twins on the CPU.  The final pool is compared through
``sangnom2_pool_stream``.
"""

import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import sangnom_tpu as J  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu.ops import pool_carry as jpc  # noqa: E402
from sangnom_tpu.ops.sangnom import sangnom2_pool_stream as j_stream  # noqa: E402
from sangnom_tpu_torch.ops import pool_carry as tpc  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream as t_stream  # noqa: E402
from sangnom_tpu_torch.oracle import sangnom2_clip_oracle  # noqa: E402

from conftest import make_planes  # noqa: E402
from test_pool_compat import CONFIGS  # noqa: E402

PARITIES = np.array([True, False, True])


def _planes(fname, w, h, n, seed):
    rng = np.random.default_rng(seed)
    fmt = J.get_format(fname)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    return [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]


def _frames(planes):
    return [[p[n] for p in planes] for n in range(planes[0].shape[0])]


def _tclip(planes, fname, parity=None):
    return T.Clip.from_numpy(planes, fname, device="cpu", parity=parity)


def _jclip(planes, fname, parity=None):
    return J.Clip.from_numpy(planes, fname, parity=parity)


def _assert_planes(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{what} plane {i}")


def _case(cfg):
    fname, w, h, order, aa, aac, dh, luma, chroma = cfg
    planes = _planes(fname, w, h, 3, zlib.crc32(repr(cfg).encode()))
    kw = dict(order=order, aa=aa, aac=aac, dh=dh, luma=luma, chroma=chroma)
    return fname, planes, kw


@functools.lru_cache(maxsize=None)
def _jax_out(cfg, opt):
    """JAX whole-clip output planes for a CONFIGS entry at ``opt``."""
    fname, planes, kw = _case(cfg)
    out = J.sangnom2(_jclip(planes, fname, PARITIES), pool_compat=True, opt=opt, **kw)
    return [np.asarray(p) for p in out.planes]


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_pool_matches_jax_opt0(cfg):
    """Both port routes equal JAX opt=0, and so does the final pool."""
    fname, planes, kw = _case(cfg)
    want = _jax_out(cfg, 0)
    clip = _tclip(planes, fname, PARITIES)
    for opt in (0, -1):
        _assert_planes(T.sangnom2(clip, pool_compat=True, opt=opt, **kw).planes,
                       want, f"opt={opt}")
    jclip = _jclip(planes, fname, PARITIES)
    _, jpool = j_stream(jclip, None, opt=0, **kw)
    tout, tpool = t_stream(clip, None, opt=-1, **kw)
    _assert_planes(tout.planes, want, "stream")
    np.testing.assert_array_equal(tpc.pool_to_numpy(tpool), np.asarray(jpool))


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_pool_matches_jax_pallas(cfg):
    """The port equals the TPU package's Pallas pool kernels (interpret mode)."""
    fname, planes, kw = _case(cfg)
    got = T.sangnom2(_tclip(planes, fname, PARITIES), pool_compat=True, **kw)
    _assert_planes(got.planes, _jax_out(cfg, 1))


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_pool_matches_oracle(cfg):
    """The port equals the native oracle threading one pool, frame by frame;
    the port's oracle binding equals the TPU package's."""
    from sangnom_tpu.oracle import sangnom2_clip_oracle as j_oracle

    fname, planes, kw = _case(cfg)
    fmt = T.get_format(fname)
    want = sangnom2_clip_oracle(_frames(planes), fmt, parities=list(PARITIES),
                                pool_compat=True, **kw)
    want_j = j_oracle(_frames(planes), J.get_format(fname),
                      parities=list(PARITIES), pool_compat=True, **kw)
    got = T.sangnom2(_tclip(planes, fname, PARITIES), pool_compat=True, opt=0, **kw)
    got_frames = _frames([p.numpy() for p in got.planes])
    for n, (g, wf, wj) in enumerate(zip(got_frames, want, want_j)):
        _assert_planes(wf, wj, f"oracle frame {n}")
        _assert_planes(g, wf, f"frame {n}")


HOOK_GEOMETRIES = [
    ("YUV420P8", 64, 16, dict(order=1, dh=True)),        # aligned
    ("YUV420P8", 52, 16, dict(order=2)),                 # unaligned
    ("GRAY16", 48, 12, dict(order=1, numerics="sse2")),  # u16 sse2
    ("GRAYS", 64, 12, dict(order=0)),                    # float
]


@pytest.fixture
def hook_flags():
    """Sets the TPU package's hook flags (clearing JAX's caches, as
    tests/test_pool_backend_hooks.py does) and the port's; restores both."""
    saved = (jpc.POOL_FUSED, jpc.POOL_SPLIT3, tpc.POOL_FUSED, tpc.POOL_SPLIT3)

    def set_flags(hook):
        jpc.POOL_FUSED = tpc.POOL_FUSED = hook == "fused"
        jpc.POOL_SPLIT3 = tpc.POOL_SPLIT3 = hook == "split3"
        jax.clear_caches()

    yield set_flags
    jpc.POOL_FUSED, jpc.POOL_SPLIT3, tpc.POOL_FUSED, tpc.POOL_SPLIT3 = saved
    jax.clear_caches()


@pytest.mark.parametrize("hook", ["fused", "split3"])
@pytest.mark.parametrize("fname,w,h,kw", HOOK_GEOMETRIES, ids=str)
def test_hook_arms_match_jax(hook_flags, hook, fname, w, h, kw):
    """The port's K6/K7 arms (their twins on the CPU) equal the TPU
    package's hook arms, and the final pool equals the plain pass's."""
    planes = _planes(fname, w, h, 3, w * h)
    parity = np.arange(3) % 2 == 0
    tclip = _tclip(planes, fname, parity)
    plain_out, plain_pool = t_stream(tclip, None, opt=0, **kw)
    hook_flags(hook)
    want = J.sangnom2(_jclip(planes, fname, parity), pool_compat=True, opt=1, **kw)
    got = T.sangnom2(tclip, pool_compat=True, **kw)
    _assert_planes(got.planes, want.planes, hook)
    out, pool = t_stream(tclip, None, **kw)
    _assert_planes(out.planes, plain_out.planes, f"{hook} stream")
    assert torch.equal(pool, plain_pool)


def _pool_run(planes, fname, **kw):
    out = T.sangnom2(_tclip(planes, fname), pool_compat=True, **kw)
    return [p.numpy() for p in out.planes]


def test_divergence_localized_to_stale_regions():
    """Zero contract vs pool-compat on one 4:2:0 frame: luma identical (its
    prepare covers the whole pool at an aligned width); chroma differs only
    in the 3-column-per-row creep cone from the stale columns, and in the
    last interpolated row, which reads a stale pool row outright
    (reference src/SangNom2.cpp:126-159)."""
    planes = _planes("YUV420P8", 64, 16, 1, 5)
    kw = dict(order=1, aa=48, aac=48)
    zero = [p.numpy() for p in T.sangnom2(_tclip(planes, "YUV420P8"), **kw).planes]
    pool = _pool_run(planes, "YUV420P8", **kw)
    np.testing.assert_array_equal(zero[0], pool[0])
    w_c, buf_c = 32, 4
    saw_stale_row = False
    for i in (1, 2):
        diffs = np.argwhere(zero[i][0] != pool[i][0])
        assert len(diffs), "the stale pool must show on 4:2:0 chroma"
        for r, c in diffs:
            assert r % 2 == 1, "kept rows never differ"
            b = (r + 1) // 2
            if b == buf_c - 1:
                saw_stale_row = True
                continue
            assert c >= w_c - 3 * b, f"plane {i} row {r} col {c} outside the cone"
    assert saw_stale_row
    _assert_planes(pool, [np.asarray(p) for p in J.sangnom2(
        _jclip(planes, "YUV420P8"), pool_compat=True, opt=0, **kw).planes])


def test_cross_frame_carry_without_luma():
    """luma=False: frame n's U pass inherits frame n-1's V residue, so two
    identical frames give different chroma, as in the TPU package."""
    one = _planes("YUV420P8", 64, 16, 1, 6)
    planes = [np.concatenate([p, p]) for p in one]
    kw = dict(order=1, aa=48, aac=48, luma=False, chroma=True)
    got = _pool_run(planes, "YUV420P8", **kw)
    assert not np.array_equal(got[1][0], got[1][1])
    want = J.sangnom2(_jclip(planes, "YUV420P8"), pool_compat=True, opt=0, **kw)
    _assert_planes(got, want.planes)


def test_unaligned_width_luma_carry():
    """Width 60 in stride 64: the pad columns are smoothed by every pass and
    never prepared again, so even luma carries across frames, within the
    creep bound; the oracle agrees."""
    one = _planes("GRAY8", 60, 16, 1, 7)
    planes = [np.concatenate([one[0], one[0]])]
    got = _pool_run(planes, "GRAY8", order=1, aa=48)
    y0, y1 = got[0]
    diffs = np.argwhere(y0 != y1)
    assert len(diffs)
    for r, c in diffs:
        assert c >= 60 - 3 * ((r + 1) // 2)
    want = sangnom2_clip_oracle(_frames(planes), T.get_format("GRAY8"), order=1,
                                aa=48, pool_compat=True)
    for n in range(2):
        np.testing.assert_array_equal(got[0][n], want[n][0])


def test_pool_equals_zero_when_prepare_covers_pool():
    """4:4:4 at an aligned width: every pass prepares the whole pool, so the
    pool mode equals the zero contract on every frame."""
    planes = _planes("YUV444P8", 64, 16, 2, 8)
    kw = dict(order=1, aa=48, aac=48)
    zero = T.sangnom2(_tclip(planes, "YUV444P8"), **kw)
    _assert_planes(_pool_run(planes, "YUV444P8", **kw),
                   [p.numpy() for p in zero.planes])


STREAM_CASES = [
    ("YUV420P8", 52, 16, dict(order=0, aac=40), (2, 3)),
    ("YUV420P10", 48, 16, dict(order=1, numerics="sse2", luma=False), (1, 1, 3)),
    ("GRAYS", 40, 12, dict(order=2, dh=True), (4, 1)),
]


@pytest.mark.parametrize("fname,w,h,kw,chunks", STREAM_CASES, ids=str)
def test_stream_chunked_equals_whole(fname, w, h, kw, chunks):
    """Chunks through `sangnom2_pool_stream`, the pool handed on, equal one
    whole-clip call, final pool included; the caller's pool is untouched."""
    n = sum(chunks)
    planes = _planes(fname, w, h, n, n * w)
    parity = np.arange(n) % 3 == 0
    clip = _tclip(planes, fname, parity)
    whole, whole_pool = t_stream(clip, None, **kw)
    pool, outs, s = None, [], 0
    for k in chunks:
        before = None if pool is None else pool.clone()
        out, new_pool = t_stream(clip[s:s + k], pool, **kw)
        if before is not None:
            assert torch.equal(pool, before), "the caller's pool was modified"
        pool, s = new_pool, s + k
        outs.append(out)
    _assert_planes(T.Clip.concat(*outs).planes, whole.planes)
    assert torch.equal(pool, whole_pool)
    _assert_planes(whole.planes, T.sangnom2(clip, pool_compat=True, **kw).planes)


@pytest.mark.parametrize("fname,w,h,kw", [
    ("YUV420P8", 52, 16, dict(order=1, aac=48)),
    ("GRAY16", 40, 12, dict(order=2, numerics="sse2")),
    ("YUV444PS", 36, 12, dict(order=0)),
], ids=str)
def test_jax_pool_continues_in_port(fname, w, h, kw):
    """A pool that the TPU package's stream returns after k frames, fed to
    the port's stream, gives the frames k.. and the final pool of JAX
    continuing."""
    planes = _planes(fname, w, h, 4, w + h)
    parity = np.array([True, False, False, True])
    jclip = _jclip(planes, fname, parity)
    want, want_pool = j_stream(jclip, None, opt=0, **kw)
    _, jpool = j_stream(jclip[0:2], None, opt=0, **kw)
    fmt = T.get_format(fname)
    pool = tpc.pool_from_numpy(np.asarray(jpool), fmt, device="cpu")
    got, got_pool = t_stream(_tclip(planes, fname, parity)[2:4], pool, **kw)
    _assert_planes(got.planes, [np.asarray(p)[2:4] for p in want.planes])
    np.testing.assert_array_equal(tpc.pool_to_numpy(got_pool), np.asarray(want_pool))


def test_init_pool_matches_jax():
    for fname, w, h_out in (("YUV420P8", 60, 16), ("GRAYS", 64, 24), ("GRAY16", 33, 10)):
        want = np.asarray(jpc.init_pool(w, h_out, J.get_format(fname)))
        got = tpc.pool_to_numpy(tpc.init_pool(w, h_out, T.get_format(fname), "cpu"))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert not got.any()


def test_pool_from_numpy_refuses_bad_pools():
    fmt = T.get_format("GRAY8")
    ok = np.zeros((9, 5, 32), np.int32)
    assert tpc.pool_from_numpy(ok, fmt, "cpu").dtype == torch.int32
    for bad in (ok.astype(np.float32), ok[:8], ok[0]):
        with pytest.raises(ValueError, match="pool must be"):
            tpc.pool_from_numpy(bad, fmt, "cpu")
    clip = _tclip(_planes("GRAY8", 32, 8, 1, 1), "GRAY8")
    with pytest.raises(ValueError, match="does not fit the clip"):
        t_stream(clip, torch.zeros((9, 6, 32), dtype=torch.int32))


@pytest.mark.parametrize("pass_name", ["plain", "k3", "split3", "fused"])
def test_degenerate_plane_only_smooths(pass_name):
    """A kept field of one row: no rows to interpolate, but every route still
    smooths the whole pool, as the TPU package's plain pass does."""
    import jax.numpy as jnp
    from sangnom_tpu.ops.primitives import KernelSpec as JSpec

    spec = KernelSpec.from_format(T.get_format("GRAY16"))
    rng = np.random.default_rng(3)
    pool_np = rng.integers(0, 0x10000, (9, 7, 32)).astype(np.int32)
    kept = rng.integers(0, 0x10000, (1, 20)).astype(np.uint16)
    _, want_pool = jpc.interp_field_pool(jnp.asarray(kept), jnp.asarray(pool_np), 100,
                                         JSpec(False, 0xFFFF, False))
    pool = torch.from_numpy(pool_np.copy())
    kt = torch.from_numpy(kept)
    if pass_name in ("plain", "k3"):
        fn = tpc.interp_field_pool if pass_name == "plain" else tpc.interp_field_pool_k3
        out = fn(kt, pool, 100, spec)
    else:
        carry = tpc._pool_split(pool)
        fn = tpc.interp_field_pool_split3 if pass_name == "split3" else tpc.interp_field_pool_fused
        out = fn(kt, carry, 100, spec)
        pool = tpc._pool_join(carry)
    assert out.shape == (0, 20)
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want_pool))
