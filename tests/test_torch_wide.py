"""Planes wider than one block of the port's kernels (more than 2048
smoothed columns for the field kernel, 8192 for the pool walk), against
sangnom_tpu, bit for bit, float included.

On the card a field past one block runs as the width-sharded kernel K4 runs
a field (``deint_kernel.field_plan``: k blocks of 4-column threads of a field
in a cluster, the plane edge-padded and the output cropped), the pool walk past one block
splits a map's row over a cluster (``pool_kernel.walk_plan``), and a
sharded route splits each shard that is too wide into k blocks
(``shard_kernel.split_count``).  On the CPU the wrappers run their plain
twins, which have no width limit, and the field kernel's wrappers take the
wide route's plain twin (K4's plain version with the k, padding and crop
the card uses) where the pass's plan does; so the fixtures below send the
CPU path through the wrappers and the split walk's plain twin, and those runs
are held against the TPU package at ``opt=0`` (one case also at ``opt=1``,
its Pallas kernels in interpret mode).  The ``cuda`` cases launch the
kernels and hold each against its plain version on the card; they skip
without one.  JAX is imported inside the tests, so on a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wide.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import (  # noqa: E402
    aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds, width_tiers)
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
from sangnom_tpu_torch.ops import launch_geometry as geo  # noqa: E402
from sangnom_tpu_torch.ops import pool_carry as pc  # noqa: E402
from sangnom_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from sangnom_tpu_torch.ops import reference as ref  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream as t_stream  # noqa: E402
from sangnom_tpu_torch.parallel import shard_kernel as sk  # noqa: E402


def _plane(rng, shape, fmt):
    """Full-range samples, out-of-nominal codes included for >8-bit formats
    (tests/conftest.make_plane's distribution)."""
    if fmt.is_float:
        return (rng.random(shape, dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)


def _planes(fname, w, h, n, seed):
    rng = np.random.default_rng(seed)
    fmt = get_format(fname)
    return [_plane(rng, (n,) + fmt.plane_dims(w, h, i)[::-1], fmt)
            for i in range(fmt.num_planes)]


def _equal(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                for x in (g, w))
        np.testing.assert_array_equal(g, w, err_msg=f"{what} plane {i}")


def _jax():
    pytest.importorskip("jax")
    import sangnom_tpu as J

    return J


def _spec(fname, sse2=False):
    return KernelSpec.from_format(get_format(fname), sse2=sse2)


def _pool(fname, S, P, seed):
    """A stale pool [9, P+1, S]: every row and column holds data, as a
    pool does after earlier passes."""
    fmt = get_format(fname)
    rng = np.random.default_rng(seed)
    if fmt.is_float:
        return rng.random((9, P + 1, S), dtype=np.float32) * 40
    return rng.integers(0, 16 << (8 * fmt.component_size), (9, P + 1, S)).astype(np.int32)


@pytest.fixture
def wide_route(monkeypatch):
    """The port's main path on the CPU through the field kernel's wrappers,
    which route each pass by its `field_plan` as the card does: K4's plain
    version wherever a field is past one block; records the widths that
    took it."""
    from sangnom_tpu_torch.ops import sangnom as ops
    from sangnom_tpu_torch.parallel import fused_smooth as fs

    used = []
    real = fs.fused_full_plain

    def spy(kept, aaf, spec, n_space, plane_width, *a):
        used.append(plane_width)
        return real(kept, aaf, spec, n_space, plane_width, *a)

    monkeypatch.setattr(fs, "fused_full_plain", spy)
    monkeypatch.setattr(ops, "_pick_backend", lambda opt, device: dk.interpolate_field_batch)
    return used


@pytest.fixture
def wide_walk(monkeypatch):
    """The pool walks on the CPU (K6 / K7's walk, the batched walk) through
    the split walk's plain twin wherever the pool is past one block;
    records each plan's k."""
    used = []
    split3, batch = pk.smooth_split3_plain_, pk.smooth_batch_plain_

    def split3_wide(row0, body, tail, spec):
        plan = pk.walk_plan(body.shape[2], body.shape[1])
        if plan.k == 1:
            return split3(row0, body, tail, spec)
        used.append(plan.k)
        return pk.smooth_split_plain_(row0, body, tail, spec, plan)

    def batch_wide(row0, body, tail, spec):
        K, _, n, S = body.shape
        plan = pk.walk_plan(S, n)
        if plan.k == 1:
            return batch(row0, body, tail, spec)
        used.append(plan.k)
        pk.smooth_split_plain_(row0.reshape(K * 9, S), body.view(K * 9, n, S),
                               tail.reshape(K * 9, S), spec, plan)
        return body

    monkeypatch.setattr(pk, "smooth_split3_plain_", split3_wide)
    monkeypatch.setattr(pk, "smooth_batch_plain_", batch_wide)
    return used


# --- (a) the filter surface past one block ---------------------------------

API_CASES = [
    # fmt, w, h, kw
    ("GRAY8", 8193, 8, dict(order=1)),
    ("GRAY8", 8448, 8, dict(order=2)),
    ("YUV420P8", 16416, 8, dict(order=0)),
    ("YUV420P8", 8448, 4, dict(order=1, dh=True)),
    ("GRAY16", 8448, 8, dict(order=1, aa=128, aac=64)),
    ("YUV444PS", 8193, 4, dict(order=2)),
    ("GRAY8", 8448, 8, dict(order=1, numerics="sse2")),
]


@pytest.mark.parametrize("fname,w,h,kw", API_CASES, ids=str)
def test_sangnom2_wide_matches_jax(wide_route, fname, w, h, kw):
    """``sangnom2`` through the wide route (K4's plain version at the card's
    k) equals the TPU package's opt=0, frame by frame."""
    J = _jax()
    planes = _planes(fname, w, h, 2, w + h)
    parity = np.array([True, False])
    want = J.sangnom2(J.Clip.from_numpy(planes, fname, parity=parity), opt=0, **kw)
    got = T.sangnom2(T.Clip.from_numpy(planes, fname, device="cpu", parity=parity), **kw)
    _equal(got.planes, want.planes, f"{fname} {w}")
    assert w in wide_route  # the luma fields took the wide route


def test_sangnom2_wide_matches_jax_pallas(wide_route):
    """The wide route equals the TPU package's Pallas kernel (interpret
    mode, as its own tests run it) on a field past one block."""
    J = _jax()
    planes = _planes("GRAY8", 8448, 4, 1, 5)
    want = J.sangnom2(J.Clip.from_numpy(planes, "GRAY8"), opt=1, order=1)
    got = T.sangnom2(T.Clip.from_numpy(planes, "GRAY8", device="cpu"), order=1)
    _equal(got.planes, want.planes)
    assert wide_route == [8448]


# --- (b) bob ---------------------------------------------------------------

def test_bob_wide_matches_jax(wide_route):
    """The bob of a 4:2:0 plane past one block: the luma and chroma fields
    split from the interlaced plane and through the wide route."""
    J = _jax()
    planes = _planes("YUV420P8", 8448, 8, 1, 17)
    want = J.bob(J.Clip.from_numpy(planes, "YUV420P8", tff=True))
    got = T.bob(T.Clip.from_numpy(planes, "YUV420P8", device="cpu", tff=True))
    _equal(got.planes, want.planes)
    assert wide_route == [4224, 8448]  # U+V (4224 wide) past one block too


# --- (c) pool_compat --------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["sequential", "POOL_FAST"])
def test_pool_compat_wide_matches_jax(wide_walk, monkeypatch, fast):
    """pool_compat over 3 frames of a 8448-wide clip: every pass's walk
    split over a 2-block cluster (the pool's stride), on the default K7
    route and on the frame-parallel path; frames and final pool equal the
    TPU package's."""
    from sangnom_tpu.ops.sangnom import sangnom2_pool_stream as j_stream

    J = _jax()
    monkeypatch.setattr(pc, "POOL_FAST", fast)
    planes = _planes("YUV420P8", 8448, 8, 3, 23)
    kw = dict(order=1, aac=48)
    want, want_pool = j_stream(J.Clip.from_numpy(planes, "YUV420P8"), None, opt=0, **kw)
    got, pool = t_stream(
        T.Clip.from_numpy(planes, "YUV420P8", device="cpu"), None, **kw)
    _equal(got.planes, want.planes)
    np.testing.assert_array_equal(pc.pool_to_numpy(pool), np.asarray(want_pool))
    assert wide_walk and set(wide_walk) == {2}


def test_jax_pool_continues_wide(wide_walk):
    """A pool that the TPU package's stream returns after 2 frames continues
    in the port's split walk."""
    from sangnom_tpu.ops.sangnom import sangnom2_pool_stream as j_stream

    J = _jax()
    planes = _planes("GRAY16", 8448, 8, 4, 29)
    parity = np.array([True, False, False, True])
    kw = dict(order=0, numerics="sse2")
    jclip = J.Clip.from_numpy(planes, "GRAY16", parity=parity)
    want, want_pool = j_stream(jclip, None, opt=0, **kw)
    _, jpool = j_stream(jclip[0:2], None, opt=0, **kw)
    fmt = T.get_format("GRAY16")
    pool = pc.pool_from_numpy(np.asarray(jpool), fmt, device="cpu")
    clip = T.Clip.from_numpy(planes, "GRAY16", device="cpu", parity=parity)
    got, got_pool = t_stream(clip[2:4], pool, **kw)
    _equal(got.planes, [np.asarray(p)[2:4] for p in want.planes])
    np.testing.assert_array_equal(pc.pool_to_numpy(got_pool), np.asarray(want_pool))
    assert wide_walk


# --- (d) sharded routes with shards past one block --------------------------

@pytest.mark.parametrize("space,smooth,across", [
    (1, None, False), (1, "fused", False), (2, "fused", False), (2, "chunked", False),
    (2, "fused", True)], ids=str)
def test_sharded_wide_matches_jax(monkeypatch, space, smooth, across):
    """``sangnom2_sharded`` at 16416 (shards of 16416 or 8208 columns, past
    one block): the kernel arms split each shard into k blocks, n_space * k
    shards in all, and the output equals the TPU package's unsharded opt=0."""
    from sangnom_tpu_torch.parallel import cross_device, fused_smooth, sangnom2_sharded
    from sangnom_tpu_torch.parallel.sharding import default_mesh

    J = _jax()
    shards = []
    real = fused_smooth.fused_full_plain

    def spy(kept, aaf, spec, n_space, *a):
        shards.append(n_space)
        return real(kept, aaf, spec, n_space, *a)

    monkeypatch.setattr(fused_smooth, "fused_full_plain", spy)
    planes = _planes("GRAY8", 16416, 8, 2, 31)
    want = J.sangnom2(J.Clip.from_numpy(planes, "GRAY8"), opt=0, order=1)
    clip = T.Clip.from_numpy(planes, "GRAY8", device="cpu")
    if across:
        got = cross_device.sangnom2_across(clip, ["cpu"] * space, smooth=smooth, order=1)
    else:
        got = sangnom2_sharded(clip, default_mesh(1, space, devices=["cpu"] * space),
                               space_axis="space", smooth=smooth, order=1)
    _equal(got.planes, want.planes)
    if smooth == "fused" and not across:
        assert shards == [3 if space == 1 else 4]


# --- (e) the split itself ----------------------------------------------------

SPLIT_CASES = [
    # fmt, sse2, n fields, bufH, w, interlaced_tff (the 65600 case past 8
    # blocks: the chunk route)
    ("GRAY8", False, 2, 5, 8193, None),
    ("GRAYS", False, 2, 3, 8224, None),
    ("GRAY8", True, 1, 4, 65600, None),
    ("GRAY8", False, 2, 8, 3840, None),  # order=1 fields of 3840 x 16 frames
    ("GRAY8", False, 4, 8, 2560, True),  # bob fields of 2560 x 16 frames
    ("GRAY10", False, 2, 6, 3840, None),  # 3840 x 12, 10-bit
    ("GRAYS", False, 2, 6, 3840, None),  # 3840 x 12, float
    ("GRAY8", False, 2, 1, 3840, None),  # one kept row: the weave only
    ("GRAY8", False, 2, 1, 16384, None),  # one kept row past 8 blocks: the chunk route
]


@pytest.mark.parametrize("fname,sse2,n,bufH,w,tff", SPLIT_CASES, ids=str)
def test_wide_split_matches_jax(fname, sse2, n, bufH, w, tff):
    """The wrappers on the CPU take the wide route's plain twin (K4's plain
    version over the plan's k shards of the padded plane, cropped), which
    equals the TPU package's field interpolation, woven at offsets 0, 1 and
    per field; with ``tff`` the fields are split from an interlaced plane
    first, as the bob's are."""
    J = _jax()
    from sangnom_tpu.ops import reference as jref
    from sangnom_tpu.ops.primitives import KernelSpec as JSpec
    from sangnom_tpu.ops.sangnom import weave_assemble as j_weave

    fmt = get_format(fname)
    spec = _spec(fname, sse2)
    stride = buffer_stride_elems(w, fmt.component_size)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
    rng = np.random.default_rng(w + bufH)
    if tff is None:
        src = kept = _plane(rng, (n, bufH, w), fmt)
    else:  # [n/2, 2*bufH, w] frames; field 2j+b of frame j, b = 0 the first
        src = _plane(rng, (n // 2, 2 * bufH, w), fmt)
        rows = src.reshape(n // 2, bufH, 2, w)
        kept = (rows if tff else rows[:, :, ::-1]).transpose(0, 2, 1, 3).reshape(n, bufH, w)
    fp = dk.field_plan(n, w, bufH, stride, spec, cl.H100)
    assert fp.k > 1 and fp.plan.cluster == (fp.k <= geo.MAX_CLUSTER)
    import jax.numpy as jnp

    jspec = JSpec.from_format(J.get_format(fname), sse2=sse2)
    jinterp = jref.interpolate_field_batch(jnp.asarray(kept), aaf, jspec, stride)
    if bufH >= 2:
        got = dk.interpolate_field_batch(torch.from_numpy(kept.copy()), aaf, spec, stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jinterp))
    pf = np.arange(n, dtype=np.int32) % 2
    for off in (0, 1, pf):
        t_off = torch.from_numpy(off) if isinstance(off, np.ndarray) else off
        j_off = jnp.asarray(off) if isinstance(off, np.ndarray) else off
        want = j_weave(jnp.asarray(kept), jinterp, j_off)
        got = dk.deinterlace_field_batch_fused(torch.from_numpy(src), t_off, aaf, spec,
                                               stride, tff)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(off))


@pytest.mark.parametrize("fname,S,P", [("GRAY8", 8448, 9), ("GRAYS", 16416, 7),
                                       ("GRAY16", 65600, 5)], ids=str)
def test_split_walk_matches_jax(fname, S, P):
    """The split walk's plain twin (each shard walks its own columns and
    its halo, exchanges every R rows; the chunk route past 8 blocks) on a
    stale pool equals the TPU package's pool smoothing."""
    J = _jax()
    import jax.numpy as jnp
    from sangnom_tpu.ops import reference as jref
    from sangnom_tpu.ops.primitives import KernelSpec as JSpec

    pool = _pool(fname, S, P, S)
    spec = _spec(fname)
    jspec = JSpec.from_format(J.get_format(fname))
    want = np.asarray(jref.smooth_scan(jnp.asarray(pool), jspec, init=jnp.asarray(pool[:, 0])))
    want = want.transpose(1, 0, 2)  # time-major [P-1, 9, S] -> [9, P-1, S]
    plan = pk.walk_plan(S, P - 1)
    assert plan.k > 1 and plan.cluster == (plan.k <= geo.MAX_CLUSTER)
    got = torch.from_numpy(pool.copy())
    pk.smooth_split_plain_(got[:, 0], got[:, 1:P], got[:, P], spec, plan)
    np.testing.assert_array_equal(got[:, 1:P].numpy(), want)
    np.testing.assert_array_equal(got[:, [0, P]].numpy(), pool[:, [0, P]])


@pytest.mark.parametrize("w,fields", [(3840, 24), (1920, 0)], ids=str)
def test_cluster_fields_counted(wide_route, w, fields):
    """``cluster_fields`` counts the fields that the card walks as a
    cluster split (``test_wide_launch_span_on_card``: 24 for a 24-frame
    3840-wide luma pass, none at 1920).  On the CPU the same call takes
    the plan the card would, a cluster of 4 blocks for each of the 24
    luma fields at 3840 and one block a field at 1920, runs K4's plain
    version there and counts nothing."""
    from sangnom_tpu_torch.utils import profiling as pr

    planes = _planes("GRAY8", w, 4, 24, 37)
    clip = T.Clip.from_numpy(planes, "GRAY8", device="cpu")
    fp = dk.field_plan(24, w, 4, buffer_stride_elems(w, 1), _spec("GRAY8"), cl.H100)
    if fields:
        assert (fp.k, fp.plan.cluster) == (4, True)
    else:
        assert fp.k == 1
    before = pr.counters().get("cluster_fields", 0)
    with pr.tracing():
        got = T.sangnom2(clip, order=1)
    pr.drain()
    assert pr.counters().get("cluster_fields", 0) == before
    assert wide_route == ([w] if fields else [])
    _equal(got.planes, T.sangnom2(clip, order=1, opt=0).planes)


# --- (f) the plans ----------------------------------------------------------

WIDTHS = (8192, 8193, 8224, 12288, 15360, 16384, 32768, 65280, 65536)


@pytest.mark.parametrize("S", (1920, 2048, 2049, 2056, 3840, 4096, 7680) + WIDTHS)
def test_wide_plan(S):
    """`field_plan` for 24 GRAY8 fields of width S: up to 2048 smoothed
    columns K1's plan, a block a field; above, K4's 4-column build over k >=
    2 blocks a field, a halo exchange every ``WIDE_FIELD_ROWS`` rows: the
    least k up to 8 whose blocks, halos included, fit ``WIDE_BLOCK``
    columns, else the least k whose blocks fit 2040; each halo within the
    adjacent block, the cluster route up to 8 blocks, and blocks that fit
    one a SM asking for `shard_kernel.one_wave_smem`."""
    spec = _spec("GRAY8")
    stride = buffer_stride_elems(S, 1)
    for bufH in (1, 4, 540):
        fp = dk.field_plan(24, S, bufH, stride, spec, cl.H100)
        smoothed = width_tiers(S, bufH, stride, spec)[2]
        if smoothed <= dk.FIELD_COLS:
            assert (fp.k, fp.W_loc, fp.blocks) == (1, smoothed, 24)
            assert fp.plan == dk.launch_plan(S, smoothed, 1, cl.H100.smem_block)
            assert fp.plan.cols == 4
            continue
        assert fp.k > 1 and fp.width >= S and fp.width % fp.k == 0
        assert fp.blocks == 24 * fp.k
        plan = fp.plan
        planned = sk.full_plan(fp.k, fp.W_loc, bufH, 1, cl.H100.smem_block,
                               dk.WIDE_FIELD_ROWS)
        assert plan == planned._replace(
            smem_bytes=sk.one_wave_smem(fp.blocks, planned.smem_bytes, cl.H100))
        assert plan.R == max(1, min(dk.WIDE_FIELD_ROWS, bufH - 1))
        assert plan.H == 3 * plan.R <= fp.W_loc
        assert plan.cols == 4 and plan.threads <= 512
        assert plan.cluster == (fp.k <= geo.MAX_CLUSTER)
        if bufH == 1:  # the weave alone: one launch over no steps, either route
            assert plan.launches == 1
        else:
            assert plan.launches == (1 if plan.cluster else -(-(bufH - 1) // plan.R))

        def fits(j, cap):
            W = fp.width // j
            return fp.width % j == 0 and geo.block_width(j, W, plan.H) <= cap

        narrow = [j for j in range(2, geo.MAX_CLUSTER + 1) if fits(j, dk.WIDE_BLOCK)]
        if narrow:
            assert fp.k == narrow[0]
        else:  # the least k within the 4-column build
            assert fits(fp.k, sk.MAX_BLOCK_4)
            assert not any(fits(j, sk.MAX_BLOCK_4) for j in range(2, fp.k))
        if S == 3840:  # the maa pass's luma: four blocks of 960, no pad, no crop
            assert (fp.k, fp.W_loc, fp.width, plan.cluster) == (4, 960, 3840, True)
            assert plan.threads == 256
        if S == 15360:
            assert (fp.k, fp.W_loc) == (8, 1920)


@pytest.mark.parametrize("S", WIDTHS + (65600,))
def test_walk_plan(S):
    """The pool walk: one block up to 8192 columns; above, k blocks that
    cover S, each within one block's columns with its halos, each halo
    within the adjacent shard, R <= D + 1 for every build."""
    plan = pk.walk_plan(S, 539)
    if S <= geo.MAX_COLS:
        assert (plan.k, plan.cluster, plan.launches) == (1, False, 1)
        assert (plan.cols, plan.threads) == geo.launch_shape(S)
        return
    k, W_loc, H = plan.k, plan.W_loc, plan.H
    assert k > 1 and (k - 1) * W_loc < S <= k * W_loc
    assert H == 3 * plan.R and plan.R == pk.WIDE_ROWS <= 3  # R <= D + 1, D >= 2
    last = S - (k - 1) * W_loc
    assert H <= last <= W_loc
    assert W_loc + min(k - 1, 2) * H <= geo.MAX_COLS
    assert (plan.cols, plan.threads) == geo.launch_shape(W_loc + min(k - 1, 2) * H)
    assert plan.cluster == (k <= geo.MAX_CLUSTER)
    assert plan.launches == (1 if plan.cluster else -(-539 // plan.R))
    assert pk.walk_plan(S, 539, cluster=False).launches == -(-539 // plan.R)


@pytest.mark.parametrize("S", WIDTHS)
@pytest.mark.parametrize("n_space,halo", [(1, 12), (2, 12), (4, 102)])
def test_split_count(S, n_space, halo):
    """The sharded routes' sub-split: 1 where a shard fits one block with
    its halos; else the least k whose n_space * k blocks do."""
    S = buffer_stride_elems(S, 1)
    k = sk.split_count(S, n_space, halo)
    n = n_space * k

    def fits(n):
        return S % n == 0 and S // n + min(n - 1, 2) * halo <= sk.MAX_BLOCK

    assert fits(n) and not any(fits(n_space * j) for j in range(1, k))
    if S // n_space + min(n_space - 1, 2) * halo <= sk.MAX_BLOCK:
        assert k == 1


# --- (g) on the card -----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


KERNEL_CASES = [
    # fmt, sse2, n, bufH, w, offset, interlaced_tff
    ("GRAY8", False, 3, 8, 8193, 0, None),
    ("GRAY8", True, 2, 12, 8448, "pf", True),
    ("GRAY16", False, 2, 9, 10240, 1, None),
    ("YUV422P10", True, 2, 6, 16416, "pf", None),
    ("GRAYS", False, 2, 7, 8448, "pf", False),
    ("GRAY8", False, 1, 9, 65600, 0, None),  # 40 blocks: the chunk route
    ("GRAY8", False, 3, 9, 3840, 1, None),  # UHD luma: 4 blocks of 960
    ("GRAY8", False, 2, 8, 2560, "pf", True),  # a UHD-ish bob, fields in place
    ("GRAY10", False, 2, 6, 3840, 0, None),
    ("GRAYS", True, 2, 6, 4096, 1, None),  # 8 blocks of 512
    ("GRAY8", False, 2, 1, 3840, 0, None),  # one kept row: the weave only
    ("GRAY8", False, 2, 1, 16384, 1, None),  # one kept row on the chunk route (16 blocks)
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_wide_field_on_card(cuda, case):
    """The wide route's K4 launches against the plain path on the card,
    woven and not; launches counted in shard_kernel, none in deint's."""
    fname, sse2, n, bufH, w, offset, tff = case
    fmt = get_format(fname)
    spec = _spec(fname, sse2)
    stride = buffer_stride_elems(w, fmt.component_size)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
    rng = np.random.default_rng(w + bufH)
    shape = (n, bufH, w) if tff is None else (max(1, n // 2), 2 * bufH, w)
    kept = torch.from_numpy(_plane(rng, shape, fmt)).to(cuda)
    n_fields = 2 * shape[0] if tff is not None else n
    off = (torch.arange(n_fields, dtype=torch.int32, device=cuda) % 2
           if offset == "pf" else offset)
    fp = dk.field_plan(n_fields, w, bufH, stride, spec, cl.card_figures(cuda))
    before, full = dk.LAUNCHES, sk.LAUNCHES["full"]
    got = dk.deinterlace_field_batch_fused(kept, off, aaf, spec, stride, tff)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == before
    assert sk.LAUNCHES["full"] - full == fp.plan.launches
    want = dk.deinterlace_field_batch_plain(kept, off, aaf, spec, stride, tff)
    assert torch.equal(got, want)
    if tff is None:
        got = dk.interpolate_field_batch(kept, aaf, spec, stride)
        assert torch.equal(got, ref.interpolate_field_batch(kept, aaf, spec, stride))


@pytest.mark.cuda
@pytest.mark.parametrize("fname,sse2", [("GRAY8", False), ("GRAY16", True), ("GRAYS", False)])
@pytest.mark.parametrize("S,P", [(8448, 33), (12288, 12), (65600, 9)], ids=str)
def test_wide_walk_on_card(cuda, fname, sse2, S, P):
    """The wide walk (cluster route; the chunk route at 65600) against its
    plain twin on a stale pool, through K3, K6 and the batched walk."""
    spec = _spec(fname, sse2)
    pool = torch.from_numpy(_pool(fname, S, P, S + P)).to(cuda)
    want = pk.smooth_pool_plain_(pool.clone(), spec)
    plan = pk.card_walk_plan(spec, S, P - 1, cuda)
    assert plan.k > 1
    pk.reset_launches()
    assert torch.equal(pk.smooth_pool_(pool.clone(), spec), want), "K3"
    row0, body, tail = (x.contiguous() for x in (pool[:, 0], pool[:, 1:P], pool[:, P]))
    assert torch.equal(pk.smooth_split3_(row0, body.clone(), tail, spec),
                       want[:, 1:P]), "K6"
    b = torch.stack([body, body.flip(-1)]).contiguous()
    z = torch.stack([row0, row0.flip(-1)]).contiguous()
    t = torch.stack([tail, tail.flip(-1)]).contiguous()
    wb = pk.smooth_batch_plain_(z.cpu(), b.cpu(), t.cpu(), spec)
    assert torch.equal(pk.smooth_batch_(z, b, t, spec).cpu(), wb), "batch"
    torch.cuda.synchronize()
    assert pk.LAUNCHES["smooth"] == plan.launches  # K3
    assert pk.LAUNCHES["split3"] == 2 * plan.launches  # K6 and the batched walk


@pytest.mark.cuda
@pytest.mark.parametrize("bufH", [1, 9])
def test_wide_chunk_route_on_card(cuda, monkeypatch, request, bufH):
    """The wide route where the card cannot schedule the cluster: 3840
    columns on the chunk route (4 blocks, a launch a chunk of R rows; one
    launch for one kept row) against the plain path, woven at offsets 0, 1
    and per field, and not woven."""
    spec = _spec("GRAY8")
    fmt = get_format("GRAY8")
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
    monkeypatch.setattr(cl, "cluster_fits", lambda device, key, clusters: False)
    dk.field_plan.cache_clear()
    request.addfinalizer(dk.field_plan.cache_clear)
    fp = dk.field_plan(3, 3840, bufH, 3840, spec, cl.card_figures(cuda))
    assert (fp.k, fp.plan.cluster) == (4, False)
    kept = torch.from_numpy(_plane(np.random.default_rng(bufH), (3, bufH, 3840), fmt)).to(cuda)
    for off in (0, 1, torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)):
        full = sk.LAUNCHES["full"]
        got = dk.deinterlace_field_batch_fused(kept, off, aaf, spec, 3840)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["full"] - full == fp.plan.launches
        assert torch.equal(got, dk.deinterlace_field_batch_plain(kept, off, aaf, spec, 3840))
    if bufH > 1:
        got = dk.interpolate_field_batch(kept, aaf, spec, 3840)
        assert torch.equal(got, ref.interpolate_field_batch(kept, aaf, spec, 3840))


UHD_CASES = [
    # the maa pass and the bob at 3840 x 2160: the luma fields on K4 over 4
    # blocks, the 1920-wide chroma on K1
    ("YUV420P8", 3840, 2160, dict(order=1, aa=48, aac=0)),
    ("YUV420P8", 3840, 2160, dict(bob=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fname,w,h,kw", API_CASES + UHD_CASES, ids=str)
def test_sangnom2_wide_on_card(cuda, fname, w, h, kw):
    """The filter surface on the card past one block equals opt=0; past
    the pool walk's one block (8192 columns) pool_compat too."""
    kw = dict(kw)
    bob = kw.pop("bob", False)
    planes = _planes(fname, w, h, 2, w + h)
    if bob:
        clip = T.Clip.from_numpy(planes, fname, device=cuda, tff=True)
        _equal(T.bob(clip, **kw).planes, T.bob(clip, opt=0, **kw).planes, "bob")
        return
    clip = T.Clip.from_numpy(planes, fname, device=cuda, parity=np.array([True, False]))
    _equal(T.sangnom2(clip, **kw).planes, T.sangnom2(clip, opt=0, **kw).planes)
    if w > geo.MAX_COLS:
        _equal(T.sangnom2(clip, pool_compat=True, **kw).planes,
               T.sangnom2(clip, pool_compat=True, opt=0, **kw).planes, "pool_compat")


@pytest.mark.cuda
def test_wide_launch_span_on_card(cuda):
    """A wide field pass's K4 launch span carries its route and k, and
    ``cluster_fields`` counts its fields: 24 luma fields of 3840 on a
    cluster of 4 blocks; none at 1920."""
    from sangnom_tpu_torch.utils import profiling as pr

    spec = _spec("GRAY8")
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, get_format("GRAY8"))[0],
                       get_format("GRAY8"))
    for w, fields, ks in ((3840, 24, [4]), (1920, 0, [])):
        kept = torch.randint(0, 256, (24, 16, w), dtype=torch.uint8, device=cuda)
        before = pr.counters().get("cluster_fields", 0)
        with pr.tracing():
            got = dk.deinterlace_field_batch_fused(kept, 1, aaf, spec, w)
        torch.cuda.synchronize()
        recs = [r for r in pr.drain() if r.name == pr.LAUNCH]
        k4 = [r.counts for r in recs if r.counts.get("kernel") == "shard_full_kernel"]
        assert [c["k"] for c in k4] == ks
        assert all(c["route"] == "cluster" for c in k4)
        assert pr.counters().get("cluster_fields", 0) - before == fields
        assert torch.equal(got, dk.deinterlace_field_batch_plain(kept, 1, aaf, spec, w))


@pytest.mark.cuda
def test_bob_and_sharded_wide_on_card(cuda):
    """bob, a 1x2 mesh of the card (K4 over 4 blocks a field) and the route
    across devices with two slots of the card, past one block."""
    from sangnom_tpu_torch.parallel import cross_device, sangnom2_sharded
    from sangnom_tpu_torch.parallel.sharding import default_mesh

    planes = _planes("YUV420P8", 16416, 8, 2, 3)
    clip = T.Clip.from_numpy(planes, "YUV420P8", device=cuda, tff=True)
    _equal(T.bob(clip).planes, T.bob(clip, opt=0).planes, "bob")
    want = T.sangnom2(clip, opt=0).planes
    mesh = default_mesh(1, 2, devices=[cuda] * 2)
    for smooth in ("fused", "chunked"):
        _equal(sangnom2_sharded(clip, mesh, space_axis="space", smooth=smooth).planes,
               want, smooth)
        _equal(cross_device.sangnom2_across(clip, [cuda] * 2, smooth=smooth).planes,
               want, f"across {smooth}")
