"""Planes wider than one block of the port's kernels (more than 8192
smoothed columns), against sangnom_tpu, bit for bit, float included.

On the card a field past one block runs as the width-sharded kernel K4 runs
a field (``deint_kernel.wide_plan``: k blocks of a field in a cluster, the
plane edge-padded and the output cropped), the pool walk past one block
splits a map's row over a cluster (``pool_kernel.walk_plan``), and a
sharded route splits each shard that is too wide into k blocks
(``shard_kernel.split_count``).  On the CPU the wrappers run their plain
twins, which have no width limit; so the fixtures below send the CPU path
through the wide routes' plain twins (K4's plain version and the split
walk's, with the k, padding, halos and crop the card uses), and those runs
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
    aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds)
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
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
    """The port's main path on the CPU through the wide route's plain twin
    wherever a field is past one block, as the card routes it; records the
    widths that took it."""
    from sangnom_tpu_torch.ops import sangnom as ops

    used = []

    def interp(kept, aaf, spec, stride):
        if dk._is_wide(kept.shape[2], kept.shape[1], stride, spec):
            used.append(kept.shape[2])
            return dk._wide(kept, None, aaf, spec, stride)
        return ref.interpolate_field_batch(kept, aaf, spec, stride)

    def weave(kept, offset, aaf, spec, stride, interlaced_tff=None):
        bufH = kept.shape[1] // (1 if interlaced_tff is None else 2)
        if dk._is_wide(kept.shape[2], bufH, stride, spec):
            used.append(kept.shape[2])
            return dk._wide(kept, offset, aaf, spec, stride, interlaced_tff)
        return dk.deinterlace_field_batch_plain(kept, offset, aaf, spec, stride,
                                                interlaced_tff)

    interp.fused_weave = weave
    monkeypatch.setattr(ops, "_pick_backend", lambda opt, device: interp)
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
    assert wide_route == [8448]  # chroma (4224 wide) stays on K1's plan


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
    real = fused_smooth._fused_full

    def spy(kept, aaf, spec, n_space, *a):
        shards.append(n_space)
        return real(kept, aaf, spec, n_space, *a)

    monkeypatch.setattr(fused_smooth, "_fused_full", spy)
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
    # fmt, sse2, n, bufH, w (the last past 8 blocks: the chunk route)
    ("GRAY8", False, 2, 5, 8193),
    ("GRAYS", False, 2, 3, 8224),
    ("GRAY8", True, 1, 4, 65600),
]


@pytest.mark.parametrize("fname,sse2,n,bufH,w", SPLIT_CASES, ids=str)
def test_wide_split_matches_jax(fname, sse2, n, bufH, w):
    """The wide route's plain twin (K4's plain version over the plan's k
    shards of the padded plane, cropped) equals the TPU package's field
    interpolation, woven at offsets 0, 1 and per field."""
    J = _jax()
    from sangnom_tpu.ops import reference as jref
    from sangnom_tpu.ops.primitives import KernelSpec as JSpec
    from sangnom_tpu.ops.sangnom import weave_assemble as j_weave

    fmt = get_format(fname)
    spec = _spec(fname, sse2)
    stride = buffer_stride_elems(w, fmt.component_size)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
    kept = _plane(np.random.default_rng(w), (n, bufH, w), fmt)
    plan = dk.wide_plan(w, bufH, stride, spec, dk.H100_SMEM)
    assert plan.k > 1 and plan.plan.cluster == (plan.k <= sk.MAX_CLUSTER)
    import jax.numpy as jnp

    jspec = JSpec.from_format(J.get_format(fname), sse2=sse2)
    jinterp = jref.interpolate_field_batch(jnp.asarray(kept), aaf, jspec, stride)
    got = dk._wide(torch.from_numpy(kept), None, aaf, spec, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jinterp))
    pf = np.arange(n, dtype=np.int32) % 2
    for off in (0, 1, pf):
        t_off = torch.from_numpy(off) if isinstance(off, np.ndarray) else off
        j_off = jnp.asarray(off) if isinstance(off, np.ndarray) else off
        want = j_weave(jnp.asarray(kept), jinterp, j_off)
        got = dk._wide(torch.from_numpy(kept), t_off, aaf, spec, stride)
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
    assert plan.k > 1 and plan.cluster == (plan.k <= sk.MAX_CLUSTER)
    got = torch.from_numpy(pool.copy())
    pk.smooth_split_plain_(got[:, 0], got[:, 1:P], got[:, P], spec, plan)
    np.testing.assert_array_equal(got[:, 1:P].numpy(), want)
    np.testing.assert_array_equal(got[:, [0, P]].numpy(), pool[:, [0, P]])


# --- (f) the plans ----------------------------------------------------------

WIDTHS = (8192, 8193, 8224, 12288, 15360, 16384, 32768, 65280, 65536)


@pytest.mark.parametrize("S", WIDTHS)
def test_wide_plan(S):
    """GRAY8 fields of width S (S smoothed columns): up to 8192 K1's plan;
    above, k blocks of at most 8184 columns, halos included, each halo
    within the adjacent block, the cluster route up to 8 blocks."""
    spec = _spec("GRAY8")
    stride = buffer_stride_elems(S, 1)
    for bufH in (4, 540):
        fp = dk.wide_plan(S, bufH, stride, spec, dk.H100_SMEM)
        if S <= dk.MAX_COLS:
            assert (fp.k, fp.W_loc) == (1, S)
            assert fp.plan == dk.launch_plan(S, S, 1, dk.H100_SMEM)
            continue
        assert fp.k > 1 and fp.width >= S and fp.width % fp.k == 0
        plan = fp.plan
        assert plan.H <= fp.W_loc
        assert sk.block_width(fp.k, fp.W_loc, plan.H) <= sk.MAX_BLOCK
        assert plan.cluster == (fp.k <= sk.MAX_CLUSTER)
        assert plan.launches == (1 if plan.cluster else -(-(bufH - 1) // plan.R))
        # the least such k
        assert not any(fp.width % j == 0 and
                       sk.block_width(j, fp.width // j, 3 * sk.CLUSTER_ROWS) <= sk.MAX_BLOCK
                       for j in range(2, fp.k))


@pytest.mark.parametrize("S", WIDTHS + (65600,))
def test_walk_plan(S):
    """The pool walk: one block up to 8192 columns; above, k blocks that
    cover S, each within one block's columns with its halos, each halo
    within the adjacent shard, R <= D + 1 for every build."""
    plan = pk.walk_plan(S, 539)
    if S <= dk.MAX_COLS:
        assert (plan.k, plan.cluster, plan.launches) == (1, False, 1)
        assert (plan.cols, plan.threads) == dk.launch_shape(S)
        return
    k, W_loc, H = plan.k, plan.W_loc, plan.H
    assert k > 1 and (k - 1) * W_loc < S <= k * W_loc
    assert H == 3 * plan.R and plan.R == pk.WIDE_ROWS <= 3  # R <= D + 1, D >= 2
    last = S - (k - 1) * W_loc
    assert H <= last <= W_loc
    assert W_loc + min(k - 1, 2) * H <= dk.MAX_COLS
    assert (plan.cols, plan.threads) == dk.launch_shape(W_loc + min(k - 1, 2) * H)
    assert plan.cluster == (k <= sk.MAX_CLUSTER)
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
    ("GRAY8", False, 1, 9, 65600, 0, None),  # 10 blocks: the chunk route
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
    fp = dk._card_plan(w, bufH, stride, spec, cuda)
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
@pytest.mark.parametrize("fname,w,h,kw", API_CASES, ids=str)
def test_sangnom2_wide_on_card(cuda, fname, w, h, kw):
    """The filter surface on the card past one block equals opt=0."""
    planes = _planes(fname, w, h, 2, w + h)
    clip = T.Clip.from_numpy(planes, fname, device=cuda, parity=np.array([True, False]))
    _equal(T.sangnom2(clip, **kw).planes, T.sangnom2(clip, opt=0, **kw).planes)
    _equal(T.sangnom2(clip, pool_compat=True, **kw).planes,
           T.sangnom2(clip, pool_compat=True, opt=0, **kw).planes, "pool_compat")


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
