"""The port's width-sharded kernels K4 and K5 (sangnom_tpu_torch.parallel.
fused_smooth) against its scan arm, and their halo-exchange counts.

On the CPU each wrapper runs its plain version.  Those are held bit for bit
(float too) against the scan arm (parallel.width_sharded, a 3-column halo
exchange per row around the shared ``smooth_scan``) over chunk sizes, shard
counts 1-8 (thin shards included), the three weave modes and the formats,
and the exchanges are counted against their formulas: one kept exchange
plus ceil(n_tot / R) carry exchanges per plane pass for K4, bufH-1 row
exchanges plus one kept exchange for the scan.  The kernels' launch
geometry (``shard_kernel.full_plan`` / ``smooth_plan``: cluster or chunk
route, halo, shared bytes, launches) is checked here too, and the chunked
route's plain stages against the route.

The ``cuda`` cases launch the CUDA kernels and hold each against its plain
version on the same CUDA tensors; they skip without a card.  This module
imports neither JAX nor the test conftest, so on a machine with a card and
no JAX they run with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_shard_kernel.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import (  # noqa: E402
    aaf_as_pixel,
    scaled_aa_thresholds,
)
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402
from sangnom_tpu_torch.ops import launch_geometry as geo  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.ops.sangnom import weave_assemble  # noqa: E402
from sangnom_tpu_torch.parallel import fused_smooth as fs  # noqa: E402
from sangnom_tpu_torch.parallel import shard_kernel as sk  # noqa: E402
from sangnom_tpu_torch.parallel import width_sharded as ws  # noqa: E402

FORMATS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False),
           ("YUV420P10", True), ("GRAYS", False)]
# (shards, columns per shard, true width short of the padded width by)
K4_GEOMS = [(1, 40, 0), (2, 20, 3), (3, 9, 0), (4, 12, 7), (8, 9, 2)]
K5_GEOMS = [(1, 30), (2, 7), (3, 20), (4, 8), (8, 12)]
WEAVES = [None, 0, 1, "pf"]


def _rand(rng, shape, fmt):
    """Full-range samples, out-of-nominal codes included for >8-bit formats
    (the same distribution as tests/conftest.make_plane)."""
    if fmt.is_float:
        return (rng.random(shape, dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)


def _setup(fmt_name, sse2, seed):
    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    return fmt, spec, aaf, np.random.default_rng(seed)


def _kept(rng, fmt, N, bufH, S, short, device="cpu"):
    """[N, bufH, S] kept fields whose true width S - short is edge-padded, as
    parallel.sharding pads a plane."""
    k = _rand(rng, (N, bufH, S - short), fmt)
    k = np.concatenate([k, np.repeat(k[:, :, -1:], short, axis=2)], axis=2)
    return torch.from_numpy(np.ascontiguousarray(k)).to(device)


def _offsets(weave, N, rng, device="cpu"):
    if weave == "pf":
        return torch.from_numpy(rng.integers(0, 2, N).astype(np.int32)).to(device)
    return weave


def _scan(kept, offsets, aaf, spec, n, plane_width):
    interp = ws.interpolate_field_width_sharded(kept, aaf, spec, n, plane_width,
                                                smooth="scan")
    return interp if offsets is None else weave_assemble(kept, interp, offsets)


def _k4(kept, offsets, aaf, spec, n, plane_width, chunk_rows, plain):
    if offsets is None:
        fn = fs.interpolate_fused_full_plain if plain else fs.interpolate_fused_full
        return fn(kept, aaf, spec, n, plane_width, chunk_rows)
    fn = fs.deinterlace_fused_full_plain if plain else fs.deinterlace_fused_full
    return fn(kept, offsets, aaf, spec, n, plane_width, chunk_rows)


def _raw(rng, spec, n, C, bufH, w, device="cpu"):
    """Random raw maps [n, C, bufH+1, w] with zero boundary rows."""
    if spec.is_float:
        r = rng.random((n, C, bufH + 1, w), dtype=np.float32) * 300
    else:
        r = rng.integers(0, spec.mask + 1, (n, C, bufH + 1, w)).astype(np.int32)
    r[:, :, [0, bufH]] = 0
    return torch.from_numpy(r).to(device)


# --- on the CPU ------------------------------------------------------------

@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", K4_GEOMS, ids=str)
@pytest.mark.parametrize("chunk_rows", [1, 5, 16])
def test_k4_plain_matches_scan(fmt_name, sse2, geom, chunk_rows):
    """K4's plain version == the scan arm (then weave_assemble), with no
    weave and weave offsets 0 / 1 / per frame."""
    n, w_loc, short = geom
    fmt, spec, aaf, rng = _setup(fmt_name, sse2, n * 100 + w_loc)
    S = n * w_loc
    kept = _kept(rng, fmt, 3, 7, S, short)
    pw = S - short if short else None
    for weave in WEAVES:
        offs = _offsets(weave, 3, rng)
        want = _scan(kept, offs, aaf, spec, n, pw)
        got = _k4(kept, offs, aaf, spec, n, pw, chunk_rows, plain=True)
        assert got.dtype == kept.dtype and got.shape == want.shape
        assert torch.equal(got, want), (weave, (got.double() - want.double()).abs().max())


@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", K5_GEOMS, ids=str)
@pytest.mark.parametrize("chunk_rows", [1, 5, 16])
def test_k5_plain_matches_scan(fmt_name, sse2, geom, chunk_rows):
    """K5's plain version == the scan arm's smoothing on the same raw maps."""
    n, w_loc = geom
    _, spec, _, rng = _setup(fmt_name, sse2, n * 10 + w_loc)
    raw = _raw(rng, spec, n, 4, 9, w_loc)
    want = ws.smooth_sharded_scan(raw, spec)
    got = fs.smooth_sharded_chunked(raw, spec, chunk_rows)
    assert torch.equal(got, want)


def test_cpu_wrappers_do_not_launch():
    fmt, spec, aaf, rng = _setup("GRAY8", False, 1)
    kept = _kept(rng, fmt, 2, 6, 40, 0)
    before = dict(sk.LAUNCHES)
    fs.deinterlace_fused_full(kept, 0, aaf, spec, 2)
    fs.interpolate_fused_full(kept, aaf, spec, 2)
    fs.smooth_sharded_chunked(_raw(rng, spec, 2, 3, 6, 20), spec)
    assert sk.LAUNCHES == before
    sk.reset_launches()
    assert set(sk.LAUNCHES.values()) == {0}


def _exchanges(fn):
    ws.reset_exchanges()
    fn()
    return dict(ws.HALO_EXCHANGES)


@pytest.mark.parametrize("bufH,w_loc,chunk_rows", [(7, 20, 16), (16, 32, 16),
                                                   (16, 12, 5), (9, 9, 1)])
def test_halo_exchange_counts(bufH, w_loc, chunk_rows):
    """One kept exchange per plane pass, plus one carry exchange per chunk
    (K4: ceil(n_tot / R), n_tot = bufH with the weave, bufH-1 without; K5
    adds the raw maps' exchange, ceil((bufH-1) / R) chunks); the scan one
    row exchange per row."""
    fmt, spec, aaf, rng = _setup("GRAY8", False, 2)
    n = 2
    kept = _kept(rng, fmt, 2, bufH, n * w_loc, 0)
    for weave, n_tot in ((0, bufH), ("pf", bufH), (None, bufH - 1)):
        R = fs.chunk_geometry_k4(w_loc, n_tot, chunk_rows)[0]
        offs = _offsets(weave, 2, rng)
        got = _exchanges(lambda: _k4(kept, offs, aaf, spec, n, None, chunk_rows, True))
        assert got == {"kept": 1, "carry": math.ceil(n_tot / R), "row": 0}, weave
    got = _exchanges(lambda: ws.interpolate_field_width_sharded(kept, aaf, spec, n))
    assert got == {"kept": 1, "carry": 0, "row": bufH - 1}
    R5 = fs.chunk_geometry_k5(w_loc, bufH - 1)[0]
    got = _exchanges(lambda: ws.interpolate_field_width_sharded(
        kept, aaf, spec, n, smooth="chunked"))
    assert got == {"kept": 2, "carry": math.ceil((bufH - 1) / R5), "row": 0}


def _bad_calls():
    spec = KernelSpec.from_format(get_format("GRAY8"))
    kept = torch.zeros((2, 6, 40), dtype=torch.uint8)
    raw = torch.zeros((2, 9, 7, 20), dtype=torch.int32)
    return [
        ("kept must be", lambda: fs.interpolate_fused_full(kept.to(torch.uint16), 62, spec, 2)),
        ("contiguous", lambda: fs.interpolate_fused_full(
            kept.transpose(1, 2).contiguous().transpose(1, 2), 62, spec, 2)),
        ("at least 9 columns", lambda: fs.interpolate_fused_full(kept, 62, spec, 5)),
        ("at least 2 kept rows", lambda: fs.interpolate_fused_full(kept[:, :1].contiguous(), 62, spec, 2)),
        ("offset 2", lambda: fs.deinterlace_fused_full(kept, 2, 62, spec, 2)),
        ("offsets \\(3,\\)", lambda: fs.deinterlace_fused_full(
            kept, torch.zeros(3, dtype=torch.int32), 62, spec, 2)),
        ("raw must be", lambda: fs.smooth_sharded_chunked(raw.float(), spec)),
        ("wider than 6", lambda: fs.smooth_sharded_chunked(raw[..., :6], spec)),
    ]


@pytest.mark.parametrize("k", range(len(_bad_calls())))
def test_wrappers_refuse_bad_input(k):
    match, call = _bad_calls()[k]
    with pytest.raises(ValueError, match=match):
        call()


# --- launch geometry -----------------------------------------------------------

@pytest.mark.parametrize("W_c,cols,threads", [(9, 1, 32), (56, 1, 64), (64, 1, 96),
                                              (65, 4, 32), (504, 4, 128), (576, 4, 160),
                                              (2040, 4, 512), (2041, 8, 288),
                                              (8184, 8, 1024)])
def test_shard_shape(W_c, cols, threads):
    """Whole groups of ``cols`` columns, plus 8 / cols threads for the 8
    pad columns, in whole warps."""
    assert sk.shard_shape(W_c) == (cols, threads)
    assert -(-W_c // cols) + 8 // cols <= threads <= (512 if cols < 8 else 1024)


def test_shard_shape_refuses_too_wide():
    with pytest.raises(ValueError, match="at most 8184"):
        sk.shard_shape(8185)


@pytest.mark.parametrize("n,W_loc,steps,chunk_rows,want", [
    (4, 480, 539, 16, (16, 48)), (4, 480, 539, 4, (4, 12)), (4, 247, 269, 1, (1, 3)),
    (8, 9, 20, 16, (3, 9)), (2, 40, 2, 16, (2, 6)), (1, 1920, 539, 16, (16, 0)),
    (4, 480, 539, None, (sk.CLUSTER_ROWS, 3 * sk.CLUSTER_ROWS))])
def test_cluster_rows(n, W_loc, steps, chunk_rows, want):
    """R = min(chunk_rows, rows, W_loc // 3), CLUSTER_ROWS for None; the
    halo 3R <= W_loc, none for one shard."""
    R, H = sk.cluster_rows(n, W_loc, steps, chunk_rows)
    assert (R, H) == want and H <= W_loc


@pytest.mark.parametrize("n", [1, 2, 4, 8, 9, 12])
def test_full_plan_route_and_launches(n):
    """Up to MAX_CLUSTER shards: the cluster route, one launch a pass; above
    it the chunk route, ceil((bufH-1) / R) launches; the shared bytes are the
    route's buffers plus the cluster exchange's 2 x 2 x 9 x H words."""
    W_loc, bufH = 12, 17
    plan = sk.full_plan(n, W_loc, bufH, 1, 227 * 1024, chunk_rows=5)
    R, H = sk.cluster_rows(n, W_loc, bufH - 1, 5)
    assert (plan.R, plan.H) == (R, H) == (4, 12 if n > 1 else 0)
    assert plan.cluster == (n <= geo.MAX_CLUSTER)
    assert plan.launches == (1 if n <= geo.MAX_CLUSTER else math.ceil((bufH - 1) / R))
    W_c = W_loc + min(n - 1, 2) * H
    assert W_c == geo.block_width(n, W_loc, H)
    assert (plan.cols, plan.threads) == sk.shard_shape(W_c)
    assert plan.pitch_b >= W_c + plan.cols + 8 and plan.pitch_b % 4 == 0
    assert plan.pitch_r >= W_c + plan.cols + 8 and plan.pitch_r % 16 == 0
    xb = 2 * 2 * 9 * H * 4 if plan.cluster else 0
    assert plan.route == "double"
    assert plan.smem_bytes == (2 * 9 * plan.pitch_b * 4 + 9 * plan.pitch_p
                               + 5 * plan.pitch_r + xb)


def test_full_plan_falls_back_by_shared_memory():
    """The 1x4 1080 luma pass fits the one-barrier route; narrower limits
    take one smoothing row, then device-memory rows; too little raises."""
    plan = sk.full_plan(4, 480, 540, 1, 227 * 1024)
    assert (plan.route, plan.cluster, plan.launches) == ("double", True, 1)
    assert plan.smem_bytes < 227 * 1024 // 4  # room for four blocks a SM
    single = sk.full_plan(4, 480, 540, 1, plan.smem_bytes - 1)
    assert single.route == "single"
    glob = sk.full_plan(4, 480, 540, 1, single.smem_bytes - 1)
    assert glob.route == "global" and glob.smem_bytes < single.smem_bytes
    with pytest.raises(ValueError, match="exceeds shared memory"):
        sk.full_plan(4, 480, 540, 1, 100)


@pytest.mark.parametrize("n", [1, 4, 8, 10])
def test_smooth_plan(n):
    plan = sk.smooth_plan(n, 30, 13, 227 * 1024, chunk_rows=5)
    R, H = sk.cluster_rows(n, 30, 12, 5)
    W_c = geo.block_width(n, 30, H)
    assert (plan.R, plan.H, plan.cols) == (R, H, sk.shard_shape(W_c)[0])
    assert plan.launches == (1 if n <= geo.MAX_CLUSTER else math.ceil(12 / R))
    assert plan.smem_bytes == 2 * plan.pitch_b * 4 + (16 * H if plan.cluster else 0)
    with pytest.raises(ValueError, match="exceeds shared memory"):
        sk.smooth_plan(n, 30, 13, 64)


def test_unschedulable_cluster_raises():
    """The launchers' "no cluster fits" code raises; it never reroutes."""
    with pytest.raises(RuntimeError, match="a cluster of 4 blocks cannot be scheduled"):
        cl.check(cl.NO_CLUSTER, "sharded fused kernel launch", 4)


@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("n,w_loc,short", [(1, 30, 0), (2, 20, 3), (4, 8, 5)])
def test_chunked_route_stages_match_route(fmt_name, sse2, n, w_loc, short):
    """The chunked route's plain stages (prepare twin, full-width smoothing,
    finalize twin) == the CPU route and the scan arm."""
    fmt, spec, aaf, rng = _setup(fmt_name, sse2, n * 7 + w_loc)
    S = n * w_loc
    kept = _kept(rng, fmt, 3, 9, S, short)
    pw = S - short if short else None
    want = ws.interpolate_field_width_sharded(kept, aaf, spec, n, pw, smooth="scan")
    got = ws.interpolate_field_width_sharded(kept, aaf, spec, n, pw, smooth="chunked")
    assert torch.equal(got, want)
    for chunk_rows in (1, 16):
        assert torch.equal(fs.interpolate_chunked_plain(kept, aaf, spec, n, pw, chunk_rows),
                           want)
    raw = ws.prepare_chunked_plain(kept, spec, n, pw)
    assert raw.shape == (9, 3, 10, S) and raw.dtype == spec.acc_dtype
    assert not raw[:, :, [0, 9]].any()
    if short:
        assert not raw[..., S - short:].any()


@pytest.mark.parametrize("n,w_loc", K5_GEOMS, ids=str)
def test_smooth_full_width_matches_shards(n, w_loc):
    _, spec, _, rng = _setup("GRAY16", False, n + w_loc)
    raw = _raw(rng, spec, n, 4, 9, w_loc)
    want = fs.smooth_sharded_chunked(raw, spec, 5)
    got = fs.smooth_full_width(ws._unshard(raw), spec, n, 5)
    assert torch.equal(ws._shards(got, n), want)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", K4_GEOMS, ids=str)
def test_k4_kernel_matches_plain_on_card(cuda, fmt_name, sse2, geom):
    """K4 against its plain version on the same CUDA tensors: every weave
    mode, chunk sizes 1 / 5 / 16, bit-equal."""
    n, w_loc, short = geom
    fmt, spec, aaf, rng = _setup(fmt_name, sse2, n * 100 + w_loc)
    S = n * w_loc
    kept = _kept(rng, fmt, 5, 13, S, short, cuda)
    pw = S - short if short else None
    for chunk_rows in (1, 5, 16):
        for weave in WEAVES:
            offs = _offsets(weave, 5, rng, cuda)
            before = sk.LAUNCHES["full"]
            got = _k4(kept, offs, aaf, spec, n, pw, chunk_rows, plain=False)
            want = _k4(kept, offs, aaf, spec, n, pw, chunk_rows, plain=True)
            torch.cuda.synchronize()
            assert sk.LAUNCHES["full"] > before
            assert torch.equal(got, want), (chunk_rows, weave)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", K5_GEOMS, ids=str)
def test_k5_kernel_matches_plain_on_card(cuda, fmt_name, sse2, geom):
    n, w_loc = geom
    _, spec, _, rng = _setup(fmt_name, sse2, n * 10 + w_loc)
    raw = _raw(rng, spec, n, 18, 13, w_loc, cuda)
    for chunk_rows in (1, 5, 16):
        before = sk.LAUNCHES["smooth"]
        got = fs.smooth_sharded_chunked(raw, spec, chunk_rows)
        want = fs.smooth_sharded_chunked_plain(raw, spec, chunk_rows)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["smooth"] > before
        assert torch.equal(got, want), chunk_rows


@pytest.mark.cuda
def test_sharded_entry_point_on_card(cuda):
    """sangnom2_sharded on a 1x4 mesh of the card, through K4 and K5, equals
    the single-device kernel path."""
    import sangnom_tpu_torch as T
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded

    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, (4, h, w)).astype(np.uint8)
              for h, w in ((32, 128), (16, 64), (16, 64))]
    clip = T.Clip.from_numpy(planes, "YUV420P8", device=cuda,
                             parity=np.array([True, False, True, False]))
    mesh = default_mesh(1, 4, devices=["cuda:0"] * 4)
    for kw in (dict(order=1, dh=True), dict(order=0)):
        want = T.sangnom2(clip, **kw)
        for smooth in ("fused", "chunked"):
            got = sangnom2_sharded(clip, mesh, space_axis="space", smooth=smooth, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got.planes, want.planes)), (kw, smooth)


# Card geometries beyond K4_GEOMS: 4- and 8-column blocks, and mesh rows
# above the cluster limit (the chunk route).
K4_CARD_GEOMS = [(2, 300, 11), (4, 70, 0), (1, 2100, 5), (9, 12, 1), (12, 9, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", K4_CARD_GEOMS, ids=str)
def test_k4_routes_on_card(cuda, fmt_name, sse2, geom):
    """K4 at 4- and 8-column blocks and above the cluster limit, bit-equal
    to its plain version; one launch a pass on the cluster route, ceil((bufH
    - 1) / R) on the chunk route."""
    n, w_loc, short = geom
    fmt, spec, aaf, rng = _setup(fmt_name, sse2, n * 100 + w_loc)
    S = n * w_loc
    bufH = 11
    kept = _kept(rng, fmt, 3, bufH, S, short, cuda)
    pw = S - short if short else None
    for chunk_rows in (1, 5, 16):
        plan = sk.full_plan(n, w_loc, bufH, kept.element_size(), 227 * 1024, chunk_rows)
        for weave in WEAVES:
            offs = _offsets(weave, 3, rng, cuda)
            before = sk.LAUNCHES["full"]
            got = _k4(kept, offs, aaf, spec, n, pw, chunk_rows, plain=False)
            torch.cuda.synchronize()
            assert sk.LAUNCHES["full"] - before == plan.launches
            want = _k4(kept, offs, aaf, spec, n, pw, chunk_rows, plain=True)
            assert torch.equal(got, want), (chunk_rows, weave)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", [(2, 300), (4, 70), (10, 12), (1, 2100)], ids=str)
def test_k5_routes_on_card(cuda, fmt_name, sse2, geom):
    """K5 on the whole plane at 4- and 8-column blocks and above the
    cluster limit, bit-equal to the plain chunk loop."""
    n, w_loc = geom
    _, spec, _, rng = _setup(fmt_name, sse2, n * 10 + w_loc)
    raw = _raw(rng, spec, n, 5, 12, w_loc)
    full = ws._unshard(raw).contiguous().to(cuda)
    for chunk_rows in (1, 5, 16):
        plan = sk.smooth_plan(n, w_loc, 12, 227 * 1024, chunk_rows)
        before = sk.LAUNCHES["smooth"]
        got = fs.smooth_full_width(full, spec, n, chunk_rows)
        torch.cuda.synchronize()
        assert sk.LAUNCHES["smooth"] - before == plan.launches
        want = ws._unshard(fs.smooth_sharded_chunked_plain(raw, spec, chunk_rows))
        assert torch.equal(got.cpu(), want), chunk_rows


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", FORMATS, ids=str)
@pytest.mark.parametrize("geom", [(1, 30, 0), (4, 12, 7), (4, 247, 27), (8, 9, 2)], ids=str)
def test_chunked_route_on_card(cuda, fmt_name, sse2, geom):
    """The prepare and finalize kernels against their plain twins, and the
    route (prepare, K5, finalize: one launch each) against its plain
    version, with no weave and weave offsets 0 / 1 / per frame."""
    n, w_loc, short = geom
    fmt, spec, aaf, rng = _setup(fmt_name, sse2, n * 3 + w_loc)
    S = n * w_loc
    kept = _kept(rng, fmt, 4, 10, S, short, cuda)
    pw = S - short if short else None
    raw = sk.prepare(kept, spec, S - short)
    torch.cuda.synchronize()
    assert torch.equal(raw, ws.prepare_chunked_plain(kept, spec, n, pw))
    sm = (torch.rand((9, 4, 9, S), device=cuda) * 600).to(spec.acc_dtype)
    assert torch.equal(sk.finalize(kept, sm, aaf, spec),
                       ws.finalize_chunked_plain(kept, sm, aaf, spec, n))
    for weave in WEAVES:
        offs = _offsets(weave, 4, rng, cuda)
        sk.reset_launches()
        if offs is None:
            got = fs.interpolate_chunked(kept, aaf, spec, n, pw)
            want = fs.interpolate_chunked_plain(kept, aaf, spec, n, pw)
        else:
            got = fs.deinterlace_chunked(kept, offs, aaf, spec, n, pw)
            want = fs.deinterlace_chunked_plain(kept, offs, aaf, spec, n, pw)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == {"full": 0, "smooth": 1, "prepare": 1, "finalize": 1}
        assert torch.equal(got, want), weave


@pytest.mark.cuda
def test_unschedulable_cluster_raises_on_card(cuda, monkeypatch):
    """A cluster of 12 blocks (past the portable 8) is refused: a launch
    handed that plan raises, and the call raises at its plan
    (`shard_kernel.pass_plan` asks the card before any launch) instead of
    taking another route."""
    fmt, spec, aaf, rng = _setup("GRAY8", False, 3)
    kept = _kept(rng, fmt, 2, 8, 12 * 9, 0, cuda)
    monkeypatch.setattr(sk, "MAX_CLUSTER", 32)
    planned = sk.full_plan(12, 9, 8, 1, cl.max_smem_bytes(cuda))
    assert planned.cluster
    with pytest.raises(RuntimeError, match="sharded fused kernel launch"):
        sk.full_pass(kept, None, aaf, spec, 12, 12 * 9, planned)
        torch.cuda.synchronize()
    before = sk.LAUNCHES["full"]
    with pytest.raises(RuntimeError, match="cluster"):
        fs.interpolate_fused_full(kept, aaf, spec, 12)
        torch.cuda.synchronize()
    assert sk.LAUNCHES["full"] == before
