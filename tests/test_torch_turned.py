"""maa's turned pass: the SangNom pass of Didee's maa on the 2x supersample
of a 1080p source turned on its side, 2160 columns by 3840 rows (chroma
1080 x 1920), ``sangnom2(order=1)``.

Its luma fields are the narrowest that take the field kernel's wide route:
S = 2176 smoothed columns, the stride itself (2^7 x 17), only 128 past
``FIELD_COLS``, so K4 walks 1919 row steps a field on 4 blocks of 544
columns.  On the CPU at reduced height the main path goes through the
field kernel's wrappers, which take K4's plain version with the card's
plan; held bit for bit against the TPU package at ``opt=0`` and the
native oracle.  The full-size plans as literals, where the call's second
stream starts, the side plan that keeps the U+V blocks off K4's SMs, the
wide route's ``wide_row_steps`` counter, and on the card the K4 launch
span's counts and the side pass's shared memory:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_turned.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import (  # noqa: E402
    aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds)
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
from sangnom_tpu_torch.ops import launch_geometry as geo  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.parallel import shard_kernel as sk  # noqa: E402
from sangnom_tpu_torch.utils import profiling as pr  # noqa: E402

W, STRIDE = 2160, 2176  # the turned supersample's luma width and its stride
PARITY = np.array([True, False])


@pytest.fixture(autouse=True)
def spans_off():
    pr.disable()
    pr.drain()
    yield
    pr.disable()
    pr.drain()


@pytest.fixture
def wide_route(monkeypatch):
    """The main path on the CPU through the field kernel's wrappers, routed
    by each pass's `field_plan` as on the card; records (k, padded width,
    cropped width) of each pass that took K4's plain version."""
    from sangnom_tpu_torch.ops import sangnom as ops
    from sangnom_tpu_torch.parallel import fused_smooth as fs

    used = []
    real = fs.fused_full_plain

    def spy(kept, aaf, spec, n_space, plane_width, *a):
        used.append((n_space, kept.shape[2], plane_width))
        return real(kept, aaf, spec, n_space, plane_width, *a)

    monkeypatch.setattr(fs, "fused_full_plain", spy)
    monkeypatch.setattr(ops, "_pick_backend", lambda opt, device: dk.interpolate_field_batch)
    return used


def _planes(w, h, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n, h >> s, w >> s), dtype=np.uint8) for s in (0, 1, 1)]


def _spec(fname="YUV420P8"):
    return KernelSpec.from_format(get_format(fname))


@pytest.mark.parametrize("aa", [48, 0])
@pytest.mark.parametrize("h", [32, 40])
def test_turned_pass_matches_jax_and_the_oracle(wide_route, h, aa):
    """2 frames of 2160 x h: the luma pass on K4's plain version at the
    card's plan (4 shards of 544 over the plane padded to the stride),
    chroma (1080 columns) on K1's; equal to the TPU package at opt=0 and to
    the native oracle."""
    pytest.importorskip("jax")
    import sangnom_tpu as J
    from sangnom_tpu_torch.oracle import sangnom2_clip_oracle

    planes = _planes(W, h, seed=h + aa)
    kw = dict(order=1, aa=aa, aac=0)
    got = T.sangnom2(T.Clip.from_numpy(planes, "YUV420P8", device="cpu", parity=PARITY), **kw)
    assert wide_route == [(4, STRIDE, W)]
    want = J.sangnom2(J.Clip.from_numpy(planes, "YUV420P8", parity=PARITY), opt=0, **kw)
    frames = [[p[n] for p in planes] for n in range(2)]
    oracle = sangnom2_clip_oracle(frames, T.get_format("YUV420P8"), parities=list(PARITY), **kw)
    for i, (g, w) in enumerate(zip(got.planes, want.planes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"jax plane {i}")
        for n in range(2):
            np.testing.assert_array_equal(g[n].numpy(), oracle[n][i],
                                          err_msg=f"oracle frame {n} plane {i}")


def test_turned_full_size_plans():
    """The full-size call on an H100: 24 luma fields of 2160 x 1920 kept
    rows on K4, 4 blocks of 544 columns (592 with halos, 160 threads, the
    double memory route, one a SM); 48 U+V fields of 1080 x 960 on K1 at
    S 1152, two a SM, one wave on the SMs K4 leaves free: the U+V pass
    runs beside the luma pass."""
    spec = _spec()
    assert buffer_stride_elems(W, 1) == STRIDE
    luma = dk.field_plan(24, W, 1920, STRIDE, spec, cl.H100)
    assert (luma.k, luma.W_loc, luma.width, luma.blocks) == (4, 544, STRIDE, 96)
    p = luma.plan
    assert (p.R, p.H, p.threads, p.cols, p.cluster, p.launches) == (8, 24, 160, 4, True, 1)
    assert (p.route, p.smem_bytes) == ("double", 115713)
    assert geo.block_width(luma.k, luma.W_loc, p.H) == 592
    assert dk.blocks_per_sm(luma, cl.H100) == 1
    uv = dk.field_plan(48, W // 2, 960, STRIDE, spec, cl.H100)
    assert (uv.k, uv.W_loc, uv.blocks) == (1, 1152, 48)
    assert dk.blocks_per_sm(uv, cl.H100) == 2
    cuda = torch.device("cuda")
    assert dk.overlap_uv([(24, 3840, W), (24, 1920, W // 2)], [cuda] * 3, dh=False,
                         interlaced=False, stride=STRIDE, spec=spec, kernel=True,
                         card=cl.H100)


def test_wide_plan_at_the_turned_stride():
    """`test_wide_plan`'s rule at S 2176 and 1920 kept rows (fields of
    2176 and of the turned 2160 in that stride): the clamp at the stride
    is observable, so the plane pads to the stride, which k 3 does not
    divide, and k 2's blocks (1088 columns and a halo) pass ``WIDE_BLOCK``:
    the least k is 4."""
    spec = _spec("GRAY8")
    for w in (STRIDE, W):
        fp = dk.field_plan(24, w, 1920, STRIDE, spec, cl.H100)
        plan = fp.plan
        planned = sk.full_plan(fp.k, fp.W_loc, 1920, 1, cl.H100.smem_block, dk.WIDE_FIELD_ROWS)
        assert plan == planned._replace(
            smem_bytes=sk.one_wave_smem(fp.blocks, planned.smem_bytes, cl.H100))
        assert (fp.k, fp.W_loc, fp.width, fp.blocks) == (4, 544, STRIDE, 96)
        assert plan.R == dk.WIDE_FIELD_ROWS and plan.H == 3 * plan.R <= fp.W_loc
        assert (plan.cols, plan.cluster, plan.launches) == (4, True, 1)
        assert STRIDE % 3 and geo.block_width(2, STRIDE // 2, plan.H) > dk.WIDE_BLOCK
        assert geo.block_width(4, 544, plan.H) <= dk.WIDE_BLOCK


@pytest.mark.parametrize("w,steps", [(W, 2 * 15), (3840, 2 * 15), (1920, 0)], ids=str)
def test_wide_row_steps_counted_on_the_cpu(wide_route, w, steps):
    """``wide_row_steps`` adds fields x serial row steps of each pass on
    the wide route, on the CPU's plain version too (2 luma fields of 16
    kept rows at 2160 and 3840; none at 1920, which K1 takes); the counter
    lands on the luma plane's span; ``cluster_fields`` counts on the card
    only."""
    clip = T.Clip.from_numpy(_planes(w, 32), "YUV420P8", device="cpu", parity=PARITY)
    before = pr.counters()
    with pr.tracing():
        T.sangnom2(clip, order=1)
    recs = pr.drain()
    after = pr.counters()
    assert after.get("wide_row_steps", 0) - before.get("wide_row_steps", 0) == steps
    assert after.get("cluster_fields", 0) == before.get("cluster_fields", 0)
    luma = [r for r in recs if r.name == pr.PLANE and r.counts.get("plane") == 0]
    assert [r.counts.get("wide_row_steps", 0) for r in luma] == [steps]


def test_wide_row_steps_counts_nothing_with_spans_off(wide_route):
    clip = T.Clip.from_numpy(_planes(W, 32), "YUV420P8", device="cpu", parity=PARITY)
    before = pr.counters()
    T.sangnom2(clip, order=1)
    assert pr.counters() == before and pr.drain() == []


@pytest.mark.parametrize("w,want", [(W, ["pad", "ready", "kernel"]), (3840, ["ready", "kernel"]),
                                    (1920, ["ready"])], ids=str)
def test_the_side_stream_starts_once_the_luma_kernels_input_is_issued(
        wide_route, monkeypatch, w, want):
    """With the U+V pass beside the luma pass, the luma pass's hook (where
    the call's second stream starts) fires once its kernel's input is
    issued: on the wide route after the edge pad to the stride (2160 ->
    2176), just before K4 (its plain version here); at 3840 nothing is
    padded; on K1's route (1920) before its kernel.  Started before the pad,
    the U+V kernel reached the card ahead of K4 and shared its SMs."""
    from sangnom_tpu_torch.ops import sangnom as ops
    from sangnom_tpu_torch.parallel import fused_smooth as fs

    events = []
    signed, kernel = fs.signed, fs.fused_full_plain
    monkeypatch.setattr(fs, "signed", lambda t: (events.append("pad"), signed(t))[1])
    monkeypatch.setattr(fs, "fused_full_plain", lambda *a: (events.append("kernel"), kernel(*a))[1])

    def beside(device, first, second):
        first(lambda: events.append("ready"))
        events.append("second")
        second()

    monkeypatch.setattr(dk, "overlap_uv", lambda *a, **k: True)
    monkeypatch.setattr(ops, "_beside", beside)
    clip = T.Clip.from_numpy(_planes(w, 32), "YUV420P8", device="cpu", parity=PARITY)
    T.sangnom2(clip, order=1)
    luma = events[:events.index("second")]
    seen = [e for i, e in enumerate(luma) if not i or e != luma[i - 1]]
    assert seen[:seen.index("kernel") + 1 if "kernel" in seen else None] == want
    assert luma.count("ready") == 1


# K1's U+V plans beside a K4 or K1 luma pass on an H100: the turned maa's
# (S 1152, 98.6 KB), the upright's (S 2048, 174 KB) and a 1080i bob's
SIDE_CASES = [("turned", 48, W // 2, 960, STRIDE, 98592, 115712),
              ("upright", 48, 1920, 540, 3840, 174496, 174496),
              ("bob_window8", 32, 960, 270, 1920, 87712, 115712)]


@pytest.mark.parametrize("name,fields,w,bufH,stride,planned,side", SIDE_CASES,
                         ids=[c[0] for c in SIDE_CASES])
def test_side_plan_keeps_the_uv_blocks_off_the_luma_sms(name, fields, w, bufH, stride,
                                                        planned, side):
    """Beside a luma pass whose blocks take more than half a SM, a K1 pass
    asks for at least half a SM's shared memory less the reserve (115712
    bytes): no SM holds a block of each, two of its own still fit on one.
    The turned maa's U+V blocks (98.6 KB as planned) grow to it; the
    upright's (174 KB) are left as planned; K4 plans are never padded; the
    overlap decisions stand."""
    spec = _spec()
    uv = dk.field_plan(fields, w, bufH, stride, spec, cl.H100)
    if planned is not None:
        assert uv.smem_bytes == planned
    got = dk.side_plan(uv, cl.H100)
    assert got.smem_bytes == side == max(uv.smem_bytes, cl.H100.smem_sm // 2 - 1024)
    assert got._replace(plan=got.plan._replace(smem_bytes=uv.smem_bytes)) == uv
    luma = dk.field_plan(24, W, 1920, STRIDE, spec, cl.H100)
    assert dk.side_plan(luma, cl.H100) == luma
    assert luma.smem_bytes + got.smem_bytes + 2 * cl.SMEM_RESERVED > cl.H100.smem_sm
    assert dk.blocks_per_sm(got, cl.H100) == (2 if side == 115712 else 1)
    assert dk.overlap_rule(luma, uv, cl.H100)


def test_passes_inside_beside_run_on_their_side_plan():
    """Within `deint_kernel.beside` (the call's second stream) this
    thread's passes are planned on their side plan; outside it, and on
    other threads, as `field_plan` makes them."""
    import threading

    spec = _spec()
    kept = torch.zeros((48, 960, W // 2), dtype=torch.uint8)
    plain = dk.field_plan(48, W // 2, 960, STRIDE, spec, cl.H100)
    seen = {}
    with dk.beside():
        with dk.beside():
            pass
        seen["inside"] = dk._plan(kept, 48, 960, W // 2, STRIDE, spec)
        th = threading.Thread(
            target=lambda: seen.setdefault("thread", dk._plan(kept, 48, 960, W // 2, STRIDE, spec)))
        th.start()
        th.join()
    assert seen["inside"] == dk.side_plan(plain, cl.H100) != plain
    assert seen["thread"] == plain == dk._plan(kept, 48, 960, W // 2, STRIDE, spec)


@pytest.mark.cuda
def test_side_pass_launches_on_its_side_plan_on_card():
    """On the card, a turned call's U+V pass on the second stream launches
    K1 with the side plan's shared memory (half a SM less the reserve),
    which the card's own occupancy query fits two to a SM, and gives the
    bits of the same call on one stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    from sangnom_tpu_torch.ops import sangnom as ops

    cuda = torch.device("cuda")
    card = cl.card_figures(cuda)
    floor = card.smem_sm // 2 - cl.SMEM_RESERVED
    spec = _spec()
    fp = dk.field_plan(24, W, 1920, STRIDE, spec, card)
    solo = fp.plan._replace(smem_bytes=floor, cluster=False)
    assert sk.occupancy("full", spec, solo, fp.k, cuda)["blocks_per_sm"] == 2
    clip = T.Clip.from_numpy(_planes(W, 64, n=4), "YUV420P8", device=cuda,
                             parity=np.arange(4) % 2 == 0)
    real = dk.overlap_uv
    try:
        dk.overlap_uv = lambda *a, **k: False
        want = T.sangnom2(clip, order=1)
        dk.overlap_uv = lambda *a, **k: True
        with pr.tracing():
            got = T.sangnom2(clip, order=1)
        torch.cuda.synchronize()
    finally:
        dk.overlap_uv = real
    launches = [r.counts for r in pr.drain() if r.name == pr.LAUNCH]
    k1 = [c for c in launches if c.get("kernel") == "deint_kernel"]
    assert [c["smem_bytes"] for c in k1] == [floor] and ops._side_stream(cuda) is not None
    assert any(c.get("kernel") == "shard_full_kernel" for c in launches)
    for g, w in zip(got.planes, want.planes):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fname,w,bufH", [("GRAY8", W, 32), ("GRAY8", 3840, 24),
                                           ("GRAY16", W, 24)], ids=str)
def test_turned_launch_span_on_card(fname, w, bufH):
    """A wide pass's K4 launch span counts its steps, kept rows, shard and
    block columns, exchange rows, memory route and sample size; the
    counters count the pass's fields on the cluster and its row steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    fmt = get_format(fname)
    spec = _spec(fname)
    stride = buffer_stride_elems(w, fmt.component_size)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    kept = torch.randint(0, 1 << fmt.bits, (24, bufH, w), dtype=torch.int32,
                         device="cuda").to(cl.storage_dtype(spec))
    fp = dk.field_plan(24, w, bufH, stride, spec, cl.card_figures(kept.device))
    before = pr.counters()
    with pr.tracing():
        got = dk.deinterlace_field_batch_fused(kept, 1, aaf, spec, stride)
    torch.cuda.synchronize()
    (k4,) = [r.counts for r in pr.drain()
             if r.name == pr.LAUNCH and r.counts.get("kernel") == "shard_full_kernel"]
    after = pr.counters()
    assert (k4["k"], k4["cols"], k4["steps"], k4["rows"], k4["route"]) == (
        fp.k, fp.W_loc, bufH - 1, bufH, "cluster")
    assert k4["block_cols"] == geo.block_width(fp.k, fp.W_loc, fp.plan.H)
    assert (k4["exchange_rows"], k4["mem_route"]) == (fp.plan.R, fp.plan.route)
    assert k4["elem"] == kept.element_size()
    if w == W:
        assert (k4["k"], k4["cols"], k4["block_cols"]) == (4, 544, 592)
    assert after.get("cluster_fields", 0) - before.get("cluster_fields", 0) == 24
    assert after.get("wide_row_steps", 0) - before.get("wide_row_steps", 0) == 24 * (bufH - 1)
    assert torch.equal(got, dk.deinterlace_field_batch_plain(kept, 1, aaf, spec, stride))
