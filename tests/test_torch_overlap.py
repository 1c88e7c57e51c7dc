"""A call's two plane passes on two CUDA streams (ops/sangnom.sangnom2_impl,
deint_kernel.overlap_uv): where the luma walk leaves enough SMs idle,
the batched U+V pass runs on a second stream of the calling thread beside
it.  On the CPU: the decision, a pure function of the two passes' plans
(``deint_kernel.field_plan``, the plans their launches run) and the card's
figures, and the dispatch's closures run in turn with the same
bits.  The ``cuda`` cases hold the two-stream call against the same call on
one stream on the card.  This module imports neither JAX nor the test
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_overlap.py
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import buffer_stride_elems  # noqa: E402
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
from sangnom_tpu_torch.ops import sangnom as ops_sangnom  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.parallel import shard_kernel as sk  # noqa: E402
from sangnom_tpu_torch.utils import profiling as pr  # noqa: E402

# The card's figures as the decision takes them: an H100 SXM's 132 SMs,
# 232448 bytes of shared memory a block and 233472 a SM.
CARD = cl.Card(132, 232448, 233472)
CUDA0 = torch.device("cuda", 0)

# fmt, luma [N, H, W], U [N, H, W], dh, interlaced
MAA = ("YUV420P8", (24, 2160, 3840), (24, 1080, 1920), False, False)
BOB = ("YUV420P8", (60, 1080, 1920), (60, 540, 960), True, True)
BOB10 = ("YUV422P10", (60, 1080, 1920), (60, 1080, 960), True, True)


def _bob(frames, fname="YUV420P8"):
    """A bob call of ``frames`` 1080i frames (the CLI's windows, the hosts'
    batches)."""
    chroma_h = 540 if fname == "YUV420P8" else 1080
    return (fname, (frames, 1080, 1920), (frames, chroma_h, 960), True, True)


def _decide(case, devices=(CUDA0,) * 3, kernel=True, plane_widths=None, uv=True):
    fname, luma, chroma, dh, interlaced = case
    fmt = get_format(fname)
    return dk.overlap_uv(
        (luma, chroma if uv else None), list(devices), dh=dh, interlaced=interlaced,
        stride=buffer_stride_elems(luma[2], (fmt.bits + 7) // 8),
        spec=KernelSpec.from_format(fmt), kernel=kernel, plane_widths=plane_widths,
        card=CARD)


DECISIONS = [
    # the 2160p maa pass: K4's 96 luma blocks leave 36 SMs, which hold 36
    # of the 48 one-SM U+V blocks of K1
    ("maa2160p", dict(case=MAA), True),
    # the bobs: K1's 120 luma blocks leave 12 SMs, 24 of 240 U+V blocks
    ("bob1080i", dict(case=BOB), False),
    ("bob1080i_422p10", dict(case=BOB10), False),
    # a short bob: 2N luma blocks of K1 leave 132 - 2N SMs, two U+V blocks
    # of 87712 bytes each, so up to 44 frames they hold half of the 4N
    ("bob1080i_window8", dict(case=_bob(8)), True),
    ("bob1080i_1frame", dict(case=_bob(1)), True),
    ("bob1080i_44frames", dict(case=_bob(44)), True),
    ("bob1080i_45frames", dict(case=_bob(45)), False),
    ("bob1080i_422p10_window8", dict(case=_bob(8, "YUV422P10")), True),
    # one pass (luma only, chroma=False): nothing to overlap
    ("single_pass", dict(case=MAA, uv=False), False),
    ("cpu_tensor", dict(case=MAA, devices=(torch.device("cpu"),) * 3), False),
    ("plane_widths", dict(case=MAA, plane_widths=(3840, 1920, 1920)), False),
    ("plain_path", dict(case=MAA, kernel=False), False),
    ("two_devices", dict(case=MAA, devices=(CUDA0, torch.device("cuda", 1), CUDA0)), False),
]


@pytest.mark.parametrize("name,kw,want", DECISIONS, ids=[d[0] for d in DECISIONS])
def test_overlap_decision(name, kw, want):
    """The second stream engages for the maa pass's plans and the 1080
    bobs of up to 44 frames a call, and stays off for the bob cells' 60
    frames, a single pass, a CPU tensor, the width-sharded path, the plain
    path and split devices."""
    assert _decide(**kw) is want


def test_overlap_rule_counts_free_sms():
    """The rule on the maa pass's two plans as `field_plan` makes them for
    the launch: K4's 96 luma blocks ask for more than half a SM's shared
    memory (115713 bytes, `shard_kernel.one_wave_smem` over the plan's
    91232, which a pass of more blocks than SMs keeps), so they take 96
    SMs; 132 - 96 = 36 free SMs, one K1 U+V block of 174496 bytes a SM,
    36 >= 48 / 2.  Off: a leader whose blocks could share a SM (K4's own
    91232 bytes), 110 luma blocks (22 free SMs, under half of the 48), or
    more blocks than SMs."""
    spec = KernelSpec.from_format(get_format("YUV420P8"))
    stride = buffer_stride_elems(3840, 1)
    luma = dk.field_plan(24, 3840, 1080, stride, spec, CARD)
    uv = dk.field_plan(48, 1920, 540, stride, spec, CARD)
    assert (luma.k, luma.blocks, luma.smem_bytes) == (4, 96, 115713)
    assert (uv.k, uv.blocks, uv.smem_bytes) == (1, 48, 174496)
    assert dk.field_plan(34, 3840, 1080, stride, spec, CARD).smem_bytes == 91232
    assert 2 * (luma.smem_bytes + 1024) > CARD.smem_sm >= 2 * (91232 + 1024)
    assert sk.one_wave_smem(133, 91232, CARD) == 91232
    shared = luma._replace(plan=luma.plan._replace(smem_bytes=91232))
    assert dk.blocks_per_sm(uv, CARD) == 1
    assert dk.blocks_per_sm(luma, CARD) == 1
    assert dk.blocks_per_sm(shared, CARD) == 2
    assert dk.overlap_rule(luma, uv, CARD)
    assert not dk.overlap_rule(shared, uv, CARD)
    assert not dk.overlap_rule(luma._replace(blocks=110), uv, CARD)
    assert not dk.overlap_rule(luma._replace(blocks=140), uv, CARD)


def _clip(fname, w, h, n, seed, device="cpu"):
    fmt = get_format(fname)
    rng = np.random.default_rng(seed)
    hi = (1 << fmt.bits) - 1
    dtype = np.uint8 if fmt.bits <= 8 else np.uint16
    planes = [rng.integers(0, hi + 1, (n, h, w), dtype=dtype)]
    for _ in range(2):
        planes.append(rng.integers(0, hi + 1, (n, h >> fmt.subsampling_h,
                                                w >> fmt.subsampling_w), dtype=dtype))
    return T.Clip.from_numpy(planes, fname, device=device,
                             parity=np.arange(n) % 2 == 0)


def _equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g.cpu(), w.cpu()), f"plane {i}"


@pytest.mark.parametrize("kw", [dict(order=1), dict(order=2, dh=True), dict(order=0)],
                         ids=["order1", "dh", "order0"])
def test_engaged_dispatch_gives_the_same_planes(monkeypatch, kw):
    """The engaged dispatch's closures (luma on the caller's stream, U+V
    on the side) run here in turn and give the one-stream call's planes;
    the luma pass calls its hook once its kept rows are issued; the side
    pass's span carries ``stream="side"`` and counts one
    ``overlap_passes``."""
    clip = _clip("YUV420P8", 64, 16, 3, 5)
    want = T.sangnom2(clip, **kw).planes
    order = []

    def beside(device, first, second):
        order.append("first")
        first(lambda: order.append("kept"))
        order.append("second")
        second()

    monkeypatch.setattr(dk, "overlap_uv", lambda *a, **k: True)
    monkeypatch.setattr(ops_sangnom, "_beside", beside)
    before = pr.counters().get("overlap_passes", 0)
    with pr.tracing():
        got = T.sangnom2(clip, **kw).planes
    planes = [r.counts for r in pr.drain() if r.name == pr.PLANE]
    _equal(got, want)
    assert order == ["first", "kept", "second"]
    assert [c["plane"] for c in planes] == [0, "uv"]
    assert [c.get("stream") for c in planes] == [None, "side"]
    assert pr.counters().get("overlap_passes", 0) - before == 1
    assert planes[1].get("overlap_passes") == 1


def test_no_overlap_on_cpu_with_spans_on():
    """On the CPU a call issues every pass on one stream: ``overlap_passes``
    stays 0 with spans on, and no plane span names a stream."""
    before = pr.counters().get("overlap_passes", 0)
    with pr.tracing():
        T.sangnom2(_clip("YUV420P8", 64, 16, 2, 7), order=1)
        T.bob(_clip("YUV420P8", 64, 16, 2, 8))
    planes = [r.counts for r in pr.drain() if r.name == pr.PLANE]
    pr.disable()
    assert len(planes) == 4
    assert all("stream" not in c for c in planes)
    assert pr.counters().get("overlap_passes", 0) == before


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def one_stream(monkeypatch):
    """Run the ``fn`` given with the passes forced onto the caller's
    stream."""
    real = dk.overlap_uv

    def run(fn):
        monkeypatch.setattr(dk, "overlap_uv", lambda *a, **k: False)
        try:
            return fn()
        finally:
            monkeypatch.setattr(dk, "overlap_uv", real)
    return run


def _engaged(fn):
    """Run ``fn`` with spans on; its result and the passes it issued on
    the second stream."""
    before = pr.counters().get("overlap_passes", 0)
    with pr.tracing():
        out = fn()
    pr.drain()
    return out, pr.counters().get("overlap_passes", 0) - before


CARD_CASES = [
    # the maa pass: 2 frames of 3840x2160 at order=1
    ("YUV420P8", 3840, 2160, "sangnom2", dict(order=1, aa=48, aac=0)),
    # dh: 3840x1080 sources doubled to 2160, luma on K4, U+V on K1
    ("YUV420P8", 3840, 1080, "sangnom2", dict(order=2, dh=True)),
    # a windowed 1080i bob, 8 frames: luma and U+V both on K1
    ("YUV420P8", 1920, 1080, "bob", dict(tff=True)),
    ("YUV422P10", 1920, 1080, "bob", dict(tff=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fname,w,h,fn,kw", CARD_CASES, ids=str)
def test_two_streams_equal_one_on_card(cuda, one_stream, fname, w, h, fn, kw):
    """An engaged call equals the same call on one stream, bit for bit,
    also issued under a caller's own stream, which alone is synchronized
    before the compare."""
    clip = _clip(fname, w, h, 8 if fn == "bob" else 2, w + h, device=cuda)
    call = getattr(T, fn)
    want = one_stream(lambda: call(clip, **kw).planes)
    torch.cuda.synchronize()
    got, passes = _engaged(lambda: call(clip, **kw).planes)
    assert passes == 1
    _equal(got, want)
    caller = torch.cuda.Stream(cuda)
    caller.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(caller):
        got, passes = _engaged(lambda: call(clip, **kw).planes)
    caller.synchronize()
    assert passes == 1
    _equal(got, want)


@pytest.mark.cuda
def test_two_streams_reuse_memory_on_card(cuda, one_stream):
    """50 engaged calls, each on a fresh copy of one of two clips, inputs
    and outputs dropped between calls, the outputs compared on the card
    without a host synchronize: the allocator's reuse of the second
    stream's memory leaves every output bit-equal."""
    kw = dict(order=1, aa=48, aac=0)
    clips = [_clip("YUV420P8", 3840, 2160, 2, s, device=cuda) for s in (1, 2)]
    wants = [one_stream(lambda c=c: T.sangnom2(c, **kw).planes) for c in clips]
    torch.cuda.synchronize()
    bad = torch.zeros((), dtype=torch.int64, device=cuda)
    before = pr.counters().get("overlap_passes", 0)
    with pr.tracing():
        for k in range(50):
            src = clips[k % 2]
            fresh = src.with_planes(tuple(p.clone() for p in src.planes))
            got = T.sangnom2(fresh, **kw).planes
            for g, w in zip(got, wants[k % 2]):
                bad += (g != w).sum()
            del fresh, got
    pr.drain()
    assert pr.counters().get("overlap_passes", 0) - before == 50
    assert int(bad) == 0


@pytest.mark.cuda
def test_two_streams_from_threads_on_card(cuda, one_stream):
    """Four host threads, each with its own second stream, call the maa
    pass at once; every output equals the one-stream call's."""
    kw = dict(order=1)
    clip = _clip("YUV420P8", 3840, 2160, 2, 9, device=cuda)
    want = one_stream(lambda: T.sangnom2(clip, **kw).planes)
    torch.cuda.synchronize()
    results, sides, errors = {}, {}, []

    def work(t):
        try:
            outs = [T.sangnom2(clip, **kw).planes for _ in range(3)]
            torch.cuda.current_stream(cuda).synchronize()
            results[t] = outs
            sides[t] = ops_sangnom._side_stream(cuda)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert not errors, errors
    assert len({id(s) for s in sides.values()}) == 4
    for outs in results.values():
        for got in outs:
            _equal(got, want)


@pytest.mark.cuda
def test_overlap_decision_on_card(cuda):
    """With the card's own figures the maa pass and a bob window of 8
    frames engage and the bob cells' 60 frames do not; the blocks a SM the
    rule counts for the maa luma pass's K4 plan, padded (24 frames) and as
    planned (34 frames, more blocks than SMs), are the card's own occupancy
    query's."""
    card = cl.card_figures(cuda)
    assert card.smem_block == cl.max_smem_bytes(cuda)
    spec = KernelSpec.from_format(get_format("YUV420P8"))
    for fields in (24, 34):
        fp = dk.field_plan(fields, 3840, 1080, buffer_stride_elems(3840, 1), spec, card)
        occ = sk.occupancy("full", spec, fp.plan, fp.k, cuda)
        assert occ["blocks_per_sm"] == dk.blocks_per_sm(fp, card)
    for case, want in ((MAA, True), (BOB, False), (BOB10, False), (_bob(8), True)):
        fname, luma, chroma, dh, interlaced = case
        fmt = get_format(fname)
        got = dk.overlap_uv(
            (luma, chroma), [cuda] * 3, dh=dh, interlaced=interlaced,
            stride=buffer_stride_elems(luma[2], (fmt.bits + 7) // 8),
            spec=KernelSpec.from_format(fmt), kernel=True)
        assert got is want, (fname, card)


@pytest.mark.cuda
def test_one_wave_k4_takes_a_sm_each_on_card(cuda):
    """A wide pass whose K4 blocks fit one a SM launches them with more
    than half a SM's shared memory; a pass of more blocks than SMs keeps
    its plan's; both equal the plain version."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds

    fmt = get_format("GRAY8")
    spec = KernelSpec.from_format(fmt)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    card = cl.card_figures(cuda)
    for fields in (24, card.sms // 4 + 8):
        kept = torch.randint(0, 256, (fields, 16, 3840), dtype=torch.uint8, device=cuda)
        with pr.tracing():
            got = dk.deinterlace_field_batch_fused(kept, 1, aaf, spec, 3840)
        torch.cuda.synchronize()
        k4 = [r.counts for r in pr.drain()
              if r.name == pr.LAUNCH and r.counts.get("kernel") == "shard_full_kernel"]
        fp = dk.field_plan(fields, 3840, 16, 3840, spec, card)
        assert len(k4) == 1 and k4[0]["blocks"] == fp.blocks == 4 * fields
        assert k4[0]["smem_bytes"] == fp.smem_bytes
        if 4 * fields <= card.sms:
            assert 2 * (fp.smem_bytes + 1024) > card.smem_sm
        else:
            assert fp.smem_bytes == sk.full_plan(4, 960, 16, 1, card.smem_block,
                                                 dk.WIDE_FIELD_ROWS).smem_bytes
        assert torch.equal(got, dk.deinterlace_field_batch_plain(kept, 1, aaf, spec, 3840))
