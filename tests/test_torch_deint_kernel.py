"""The port's kernel module (sangnom_tpu_torch.ops.deint_kernel).

On the CPU the wrappers run their plain PyTorch twin; those cases are held
bit for bit against the TPU package's Pallas kernel
(``pallas_kernel.deinterlace_field_batch_fused`` / ``interpolate_field_batch``)
run in interpret mode, as tests/test_pallas.py runs it.

The ``cuda`` cases launch the hand-written CUDA kernel and hold it bit for
bit against the plain twin on the same CUDA tensors; they skip without a
card.  This module imports neither JAX nor the test conftest at import time,
so on a machine with a card and no JAX the kernel cases run with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_deint_kernel.py
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
from sangnom_tpu_torch.ops.launch_geometry import launch_shape  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.parallel import shard_kernel as sk  # noqa: E402


def _rand(rng, shape, fmt):
    """Full-range samples, out-of-nominal codes included for >8-bit formats
    (the same distribution as tests/conftest.make_plane)."""
    if fmt.is_float:
        return (rng.random(shape, dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)


def _aaf(fmt, aa=48):
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds

    return aaf_as_pixel(scaled_aa_thresholds(aa, aa, fmt)[0], fmt)


@pytest.fixture
def jax_pallas():
    jax = pytest.importorskip("jax")
    assert jax.default_backend() == "cpu"
    from sangnom_tpu.ops import pallas_kernel

    return pallas_kernel


CPU_CASES = [
    # fmt, sse2, n_frames, kept rows, width, offset, interlaced_tff
    ("GRAY8", False, 3, 8, 40, 0, None),
    ("GRAY8", False, 3, 8, 40, 1, None),
    ("GRAY8", False, 4, 8, 33, "pf", None),
    ("GRAY8", True, 2, 12, 61, "pf", True),
    ("GRAY8", False, 2, 6, 40, "pf", False),
    ("GRAY16", False, 2, 8, 29, 0, True),
    ("YUV422P10", True, 3, 10, 40, 1, None),
    ("GRAYS", False, 2, 8, 37, "pf", True),
    ("GRAYS", False, 3, 16, 24, 1, None),
    ("GRAY8", False, 2, 32, 48, 0, None),
]


def _offsets(offset, n, seed):
    if offset != "pf":
        return offset, offset
    offs = np.random.default_rng(seed).integers(0, 2, n).astype(np.int32)
    return offs, torch.from_numpy(offs)


@pytest.mark.parametrize("case", CPU_CASES, ids=str)
def test_plain_twin_matches_pallas_weave(jax_pallas, case):
    import jax.numpy as jnp
    from sangnom_tpu.ops.primitives import KernelSpec as JaxSpec

    fmt_name, sse2, n, bufH, w, offset, tff = case
    fmt = get_format(fmt_name)
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    n_fields = n if tff is None else 2 * n
    shape = (n, bufH, w) if tff is None else (n, 2 * bufH, w)
    src = _rand(rng, shape, fmt)
    off_np, off_t = _offsets(offset, n_fields, 1)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    jspec = JaxSpec(spec.is_float, spec.mask, spec.sse2)
    stride = -(-w // 32) * 32 + 32  # a luma-derived stride wider than w
    aaf = _aaf(fmt)
    want = np.asarray(jax_pallas.deinterlace_field_batch_fused(
        jnp.asarray(src), off_np if isinstance(off_np, int) else jnp.asarray(off_np),
        aaf, jspec, stride, interlaced_tff=tff))
    got = dk.deinterlace_field_batch_fused(
        torch.from_numpy(src), off_t, aaf, spec, stride, interlaced_tff=tff)
    assert got.shape == (n_fields, 2 * bufH, w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt_name,sse2,w", [
    ("GRAY8", False, 45), ("GRAY16", True, 40), ("YUV444PS", False, 31),
], ids=str)
def test_plain_interpolate_matches_pallas(jax_pallas, fmt_name, sse2, w):
    import jax.numpy as jnp
    from sangnom_tpu.ops.primitives import KernelSpec as JaxSpec

    fmt = get_format(fmt_name)
    rng = np.random.default_rng(w)
    kept = _rand(rng, (3, 12, w), fmt)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    jspec = JaxSpec(spec.is_float, spec.mask, spec.sse2)
    stride = -(-w // 32) * 32
    want = np.asarray(jax_pallas.interpolate_field_batch(
        jnp.asarray(kept), _aaf(fmt), jspec, stride))
    got = dk.interpolate_field_batch(torch.from_numpy(kept), _aaf(fmt), spec, stride)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_do_not_launch():
    fmt = get_format("GRAY8")
    kept = torch.from_numpy(_rand(np.random.default_rng(3), (2, 6, 20), fmt))
    spec = KernelSpec.from_format(fmt)
    before = dk.LAUNCHES
    dk.deinterlace_field_batch_fused(kept, 0, 62, spec, 32)
    dk.interpolate_field_batch(kept, 62, spec, 32)
    assert dk.LAUNCHES == before


def test_launch_shape_covers_width():
    for S in (1, 5, 31, 61, 512, 513, 1023, 1024, 1920, 2048, 2049, 3840, 4096, 8192):
        cols, threads = launch_shape(S)
        assert cols == (1 if S <= 512 else 4 if S <= 2048 else 8)
        # contiguous groups t*cols .. t*cols+cols-1 cover S; no idle warp
        assert cols * threads >= S and threads % 32 == 0
        assert (threads - 32) * cols < S
        assert threads <= (1024 if cols == 8 else 512)
    with pytest.raises(ValueError, match="too wide"):
        launch_shape(8193)


LIMIT = 227 * 1024  # the H100's opt-in shared memory a block, 232448 bytes

# (S, shared-memory limit) -> route for u8, u16, f32 (w = S), or None where
# neither route fits, and the bytes of each route: 2 * buf + raw slice +
# ring, or buf + raw slice + ring.  The field kernel takes at most 2048
# smoothed columns, where the single route fits an H100 at every sample
# size; smaller limits reach the refusal.
PLAN_ROUTES = {
    (61, LIMIT): ("double", "double", "double"),
    (1024, LIMIT): ("double", "double", "double"),
    (1920, LIMIT): ("double", "double", "single"),
    (2048, LIMIT): ("double", "double", "single"),
    (2048, 128 * 1024): ("single", "single", None),
    (2048, 64 * 1024): (None, None, None),
}


@pytest.mark.parametrize("S,limit", sorted(PLAN_ROUTES), ids=str)
@pytest.mark.parametrize("elem", [1, 2, 4])
def test_launch_plan_route_and_bytes(S, limit, elem):
    route = PLAN_ROUTES[S, limit][{1: 0, 2: 1, 4: 2}[elem]]
    if route is None:
        with pytest.raises(ValueError, match="exceeds shared memory"):
            dk.launch_plan(S, S, elem, limit)
        return
    plan = dk.launch_plan(S, S, elem, limit)
    cols, threads = launch_shape(S)
    assert (plan.cols, plan.threads) == (cols, threads)
    assert plan.route == route
    # pitches: 4 left pads, the right pads, 16-byte rows
    assert plan.pitch_b >= S + cols + 8 and plan.pitch_b % 4 == 0
    assert plan.pitch_r >= S + cols + 8 and plan.pitch_r % 16 == 0
    assert plan.pitch_p >= threads * cols and plan.pitch_p % 16 == 0
    buf = 9 * plan.pitch_b * 4
    rp = 9 * plan.pitch_p * elem
    ring = 4 * plan.pitch_r * elem
    want = {"double": 2 * buf + rp + ring, "single": buf + rp + ring}[plan.route]
    assert plan.smem_bytes == want <= limit
    if plan.route != "double":  # the plan takes the first route that fits
        assert 2 * buf + rp + ring > limit


def test_launch_plan_main_path_bytes():
    # the 1080 bob's launches: luma S = 1920, U/V S = 1024 (w 960), u8
    assert dk.launch_plan(1920, 1920, 1, LIMIT) == dk.LaunchPlan(
        4, 480, "double", 164128, 1932, 1936, 1920)
    assert dk.launch_plan(960, 1024, 1, LIMIT) == dk.LaunchPlan(
        4, 256, "double", 87712, 1036, 976, 1024)
    with pytest.raises(ValueError, match="exceeds shared memory"):
        dk.launch_plan(2048, 2048, 4, 16 * 1024)
    # one block takes at most FIELD_COLS; wider fields take the wide route
    assert dk.FIELD_COLS == 2048
    with pytest.raises(ValueError, match="wide route"):
        dk.launch_plan(2049, 2049, 1, LIMIT)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


UNPADDED = (1023, 5)

CUDA_FORMATS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False),
                ("GRAY16", True), ("YUV420P10", False), ("YUV420P10", True),
                ("GRAYS", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CUDA_FORMATS, ids=str)
@pytest.mark.parametrize("offset", [0, 1, "pf"])
@pytest.mark.parametrize("tff", [None, True, False])
@pytest.mark.parametrize("w", [61, 1920, 3840, 1023, 5])
def test_kernel_matches_plain_on_card(cuda, fmt_name, sse2, offset, tff, w):
    fmt = get_format(fmt_name)
    rng = np.random.default_rng(w)
    n, bufH = 3, 9
    n_fields = n if tff is None else 2 * n
    shape = (n, bufH, w) if tff is None else (n, 2 * bufH, w)
    src = torch.from_numpy(_rand(rng, shape, fmt)).to(cuda)
    _, off = _offsets(offset, n_fields, 2)
    if not isinstance(off, int):
        off = off.to(cuda)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    # 1023 and 5 unpadded: S not a multiple of 4, and a plane below the
    # 7-tap span; 3840 is past one block: K4 over 4 blocks of a cluster
    stride = w if w in UNPADDED else -(-w // 32) * 32
    wide = dk.field_plan(n_fields, w, bufH, stride, spec, cl.card_figures(cuda)).k > 1
    assert wide == (w == 3840)
    before, full = dk.LAUNCHES, sk.LAUNCHES["full"]
    got = dk.deinterlace_field_batch_fused(src, off, _aaf(fmt), spec, stride,
                                           interlaced_tff=tff)
    assert dk.LAUNCHES == before + (not wide)
    assert sk.LAUNCHES["full"] == full + wide
    want = dk.deinterlace_field_batch_plain(src, off, _aaf(fmt), spec, stride,
                                            interlaced_tff=tff)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if tff is None:
        got2 = dk.interpolate_field_batch(src, _aaf(fmt), spec, stride)
        from sangnom_tpu_torch.ops.reference import interpolate_field_batch

        assert torch.equal(got2, interpolate_field_batch(src, _aaf(fmt), spec, stride))


@pytest.mark.cuda
@pytest.mark.parametrize("n,bufH,w,stride", [
    (150, 5, 40, 64),        # more fields than the card has SMs
    (2, 4, 6200, 6208),      # past one block: K4 over 8 blocks
    (2, 1, 16, 32),          # one kept row: weave only
    (2, 6, 3840, 3840),      # 4K luma: K4 over 4 blocks of a cluster
    (3, 7, 1023, 1023),      # S = 1023: the last thread owns 3 columns
    (4, 6, 5, 5),            # narrower than the 7-tap span
    (2, 2, 700, 700),        # two kept rows: one step, no row ahead
], ids=str)
def test_kernel_shapes_on_card(cuda, n, bufH, w, stride):
    fmt = get_format("GRAY8")
    src = torch.from_numpy(_rand(np.random.default_rng(n), (n, bufH, w), fmt)).to(cuda)
    spec = KernelSpec.from_format(fmt)
    got = dk.deinterlace_field_batch_fused(src, 1, 62, spec, stride)
    want = dk.deinterlace_field_batch_plain(src, 1, 62, spec, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_concurrent_launches_on_card(cuda):
    """Host threads launching the kernel at once, as the frame-serving hosts
    do, at two widths (two shared-memory sizes of one instantiation): every
    launch succeeds and equals its plain twin."""
    from concurrent.futures import ThreadPoolExecutor

    fmt = get_format("GRAY8")
    spec = KernelSpec.from_format(fmt)
    rng = np.random.default_rng(5)
    cases = []
    for w in (1920, 960):
        src = torch.from_numpy(_rand(rng, (4, 17, w), fmt)).to(cuda)
        stride = -(-w // 32) * 32
        cases.append((src, stride,
                      dk.deinterlace_field_batch_plain(src, 1, 62, spec, stride)))
    from sangnom_tpu_torch.core.geometry import width_tiers

    limit = cl.max_smem_bytes(cuda)
    assert len({dk.launch_plan(w, width_tiers(w, 17, stride, spec)[2], 1, limit).smem_bytes
                for w, stride in ((s.shape[2], st) for s, st, _ in cases)}) == 2

    def run(k):
        outs = [(dk.deinterlace_field_batch_fused(src, 1, 62, spec, stride), want)
                for src, stride, want in (cases[(k + i) % 2] for i in range(40))]
        torch.cuda.synchronize()
        return sum(not torch.equal(got, want) for got, want in outs)

    with ThreadPoolExecutor(8) as ex:
        assert sum(ex.map(run, range(8), timeout=300)) == 0


@pytest.mark.cuda
def test_kernel_refuses_bad_input_on_card(cuda):
    """A wrong dtype is refused; the kernel's launch refuses a strided
    input (`interpolate_field_batch` hands it the rows as given), while the
    fused weave takes a strided view of a plane's rows and copies it once,
    with the bits of its contiguous copy."""
    spec = KernelSpec.from_format(get_format("GRAY8"))
    src = torch.zeros((2, 8, 32), dtype=torch.uint16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        dk.deinterlace_field_batch_fused(src, 0, 62, spec, 32)
    src = torch.randint(0, 256, (2, 32, 8), dtype=torch.int32,
                        device=cuda).to(torch.uint8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dk.interpolate_field_batch(src, 62, spec, 32)
    assert torch.equal(dk.deinterlace_field_batch_fused(src, 0, 62, spec, 32),
                       dk.deinterlace_field_batch_fused(src.contiguous(), 0, 62, spec, 32))
