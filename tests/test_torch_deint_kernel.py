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
from sangnom_tpu_torch.ops import deint_kernel as dk  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402


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
    for S in (1, 31, 512, 513, 1024, 1920, 2048, 2049, 4096, 8192):
        cols, threads = dk.launch_shape(S)
        assert cols in (1, 4, 8)
        assert cols * threads >= S and threads % 32 == 0
        assert threads <= (1024 if cols == 8 else 512)
    with pytest.raises(ValueError, match="too wide"):
        dk.launch_shape(8193)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


CUDA_FORMATS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False),
                ("GRAY16", True), ("YUV420P10", False), ("YUV420P10", True),
                ("GRAYS", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CUDA_FORMATS, ids=str)
@pytest.mark.parametrize("offset", [0, 1, "pf"])
@pytest.mark.parametrize("tff", [None, True, False])
@pytest.mark.parametrize("w", [61, 1920])
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
    stride = -(-w // 32) * 32
    before = dk.LAUNCHES
    got = dk.deinterlace_field_batch_fused(src, off, _aaf(fmt), spec, stride,
                                           interlaced_tff=tff)
    assert dk.LAUNCHES == before + 1
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
    (2, 4, 6200, 6208),      # smoothed rows too wide for shared memory
    (2, 1, 16, 32),          # one kept row: weave only
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
def test_kernel_refuses_bad_input_on_card(cuda):
    spec = KernelSpec.from_format(get_format("GRAY8"))
    src = torch.zeros((2, 8, 32), dtype=torch.uint16, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        dk.deinterlace_field_batch_fused(src, 0, 62, spec, 32)
    src = torch.zeros((2, 32, 8), dtype=torch.uint8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        dk.deinterlace_field_batch_fused(src, 0, 62, spec, 32)
