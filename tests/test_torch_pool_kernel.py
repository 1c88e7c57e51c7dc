"""The port's pool kernels (sangnom_tpu_torch.ops.pool_kernel): K3, K6, and
K7 as its prepare kernel, the K6 walk and its finalize kernel.

On the CPU each wrapper runs its plain PyTorch twin; those cases are held
bit for bit against the TPU package's Pallas pool kernels in interpret mode
(``smooth_pool_pallas``, ``_smooth_rows_split3``, ``interp_field_pool_fused``),
and the wrappers' input checks are exercised.

The ``cuda`` cases launch the hand-written CUDA kernels and hold each one
bit for bit against its twin on the same CUDA tensors, interpolated rows and
the whole pool; they skip without a card.  This module imports neither JAX
nor the test conftest at import time, so on a machine with a card and no
JAX the kernel cases run with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pool_kernel.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import (  # noqa: E402
    aaf_as_pixel,
    scaled_aa_thresholds,
)
from sangnom_tpu_torch.ops import pool_carry as pc  # noqa: E402
from sangnom_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402


def _rand(rng, shape, fmt):
    """Full-range samples, out-of-nominal codes included for >8-bit formats
    (the same distribution as tests/conftest.make_plane)."""
    if fmt.is_float:
        return (rng.random(shape, dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)


def _aaf(fmt, plane=0):
    """The threshold of aa=48 (luma) or aac=40 (chroma) in ``fmt``."""
    return aaf_as_pixel(scaled_aa_thresholds(40 if plane else 48, 0, fmt)[0], fmt)


def _stale_pool(fmt, spec, P, S, rng, device="cpu"):
    """A pool holding stale smoothed content: two plain passes over random
    planes (one luma-like at an unaligned width, one chroma-like)."""
    pool = torch.zeros((9, P + 1, S), dtype=spec.acc_dtype, device=device)
    for rows, w in ((P, max(S - 5, 1)), (max(P // 2, 1), max(S // 2 - 3, 1))):
        kept = torch.from_numpy(_rand(rng, (rows, w), fmt)).to(device)
        pc.interp_field_pool(kept, pool, _aaf(fmt), spec)
    return pool


def _kept_shapes(P, S):
    """(rows, width) of the planes a pass is tested on: luma covering the
    pool (R = P-1), an unaligned luma, chroma (R < P-1, w < S), widths below
    the 7-tap span, degenerate."""
    return [(P, S), (P, max(S - 7, 1)), (max(P // 2, 2), max(S // 2 - 3, 1)),
            (5, 6), (2, 1), (1, S // 2)]


def _kept_views(rng, rows, w, fmt, device="cpu"):
    """The same kept rows twice: contiguous, and as the odd rows of a frame
    (a field read in place, row stride 2w)."""
    frame = torch.from_numpy(_rand(rng, (2 * rows, w), fmt)).to(device)
    return frame[1::2].contiguous(), frame[1::2]


# --- on the CPU ------------------------------------------------------------

def test_cpu_wrappers_do_not_launch():
    fmt = get_format("GRAY8")
    spec = KernelSpec.from_format(fmt)
    rng = np.random.default_rng(1)
    pool = _stale_pool(fmt, spec, 6, 32, rng)
    kept = torch.from_numpy(_rand(rng, (5, 30), fmt))
    before = dict(pk.LAUNCHES)
    pk.smooth_pool_(pool.clone(), spec)
    carry = pc._pool_split(pool)
    pk.smooth_split3_(*carry, spec)
    pk.interp_fused(kept, *pc._pool_split(pool), _aaf(fmt), spec)
    body = carry[1]
    pk.prepare_pool_(kept, body, spec)
    pk.finalize_pool(kept, body, _aaf(fmt), spec)
    assert pk.LAUNCHES == before
    pk.reset_launches()
    assert set(pk.LAUNCHES.values()) == {0}


def _bad_calls():
    spec = KernelSpec.from_format(get_format("GRAY8"))
    pool = torch.zeros((9, 6, 32), dtype=torch.int32)
    row0, body, tail = pc._pool_split(pool)
    kept = torch.zeros((5, 30), dtype=torch.uint8)
    return [
        ("dtype", lambda: pk.smooth_pool_(pool.float(), spec)),
        ("must be \\[9, P\\+1, S\\]", lambda: pk.smooth_pool_(pool[:8], spec)),
        ("contiguous", lambda: pk.smooth_pool_(pool.transpose(1, 2), spec)),
        ("row0 must be", lambda: pk.smooth_split3_(row0[:, :16], body, tail, spec)),
        ("contiguous", lambda: pk.smooth_split3_(row0, body.transpose(1, 2).contiguous()
                                                 .transpose(1, 2), tail, spec)),
        ("dtype", lambda: pk.smooth_split3_(row0, body, tail.float(), spec)),
        ("dtype", lambda: pk.interp_fused(kept.to(torch.uint16), row0, body, tail, 62, spec)),
        ("contiguous", lambda: pk.interp_fused(kept.t().contiguous().t(), row0, body,
                                               tail, 62, spec)),
        ("does not fit", lambda: pk.interp_fused(torch.zeros((7, 30), dtype=torch.uint8),
                                                 row0, body, tail, 62, spec)),
        ("does not fit", lambda: pk.interp_fused(torch.zeros((5, 33), dtype=torch.uint8),
                                                 row0, body, tail, 62, spec)),
        ("does not fit", lambda: pk.interp_fused(kept[:1], row0, body, tail, 62, spec)),
        ("body must be", lambda: pk.prepare_pool_(kept, body[:8], spec)),
        ("contiguous", lambda: pk.prepare_pool_(kept[:, ::2], body, spec)),
        ("does not fit", lambda: pk.finalize_pool(torch.zeros((5, 33), dtype=torch.uint8), body,
                                                  62, spec)),
        ("dtype", lambda: pk.finalize_pool(kept, body.float(), 62, spec)),
    ]


@pytest.mark.parametrize("k", range(len(_bad_calls())))
def test_wrappers_refuse_bad_input(k):
    match, call = _bad_calls()[k]
    with pytest.raises(ValueError, match=match):
        call()


@pytest.fixture
def jax_pool():
    jax = pytest.importorskip("jax")
    assert jax.default_backend() == "cpu"
    from sangnom_tpu.ops import pool_carry

    return pool_carry


SPECS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False), ("GRAYS", False)]


def _jspec(spec):
    from sangnom_tpu.ops.primitives import KernelSpec as JSpec

    return JSpec(spec.is_float, spec.mask, spec.sse2)


@pytest.mark.parametrize("fmt_name,sse2", SPECS, ids=str)
def test_smooth_twin_matches_pallas(jax_pool, fmt_name, sse2):
    """K3's twin == the TPU package's K3 (`smooth_pool_pallas`)."""
    import jax.numpy as jnp

    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    pool = _stale_pool(fmt, spec, 8, 64, np.random.default_rng(2))
    want = np.asarray(jax_pool.smooth_pool_pallas(jnp.asarray(pool.numpy()), _jspec(spec)))
    got = pk.smooth_pool_plain_(pool.clone(), spec)
    np.testing.assert_array_equal(got[:, 1:-1].transpose(0, 1).numpy(), want)
    np.testing.assert_array_equal(got[:, [0, -1]].numpy(), pool[:, [0, -1]].numpy())


@pytest.mark.parametrize("fmt_name,sse2", SPECS, ids=str)
def test_split3_twin_matches_pallas(jax_pool, fmt_name, sse2):
    """K6's twin == the TPU package's K6 (`_smooth_rows_split3`) on its
    split carry."""
    import jax.numpy as jnp
    from sangnom_tpu.ops.pallas_kernel import _packed_smoothing

    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    jspec = _jspec(spec)
    pool = _stale_pool(fmt, spec, 9, 64, np.random.default_rng(3))
    row0, body, tail = jax_pool._pool_split_fused(jnp.asarray(pool.numpy()), jspec)
    sm = jax_pool._smooth_rows_split3(row0, body, tail, jspec,
                                      _packed_smoothing(jspec), 64)
    want = np.asarray(jax_pool._pool_join_fused((row0, sm, tail), jspec, 64))
    carry = pc._pool_split(pool)
    pk.smooth_split3_plain_(*carry, spec)
    np.testing.assert_array_equal(pc._pool_join(carry).numpy(), want)


@pytest.mark.parametrize("fmt_name,sse2", SPECS, ids=str)
@pytest.mark.parametrize("shape", ["luma", "chroma"])
def test_fused_twin_matches_pallas(jax_pool, fmt_name, sse2, shape):
    """K7's twin == the TPU package's K7 (`interp_field_pool_fused`),
    interpolated rows and the whole pool."""
    import jax.numpy as jnp

    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    jspec = _jspec(spec)
    rng = np.random.default_rng(4)
    P, S = 8, 64
    pool = _stale_pool(fmt, spec, P, S, rng)
    rows, w = (P, 61) if shape == "luma" else (3, 29)
    kept = _rand(rng, (rows, w), fmt)
    aaf = _aaf(fmt, 0 if shape == "luma" else 1)
    jcarry = jax_pool._pool_split_fused(jnp.asarray(pool.numpy()), jspec)
    want, jcarry = jax_pool.interp_field_pool_fused(jnp.asarray(kept), jcarry, aaf,
                                                    jspec, S)
    carry = pc._pool_split(pool)
    got = pk.interp_fused_plain(torch.from_numpy(kept), *carry, aaf, spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pc._pool_join(carry).numpy(),
                                  np.asarray(jax_pool._pool_join_fused(jcarry, jspec, S)))


@pytest.mark.parametrize("fmt_name,sse2", SPECS, ids=str)
@pytest.mark.parametrize("shape", ["luma", "chroma"])
@pytest.mark.parametrize("via", ["plain", "wrappers"])
def test_fused_stages_match_pallas(jax_pool, fmt_name, sse2, shape, via):
    """K7's three stages in sequence (prepare, K6 walk, finalize; their
    plain twins, or the wrappers that run them on the CPU) == the TPU
    package's K7 on a stale pool, the kept rows read in place as the odd
    rows of a frame: luma covers the pool (R = P-1, w < S), chroma has
    R < P-1 and w < S/2."""
    import jax.numpy as jnp

    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    jspec = _jspec(spec)
    rng = np.random.default_rng(6)
    P, S = 8, 64
    pool = _stale_pool(fmt, spec, P, S, rng)
    rows, w = (P, 61) if shape == "luma" else (3, 29)
    dense, kept = _kept_views(rng, rows, w, fmt)
    assert kept.stride(0) == 2 * w
    aaf = _aaf(fmt, 0 if shape == "luma" else 1)
    jcarry = jax_pool._pool_split_fused(jnp.asarray(pool.numpy()), jspec)
    want, jcarry = jax_pool.interp_field_pool_fused(jnp.asarray(dense.numpy()), jcarry,
                                                    aaf, jspec, S)
    row0, body, tail = pc._pool_split(pool)
    if via == "plain":
        pk.prepare_pool_plain_(kept, body, spec)
        pk.smooth_split3_plain_(row0, body, tail, spec)
        got = pk.finalize_pool_plain(kept, body, aaf, spec)
    else:
        pk.prepare_pool_(kept, body, spec)
        pk.smooth_split3_(row0, body, tail, spec)
        got = pk.finalize_pool(kept, body, aaf, spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pc._pool_join((row0, body, tail)).numpy(),
                                  np.asarray(jax_pool._pool_join_fused(jcarry, jspec, S)))


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


CUDA_FORMATS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False),
                ("GRAY16", True), ("YUV420P10", False), ("YUV420P10", True),
                ("GRAYS", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CUDA_FORMATS, ids=str)
@pytest.mark.parametrize("S", [64, 736, 1920])
def test_pool_kernels_match_twins_on_card(cuda, fmt_name, sse2, S):
    """K3, K6 and K7 each against its twin on the same CUDA tensors, on a
    stale pool, for luma, chroma and degenerate planes: interpolated rows and
    the whole pool bit-equal."""
    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    rng = np.random.default_rng(S)
    P = 21
    pool = _stale_pool(fmt, spec, P, S, rng, cuda)
    assert pool[:, 1:P].any()
    for rows, w in _kept_shapes(P, S):
        dense, strided = _kept_views(rng, rows, w, fmt, cuda)
        aaf = _aaf(fmt, 0 if w >= S - 7 else 1)
        want_pool = pool.clone()
        want = pc.interp_field_pool(dense, want_pool, aaf, spec)
        for kept in (dense, strided):
            for name, run in (
                ("K3", lambda p: (pc.interp_field_pool_k3(kept, p, aaf, spec), p)),
                ("K6", lambda p: _on_split(pc.interp_field_pool_split3, kept, p, aaf, spec)),
                ("K7", lambda p: _on_split(pc.interp_field_pool_fused, kept, p, aaf, spec)),
            ):
                before = dict(pk.LAUNCHES)
                got, got_pool = run(pool.clone())
                torch.cuda.synchronize()
                assert pk.LAUNCHES != before, f"{name} did not launch"
                assert torch.equal(got, want), f"{name} rows differ at kept {rows}x{w}"
                assert torch.equal(got_pool, want_pool), f"{name} pool differs at kept {rows}x{w}"
        pool = want_pool


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CUDA_FORMATS, ids=str)
@pytest.mark.parametrize("S", [64, 736, 1920])
def test_prepare_finalize_kernels_match_twins_on_card(cuda, fmt_name, sse2, S):
    """The K7 prepare and finalize kernels each against its twin on the same
    CUDA tensors, on a stale body, kept rows contiguous and strided, at
    luma, chroma and narrow widths: the whole body and the rows bit-equal;
    each K7 pass is three launches."""
    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    rng = np.random.default_rng(S + 1)
    P = 21
    _, body, _ = pc._pool_split(_stale_pool(fmt, spec, P, S, rng, cuda))
    for rows, w in _kept_shapes(P, S)[:-1]:
        aaf = _aaf(fmt, 0 if w >= S - 7 else 1)
        for kept in _kept_views(rng, rows, w, fmt, cuda):
            got, want = body.clone(), body.clone()
            pk.prepare_pool_(kept, got, spec)
            pk.prepare_pool_plain_(kept, want, spec)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"prepare differs at kept {rows}x{w}"
            rows_got = pk.finalize_pool(kept, body, aaf, spec)
            rows_want = pk.finalize_pool_plain(kept, body, aaf, spec)
            torch.cuda.synchronize()
            assert torch.equal(rows_got, rows_want), f"finalize differs at kept {rows}x{w}"
    row0, body, tail = pc._pool_split(_stale_pool(fmt, spec, P, S, rng, cuda))
    kept = _kept_views(rng, P // 2, S // 2, fmt, cuda)[1]
    before = dict(pk.LAUNCHES)
    pk.interp_fused(kept, row0, body, tail, _aaf(fmt), spec)
    assert {k: pk.LAUNCHES[k] - before[k] for k in before} == {
        "smooth": 0, "split3": 1, "prepare": 1, "finalize": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CUDA_FORMATS, ids=str)
@pytest.mark.parametrize("S", [5, 61, 739, 2050])
def test_smooth_kernel_odd_strides_on_card(cuda, fmt_name, sse2, S):
    """K3 and K6 against their twins at pool strides below the 7-tap span,
    not a multiple of the 4-column group, and in the 8-column build with a
    partial last group: the whole pool bit-equal."""
    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    pool = _stale_pool(fmt, spec, 13, S, np.random.default_rng(S + 2), cuda)
    got, want = pool.clone(), pool.clone()
    pk.smooth_pool_(got, spec)
    pk.smooth_pool_plain_(want, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"K3 differs at stride {S}"
    carry = pc._pool_split(pool)
    pk.smooth_split3_(*carry, spec)
    torch.cuda.synchronize()
    assert torch.equal(pc._pool_join(carry), want), f"K6 differs at stride {S}"


def _on_split(plane_pass, kept, pool, aaf, spec):
    carry = pc._pool_split(pool)
    out = plane_pass(kept, carry, aaf, spec)
    return out, pc._pool_join(carry)


@pytest.mark.cuda
def test_pool_kernels_refuse_bad_input_on_card(cuda):
    spec = KernelSpec.from_format(get_format("GRAY8"))
    pool = torch.zeros((9, 6, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        pk.smooth_pool_(pool.float(), spec)
    row0, body, tail = pc._pool_split(pool)
    with pytest.raises(ValueError, match="different devices"):
        pk.interp_fused(torch.zeros((5, 30), dtype=torch.uint8), row0, body, tail, 62, spec)
