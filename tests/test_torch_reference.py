"""The port's plain path (opt=0) against JAX opt=0 and the native oracle.

`sangnom_tpu_torch.ops.reference` is the ground truth the CUDA kernel is held
to on the card, so it must equal the TPU package's jnp reference bit for bit
(float formats included), the native oracle, and the finalize tie table of
tests/test_finalize_priority.py.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sangnom_tpu.core.formats import get_format as jax_format  # noqa: E402
from sangnom_tpu.ops import primitives as jp  # noqa: E402
from sangnom_tpu.ops import reference as jr  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import (  # noqa: E402
    aaf_as_pixel,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from sangnom_tpu_torch.ops import primitives as tp  # noqa: E402
from sangnom_tpu_torch.ops import reference as tr  # noqa: E402
from sangnom_tpu_torch.oracle import deinterlace_plane_oracle  # noqa: E402

from conftest import make_plane  # noqa: E402
from test_finalize_priority import MN, OTHER, PREDS, TAPS, _expected  # noqa: E402


CASES = [
    # format, numerics, frames, kept rows, width, stride (None: ceil32(w))
    ("GRAY8", "c", 3, 12, 64, None),
    ("GRAY8", "sse2", 2, 9, 61, None),
    ("GRAY8", "c", 2, 7, 5, None),
    ("GRAY8", "c", 2, 10, 33, 96),  # chroma-style luma-derived stride
    ("GRAY16", "c", 2, 10, 40, None),
    ("GRAY16", "sse2", 2, 10, 37, None),
    ("YUV420P10", "c", 2, 8, 29, 64),
    ("YUV420P10", "sse2", 2, 8, 29, 64),
    ("GRAYS", "c", 2, 12, 43, None),
    ("YUV444PS", "c", 2, 6, 31, 64),
    ("GRAY8", "c", 2, 1, 16, None),  # one kept row: nothing to interpolate
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_interpolate_batch_matches_jax(case):
    fmt_name, numerics, n, bufH, w, stride = case
    fmt = get_format(fmt_name)
    rng = np.random.default_rng(bufH * 1000 + w)
    kept = np.stack([make_plane(rng, bufH, w, jax_format(fmt_name)) for _ in range(n)])
    stride = stride or buffer_stride_elems(w, fmt.component_size)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
    tspec = tp.KernelSpec.from_format(fmt, sse2=numerics == "sse2")
    jspec = jp.KernelSpec(tspec.is_float, tspec.mask, tspec.sse2)
    got = tr.interpolate_field_batch(torch.from_numpy(kept), aaf, tspec, stride)
    want = np.asarray(jr.interpolate_field_batch(jnp.asarray(kept), aaf, jspec, stride))
    assert got.dtype == fmt.dtype and got.shape == (n, max(bufH - 1, 0), w)
    np.testing.assert_array_equal(got.numpy(), want)
    single = tr.interpolate_field(torch.from_numpy(kept[0]), aaf, tspec, stride)
    np.testing.assert_array_equal(single.numpy(), want[0])


@pytest.mark.parametrize("fmt_name,w,offset", [
    ("GRAY8", 48, 0), ("GRAY8", 21, 1), ("GRAY16", 40, 1), ("GRAYS", 35, 0),
], ids=str)
def test_interpolate_matches_oracle(fmt_name, w, offset):
    """The oracle's dh plane (kept rows = the source) carries the
    interpolated rows at rows 2r+1+offset."""
    fmt = get_format(fmt_name)
    rng = np.random.default_rng(w)
    kept = make_plane(rng, 10, w, jax_format(fmt_name))
    aaf_f = scaled_aa_thresholds(64, 0, fmt)[0]
    stride = buffer_stride_elems(w, fmt.component_size)
    spec = tp.KernelSpec.from_format(fmt)
    got = tr.interpolate_field(torch.from_numpy(kept), aaf_as_pixel(aaf_f, fmt),
                               spec, stride).numpy()
    want = deinterlace_plane_oracle(kept, offset, True, aaf_f, stride)
    np.testing.assert_array_equal(got, want[1 + offset::2][:9])


def test_smooth_scan_matches_jax():
    rng = np.random.default_rng(5)
    for spec in ((False, 0xFF, False), (False, 0xFFFF, True), (True, 0, False)):
        if spec[0]:
            raw = rng.random((9, 8, 50), dtype=np.float32) * 3
        else:
            raw = rng.integers(0, spec[1] + 1, size=(9, 8, 50)).astype(np.int32)
        raw[:, 0] = 0
        raw[:, -1] = 0
        want = np.asarray(jr.smooth_scan(jnp.asarray(raw), jp.KernelSpec(*spec)))
        got = tr.smooth_scan(torch.from_numpy(raw).permute(1, 0, 2), tp.KernelSpec(*spec))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec", [
    pytest.param((False, 0xFF, False), id="u8_c"),
    pytest.param((False, 0xFF, True), id="u8_sse2"),
    pytest.param((False, 0xFFFF, False), id="u16_c"),
    pytest.param((True, 0, False), id="f32"),
])
def test_priority_truth_table_all_tie_subsets(spec):
    """All 511 nonempty tie subsets x 3 threshold regimes against the
    directly evaluated C if-chain (the table of test_finalize_priority)."""
    jspec, tspec = jp.KernelSpec(*spec), tp.KernelSpec(*spec)
    dt = np.float32 if jspec.is_float else np.int32
    subsets = [frozenset(s) for r in range(1, 10)
               for s in itertools.combinations(range(9), r)]
    n = len(subsets)
    bufs = np.full((9, n), OTHER, dt)
    for j, s in enumerate(subsets):
        for i in s:
            bufs[i, j] = MN
    taps = tuple(torch.full((n,), v, dtype=tspec.acc_dtype) for v in TAPS)
    preds = tuple(torch.full((n,), v, dtype=tspec.acc_dtype) for v in PREDS)
    for aaf in (100, 3, MN):
        aaf_t = np.float32(aaf) if jspec.is_float else aaf
        want = np.array([_expected(s, aaf, jspec) for s in subsets], dt)
        got = tr.finalize_select_from_taps(taps, preds, torch.from_numpy(bufs),
                                           aaf_t, tspec)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"aaf={aaf}")
        got_seq = tr.finalize_select_from_taps(
            taps, preds, [torch.from_numpy(bufs[i]) for i in range(9)], aaf_t, tspec)
        np.testing.assert_array_equal(got_seq.numpy(), want, err_msg=f"seq aaf={aaf}")
