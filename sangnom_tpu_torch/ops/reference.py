"""The plain PyTorch path (opt=0): the numerics ground truth of the port.

A direct implementation of the reference's C kernel path (reference
src/SangNom2.cpp:74-273) on whole tensors:
  1. prepare:  9 directional error maps between adjacent kept lines.
  2. smooth:   the 3x7 box filter.  The reference smooths IN PLACE, so each
     row's vertical 3-sum reads the already-smoothed row above
     (src/SangNom2.cpp:129-131, 155-157).  That makes it a scan over rows,
     written here as a Python loop carrying the smoothed row; a convolution
     is NOT bit-exact.
  3. finalize: 9-way min and fixed-priority select, as reverse-order masked
     overwrites (ties break by the C if-chain's order, src/SangNom2.cpp:
     212-249; an argmin breaks them differently).

Buffer rows 0 and bufH and padding columns [w, stride) are zero.
The CUDA kernel (ops/deint_kernel.py) is held bit for bit against this.
"""

from __future__ import annotations

import torch

from sangnom_tpu_torch.core.geometry import decay_hops
from sangnom_tpu_torch.ops.primitives import (
    KernelSpec,
    abs_diff,
    avg_pair,
    calc_sangnom,
    neighborhood,
    smooth_writeback,
)


def pair_taps(curr, nxt, spec: KernelSpec):
    """(taps, preds) of a kept-line pair: the 14 edge-clamped neighborhood
    taps and 4 directional predictors (reference src/SangNom2.cpp:87-106)."""
    cm3, cm2, cm1, c0, cp1, cp2, cp3 = neighborhood(curr, 3)
    nm3, nm2, nm1, n0, np1, np2, np3 = neighborhood(nxt, 3)
    fwd1 = calc_sangnom(cm1, c0, cp1, spec)
    fwd2 = calc_sangnom(np1, n0, nm1, spec)
    bwd1 = calc_sangnom(cp1, c0, cm1, spec)
    bwd2 = calc_sangnom(nm1, n0, np1, spec)
    taps = (cm3, cm2, cm1, c0, cp1, cp2, cp3,
            nm3, nm2, nm1, n0, np1, np2, np3)
    return taps, (fwd1, fwd2, bwd1, bwd2)


def error_maps_list(taps, preds) -> list:
    """The 9 raw directional error maps, in spatial priority order
    (reference enum Buffers, src/SangNom2.h:8-20; stores at
    src/SangNom2.cpp:103-117)."""
    (cm3, cm2, cm1, c0, cp1, cp2, cp3,
     nm3, nm2, nm1, n0, np1, np2, np3) = taps
    fwd1, fwd2, bwd1, bwd2 = preds
    return [
        abs_diff(cm3, np3),  # 0 ADIFF_M3_P3
        abs_diff(cm2, np2),  # 1 ADIFF_M2_P2
        abs_diff(cm1, np1),  # 2 ADIFF_M1_P1
        abs_diff(fwd1, fwd2),  # 3 SG_FORWARD
        abs_diff(c0, n0),  # 4 ADIFF_P0_M0
        abs_diff(bwd1, bwd2),  # 5 SG_REVERSE
        abs_diff(cp1, nm1),  # 6 ADIFF_P1_M1
        abs_diff(cp2, nm2),  # 7 ADIFF_P2_M2
        abs_diff(cp3, nm3),  # 8 ADIFF_P3_M3
    ]


def error_maps_from_taps(taps, preds) -> torch.Tensor:
    """The 9 raw error maps stacked: [9, ...] in spatial priority order."""
    return torch.stack(error_maps_list(taps, preds))


def hbox7(line: torch.Tensor) -> torch.Tensor:
    """7-tap horizontal box sum, taps edge-clamped at the line's width (the
    padded stride, reference src/SangNom2.cpp:141-152), summed strictly left
    to right as the C expression does (float exactness)."""
    t = neighborhood(line, 3)
    s = t[0]
    for k in range(1, 7):
        s = s + t[k]
    return s


def smooth_scan(raw: torch.Tensor, spec: KernelSpec,
                init: torch.Tensor | None = None,
                hbox_fn=None) -> torch.Tensor:
    """The recursive 3x7 smoothing over buffer rows 1..bufH-1.

    raw: [bufH+1, ..., S] raw error maps (rows first; the rest is any layout
    ``hbox_fn`` takes).  Rows 0 and bufH are the buffer's boundary rows:
    zero under the zero-defined contract, carried pool content in
    pool-compat mode, which passes ``init`` = row 0 as the smoothed "row 0"
    seed (zero when None).  ``hbox_fn``: the horizontal 7-tap box sum of one
    line (default `hbox7`, clamped at the line's width; the width-sharded
    scan passes a halo-exchanging one, so the recursion is shared).
    Returns the smoothed rows [bufH-1, ..., S]."""
    bufH = raw.shape[0] - 1
    if hbox_fn is None:
        hbox_fn = hbox7
    sm = torch.zeros_like(raw[0]) if init is None else init
    out = []
    for b in range(1, bufH):
        line = sm + raw[b] + raw[b + 1]  # row b-1 already smoothed
        sm = smooth_writeback(hbox_fn(line), spec)
        out.append(sm)
    if not out:
        return raw[:0]
    return torch.stack(out)


def finalize_select_from_taps(taps, preds, bufs, aaf, spec: KernelSpec):
    """9-way min and fixed-priority select over the smoothed maps ``bufs``
    ([9, ...] tensor or a sequence of 9), written as reverse-priority masked
    overwrites: the LAST write wins, from the lowest-priority direction up to
    the vertical/threshold case (reference src/SangNom2.cpp:212-249)."""
    (cm3, cm2, cm1, c0, cp1, cp2, cp3,
     nm3, nm2, nm1, n0, np1, np2, np3) = taps
    fwd1, fwd2, bwd1, bwd2 = preds
    if isinstance(bufs, (list, tuple)):
        bufs = torch.stack(list(bufs))
    mn = bufs.amin(dim=0)

    res = avg_pair(cm3, np3, spec)  # buf0 ADIFF_M3_P3 (lowest priority)
    for idx, val in (
        (8, avg_pair(cp3, nm3, spec)),  # ADIFF_P3_M3
        (1, avg_pair(cm2, np2, spec)),  # ADIFF_M2_P2
        (7, avg_pair(cp2, nm2, spec)),  # ADIFF_P2_M2
        (2, avg_pair(cm1, np1, spec)),  # ADIFF_M1_P1
        (6, avg_pair(cp1, nm1, spec)),  # ADIFF_P1_M1
        (3, avg_pair(fwd1, fwd2, spec)),  # SG_FORWARD
        (5, avg_pair(bwd1, bwd2, spec)),  # SG_REVERSE
    ):
        res = torch.where(bufs[idx] == mn, val, res)
    # highest priority: vertical if it ties the min OR the min exceeds aaf
    # (reference src/SangNom2.cpp:214-217)
    aaf_c = torch.tensor(aaf, dtype=c0.dtype, device=c0.device)
    return torch.where((bufs[4] == mn) | (mn > aaf_c), avg_pair(c0, n0, spec), res)


def smooth_width(w: int, stride: int, spec: KernelSpec) -> int:
    """Columns the plain path smooths: the full stride for float; for integer
    formats the padding decays to exact zero within `decay_hops` rows, so the
    scan stops at w + 3*hops + 6 (see core.geometry.creep_bound).  Only for
    zero-defined padding: the pool-compat pass (ops.pool_carry) smooths the
    full stride, because stale pool columns are not zero."""
    if spec.is_float:
        return stride
    return min(stride, w + 3 * decay_hops(spec.mask) + 6)


def interpolate_field_batch(
    kept: torch.Tensor, aaf, spec: KernelSpec, stride: int
) -> torch.Tensor:
    """[N, bufH, w] kept fields (storage dtype) -> [N, bufH-1, w] interpolated
    lines in the same dtype.

    ``aaf``: the pre-scaled threshold as the kernel sees it (int or float32);
    ``stride``: the padded, luma-derived buffer stride in elements.
    """
    out_dtype = kept.dtype
    N, bufH, w = kept.shape
    if bufH < 2:
        return kept.new_zeros((N, 0, w))
    kept = kept.to(spec.acc_dtype)
    curr, nxt = kept[:, :-1], kept[:, 1:]  # kept pairs, buffer rows 1..bufH-1
    taps, preds = pair_taps(curr, nxt, spec)

    # stage 1: prepare, into the zero-defined [bufH+1, 9, N, S] pool
    S_sm = smooth_width(w, stride, spec)
    raw = kept.new_zeros((bufH + 1, 9, N, S_sm))
    maps = error_maps_from_taps(taps, preds)  # [9, N, bufH-1, w]
    raw[1:bufH, :, :, :w] = maps.permute(2, 0, 1, 3)
    del maps

    # stage 2: smooth
    sm = smooth_scan(raw, spec)  # [bufH-1, 9, N, S]
    del raw
    bufs = sm[..., :w].permute(1, 2, 0, 3)  # [9, N, bufH-1, w]

    # stage 3: finalize
    res = finalize_select_from_taps(taps, preds, bufs, aaf, spec)
    return res.to(out_dtype)


def interpolate_field(kept: torch.Tensor, aaf, spec: KernelSpec, stride: int):
    """Single-field convenience wrapper: [bufH, w] -> [bufH-1, w]."""
    return interpolate_field_batch(kept[None], aaf, spec, stride)[0]
