"""Width-sharded interpolation: a plane's columns split into ``n_space``
shards that exchange halos.

The smoothing recursion propagates horizontal influence 3 columns per row
(sm[b][x] depends on sm[b-1][x±3], reference src/SangNom2.cpp:129-152), so a
width shard needs its neighbours' edge columns: the scan arm exchanges a
3-column halo of the in-flight line at EVERY row; the kernel arms
(parallel.fused_smooth) exchange 3R+3 or 3R+6 columns once per R rows.

All shards of a plane lie on one device here, so the shard-local view of a
padded plane ``[N, bufH, S_eff]`` is the reshaping ``[n_space, N, bufH,
W_loc]`` (``_shards``), and a halo exchange is a gather of the neighbours'
edge columns.  ``HALO_EXCHANGES`` counts them by kind: "kept" (once per
plane pass: the kept rows, and in the chunked arm its raw maps), "carry"
(once per chunk of R rows) and "row" (once per row of the scan arm).

Stride semantics: the caller pads every plane toward the luma-derived buffer
stride with EDGE REPLICATION (parallel.sharding), so (a) pixel taps that
would clamp at the true plane width read the replicated edge pixel, exactly
loadPixel's clamp (reference src/SangNom2.cpp:25-34); (b) the smoothing
clamp falls on the global array edge, realized by edge-replicated halos on
the boundary shards; and (c) the zero-defined raw-map padding columns
[w, S) are recreated by masking raw maps against the GLOBAL column index,
which keeps horizontally subsampled chroma (w < S) bit-exact, its
observable zero-padding creep included.

The numerics live in ops/reference.py: this module only contributes the tap
source (halo-extended slices instead of clamped shifts) and the
halo-exchanging box sum, so the two paths cannot drift.
"""

from __future__ import annotations

import torch

from sangnom_tpu_torch.ops.primitives import KernelSpec, calc_sangnom
from sangnom_tpu_torch.ops.reference import (
    error_maps_from_taps,
    finalize_select_from_taps,
    smooth_scan,
)

# Halo exchanges since import (or since the caller last reset them).
HALO_EXCHANGES = {"kept": 0, "carry": 0, "row": 0}


def reset_exchanges() -> None:
    for k in HALO_EXCHANGES:
        HALO_EXCHANGES[k] = 0


def _shards(plane: torch.Tensor, n_space: int) -> torch.Tensor:
    """[N, H, S] -> the shard-local view [n_space, N, H, S // n_space]."""
    N, H, S = plane.shape
    return plane.view(N, H, n_space, S // n_space).permute(2, 0, 1, 3)


def _unshard(x: torch.Tensor) -> torch.Tensor:
    """[n_space, N, H, W_loc] -> [N, H, n_space * W_loc]."""
    n, N, H, w = x.shape
    return x.permute(1, 2, 0, 3).reshape(N, H, n * w)


def _exchange_halo(x: torch.Tensor, radius: int, kind: str) -> torch.Tensor:
    """[n_space, ..., W_loc] -> [n_space, ..., W_loc + 2*radius]: each shard
    gets its neighbours' edge columns; the global boundaries get edge
    replication (clamp semantics, reference loadPixel src/SangNom2.cpp:25-34).
    ``radius`` <= W_loc: the exchange reaches only the adjacent shard."""
    HALO_EXCHANGES[kind] += 1
    edge_shape = x.shape[1:-1] + (radius,)
    first_l = x[:1, ..., :1].expand((1,) + edge_shape)
    last_r = x[-1:, ..., -1:].expand((1,) + edge_shape)
    left = torch.cat([first_l, x[:-1, ..., -radius:]], dim=0)
    right = torch.cat([x[1:, ..., :radius], last_r], dim=0)
    return torch.cat([left, x, right], dim=-1)


def _taps7_ext(ext: torch.Tensor, w_loc: int) -> list[torch.Tensor]:
    """Plain shifted slices of a halo-extended array (radius 3)."""
    return [ext[..., 3 + k: 3 + k + w_loc] for k in range(-3, 4)]


def _pair_taps_halo(curr_ext, nxt_ext, w_loc: int, spec: KernelSpec):
    """The sharded tap source: the (taps, preds) contract of
    ops.reference.pair_taps, from halo-extended rows."""
    cm3, cm2, cm1, c0, cp1, cp2, cp3 = _taps7_ext(curr_ext, w_loc)
    nm3, nm2, nm1, n0, np1, np2, np3 = _taps7_ext(nxt_ext, w_loc)
    fwd1 = calc_sangnom(cm1, c0, cp1, spec)
    fwd2 = calc_sangnom(np1, n0, nm1, spec)
    bwd1 = calc_sangnom(cp1, c0, cm1, spec)
    bwd2 = calc_sangnom(nm1, n0, np1, spec)
    taps = (cm3, cm2, cm1, c0, cp1, cp2, cp3, nm3, nm2, nm1, n0, np1, np2, np3)
    return taps, (fwd1, fwd2, bwd1, bwd2)


def smooth_sharded_scan(raw: torch.Tensor, spec: KernelSpec) -> torch.Tensor:
    """The scan arm's smoothing, with the contract of
    fused_smooth.smooth_sharded_chunked: raw maps [n_space, C, bufH+1,
    W_loc] -> smoothed rows [n_space, C, bufH-1, W_loc], the shared
    `smooth_scan` recursion with a 3-column halo exchange at every row."""
    w_loc = raw.shape[-1]

    def hbox_halo(line):  # [n_space, C, W_loc], one exchange per row
        t = _taps7_ext(_exchange_halo(line, 3, "row"), w_loc)
        h = t[0]
        for tp in t[1:]:
            h = h + tp
        return h

    sm = smooth_scan(raw.permute(2, 0, 1, 3), spec, hbox_fn=hbox_halo)
    return sm.permute(1, 2, 0, 3)


def _taps_shards(kept: torch.Tensor, spec: KernelSpec, n_space: int):
    """Each shard's pixel taps of every kept pair, from one 3-column kept
    exchange: (taps, preds) [n, N, bufH-1, W_loc] each."""
    local = _shards(kept.to(spec.acc_dtype), n_space)  # [n, N, bufH, W_loc]
    keptx = _exchange_halo(local, 3, "kept")  # one exchange for pixel taps
    return _pair_taps_halo(keptx[:, :, :-1], keptx[:, :, 1:], local.shape[-1], spec)


def _raw_shards(taps, preds, n_space: int, plane_width: int | None) -> torch.Tensor:
    """The 9 raw maps [n, 9, N, bufH+1, W_loc] of the kept pairs: zero rows
    0 and bufH, zero at global columns >= ``plane_width``."""
    maps = error_maps_from_taps(taps, preds)  # [9, n, N, bufH-1, W_loc]
    _, n, N, rows, w_loc = maps.shape
    if plane_width is not None:
        # zero-defined raw padding beyond the TRUE plane width (global cols)
        gcol = torch.arange(n * w_loc, device=maps.device).view(1, n, 1, 1, w_loc)
        maps = maps.masked_fill(gcol >= plane_width, 0)
    raw = maps.new_zeros((n, 9, N, rows + 2, w_loc))  # zero rows 0, bufH
    raw[:, :, :, 1:rows + 1] = maps.transpose(0, 1)
    return raw


def prepare_chunked_plain(kept: torch.Tensor, spec: KernelSpec, n_space: int,
                          plane_width: int | None = None) -> torch.Tensor:
    """Plain version of the chunked route's prepare kernel
    (``shard_kernel.prepare``): kept fields [N, bufH, S] -> raw maps
    [9, N, bufH+1, S] in the accumulator dtype."""
    taps, preds = _taps_shards(kept, spec, n_space)
    raw = _raw_shards(taps, preds, n_space, plane_width)
    n, _, N, rows, w_loc = raw.shape
    return raw.permute(1, 2, 3, 0, 4).reshape(9, N, rows, n * w_loc)


def _finalize_shards(taps, preds, bufs, aaf, spec, out_dtype) -> torch.Tensor:
    """The priority select from per-shard taps and smoothed maps ``bufs``
    [9, n, N, bufH-1, W_loc] -> interpolated rows [N, bufH-1, S]."""
    res = finalize_select_from_taps(taps, preds, bufs, aaf, spec)
    return _unshard(res).to(out_dtype)


def finalize_chunked_plain(kept: torch.Tensor, sm: torch.Tensor, aaf, spec: KernelSpec,
                           n_space: int, offsets=None) -> torch.Tensor:
    """Plain version of the chunked route's finalize kernel
    (``shard_kernel.finalize``): kept fields [N, bufH, S] and smoothed maps
    [9, N, bufH-1, S] -> interpolated rows [N, bufH-1, S] (kept's dtype),
    or with ``offsets`` the woven plane [N, 2*bufH, S]."""
    from sangnom_tpu_torch.ops.sangnom import weave_assemble

    N, bufH, S = kept.shape
    taps, preds = _taps_shards(kept, spec, n_space)
    bufs = sm.reshape(9, N, bufH - 1, n_space, S // n_space).permute(0, 3, 1, 2, 4)
    interp = _finalize_shards(taps, preds, bufs, aaf, spec, kept.dtype)
    return interp if offsets is None else weave_assemble(kept, interp, offsets)


def interpolate_field_width_sharded(
    kept: torch.Tensor, aaf, spec: KernelSpec, n_space: int,
    plane_width: int | None = None, smooth: str = "scan",
) -> torch.Tensor:
    """Kept fields [N, bufH, S] (storage dtype, S = n_space * W_loc, edge-
    padded past ``plane_width``) -> interpolated rows [N, bufH-1, S], each
    of the ``n_space`` column shards computed from its own columns and
    exchanged halos; bit-exact to the unsharded paths.

    ``smooth``: "scan" = a 3-column halo exchange per row around the shared
    `smooth_scan` (the parity target); "chunked" = K5 smoothing
    (fused_smooth.smooth_sharded_chunked) between plain prepare and
    finalize, and on the card the prepare kernel, K5 and the finalize
    kernel (fused_smooth.interpolate_chunked); "fused" / "fused_noweave" =
    K4, prepare + smoothing + finalize in one kernel (fused_smooth.
    interpolate_fused_full).  K4 needs shards of at least 9 columns and
    K5 more than 6; thinner shards take the next arm down.
    """
    N, bufH, S = kept.shape
    w_loc = S // n_space
    if smooth in ("fused", "fused_noweave") and bufH >= 2 and w_loc >= 9:
        from sangnom_tpu_torch.parallel.fused_smooth import interpolate_fused_full

        return interpolate_fused_full(kept, aaf, spec, n_space, plane_width)
    if bufH < 2:
        return kept.new_zeros((N, 0, S))
    chunked = smooth in ("chunked", "fused", "fused_noweave") and w_loc > 6
    if chunked and kept.device.type == "cuda":
        from sangnom_tpu_torch.parallel.fused_smooth import interpolate_chunked

        return interpolate_chunked(kept, aaf, spec, n_space, plane_width)
    taps, preds = _taps_shards(kept, spec, n_space)
    raw = _raw_shards(taps, preds, n_space, plane_width)

    if chunked:
        # "fused" lands here only for the thin-shard fallback above
        from sangnom_tpu_torch.parallel.fused_smooth import smooth_sharded_chunked

        smoother = smooth_sharded_chunked
    else:
        smoother = smooth_sharded_scan
    sm = smoother(raw.view(n_space, 9 * N, bufH + 1, w_loc), spec)
    bufs = sm.reshape(n_space, 9, N, bufH - 1, w_loc).transpose(0, 1)
    del raw
    return _finalize_shards(taps, preds, bufs, aaf, spec, kept.dtype)
