"""The width-sharded kernels K4 and K5, and their plain versions.

The influence cone: the smoothing recursion propagates horizontal influence
exactly 3 columns per row (reference src/SangNom2.cpp:129-152), so a shard
holding a halo of the smoothed carry row computes R rows with no exchange:
the halo's validity shrinks by 3 columns a row and reaches the shard's own
width after R rows.

  ``smooth_sharded_chunked``  K5 (TPU package ``parallel/fused_smooth.py:116``,
  ``smooth_full_width``       body ``_smooth_kernel``): the smoothing only;
                              the chunked route (``interpolate_chunked``)
                              runs it between the prepare and finalize
                              kernels.
  ``interpolate_fused_full``  K4 (``_fused_full``, body ``_full_kernel``):
  ``deinterlace_fused_full``  prepare, smoothing and finalize in one kernel;
                              the second also writes the woven plane
                              (offset 0, 1 or per frame).

On a CPU tensor each wrapper runs its plain version (``*_plain``): a chunk
loop with a PyTorch step and host-side halo exchanges.  Per plane pass it
makes one exchange of the field's data (K5: also of its raw maps), then one
carry-row exchange per chunk of R rows (parallel.width_sharded.
HALO_EXCHANGES counts both); the halo is 3R+6 kept columns (K4, which also
computes the raw maps from them) or 3R+3 carry and raw columns (K5).
Boundary semantics: the reference's box clamps its taps at the buffer
stride S, the global sharded width; edge-replicated halos on the boundary
shards realize the clamp, and the recursively computed row is
re-replicated at every step.

On a CUDA tensor each wrapper launches its kernel (parallel.shard_kernel)
or raises: one launch a plane pass, the shards of a field (K4) or of a map
row (K5) in one thread-block cluster that exchanges the carry's 3R-column
halo through distributed shared memory every R rows, with no host-side
exchange; kept rows and raw maps are read in place from the whole plane.  A
mesh row of more than ``shard_kernel.MAX_CLUSTER`` shards runs the same
kernels one launch a chunk.  Results do not depend on ``chunk_rows`` (R);
left None, each route takes its own default (``PLAIN_ROWS``,
``shard_kernel.CLUSTER_ROWS``).
"""

from __future__ import annotations

import torch

from sangnom_tpu_torch.ops.primitives import KernelSpec, smooth_writeback
from sangnom_tpu_torch.ops.reference import (
    _hbox7,
    error_maps_from_taps,
    finalize_select_from_taps,
    pair_taps,
)
from sangnom_tpu_torch.ops.sangnom import Offset
from sangnom_tpu_torch.parallel.width_sharded import _exchange_halo, _shards, _unshard

_MAPS = 9
# Rows per chunk of the plain versions when the caller gives none (the TPU
# design's); the kernels take shard_kernel.CLUSTER_ROWS.
PLAIN_ROWS = 16


# --- K5: chunked smoothing --------------------------------------------------

def chunk_geometry_k5(W_loc: int, n_steps: int, chunk_rows: int | None = None):
    """(R, HK): rows per chunk and the halo width of the plain chunked
    smoothing (``chunk_rows`` None: ``PLAIN_ROWS``)."""
    R = max(1, min(chunk_rows or PLAIN_ROWS, n_steps, (W_loc - 3) // 3 if W_loc > 6 else 1))
    return R, 3 * R + 3


def _smooth_chunk_plain(smx, rawx, out, base: int, steps: int, HK: int,
                        spec: KernelSpec) -> None:
    """The plain K5 step: smooths rows base..base+steps-1 of every shard from
    the exchanged carry ``smx`` [n, C, W_ext] and raw maps ``rawx``
    [n, C, bufH+1, W_ext] into ``out`` [n, C, bufH-1, W_loc]."""
    W_loc = out.shape[-1]
    sm = smx
    for s in range(base, base + steps):
        line = sm + rawx[:, :, 1 + s] + rawx[:, :, 2 + s]  # vertical 3-sum
        sm = smooth_writeback(_hbox7(line), spec)  # taps clamp at W_ext
        # re-replicate the computed row's halo on the global boundary shards
        sm[0, :, :HK] = sm[0, :, HK: HK + 1]
        sm[-1, :, HK + W_loc:] = sm[-1, :, HK + W_loc - 1: HK + W_loc]
        out[:, :, s] = sm[..., HK: HK + W_loc]


def _chunked(raw: torch.Tensor, spec: KernelSpec, chunk_rows: int | None):
    n, C, bufHp1, W_loc = raw.shape
    n_steps = bufHp1 - 2
    if n_steps <= 0:
        return raw.new_zeros((n, C, 0, W_loc))
    if W_loc <= 6:
        raise ValueError(f"chunked smoothing needs shards wider than 6 columns, "
                         f"got {W_loc}")
    R, HK = chunk_geometry_k5(W_loc, n_steps, chunk_rows)
    rawx = _exchange_halo(raw, HK, "kept")  # once for the whole plane
    out = raw.new_empty((n, C, n_steps, W_loc))
    sm = raw.new_zeros((n, C, W_loc))  # smoothed "row 0" seed
    for base in range(0, n_steps, R):
        steps = min(R, n_steps - base)
        _smooth_chunk_plain(_exchange_halo(sm, HK, "carry"), rawx, out, base, steps, HK,
                            spec)
        sm = out[:, :, base + steps - 1]
    return out


def smooth_sharded_chunked_plain(raw: torch.Tensor, spec: KernelSpec,
                                 chunk_rows: int | None = None) -> torch.Tensor:
    """Plain version of `smooth_sharded_chunked`."""
    return _chunked(raw, spec, chunk_rows)


def smooth_sharded_chunked(raw: torch.Tensor, spec: KernelSpec,
                           chunk_rows: int | None = None) -> torch.Tensor:
    """Width-sharded recursive smoothing, R rows per launch.

    raw: [n_space, C, bufH+1, W_loc] shard-local raw maps in the accumulator
    dtype (C = maps x fields, independent rows; buffer rows 0 and bufH are
    zero).  Returns the smoothed rows [n_space, C, bufH-1, W_loc], the
    contract of ops.reference.smooth_scan with the rows moved to axis 2."""
    if raw.dim() != 4 or raw.dtype != spec.acc_dtype:
        raise ValueError(f"chunked smoothing: raw must be [n, C, bufH+1, W_loc] "
                         f"{spec.acc_dtype}, got {tuple(raw.shape)} {raw.dtype}")
    if raw.device.type == "cpu":
        return smooth_sharded_chunked_plain(raw, spec, chunk_rows)
    n, C, bufHp1, W_loc = raw.shape
    if W_loc <= 6:
        raise ValueError(f"chunked smoothing needs shards wider than 6 columns, "
                         f"got {W_loc}")
    out = smooth_full_width(_unshard(raw), spec, n, chunk_rows)
    return _shards(out, n).contiguous()


def smooth_full_width(raw: torch.Tensor, spec: KernelSpec, n_space: int,
                      chunk_rows: int | None = None) -> torch.Tensor:
    """K5 on the whole plane: raw maps [C, bufH+1, S] (S = n_space * W_loc;
    rows 0 and bufH zero) -> smoothed rows [C, bufH-1, S], each row's
    ``n_space`` column shards smoothed apart with halo exchanges."""
    if raw.dim() != 3 or raw.dtype != spec.acc_dtype:
        raise ValueError(f"chunked smoothing: raw must be [C, bufH+1, S] "
                         f"{spec.acc_dtype}, got {tuple(raw.shape)} {raw.dtype}")
    if raw.device.type == "cpu":
        n = n_space
        sm = smooth_sharded_chunked_plain(_shards(raw, n), spec, chunk_rows)
        return _unshard(sm)
    from sangnom_tpu_torch.parallel import shard_kernel

    return shard_kernel.smooth_pass(raw.contiguous(), spec, n_space, chunk_rows)


def _chunked_route(kept, offsets, aaf, spec, n_space, plane_width, chunk_rows):
    from sangnom_tpu_torch.parallel import shard_kernel

    N, bufH, S = kept.shape
    kept = kept.contiguous()
    raw = shard_kernel.prepare(kept, spec, S if plane_width is None else plane_width)
    sm = shard_kernel.smooth_pass(raw.view(_MAPS * N, bufH + 1, S), spec, n_space,
                                  chunk_rows)
    del raw
    return shard_kernel.finalize(kept, sm.view(_MAPS, N, bufH - 1, S), aaf, spec, offsets)


def _chunked_route_plain(kept, offsets, aaf, spec, n_space, plane_width, chunk_rows):
    from sangnom_tpu_torch.parallel.width_sharded import (
        finalize_chunked_plain, prepare_chunked_plain)

    N, bufH, S = kept.shape
    raw = prepare_chunked_plain(kept, spec, n_space, plane_width)
    sm = _unshard(smooth_sharded_chunked_plain(
        _shards(raw.view(_MAPS * N, bufH + 1, S), n_space), spec, chunk_rows))
    return finalize_chunked_plain(kept, sm.view(_MAPS, N, bufH - 1, S), aaf, spec,
                                  n_space, offsets)


def interpolate_chunked(kept: torch.Tensor, aaf, spec: KernelSpec, n_space: int,
                        plane_width: int | None = None,
                        chunk_rows: int | None = None) -> torch.Tensor:
    """The chunked route on a CUDA tensor: kept fields [N, bufH, S] ->
    interpolated rows [N, bufH-1, S] by three launches a plane pass, the
    prepare kernel (raw maps [9, N, bufH+1, S]), K5 and the finalize
    kernel."""
    return _chunked_route(kept, None, aaf, spec, n_space, plane_width, chunk_rows)


def deinterlace_chunked(kept: torch.Tensor, offsets: Offset, aaf, spec: KernelSpec,
                        n_space: int, plane_width: int | None = None,
                        chunk_rows: int | None = None) -> torch.Tensor:
    """The chunked route's weave on a CUDA tensor: kept fields [N, bufH, S]
    -> the woven plane [N, 2*bufH, S] (``offsets`` 0, 1 or per frame),
    written by the finalize kernel."""
    return _chunked_route(kept, _offsets(offsets, kept), aaf, spec, n_space,
                          plane_width, chunk_rows)


def interpolate_chunked_plain(kept, aaf, spec, n_space, plane_width=None, chunk_rows=None):
    """Plain version of `interpolate_chunked`: its three stages' plain
    twins (``width_sharded.prepare_chunked_plain``, the plain chunk loop on
    the whole plane, ``width_sharded.finalize_chunked_plain``)."""
    return _chunked_route_plain(kept, None, aaf, spec, n_space, plane_width, chunk_rows)


def deinterlace_chunked_plain(kept, offsets, aaf, spec, n_space, plane_width=None,
                              chunk_rows=None):
    """Plain version of `deinterlace_chunked`."""
    return _chunked_route_plain(kept, _offsets(offsets, kept), aaf, spec, n_space,
                                plane_width, chunk_rows)


# --- K4: fused prepare + smoothing + finalize ---------------------------------

def chunk_geometry_k4(W_loc: int, n_tot: int, chunk_rows: int | None = None):
    """(R, HALO): rows per chunk and the halo width of the plain fused step
    (``chunk_rows`` None: ``PLAIN_ROWS``)."""
    R = max(1, min(chunk_rows or PLAIN_ROWS, n_tot, (W_loc - 6) // 3))
    return R, 3 * R + 6


def _signed(t: torch.Tensor) -> torch.Tensor:
    """A bit-identical view CUDA can index-assign (it has no uint16 copy
    through advanced indexing)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _full_chunk_plain(keptx, smx, out, offsets, base: int, steps: int,
                      HALO: int, w_glob: int, aaf, spec: KernelSpec):
    """The plain K4 step over global steps base..base+steps-1: for each step
    s < bufH-1 the raw maps of kept pairs (s, s+1) and (s+1, s+2), zeroed at
    global columns >= ``w_glob`` (the second also at the last step), the
    vertical sum with the carried row, the boundary line re-replicated, the
    box, writeback and the priority select; the central columns go to
    ``out`` (woven rows per ``offsets``, or plain interpolated rows when it
    is None).  ``keptx`` [n, N, bufH, W_ext] (storage dtype), ``smx``
    [n, N, 9, W_ext].  Returns the last smoothed row's central columns."""
    acc = spec.acc_dtype
    n, N, bufH, W_ext = keptx.shape
    W_loc = W_ext - 2 * HALO
    n_steps = bufH - 1
    gcol = (torch.arange(n, device=keptx.device)[:, None] * W_loc - HALO
            + torch.arange(W_ext, device=keptx.device))
    beyond = (gcol >= w_glob).view(n, 1, 1, W_ext)  # [n, 1(N), 1(map), W_ext]

    def raw_of(a, b):
        taps, preds = pair_taps(keptx[:, :, a].to(acc), keptx[:, :, b].to(acc), spec)
        maps = error_maps_from_taps(taps, preds).transpose(0, 2).transpose(0, 1)
        return maps.masked_fill(beyond, 0), taps, preds  # maps [n, N, 9, W_ext]

    fidx = torch.arange(N, device=keptx.device)
    dst = _signed(out)

    def put(row, val):  # val [n, N, W_ext] -> the central columns of out rows
        v = _signed(val)[..., HALO: HALO + W_loc].permute(1, 0, 2).reshape(N, -1)
        dst[fidx, row] = v

    off = (torch.full((N,), offsets, device=keptx.device, dtype=torch.long)
           if isinstance(offsets, int) else offsets)  # None: no weave
    sm = smx
    for s in range(base, base + steps):
        kept0 = keptx[:, :, s]
        if off is not None:
            put(2 * s + off, kept0)
            if s == bufH - 1:  # the bottom missing line of offset 0
                put(torch.where(off == 0, 2 * bufH - 1, 2 * s + off), kept0)
            if s == 0:  # the top missing line of offset 1
                put(torch.where(off == 1, 0, off), kept0)
        if s >= n_steps:
            continue
        raw, taps, preds = raw_of(s, s + 1)
        if s < n_steps - 1:
            raw_next = raw_of(s + 1, s + 2)[0]
        else:
            raw_next = torch.zeros_like(raw)
        line = (sm + raw) + raw_next
        # the box's clamp at the global 0/S edges
        line[0, ..., :HALO] = line[0, ..., HALO: HALO + 1]
        line[-1, ..., HALO + W_loc:] = line[-1, ..., HALO + W_loc - 1: HALO + W_loc]
        sm = smooth_writeback(_hbox7(line), spec)
        res = finalize_select_from_taps(taps, preds, sm.permute(2, 0, 1, 3), aaf, spec)
        res = res.to(keptx.dtype)
        if off is None:
            put(torch.full((N,), s, device=keptx.device, dtype=torch.long), res)
        else:
            put(2 * s + 1 + off, res)
    return sm[..., HALO: HALO + W_loc]


def _fused_full(kept: torch.Tensor, aaf, spec: KernelSpec, n_space: int,
                plane_width: int | None, chunk_rows: int | None, offsets):
    N, bufH, S = kept.shape
    W_loc = S // n_space
    weave = offsets is not None
    n_steps = bufH - 1
    w_glob = S if plane_width is None else plane_width
    # the weave covers one more global step than interpolation, for the
    # last kept row
    n_tot = bufH if weave else n_steps
    R, HALO = chunk_geometry_k4(W_loc, n_tot, chunk_rows)
    keptx = _exchange_halo(_shards(kept, n_space), HALO, "kept")  # storage dtype
    out = torch.empty((N, 2 * bufH if weave else n_steps, S), dtype=kept.dtype,
                      device=kept.device)
    sm = torch.zeros((n_space, N, _MAPS, W_loc), dtype=spec.acc_dtype,
                     device=kept.device)
    for base in range(0, n_tot, R):
        smx = _exchange_halo(sm, HALO, "carry")
        sm = _full_chunk_plain(keptx, smx, out, offsets, base, min(R, n_tot - base),
                               HALO, w_glob, aaf, spec)
    return out


def _check_kept(kept: torch.Tensor, spec: KernelSpec, n_space: int) -> None:
    want = torch.float32 if spec.is_float else (
        torch.uint8 if spec.mask == 0xFF else torch.uint16)
    if kept.dim() != 3 or kept.dtype != want:
        raise ValueError(f"fused sharded kernel: kept must be [N, bufH, S] {want}, "
                         f"got {tuple(kept.shape)} {kept.dtype}")
    if not kept.is_contiguous():
        raise ValueError("fused sharded kernel: kept must be contiguous")
    N, bufH, S = kept.shape
    if S % n_space or S // n_space < 9:
        raise ValueError(f"fused sharded kernel: width {S} over {n_space} shards "
                         "needs shards of at least 9 columns")
    if bufH < 2:
        raise ValueError("fused sharded kernel: needs at least 2 kept rows")


def _offsets(offsets: Offset, kept: torch.Tensor):
    if isinstance(offsets, int):
        if offsets not in (0, 1):
            raise ValueError(f"fused sharded kernel: offset {offsets} not in (0, 1)")
        return offsets
    offs = torch.as_tensor(offsets, device=kept.device).long()
    if offs.shape != (kept.shape[0],):
        raise ValueError(f"fused sharded kernel: offsets {tuple(offs.shape)} for "
                         f"{kept.shape[0]} fields")
    return offs


def _full(kept, offsets, aaf, spec, n_space, plane_width, chunk_rows, plain):
    _check_kept(kept, spec, n_space)
    if plain or kept.device.type == "cpu":
        return _fused_full(kept, aaf, spec, n_space, plane_width, chunk_rows, offsets)
    from sangnom_tpu_torch.parallel import shard_kernel

    w_glob = kept.shape[2] if plane_width is None else plane_width
    return shard_kernel.full_pass(kept, offsets, aaf, spec, n_space, w_glob, chunk_rows)


def interpolate_fused_full(kept: torch.Tensor, aaf, spec: KernelSpec,
                           n_space: int, plane_width: int | None = None,
                           chunk_rows: int | None = None) -> torch.Tensor:
    """Kept fields [N, bufH, S] (storage dtype, contiguous) -> interpolated
    rows [N, bufH-1, S], over ``n_space`` column shards of at least 9
    columns: on the card one K4 launch (a chunk of R rows per launch above
    ``shard_kernel.MAX_CLUSTER`` shards); the plain version makes one kept
    exchange, then one chunk and one carry exchange per R rows."""
    return _full(kept, None, aaf, spec, n_space, plane_width, chunk_rows, False)


def interpolate_fused_full_plain(kept, aaf, spec, n_space, plane_width=None,
                                 chunk_rows=None):
    """Plain version of `interpolate_fused_full`."""
    return _full(kept, None, aaf, spec, n_space, plane_width, chunk_rows, True)


def deinterlace_fused_full(kept: torch.Tensor, offsets: Offset, aaf,
                           spec: KernelSpec, n_space: int,
                           plane_width: int | None = None,
                           chunk_rows: int | None = None) -> torch.Tensor:
    """The sharded weave: kept fields [N, bufH, S] -> the complete plane
    [N, 2*bufH, S], kept and interpolated rows interleaved per ``offsets``
    (an int 0/1, or a per-frame [N] tensor of 0/1) with the boundary line
    duplicated, written by K4 straight into the full-width plane."""
    return _full(kept, _offsets(offsets, kept), aaf, spec, n_space,
                 plane_width, chunk_rows, False)


def deinterlace_fused_full_plain(kept, offsets, aaf, spec, n_space,
                                 plane_width=None, chunk_rows=None):
    """Plain version of `deinterlace_fused_full`."""
    return _full(kept, _offsets(offsets, kept), aaf, spec, n_space,
                 plane_width, chunk_rows, True)
