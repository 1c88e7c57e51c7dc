"""Width sharding across the devices of one process: a mesh row whose
``space`` slots name different devices.

Slot q of a row has its own device, its own tensors and its own launches.
``sangnom2_impl`` runs on the row's first slot (the home device), and the
interpolation it is given (``sharded_interp``) does, for each plane pass:

  scatter   cut the kept field [N, bufH, S] into per-slot slabs: slot q owns
            columns [q*W_loc, (q+1)*W_loc) and its slab adds a halo on each
            side, clipped at 0 and S (the boundary slots have no outer
            halo); the own columns go from home to the slot's device.
  exchange  ``exchange_halo_across``: each slot's halo columns take its
            neighbours' edge columns, copied device to device, never
            through the host: once for the kept slabs ("kept"), then once
            between chunks of R rows for the carried smoothed row ("carry"),
            or at every row ("row", the scan arm).
  per slot  the arm's steps on the slot's slab, one shard a launch.
  gather    each slot's own columns back to home.

The arms, as the TPU package has them (``sangnom_tpu/parallel``):

  ``fused_pass``    K4 (``smooth="fused"`` / ``"fused_noweave"``): per chunk
                    of R rows one ``shard_kernel.full_chunk`` launch a slot,
                    then a carry exchange of the halo columns of each
                    slot's carried row; the weave is written by the launches.
  ``chunked_pass``  the K5 route (``"chunked"``): per slot the prepare
                    kernel on its slab, ``shard_kernel.smooth_chunk`` a chunk
                    (seeded from ``out`` row base-1, whose halo columns the
                    carry exchange refreshes) and the finalize kernel, which
                    weaves.
  ``scan_pass``     the per-row 3-column exchange around the shared
                    ``smooth_scan`` recursion (the parity target; plain
                    PyTorch, as the TPU package's).

Why a slab is exact: at a cut the steps clamp their taps and their box at
the slab's edge, which is wrong there.  The wrong values start at most 3
columns in (the raw maps' taps) and move 3 columns a smoothed row, so after
R rows they reach 3R+3 columns; the halo is 3R+6 columns (K4, the plain K4's
own) or 3R+3 (K5 route), and the slot's own columns stay exact.  The carry
exchange then makes the whole carried row exact again.  At a global edge
the slab's edge is the plane's, where the clamp is the reference's.

Counts: ``width_sharded.HALO_EXCHANGES`` per exchange, as the routes on one
device count theirs; ``PEER_BYTES`` the bytes that crossed slots, by kind
(the scatter to slots 1.., each exchange's halo columns, the gather from
slots 1..).  On a slot's CUDA tensor each step launches its kernel
(``shard_kernel``) or raises; on a CPU tensor it runs its plain twin, and
``plain=True`` runs the twins anywhere.  A failed copy or launch raises
RuntimeError naming the slot and its device: a row never falls back to one
device.  ``chunk_rows`` (R) changes no result; None takes
``shard_kernel.SLOT_ROWS`` (K4) or ``SLOT_ROWS_K5`` (the K5 route).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Sequence

import torch

from sangnom_tpu_torch.ops.primitives import KernelSpec, smooth_writeback
from sangnom_tpu_torch.ops.reference import (
    hbox7,
    error_maps_from_taps,
    finalize_select_from_taps,
    pair_taps,
)
from sangnom_tpu_torch.parallel import fused_smooth as fs
from sangnom_tpu_torch.parallel import shard_kernel
from sangnom_tpu_torch.ops.sangnom import weave_assemble
from sangnom_tpu_torch.parallel.width_sharded import HALO_EXCHANGES

_log = logging.getLogger(__name__)
_MAPS = 9

# Bytes that crossed slots since import (or since the caller last reset
# them), by kind: "scatter" (home to slots 1..), "kept" / "carry" / "row"
# (halo columns of each exchange), "gather" (slots 1.. to home).
PEER_BYTES = {"scatter": 0, "kept": 0, "carry": 0, "row": 0, "gather": 0}


def reset_peer_bytes() -> None:
    for k in PEER_BYTES:
        PEER_BYTES[k] = 0


def k4_geometry(W_loc: int, n_steps: int, chunk_rows: int | None = None):
    """(R, halo) of ``fused_pass``: rows a chunk and the slab's halo 3R+6
    (<= W_loc, so a halo comes from the adjacent slot only)."""
    R = max(1, min(chunk_rows or shard_kernel.SLOT_ROWS, n_steps, (W_loc - 6) // 3))
    return R, 3 * R + 6


def k5_geometry(W_loc: int, n_steps: int, chunk_rows: int | None = None):
    """(R, halo) of ``chunked_pass``: rows a chunk and the halo 3R+3."""
    R = max(1, min(chunk_rows or shard_kernel.SLOT_ROWS_K5, n_steps, (W_loc - 3) // 3))
    return R, 3 * R + 3


@contextlib.contextmanager
def _slot(q: int, device, what: str):
    """Names the slot and its device in a failure of its copy or step."""
    try:
        yield
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(f"cross-device width sharding: slot {q} on {device}: "
                           f"{what} failed: {e}") from e


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A bit-identical view every device copies (uint16 as int16)."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _copy(q: int, device, dst: torch.Tensor, src: torch.Tensor, what: str) -> int:
    """dst <- src on or across devices (ordered against both devices'
    current streams by PyTorch) for slot q on ``device``; returns the bytes
    copied."""
    with _slot(q, device, f"{what} ({src.device} -> {dst.device})"):
        _bits(dst).copy_(_bits(src), non_blocking=True)
    return src.numel() * src.element_size()


def _span(q: int, n: int, W_loc: int, halo: int):
    """(x0, width, cl) of slot q's slab: its first global column, its
    columns and where its own columns start in it."""
    lo = q * W_loc
    x0 = lo - halo if q else 0
    x1 = lo + W_loc + (halo if q < n - 1 else 0)
    return x0, x1 - x0, lo - x0


def exchange_halo_across(parts: Sequence[torch.Tensor], radius: int, kind: str):
    """The list form of ``width_sharded._exchange_halo`` (and of the TPU
    package's ppermute halo): ``parts[q]`` is slot q's [..., hl + W_loc +
    hr] on its own device, hl = ``radius`` except on the first slot, hr =
    ``radius`` except on the last (no outer halo), radius <= W_loc.  Writes
    each slot's halo columns, in place, with its neighbours' edge own
    columns, device to device; counts one ``HALO_EXCHANGES[kind]`` and the
    bytes in ``PEER_BYTES[kind]``.  Returns ``parts``."""
    n = len(parts)
    HALO_EXCHANGES[kind] += 1
    if n == 1 or radius == 0:
        return parts
    for q in range(n):
        dst = parts[q]
        if q > 0:  # the left neighbour's own columns end before its right halo
            src = parts[q - 1]
            end = src.shape[-1] - radius
            PEER_BYTES[kind] += _copy(q, dst.device, dst[..., :radius],
                                      src[..., end - radius:end], f"{kind} halo from slot {q - 1}")
        if q < n - 1:  # the right neighbour's own columns start after its left halo
            src = parts[q + 1]
            PEER_BYTES[kind] += _copy(q, dst.device, dst[..., -radius:],
                                      src[..., radius:2 * radius], f"{kind} halo from slot {q + 1}")
    return parts


def _scatter(kept: torch.Tensor, devices, halo: int) -> list:
    """Each slot's slab of ``kept`` [N, bufH, S] on its device: the own
    columns from home, then one "kept" exchange for the halos."""
    N, bufH, S = kept.shape
    n = len(devices)
    W = S // n
    slabs = []
    for q, dev in enumerate(devices):
        _, width, cl = _span(q, n, W, halo)
        with _slot(q, dev, "slab allocation"):
            slab = torch.empty((N, bufH, width), dtype=kept.dtype, device=dev)
        moved = _copy(q, dev, slab[..., cl:cl + W], kept[..., q * W:(q + 1) * W], "scatter")
        if q:
            PEER_BYTES["scatter"] += moved
        slabs.append(slab)
    return exchange_halo_across(slabs, halo, "kept")


def _gather(parts, cls, W: int, home) -> torch.Tensor:
    """Each slot's own columns [..., cl:cl+W] of ``parts`` -> one tensor
    [..., n*W] on ``home``."""
    n = len(parts)
    out = torch.empty(parts[0].shape[:-1] + (n * W,), dtype=parts[0].dtype, device=home)
    for q, (part, cl) in enumerate(zip(parts, cls)):
        moved = _copy(q, part.device, out[..., q * W:(q + 1) * W], part[..., cl:cl + W],
                      "gather")
        if q:
            PEER_BYTES["gather"] += moved
    return out


def _geometry(kept: torch.Tensor, devices, min_w: int, what: str):
    N, bufH, S = kept.shape
    n = len(devices)
    if S % n or S // n < min_w or bufH < 2:
        raise ValueError(f"{what}: width {S} over {n} slots needs slots of at least "
                         f"{min_w} columns and 2 kept rows, got {tuple(kept.shape)}")
    return N, bufH, S, n, S // n


def _slot_offsets(offsets, kept: torch.Tensor, devices) -> list:
    """Per-slot weave offsets: None, 0 / 1, or the [N] tensor on each
    slot's device."""
    if offsets is None:
        return [None] * len(devices)
    offs = fs.check_offsets(offsets, kept)
    if isinstance(offs, int):
        return [offs] * len(devices)
    return [offs.to(dev) for dev in devices]


def _local_width(w_glob: int, x0: int, width: int) -> int:
    """The slab's raw-map width: columns left of the plane's true width."""
    return max(0, min(w_glob - x0, width))


# --- K4 ----------------------------------------------------------------------

def _k4_step(slab, out, offsets, gin, gout, lo: int, hi: int, w_glob: int, aaf,
             spec: KernelSpec, plain: bool) -> None:
    """One slot's K4 chunk, steps lo..hi-1 (the kernel's numbering)."""
    if not plain and slab.device.type != "cpu":
        shard_kernel.full_chunk(slab, out, offsets, gin, gout, lo, hi, aaf, spec, w_glob)
        return
    bufH = slab.shape[1]
    smx = gin if lo > 1 else torch.zeros_like(gin)
    # the weave's last global step writes the last kept row only
    steps = hi - lo + int(offsets is not None and hi == bufH)
    sm = fs._full_chunk_plain(slab[None], smx[None], out, offsets, lo - 1, steps, 0,
                              w_glob, aaf, spec)
    if hi < bufH:
        gout.copy_(sm[0])


def fused_pass(kept: torch.Tensor, offsets, aaf, spec: KernelSpec, devices,
               plane_width: int | None = None, chunk_rows: int | None = None,
               plain: bool = False) -> torch.Tensor:
    """K4 across slots: kept fields [N, bufH, S] on home -> the woven plane
    [N, 2*bufH, S] (``offsets`` 0, 1 or per field) or, with ``offsets``
    None, the interpolated rows [N, bufH-1, S], on home.  ``devices``: the
    slots' devices (a device may repeat); slots of at least 9 columns.
    Launches ceil((bufH-1) / R) K4 chunks a slot, one carry exchange
    between chunks."""
    N, bufH, S, n, W = _geometry(kept, devices, 9, "cross-device fused pass")
    R, halo = k4_geometry(W, bufH - 1, chunk_rows)
    w_glob = S if plane_width is None else plane_width
    offs = _slot_offsets(offsets, kept, devices)
    slabs = _scatter(kept, devices, halo)
    rows = bufH - 1 if offsets is None else 2 * bufH
    outs, carries, widths, cls = [], [], [], []
    for q, dev in enumerate(devices):
        x0, width, cl = _span(q, n, W, halo)
        with _slot(q, dev, "allocation"):
            outs.append(torch.empty((N, rows, width), dtype=kept.dtype, device=dev))
            carries.append([torch.empty((N, _MAPS, width), dtype=spec.acc_dtype, device=dev)
                            for _ in range(2)])
        widths.append(_local_width(w_glob, x0, width))
        cls.append(cl)
    spans = [(lo, min(lo + R, bufH)) for lo in range(1, bufH, R)]
    for k, (lo, hi) in enumerate(spans):
        gin = [c[(k + 1) & 1] for c in carries]
        if k:
            exchange_halo_across(gin, halo, "carry")
        for q, dev in enumerate(devices):
            with _slot(q, dev, f"K4 steps {lo}..{hi - 1}"):
                _k4_step(slabs[q], outs[q], offs[q], gin[q], carries[q][k & 1], lo, hi,
                         widths[q], aaf, spec, plain)
    _log.debug("fused pass: %d slots x %d chunks enqueued with no host wait (R %d, "
               "halo %d) on %s", n, len(spans), R, halo, [str(d) for d in devices])
    return _gather(outs, cls, W, kept.device)


# --- the K5 route ------------------------------------------------------------

def _slab_taps(slab: torch.Tensor, spec: KernelSpec):
    """(taps, preds) [N, bufH-1, W] of a slab's kept pairs, clamped at its
    edges."""
    x = slab.to(spec.acc_dtype)
    return pair_taps(x[:, :-1], x[:, 1:], spec)


def _slab_maps(taps, preds, w_glob: int) -> torch.Tensor:
    """The raw maps [9, N, bufH-1, W] of a slab's kept pairs, zero at its
    columns >= ``w_glob``."""
    maps = error_maps_from_taps(taps, preds)
    col = torch.arange(maps.shape[-1], device=maps.device)
    return maps.masked_fill(col >= w_glob, 0)


def _prepare(slab, spec: KernelSpec, w_glob: int, plain: bool) -> torch.Tensor:
    """The raw maps [9, N, bufH+1, W] of a slab, rows 0 and bufH zero (the
    prepare kernel, or its plain twin)."""
    if not plain and slab.device.type != "cpu":
        return shard_kernel.prepare(slab, spec, w_glob)
    N, bufH, W = slab.shape
    raw = torch.zeros((_MAPS, N, bufH + 1, W), dtype=spec.acc_dtype, device=slab.device)
    raw[:, :, 1:bufH] = _slab_maps(*_slab_taps(slab, spec), w_glob)
    return raw


def _smooth_step(raw, sm, base: int, steps: int, spec: KernelSpec, plain: bool) -> None:
    """One slot's K5 chunk: rows base..base+steps-1 of ``sm`` [C, bufH-1,
    W], seeded from its row base-1."""
    if not plain and raw.device.type != "cpu":
        shard_kernel.smooth_chunk(raw, sm, base, steps, spec)
        return
    seed = sm[:, base - 1] if base else sm.new_zeros((sm.shape[0], sm.shape[2]))
    fs._smooth_chunk_plain(seed[None], raw[None], sm[None], base, steps, 0, spec)


def _finalize(slab, sm, aaf, spec: KernelSpec, offsets, plain: bool) -> torch.Tensor:
    """The priority select of a slab from its smoothed maps ``sm`` [9, N,
    bufH-1, W], woven per ``offsets`` (the finalize kernel, or its plain
    twin)."""
    if not plain and slab.device.type != "cpu":
        return shard_kernel.finalize(slab, sm, aaf, spec, offsets)
    interp = finalize_select_from_taps(*_slab_taps(slab, spec), sm, aaf, spec).to(slab.dtype)
    return interp if offsets is None else weave_assemble(slab, interp, offsets)


def chunked_pass(kept: torch.Tensor, offsets, aaf, spec: KernelSpec, devices,
                 plane_width: int | None = None, chunk_rows: int | None = None,
                 plain: bool = False) -> torch.Tensor:
    """The K5 route across slots, with the contract of `fused_pass` (slots
    of more than 6 columns): per slot one prepare launch, ceil((bufH-1) /
    R) K5 chunks with a carry exchange between them, one finalize launch."""
    N, bufH, S, n, W = _geometry(kept, devices, 7, "cross-device chunked pass")
    n_steps = bufH - 1
    R, halo = k5_geometry(W, n_steps, chunk_rows)
    w_glob = S if plane_width is None else plane_width
    offs = _slot_offsets(offsets, kept, devices)
    slabs = _scatter(kept, devices, halo)
    raws, sms, cls = [], [], []
    for q, dev in enumerate(devices):
        x0, width, cl = _span(q, n, W, halo)
        with _slot(q, dev, "prepare"):
            raws.append(_prepare(slabs[q], spec, _local_width(w_glob, x0, width), plain)
                        .view(_MAPS * N, bufH + 1, width))
            sms.append(torch.empty((_MAPS * N, n_steps, width), dtype=spec.acc_dtype,
                                   device=dev))
        cls.append(cl)
    bases = range(0, n_steps, R)
    for k, base in enumerate(bases):
        if k:
            exchange_halo_across([sm[:, base - 1] for sm in sms], halo, "carry")
        for q, dev in enumerate(devices):
            with _slot(q, dev, f"K5 rows {base}..{base + min(R, n_steps - base) - 1}"):
                _smooth_step(raws[q], sms[q], base, min(R, n_steps - base), spec, plain)
    del raws
    outs = []
    for q, dev in enumerate(devices):
        with _slot(q, dev, "finalize"):
            outs.append(_finalize(slabs[q], sms[q].view(_MAPS, N, n_steps, -1), aaf, spec,
                                  offs[q], plain))
    _log.debug("chunked pass: %d slots x %d chunks enqueued with no host wait (R %d, "
               "halo %d) on %s", n, len(bases), R, halo, [str(d) for d in devices])
    return _gather(outs, cls, W, kept.device)


# --- the scan arm ------------------------------------------------------------

def scan_pass(kept: torch.Tensor, aaf, spec: KernelSpec, devices,
              plane_width: int | None = None) -> torch.Tensor:
    """The scan arm across slots: kept fields [N, bufH, S] on home ->
    interpolated rows [N, bufH-1, S] on home, from one 3-column kept
    exchange and a 3-column exchange of the line at every row (the list
    form of ``width_sharded.smooth_sharded_scan``)."""
    N, bufH, S, n, W = _geometry(kept, devices, 3, "cross-device scan")
    w_glob = S if plane_width is None else plane_width
    slabs = _scatter(kept, devices, 3)
    taps, preds, raws, cls = [], [], [], []
    for q, dev in enumerate(devices):
        x0, width, cl = _span(q, n, W, 3)
        with _slot(q, dev, "raw maps"):
            t, p = _slab_taps(slabs[q], spec)
            maps = _slab_maps(t, p, _local_width(w_glob, x0, width))
            raw = maps.new_zeros((bufH + 1, _MAPS, N, width))  # zero rows 0, bufH
            raw[1:bufH] = maps.permute(2, 0, 1, 3)
        taps.append([v[..., cl:cl + W] for v in t])
        preds.append([v[..., cl:cl + W] for v in p])
        raws.append(raw)
        cls.append(cl)
    sm = [r.new_zeros(r.shape[1:]) for r in raws]
    rows: list = [[] for _ in devices]
    for b in range(1, bufH):  # smooth_scan's recursion, the line exchanged
        lines = [s + r[b] + r[b + 1] for s, r in zip(sm, raws)]
        exchange_halo_across(lines, 3, "row")
        for q, line in enumerate(lines):
            sm[q] = smooth_writeback(hbox7(line), spec)
            rows[q].append(sm[q][..., cls[q]:cls[q] + W])
    outs = []
    for q, dev in enumerate(devices):
        with _slot(q, dev, "finalize"):
            bufs = torch.stack(rows[q], dim=2)  # [9, N, bufH-1, W]
            outs.append(finalize_select_from_taps(taps[q], preds[q], bufs, aaf, spec)
                        .to(kept.dtype))
    return _gather(outs, [0] * n, W, kept.device)


# --- the router's entry --------------------------------------------------------

def sharded_interp(smooth: str, devices, chunk_rows: int | None = None):
    """The width-sharded interpolation for ``sangnom2_impl`` on a mesh row
    whose ``space`` slots are ``devices``, with the arm choice of
    ``width_sharded.interpolate_field_width_sharded``: K4 on slots of at
    least 9 columns, the K5 route on slots of more than 6, else the scan.
    The fused and chunked arms carry their weave."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def interp_fn(kept, aaf, spec, stride, plane_width=None):
        N, bufH, S = kept.shape
        if bufH < 2:
            return kept.new_zeros((N, 0, S))
        if smooth in ("fused", "fused_noweave") and S // n >= 9:
            return fused_pass(kept, None, aaf, spec, devices, plane_width, chunk_rows)
        if smooth in ("chunked", "fused", "fused_noweave") and S // n > 6:
            return chunked_pass(kept, None, aaf, spec, devices, plane_width, chunk_rows)
        return scan_pass(kept, aaf, spec, devices, plane_width)

    if smooth in ("fused", "chunked"):
        route = fused_pass if smooth == "fused" else chunked_pass

        def weave(kept, offsets, aaf, spec, stride, plane_width=None):
            return route(kept, offsets, aaf, spec, devices, plane_width, chunk_rows)

        weave.sharded = n
        interp_fn.fused_weave = weave
    return interp_fn


def sangnom2_across(clip, devices, chunk_rows: int | None = None, **kw):
    """``sangnom2_sharded`` with every width-sharded row on this route, even
    where its slots repeat a device (a test vehicle: on one card it drives
    every launch, halo copy and gather of the route).  ``devices``: one
    row's slot devices, or a [data][space] grid of them; ``kw``:
    sangnom2_sharded's filter arguments and ``smooth``."""
    from sangnom_tpu_torch.parallel.sharding import Mesh, _sharded

    grid = [list(r) for r in devices] if isinstance(devices[0], (list, tuple)) \
        else [list(devices)]
    return _sharded(clip, Mesh(grid), space_axis="space", across=True,
                    chunk_rows=chunk_rows, **kw)
