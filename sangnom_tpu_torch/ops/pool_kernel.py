"""The hand-written CUDA kernels of the pool-compat pass, and their plain twins.

The wrappers launch the kernels of ``csrc/pool.cu``, which replace the TPU
kernels of ``sangnom_tpu/ops/pool_carry.py``:

  ``smooth_pool_``   K3, ``_smooth_rows_pallas`` (body ``_pool_smooth_kernel``):
                     smooths pool rows 1..P-1 of a ``[9, P+1, S]`` pool in place.
  ``smooth_split3_`` K6, ``_smooth_rows_split3`` (body
                     ``_pool_smooth_tail_kernel``): the same smoothing on the
                     split carry ``(row0 [9, S], body [9, P-1, S], tail [9, S])``,
                     body in place.
  ``interp_fused``   K7, ``interp_field_pool_fused`` (body ``_pool_fused_kernel``):
                     a whole plane pass on the split carry, returning the
                     interpolated rows, as three launches on the current
                     stream: ``prepare_pool_`` (the kept pairs' raw maps into
                     the body), the K6 walk, ``finalize_pool`` (the
                     interpolated rows from the smoothed body).
  ``interp_batch``   the frame-parallel pass (the TPU package's fast path,
                     ``interp_field_pool_tm_batch``, which folds K frames'
                     pools into K3's walk): K frames, each with its own
                     pool, through the same three kernels as one launch each
                     over the batch: ``prepare_batch_``, ``smooth_batch_``
                     (the walk over 9K maps, one block a map) and
                     ``finalize_batch``.

A pool wider than one block's columns (S > ``MAX_COLS``, 8192) walks
in the same kernel's wide instantiation instead (`walk_plan`): a map's row split over ``k``
blocks, each owning ``W_loc`` columns plus a halo of ``H = 3R`` columns on
each inner side, the ``k`` blocks of a map in one thread-block cluster
that exchanges the carried row's halo through distributed shared memory
every R rows; K3, K6 and the batched walk take it alike, in place, with
the carry in its public layout.  Past 8 blocks, or where the
card cannot schedule the cluster, the same kernel runs one launch a chunk
of R rows on a copy of the raw rows.  `smooth_split_plain_` is the split
walk's plain twin.

Each wrapper checks shapes, dtypes and layout, then on a CPU tensor runs
its plain PyTorch twin (the ``*_plain`` functions) and on a CUDA tensor
launches its kernel or raises.  Kept rows may be strided (a field read in
place from its frame); columns must be contiguous.  The kernels are built
with the rest of the library (``ops.cuda_library``).  ``LAUNCHES``
counts launches per wrapper; a K7 pass counts one "prepare", one "split3"
and one "finalize", and so does a batched pass, whatever its frame count.
The wide walk counts under its wrapper's key ("smooth" for K3, "split3"
for K6, K7's walk and the batched walk), one a launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sangnom_tpu_torch.ops import cuda_library as cl
from sangnom_tpu_torch.ops.launch_geometry import (
    MAX_CLUSTER, MAX_COLS, ROW_THREADS, block_width, launch_shape, least_split, row_blocks)
from sangnom_tpu_torch.ops.primitives import KernelSpec, smooth_writeback
from sangnom_tpu_torch.utils.profiling import LAUNCH, span
from sangnom_tpu_torch.ops.reference import (
    error_maps_list,
    finalize_select_from_taps,
    hbox7,
    pair_taps,
    smooth_scan,
)

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"smooth": 0, "split3": 0, "prepare": 0, "finalize": 0}

_MAPS = 9
# Rows between the wide walk's halo exchanges.  The walk reads a raw row at
# its halo columns D rows ahead (csrc/pool.cu Prefetch::kDepth: 2 or 8)
# while the neighbour smooths that row in place, so a cluster barrier must
# fall between the two: R <= D + 1 for every build, which the launcher
# checks.
WIDE_ROWS = 3

cl.declare({
    "sno_pool_smooth_launch": "iiipiiip",  # dtype sse2 cols pool P S threads stream
    "sno_pool_smooth_split3_launch": "iiippp iiip",  # ... row0 body tail P S threads stream
    "sno_pool_prepare_launch": "iippq iiii p",  # dtype sse2 kept body pitch P R w S stream
    # dtype sse2 kept body interp pitch P R w S aaf stream
    "sno_pool_finalize_launch": "iippp q iiii dp",
    "sno_pool_smooth_batch_launch": "iiippp iiii p",  # ... row0 body tail maps P S threads stream
    "sno_pool_smooth_occupancy": "iiiiiP",  # dtype sse2 cols S threads blocks
    "sno_pool_prepare_batch_launch": "iippqq iiiii p",  # ... kept_fs pitch frames P R w S stream
    # ... kept_fs pitch interp_fs frames P R w S aaf stream
    "sno_pool_finalize_batch_launch": "iippp qqq iiiii dp",
    # dtype sse2 cols row0 in body tail | their map strides | maps k n S W_loc
    # H R base steps pitch cluster | threads smem stream
    "sno_pool_wide_launch": "iiipppp qqqq iiiiiiiiiii iip",
    "sno_pool_wide_query": "iiiiiiP",
})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_acc(name: str, spec: KernelSpec, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != spec.acc_dtype:
            raise ValueError(f"{name}: pool dtype {t.dtype} does not match the "
                             f"kernel spec {spec}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: pool tensors must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: pool tensors on different devices")


def _check_body(name: str, spec: KernelSpec, body: torch.Tensor) -> tuple[int, int]:
    """(P, S) of a valid body [9, P-1, S], or ValueError."""
    if body.dim() != 3 or body.shape[0] != _MAPS:
        raise ValueError(f"{name}: body must be [9, P-1, S], got {tuple(body.shape)}")
    _check_acc(name, spec, body)
    return body.shape[1] + 1, body.shape[2]


def _check_split(name: str, spec: KernelSpec, row0, body, tail) -> tuple[int, int]:
    """(P, S) of a valid split carry, or ValueError."""
    P, S = _check_body(name, spec, body)
    for t, what in ((row0, "row0"), (tail, "tail")):
        if tuple(t.shape) != (_MAPS, S):
            raise ValueError(f"{name}: {what} must be [9, {S}], got {tuple(t.shape)}")
    _check_acc(name, spec, body, row0, tail)
    return P, S


def _check_kept(name: str, spec: KernelSpec, kept: torch.Tensor, P: int, S: int,
                device: torch.device) -> None:
    """Kept rows [bufH_p, w] that a pass on a pool of P rows and stride S
    takes: storage dtype, columns contiguous, 2 <= bufH_p <= P, w <= S."""
    if kept.dim() != 2:
        raise ValueError(f"{name}: kept must be [bufH_p, w], got {tuple(kept.shape)}")
    if kept.device != device:
        raise ValueError(f"{name}: kept and pool on different devices")
    if kept.dtype != cl.storage_dtype(spec):
        raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel "
                         f"spec {spec}")
    bufH_p, w = kept.shape
    if kept.stride(1) != 1 or kept.stride(0) < w:
        raise ValueError(f"{name}: kept rows must be contiguous (column stride 1), "
                         f"got strides {kept.stride()}")
    if not 2 <= bufH_p <= P or not 1 <= w <= S:
        raise ValueError(f"{name}: kept {tuple(kept.shape)} does not fit the "
                         f"pool [9, {P + 1}, {S}] (needs 2 <= rows <= P)")


# --- the walk's plan: one block a map, or a map's row over a cluster ---------

class WalkPlan(NamedTuple):
    """How the walk over a pool of stride S runs (see ``csrc/pool.cu``).

    ``k`` blocks a map: 1 is the one-block walk (``pool_smooth_kernel``,
    S <= ``MAX_COLS``); above, its wide instantiation with shards of
    ``W_loc`` columns (the last one narrower where W_loc does not divide
    S) and a halo of ``H = 3R`` columns on each inner side.  ``cluster``:
    the k blocks of a map in one cluster, one launch; else ``launches``
    chunks of R steps.  ``pitch``: elements of a shared line row;
    ``smem_bytes``: a block's dynamic shared memory."""

    k: int
    W_loc: int
    H: int
    R: int
    cols: int
    threads: int
    cluster: bool
    launches: int
    pitch: int
    smem_bytes: int


def _line_pitch(W: int, cols: int) -> int:
    """csrc/pool.cu line_pitch: a shared line row of W columns."""
    return -(-(W + cols + 8) // 4) * 4


def walk_plan(S: int, n_steps: int, cluster: bool | None = None) -> WalkPlan:
    """The walk's plan for a pool of stride ``S`` over ``n_steps`` steps:
    the one-block walk up to ``MAX_COLS`` columns; past it the least
    ``k`` whose blocks (own columns and halos) fit one block's columns,
    on the cluster route up to ``MAX_CLUSTER`` blocks (``cluster`` None),
    else the chunk route."""
    if S <= MAX_COLS:
        cols, threads = launch_shape(S)
        return WalkPlan(1, S, 0, 0, cols, threads, False, 1, _line_pitch(S, cols),
                        2 * _line_pitch(S, cols) * 4)
    R = WIDE_ROWS
    H = 3 * R

    def cut(k):  # the last shard holds at least a halo
        W_loc = -(-S // k)
        return (k, W_loc, H) if S - (k - 1) * W_loc >= H else None

    k = least_split(cut, S, MAX_COLS, k0=2)
    W_loc = -(-S // k)
    W_c = block_width(k, W_loc, H)
    cluster = cluster is not False and k <= MAX_CLUSTER
    cols, threads = launch_shape(W_c)
    pitch = _line_pitch(W_c, cols)
    return WalkPlan(k, W_loc, H, R, cols, threads, cluster,
                    1 if cluster else -(-n_steps // R), pitch,
                    2 * pitch * 4 + (2 * 2 * H * 4 if cluster else 0))


def _wide_query(spec: KernelSpec, plan: WalkPlan, cluster: int, device) -> list:
    """The wide walk's build at ``plan``: registers, spill bytes, blocks a
    SM and clusters of ``cluster`` blocks resident at once (-1: none)."""
    code, sse2, _ = cl.launch_codes(spec, torch.device(device))
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device), cl.LAUNCH_LOCK:
        cl.check(cl.load().sno_pool_wide_query(code, sse2, plan.cols, plan.threads,
                                               plan.smem_bytes, cluster, out),
                 "pool wide walk occupancy query")
    return list(out)


def card_walk_plan(spec: KernelSpec, S: int, n_steps: int, device) -> WalkPlan:
    """`walk_plan` on the card: a cluster route the card cannot schedule
    (no cluster of k blocks resident) becomes the chunk route, decided
    before any launch."""
    plan = walk_plan(S, n_steps)
    if not plan.cluster or cl.cluster_fits(
            cl.device_index(torch.device(device)),
            ("pool", cl.launch_codes(spec, torch.device(device))[:2], plan.cols,
             plan.threads, plan.smem_bytes, plan.k),
            lambda: _wide_query(spec, plan, plan.k, device)[3]):
        return plan
    return walk_plan(S, n_steps, cluster=False)


def _walk(name: str, key: str, spec: KernelSpec, row0: torch.Tensor, body: torch.Tensor,
          tail: torch.Tensor, narrow, sp) -> None:
    """Launch the walk over ``body`` [maps, n, S] (rows contiguous, any map
    stride) seeded by ``row0`` [maps, S] with ``tail`` [maps, S] as input
    row n: ``narrow(lib, code, sse2, cols, threads, stream)`` launches the
    one-block walk; past one block's columns the wide walk runs here.  Adds
    one to ``LAUNCHES[key]`` a launch, and the grid to the launch span
    ``sp``."""
    maps, n, S = body.shape
    device = body.device
    plan = card_walk_plan(spec, S, n, device)
    if sp:
        sp.set(kernel="pool_smooth_kernel", blocks=maps * plan.k, threads=plan.threads,
               smem_bytes=plan.smem_bytes,
               bytes=(2 * body.numel() + row0.numel() + tail.numel()) * body.element_size())
    lib = cl.load()
    code, sse2, stream = cl.launch_codes(spec, device)
    if plan.k == 1:
        with torch.cuda.device(device), cl.LAUNCH_LOCK:
            err = narrow(lib, code, sse2, plan.cols, plan.threads, stream)
        cl.check(err, f"{name} launch")
        LAUNCHES[key] += 1
        return
    # the chunk route reads the raw rows from a copy: its launches have no
    # barrier between a neighbour's in-place write and this block's read
    src = body if plan.cluster else torch.empty(body.shape, dtype=body.dtype,
                                                device=device).copy_(body)
    chunks = [(0, n)] if plan.cluster else [
        (base, min(plan.R, n - base)) for base in range(0, n, plan.R)]
    with torch.cuda.device(device), cl.LAUNCH_LOCK:
        for base, steps in chunks:
            err = lib.sno_pool_wide_launch(
                code, sse2, plan.cols, row0.data_ptr(), src.data_ptr(), body.data_ptr(),
                tail.data_ptr(), row0.stride(0), src.stride(0), body.stride(0),
                tail.stride(0), maps, plan.k, n, S, plan.W_loc, plan.H, plan.R, base,
                steps, plan.pitch, int(plan.cluster), plan.threads, plan.smem_bytes,
                stream)
            cl.check(err, f"{name} launch", plan.k)
            LAUNCHES[key] += 1
    if sp:
        sp.set(launches=len(chunks))


def smooth_split_plain_(row0: torch.Tensor, body: torch.Tensor, tail: torch.Tensor,
                        spec: KernelSpec, plan: WalkPlan) -> torch.Tensor:
    """Plain twin of the wide walk with ``plan``'s geometry: ``body``
    [maps, n, S] smoothed in place, seeded by ``row0`` [maps, S], ``tail``
    [maps, S] as input row n.  Each of the k shards walks its own columns
    and its halo with the box clamped at the shard's edges, writes its own
    columns, and every R steps (the cluster route; each launch of R steps,
    from the rows already written, on the chunk route) takes its halo from
    its neighbours; the raw rows are read as they were before the walk.
    Returns ``body``."""
    maps, n, S = body.shape
    k, W_loc, H, R = plan.k, plan.W_loc, plan.H, plan.R
    spans = []
    for q in range(k):
        lo, hi = q * W_loc, min((q + 1) * W_loc, S)
        g0, g1 = max(lo - H, 0), min(hi + H, S)
        spans.append((g0, g1, lo - g0, hi - g0))
    raw = torch.cat([body, tail[:, None]], dim=1).clone()  # input rows 0..n
    hs = [row0[:, g0:g1].clone() for g0, g1, _, _ in spans]
    for t in range(n):
        if t and t % R == 0:  # the exchange: every column of the carried row exact
            full = body[:, t - 1]
            hs = [full[:, g0:g1].clone() for g0, g1, _, _ in spans]
        for q, (g0, g1, cl, cr) in enumerate(spans):
            line = (hs[q] + raw[:, t, g0:g1]) + raw[:, t + 1, g0:g1]
            hs[q] = smooth_writeback(hbox7(line), spec)
            body[:, t, g0 + cl:g0 + cr] = hs[q][:, cl:cr]
    return body


# --- K3 --------------------------------------------------------------------

def smooth_pool_plain_(pool: torch.Tensor, spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `smooth_pool_`: ``smooth_scan`` seeded with pool row 0,
    written back to rows 1..P-1."""
    P = pool.shape[1] - 1
    if P >= 2:
        rows = pool.transpose(0, 1)  # [P+1, 9, S]
        sm = smooth_scan(rows, spec, init=rows[0])
        pool[:, 1:P] = sm.transpose(0, 1)
    return pool


def smooth_pool_(pool: torch.Tensor, spec: KernelSpec) -> torch.Tensor:
    """Smooth pool rows 1..P-1 of ``pool`` ([9, P+1, S], accumulator dtype)
    in place over the full stride (reference src/SangNom2.cpp:129-152).
    Returns ``pool``."""
    with span(LAUNCH) as sp:
        name = "pool smooth kernel"
        if pool.dim() != 3 or pool.shape[0] != _MAPS:
            raise ValueError(f"{name}: pool must be [9, P+1, S], got {tuple(pool.shape)}")
        _check_acc(name, spec, pool)
        if pool.device.type == "cpu":
            return smooth_pool_plain_(pool, spec)
        P, S = pool.shape[1] - 1, pool.shape[2]
        if P < 2:
            return pool
        _walk(name, "smooth", spec, pool[:, 0], pool[:, 1:P], pool[:, P],
              lambda lib, code, sse2, cols, threads, stream: lib.sno_pool_smooth_launch(
                  code, sse2, cols, pool.data_ptr(), P, S, threads, stream), sp)
        return pool


# --- K6 --------------------------------------------------------------------

def smooth_split3_plain_(row0, body, tail, spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `smooth_split3_`: the carry concatenated, then the K3
    twin."""
    pool = torch.cat([row0[:, None], body, tail[:, None]], dim=1)
    body.copy_(smooth_pool_plain_(pool, spec)[:, 1:-1])
    return body


def smooth_split3_(row0: torch.Tensor, body: torch.Tensor, tail: torch.Tensor,
                   spec: KernelSpec) -> torch.Tensor:
    """The pool smoothing on the split carry: seeded by ``row0`` [9, S], over
    ``body`` [9, P-1, S] (smoothed in place) with ``tail`` [9, S] as pool
    row P.  Returns ``body``."""
    with span(LAUNCH) as sp:
        name = "pool split3 kernel"
        P, S = _check_split(name, spec, row0, body, tail)
        if body.device.type == "cpu":
            return smooth_split3_plain_(row0, body, tail, spec)
        if P < 2:
            return body
        _walk(name, "split3", spec, row0, body, tail,
              lambda lib, code, sse2, cols, threads, stream: lib.sno_pool_smooth_split3_launch(
                  code, sse2, cols, row0.data_ptr(), body.data_ptr(), tail.data_ptr(), P, S,
                  threads, stream), sp)
        return body


# --- K7: prepare, the K6 walk, finalize ------------------------------------

def prepare_pool_plain_(kept: torch.Tensor, body: torch.Tensor,
                        spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `prepare_pool_` (the body of ``pool_carry._prepare``)."""
    bufH_p, w = kept.shape
    k = kept.to(spec.acc_dtype)
    taps, preds = pair_taps(k[:-1], k[1:], spec)
    body[:, : bufH_p - 1, :w] = torch.stack(error_maps_list(taps, preds))
    return body


def prepare_pool_(kept: torch.Tensor, body: torch.Tensor, spec: KernelSpec) -> torch.Tensor:
    """Write the raw maps of kept pairs (b-1, b), b = 1..R (R = bufH_p-1),
    into ``body`` [9, P-1, S] rows 0..R-1 (pool rows 1..R), columns 0..w-1,
    in place; the rest of the body keeps its (stale) content.  Returns
    ``body``."""
    with span(LAUNCH) as sp:
        name = "pool prepare kernel"
        P, S = _check_body(name, spec, body)
        _check_kept(name, spec, kept, P, S, body.device)
        if kept.device.type == "cpu":
            return prepare_pool_plain_(kept, body, spec)
        bufH_p, w = kept.shape
        lib = cl.load()
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
            err = lib.sno_pool_prepare_launch(code, sse2, kept.data_ptr(), body.data_ptr(),
                                              kept.stride(0), P, bufH_p - 1, w, S, stream)
        cl.check(err, f"{name} launch")
        LAUNCHES["prepare"] += 1
        if sp:
            sp.set(kernel="pool_prepare_kernel", blocks=row_blocks(bufH_p - 1, w, 1),
                   threads=ROW_THREADS, smem_bytes=0,
                   bytes=bufH_p * w * kept.element_size()
                   + _MAPS * (bufH_p - 1) * w * body.element_size())
        return body


def finalize_pool_plain(kept: torch.Tensor, body: torch.Tensor, aaf,
                        spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `finalize_pool` (``finalize_select_from_taps``)."""
    bufH_p, w = kept.shape
    k = kept.to(spec.acc_dtype)
    taps, preds = pair_taps(k[:-1], k[1:], spec)
    res = finalize_select_from_taps(taps, preds, body[:, : bufH_p - 1, :w], aaf, spec)
    return res.to(kept.dtype)


def finalize_pool(kept: torch.Tensor, body: torch.Tensor, aaf,
                  spec: KernelSpec) -> torch.Tensor:
    """The interpolated rows [R, w] of kept pairs (b-1, b), b = 1..R, from
    the smoothed maps in ``body`` rows 0..R-1, columns 0..w-1."""
    with span(LAUNCH) as sp:
        name = "pool finalize kernel"
        P, S = _check_body(name, spec, body)
        _check_kept(name, spec, kept, P, S, body.device)
        if kept.device.type == "cpu":
            return finalize_pool_plain(kept, body, aaf, spec)
        bufH_p, w = kept.shape
        out = torch.empty((bufH_p - 1, w), dtype=kept.dtype, device=kept.device)
        lib = cl.load()
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
            err = lib.sno_pool_finalize_launch(
                code, sse2, kept.data_ptr(), body.data_ptr(), out.data_ptr(),
                kept.stride(0), P, bufH_p - 1, w, S, float(aaf), stream)
        cl.check(err, f"{name} launch")
        LAUNCHES["finalize"] += 1
        if sp:
            sp.set(kernel="pool_finalize_kernel", blocks=row_blocks(bufH_p - 1, w, 1),
                   threads=ROW_THREADS, smem_bytes=0,
                   bytes=(bufH_p * w + out.numel()) * kept.element_size()
                   + _MAPS * (bufH_p - 1) * w * body.element_size())
        return out


def interp_fused_plain(kept, row0, body, tail, aaf, spec: KernelSpec):
    """Plain twin of `interp_fused`: the three plain stages in sequence."""
    prepare_pool_plain_(kept, body, spec)
    smooth_split3_plain_(row0, body, tail, spec)
    return finalize_pool_plain(kept, body, aaf, spec)


def interp_fused(kept: torch.Tensor, row0: torch.Tensor, body: torch.Tensor,
                 tail: torch.Tensor, aaf, spec: KernelSpec) -> torch.Tensor:
    """One pool-compat plane pass: ``kept`` [bufH_p, w] (storage dtype,
    2 <= bufH_p <= P, w <= S, rows may be strided) -> interpolated rows
    [bufH_p-1, w]; ``body`` is prepared and smoothed in place.  On CUDA
    tensors: the prepare kernel, the K6 walk and the finalize kernel, queued
    on the current stream with no device op between them."""
    name = "pool fused pass"
    P, S = _check_split(name, spec, row0, body, tail)
    _check_kept(name, spec, kept, P, S, body.device)
    if kept.device.type == "cpu":
        return interp_fused_plain(kept, row0, body, tail, aaf, spec)
    prepare_pool_(kept, body, spec)
    smooth_split3_(row0, body, tail, spec)
    return finalize_pool(kept, body, aaf, spec)


# --- the frame-parallel pass: K frames, each with its own pool ------------

def _check_batch(name: str, spec: KernelSpec, row0, body, tail) -> tuple[int, int, int]:
    """(K, P, S) of a valid batched split carry: row0 [K, 9, S], body
    [K, 9, P-1, S], tail [K, 9, S], contiguous; or ValueError."""
    if body.dim() != 4 or body.shape[1] != _MAPS or body.shape[0] < 1:
        raise ValueError(f"{name}: body must be [K, 9, P-1, S], got {tuple(body.shape)}")
    K, _, Pm1, S = body.shape
    for t, what in ((row0, "row0"), (tail, "tail")):
        if tuple(t.shape) != (K, _MAPS, S):
            raise ValueError(f"{name}: {what} must be [{K}, 9, {S}], got {tuple(t.shape)}")
    _check_acc(name, spec, body, row0, tail)
    return K, Pm1 + 1, S


def _check_kept_batch(name: str, spec: KernelSpec, kept: torch.Tensor,
                      body: torch.Tensor) -> None:
    """Kept rows [K, bufH_p, w] of a batch on ``body`` [K, 9, P-1, S]: each
    frame's rows as `_check_kept` takes them."""
    if kept.dim() != 3 or kept.shape[0] != body.shape[0]:
        raise ValueError(f"{name}: kept must be [K, bufH_p, w] with K = "
                         f"{body.shape[0]}, got {tuple(kept.shape)}")
    _check_kept(name, spec, kept[0], body.shape[2] + 1, body.shape[3], body.device)


def smooth_batch_plain_(row0, body, tail, spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `smooth_batch_`: the K3 twin over the 9K maps."""
    K, _, Pm1, S = body.shape
    pool = torch.cat([row0[:, :, None], body, tail[:, :, None]], dim=2)
    body.copy_(smooth_pool_plain_(pool.reshape(K * _MAPS, Pm1 + 2, S), spec)
               .reshape(K, _MAPS, Pm1 + 2, S)[:, :, 1:-1])
    return body


def smooth_batch_(row0: torch.Tensor, body: torch.Tensor, tail: torch.Tensor,
                  spec: KernelSpec) -> torch.Tensor:
    """The pool smoothing of K frames' pools at once: frame k's carry is
    (row0[k], body[k], tail[k]) as `smooth_split3_` takes it; ``body`` is
    smoothed in place.  On CUDA tensors one launch of the walk over 9K maps.
    Returns ``body``."""
    with span(LAUNCH) as sp:
        name = "pool batch walk"
        K, P, S = _check_batch(name, spec, row0, body, tail)
        if body.device.type == "cpu":
            return smooth_batch_plain_(row0, body, tail, spec)
        if P < 2:
            return body
        _walk(name, "split3", spec, row0.view(K * _MAPS, S), body.view(K * _MAPS, P - 1, S),
              tail.view(K * _MAPS, S),
              lambda lib, code, sse2, cols, threads, stream: lib.sno_pool_smooth_batch_launch(
                  code, sse2, cols, row0.data_ptr(), body.data_ptr(), tail.data_ptr(),
                  K * _MAPS, P, S, threads, stream), sp)
        return body


def walk_occupancy(spec: KernelSpec, S: int, device="cuda") -> tuple[int, int]:
    """(threads a block, resident blocks an SM) of the pool walk at stride
    ``S`` on a card: a batched walk of 9K blocks runs in
    ceil(9K / (blocks x SMs)) waves; past one block's columns, the wide
    walk's blocks, k a map (`walk_clusters`)."""
    plan = walk_plan(S, 1)
    if plan.k > 1:
        return plan.threads, _wide_query(spec, plan, 1, device)[2]
    code, sse2, _ = cl.launch_codes(spec, torch.device(device))
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        cl.check(cl.load().sno_pool_smooth_occupancy(code, sse2, plan.cols, S, plan.threads,
                                                     ctypes.byref(blocks)),
                 "pool walk occupancy query")
    return plan.threads, blocks.value


def walk_clusters(spec: KernelSpec, S: int, n_steps: int, device="cuda") -> dict:
    """The wide walk's geometry on a card at stride ``S``: the plan's k,
    route and shared memory, and the build's registers, spill bytes,
    blocks a SM and clusters of k blocks resident at once (a batched walk
    of 9K maps runs in ceil(9K / clusters) waves)."""
    plan = card_walk_plan(spec, S, n_steps, device)
    regs, spill, per_sm, clusters = _wide_query(spec, plan, plan.k if plan.cluster else 1,
                                                device)
    return {"k": plan.k, "cluster": plan.cluster, "launches": plan.launches,
            "threads": plan.threads, "cols": plan.cols, "smem_bytes": plan.smem_bytes,
            "registers": regs, "spill_bytes": spill, "blocks_per_sm": per_sm,
            "clusters": clusters}


def prepare_batch_plain_(kept: torch.Tensor, body: torch.Tensor,
                         spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `prepare_batch_` (`prepare_pool_plain_` with a frame
    axis: the taps are last-axis functions)."""
    _, bufH_p, w = kept.shape
    k = kept.to(spec.acc_dtype)
    taps, preds = pair_taps(k[:, :-1], k[:, 1:], spec)
    body[:, :, : bufH_p - 1, :w] = torch.stack(error_maps_list(taps, preds), dim=1)
    return body


def prepare_batch_(kept: torch.Tensor, body: torch.Tensor, spec: KernelSpec) -> torch.Tensor:
    """`prepare_pool_` for K frames: kept rows [K, bufH_p, w] (frames and
    rows may be strided, columns contiguous) into ``body`` [K, 9, P-1, S],
    in place.  Returns ``body``."""
    with span(LAUNCH) as sp:
        name = "pool batch prepare"
        if body.dim() != 4 or body.shape[1] != _MAPS:
            raise ValueError(f"{name}: body must be [K, 9, P-1, S], got {tuple(body.shape)}")
        _check_acc(name, spec, body)
        _check_kept_batch(name, spec, kept, body)
        if kept.device.type == "cpu":
            return prepare_batch_plain_(kept, body, spec)
        K, bufH_p, w = kept.shape
        P, S = body.shape[2] + 1, body.shape[3]
        lib = cl.load()
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
            err = lib.sno_pool_prepare_batch_launch(
                code, sse2, kept.data_ptr(), body.data_ptr(), kept.stride(0),
                kept.stride(1), K, P, bufH_p - 1, w, S, stream)
        cl.check(err, f"{name} launch")
        LAUNCHES["prepare"] += 1
        if sp:
            sp.set(kernel="pool_prepare_kernel", blocks=row_blocks(bufH_p - 1, w, K),
                   threads=ROW_THREADS, smem_bytes=0,
                   bytes=K * bufH_p * w * kept.element_size()
                   + K * _MAPS * (bufH_p - 1) * w * body.element_size())
        return body


def finalize_batch_plain(kept: torch.Tensor, body: torch.Tensor, aaf,
                         spec: KernelSpec) -> torch.Tensor:
    """Plain twin of `finalize_batch`."""
    _, bufH_p, w = kept.shape
    k = kept.to(spec.acc_dtype)
    taps, preds = pair_taps(k[:, :-1], k[:, 1:], spec)
    bufs = body[:, :, : bufH_p - 1, :w].transpose(0, 1)  # [9, K, R, w]
    return finalize_select_from_taps(taps, preds, bufs, aaf, spec).to(kept.dtype)


def finalize_batch(kept: torch.Tensor, body: torch.Tensor, aaf,
                   spec: KernelSpec) -> torch.Tensor:
    """`finalize_pool` for K frames: the interpolated rows [K, R, w] from
    kept rows [K, bufH_p, w] and the smoothed ``body`` [K, 9, P-1, S]."""
    with span(LAUNCH) as sp:
        name = "pool batch finalize"
        if body.dim() != 4 or body.shape[1] != _MAPS:
            raise ValueError(f"{name}: body must be [K, 9, P-1, S], got {tuple(body.shape)}")
        _check_acc(name, spec, body)
        _check_kept_batch(name, spec, kept, body)
        if kept.device.type == "cpu":
            return finalize_batch_plain(kept, body, aaf, spec)
        K, bufH_p, w = kept.shape
        P, S = body.shape[2] + 1, body.shape[3]
        out = torch.empty((K, bufH_p - 1, w), dtype=kept.dtype, device=kept.device)
        lib = cl.load()
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
            err = lib.sno_pool_finalize_batch_launch(
                code, sse2, kept.data_ptr(), body.data_ptr(), out.data_ptr(),
                kept.stride(0), kept.stride(1), out.stride(0), K, P, bufH_p - 1, w,
                S, float(aaf), stream)
        cl.check(err, f"{name} launch")
        LAUNCHES["finalize"] += 1
        if sp:
            sp.set(kernel="pool_finalize_kernel", blocks=row_blocks(bufH_p - 1, w, K),
                   threads=ROW_THREADS, smem_bytes=0,
                   bytes=(K * bufH_p * w + out.numel()) * kept.element_size()
                   + K * _MAPS * (bufH_p - 1) * w * body.element_size())
        return out


def interp_batch_plain(kept, row0, body, tail, aaf, spec: KernelSpec):
    """Plain twin of `interp_batch`: the three plain stages in sequence."""
    prepare_batch_plain_(kept, body, spec)
    smooth_batch_plain_(row0, body, tail, spec)
    return finalize_batch_plain(kept, body, aaf, spec)


def interp_batch(kept: torch.Tensor, row0: torch.Tensor, body: torch.Tensor,
                 tail: torch.Tensor, aaf, spec: KernelSpec) -> torch.Tensor:
    """One plane pass of K frames, each on its own pool: ``kept`` [K,
    bufH_p, w] -> interpolated rows [K, bufH_p-1, w]; the batched carry
    (row0 [K, 9, S], body [K, 9, P-1, S], tail [K, 9, S]) is prepared and
    smoothed in place.  On CUDA tensors three launches on the current
    stream, whatever K: `prepare_batch_`, `smooth_batch_`, `finalize_batch`."""
    name = "pool batch pass"
    _check_batch(name, spec, row0, body, tail)
    _check_kept_batch(name, spec, kept, body)
    if kept.device.type == "cpu":
        return interp_batch_plain(kept, row0, body, tail, aaf, spec)
    prepare_batch_(kept, body, spec)
    smooth_batch_(row0, body, tail, spec)
    return finalize_batch(kept, body, aaf, spec)
