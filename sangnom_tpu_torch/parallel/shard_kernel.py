"""ctypes bindings of the width-sharded kernels in ``csrc/shard.cu``.

``full_pass`` launches K4 (``shard_full_kernel``) over a whole plane pass:
every shard and field, all rows.  ``smooth_pass`` launches K5
(``shard_smooth_kernel``), the chunked route's smoothing walk, between
``prepare`` (``shard_prepare_kernel``) and ``finalize``
(``shard_finalize_kernel``).  They are the CUDA steps of
``parallel.fused_smooth``; the kernels are built with the rest of the
library (``ops.cuda_library``).  Each function checks its tensors,
launches or raises, and adds one to its ``LAUNCHES`` count per launch.

Launch geometry (pure Python, ``full_plan`` / ``smooth_plan``; a K4 pass
takes `pass_plan`'s, made once and handed to ``full_pass``): a block
computes its shard's ``W_loc`` columns plus a halo of ``H = 3R`` columns a
side (none past the plane's edges), and the halo of its carried row is
refreshed from the neighbouring shards every R rows, R from ``chunk_rows``.
Two routes, never chosen silently:

  cluster  ``n_space <= MAX_CLUSTER`` (``ops.launch_geometry``): the
           shards of a field (K4) or of a (map, field) row (K5) form one
           thread-block cluster and exchange the halo through distributed
           shared memory; one launch a plane pass.  A K4 cluster the card
           cannot schedule takes the chunk route (`pass_plan`, decided
           before any launch); a K5 cluster raises RuntimeError.
  chunk    a mesh row of more shards than a cluster holds: the same kernel,
           one launch per chunk of R rows, the carried row passing through
           device memory between launches (ceil((bufH-1) / R) launches, one
           for one kept row).
  slot     ``full_chunk`` / ``smooth_chunk``: the chunk route's kernels over
           one shard (no halo in the launch: the caller's slab carries it),
           one launch a call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sangnom_tpu_torch.ops import cuda_library as cl
from sangnom_tpu_torch.ops.launch_geometry import (
    MAX_CLUSTER, ROW_THREADS, block_width, least_split, row_blocks)
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.utils.profiling import LAUNCH, span

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"full": 0, "smooth": 0, "prepare": 0, "finalize": 0}

# The most columns a block takes, its halos included (`shard_shape`).
MAX_BLOCK = 8184
# The most columns a block of 4-column threads takes (`shard_shape`): the
# widest block of the main path's wide field route (ops/deint_kernel).
MAX_BLOCK_4 = 2040
# Rows between halo exchanges when the caller gives none: the fastest R of
# the 1x4 1080 passes on an H100 (tools/shard_ab.py; PERF.md section 6).
CLUSTER_ROWS = 4
# Rows between halo exchanges of the route across devices when the caller
# gives none (parallel.cross_device): its K4 chunks and its K5 chunks, each
# the fastest R of chip_smoke.py phase 19's sweep of the 1080 dh and bob
# calls on an H100 (R 4/16/32/64; PERF.md section 5).
SLOT_ROWS = 32
SLOT_ROWS_K5 = 16

_MAPS = 9
_RING_ROWS = 5  # K4's kept-row ring slots (csrc/shard.cu kRing)

cl.declare({
    # dtype sse2 cols | kept dst offsets gbuf grp gin gout | N n bufH S W_loc H
    # w_glob | R lo hi weave static_offset dbuf | pitch_b pitch_r pitch_p
    # cluster_mode | aaf threads smem stream
    "sno_shard_full_launch": "iii ppppppp iiiiiii iiiiii iiii diip",
    # dtype sse2 cols raw out | C n bufH S W_loc H R | base steps pitch
    # cluster_mode | threads smem stream
    "sno_shard_smooth_launch": "iiipp iiiiiii iiii iip",
    "sno_shard_prepare_launch": "iippiiiip",
    "sno_shard_finalize_launch": "iippppiiiiidp",
    "sno_shard_query": "iiiiiiiP",
})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def shard_shape(W_c: int) -> tuple[int, int]:
    """(columns per thread, threads per block) for blocks of at most ``W_c``
    columns: 1 column a thread up to 64 columns, 4 up to 2040, 8 up to
    8184, and 8 / cols threads more: K4 fetches a block's kept rows with 4
    more columns at each end, thread t the cols columns from t*cols - 4;
    threads a multiple of 32, at most 512 (1 and 4 columns) or 1024 (8)."""
    for cols, max_cols in ((1, 64), (4, MAX_BLOCK_4), (8, MAX_BLOCK)):
        if W_c <= max_cols:
            return cols, _round_up(-(-W_c // cols) + 8 // cols, 32)
    raise ValueError(f"sharded kernel: {W_c} columns in a block (at most 8184)")


def split_count(width: int, n_space: int, halo: int) -> int:
    """The least k that cuts a row of ``width`` columns, over ``n_space``
    shards, into ``n_space * k`` equal blocks that each fit one block of
    the kernels (``MAX_BLOCK`` columns with a halo of ``halo`` columns on
    each inner side): 1 where the shards fit as they are.  The routes take
    the ``n_space * k`` blocks as their shards, so the sub-split changes no
    output column."""
    if width % n_space:
        raise ValueError(f"width {width} does not divide across {n_space} shards")

    def cut(k):
        n = n_space * k
        return None if width % n else (n, width // n, halo)

    return least_split(cut, width, MAX_BLOCK)


def cluster_rows(n_space: int, W_loc: int, n_steps: int,
                 chunk_rows: int | None = None) -> tuple[int, int]:
    """(R, H): rows between halo exchanges (``chunk_rows``, or
    ``CLUSTER_ROWS`` when None) and the halo width 3R (0 for one shard,
    which has no halo).  H <= W_loc, so a halo comes from the adjacent
    shard only."""
    R = max(1, min(chunk_rows or CLUSTER_ROWS, n_steps, W_loc // 3))
    return R, (3 * R if n_space > 1 else 0)


class Plan(NamedTuple):
    """How a plane pass launches (see ``csrc/shard.cu``).

    ``cluster``: the cluster route (one launch) or the chunk route
    (``launches`` of them).  ``route`` (K4): "double" (two shared smoothing
    rows, one barrier a step), "single" (one row, two barriers) or "global"
    (rows and raw slices in device memory).  ``pitch_b`` / ``pitch_r`` /
    ``pitch_p``: elements of a smoothing row, a kept-ring row and a raw
    slice row (K5: ``pitch_b`` is the line row).  ``smem_bytes``: the
    dynamic shared memory of a block, the cluster exchange's buffer
    included."""

    R: int
    H: int
    cols: int
    threads: int
    cluster: bool
    launches: int
    route: str
    smem_bytes: int
    pitch_b: int
    pitch_r: int
    pitch_p: int


def one_wave_smem(blocks: int, smem_bytes: int, card: cl.Card) -> int:
    """The shared memory a block of a K4 pass of ``blocks`` blocks asks
    for: where they fit one a SM, more than half of a SM's, so no SM takes
    two.  Two K4 blocks on one SM each walk at half speed (maa luma 7.75
    ms against 3.95 on an H100), and the scheduler doubled them up on SMs
    freed early when other kernels ran beside the launch (the U+V pass's
    copies on a second stream); one a SM, the pass never waits on
    another's."""
    if blocks > card.sms:
        return smem_bytes
    return max(smem_bytes, card.smem_sm // 2 - cl.SMEM_RESERVED + 1)


def full_plan(n_space: int, W_loc: int, bufH: int, elem: int, limit: int,
              chunk_rows: int | None = None, cluster: bool | None = None) -> Plan:
    """K4's plan for a pass of ``bufH`` kept rows, shards of ``W_loc``
    columns, ``elem``-byte samples, under a block's shared-memory
    ``limit``: the first of the routes double, single, global that fits.
    ``cluster`` None: the cluster route up to ``MAX_CLUSTER`` shards."""
    n_steps = bufH - 1
    R, H = cluster_rows(n_space, W_loc, n_steps, chunk_rows)
    W_c = block_width(n_space, W_loc, H)
    cols, threads = shard_shape(W_c)
    if cluster is None:
        cluster = n_space <= MAX_CLUSTER
    pitch_b = _round_up(W_c + cols + 8, 4)
    pitch_r = _round_up(W_c + cols + 8, 16)
    pitch_p = _round_up(threads * cols, 16)
    xb = 2 * 2 * _MAPS * H * 4 if cluster else 0
    buf = _MAPS * pitch_b * 4
    rp = _MAPS * pitch_p * elem
    ring = _RING_ROWS * pitch_r * elem
    launches = 1 if cluster else max(1, -(-n_steps // R))
    for route, smem in (("double", 2 * buf + rp + ring + xb),
                        ("single", buf + rp + ring + xb), ("global", ring + xb)):
        if smem <= limit:
            return Plan(R, H, cols, threads, cluster, launches, route, smem,
                        pitch_b, pitch_r, pitch_p)
    raise ValueError(f"sharded fused kernel: block width {W_c} exceeds shared memory")


def pass_plan(fields: int, n_space: int, W_loc: int, bufH: int, spec: KernelSpec,
              card: cl.Card, chunk_rows: int | None = None,
              cluster: bool | None = None) -> Plan:
    """The plan a K4 pass over ``fields`` fields launches: `full_plan`
    under the card's shared memory a block, its blocks asking for
    `one_wave_smem`; a cluster the card cannot schedule (none of the
    plan's clusters resident, ``sno_shard_query``) takes the chunk route,
    decided here before any launch.  One shard a field forms no cluster
    (the launch takes none), so nothing is asked for it."""
    elem = cl.storage_dtype(spec).itemsize
    plan = full_plan(n_space, W_loc, bufH, elem, card.smem_block, chunk_rows, cluster)
    plan = plan._replace(smem_bytes=one_wave_smem(fields * n_space, plan.smem_bytes, card))
    if (plan.cluster and n_space > 1 and card.device is not None and not cl.cluster_fits(
            card.device, ("full", spec, n_space, plan),
            lambda: occupancy("full", spec, plan, n_space,
                              torch.device("cuda", card.device))["clusters"])):
        return pass_plan(fields, n_space, W_loc, bufH, spec, card, chunk_rows, False)
    return plan


def smooth_plan(n_space: int, W_loc: int, bufH: int, limit: int,
                chunk_rows: int | None = None, cluster: bool | None = None) -> Plan:
    """K5's plan for a pass of ``bufH`` kept rows (bufH-1 smoothed rows):
    a double-buffered line row and the cluster exchange's buffer."""
    n_steps = bufH - 1
    R, H = cluster_rows(n_space, W_loc, n_steps, chunk_rows)
    W_c = block_width(n_space, W_loc, H)
    cols, threads = shard_shape(W_c)
    if cluster is None:
        cluster = n_space <= MAX_CLUSTER
    pitch = _round_up(W_c + cols + 8, 4)
    smem = 2 * pitch * 4 + (2 * 2 * H * 4 if cluster else 0)
    if smem > limit:
        raise ValueError(f"sharded smoothing kernel: block width {W_c} exceeds "
                         "shared memory")
    return Plan(R, H, cols, threads, cluster, 1 if cluster else -(-n_steps // R),
                "double", smem, pitch, 0, 0)


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors must lie on one CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _full_scratch(plan: Plan, blocks: int, spec: KernelSpec, kept: torch.Tensor):
    """K4's global-route scratch (gbuf, grp), or (None, None) on the shared
    routes."""
    if plan.route != "global":
        return None, None
    return (torch.empty((blocks, _MAPS, plan.pitch_b), dtype=spec.acc_dtype,
                        device=kept.device),
            torch.empty((blocks, _MAPS, plan.pitch_p), dtype=kept.dtype, device=kept.device))


def _launch_full(lib, plan: Plan, spec: KernelSpec, kept, out, weave_args, scratch, gin,
                 gout, n_space: int, w_glob: int, lo: int, hi: int, aaf, name: str) -> None:
    """One K4 launch over steps lo..hi-1 (the caller holds the device and
    LAUNCH_LOCK).  Its launch span counts, beside the grid, the serial row
    steps it walks (``steps``), the kept rows (``rows``), a shard's columns
    (``cols``), the widest block's with its halos (``block_cols``), the rows
    between halo exchanges (``exchange_rows``), the memory route
    (``mem_route``) and the sample size (``elem``)."""
    with span(LAUNCH) as sp:
        N, bufH, S = kept.shape
        weave, static_offset, offs = weave_args
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        err = lib.sno_shard_full_launch(
            code, sse2, plan.cols, kept.data_ptr(), out.data_ptr(), _ptr(offs),
            _ptr(scratch[0]), _ptr(scratch[1]), _ptr(gin), _ptr(gout), N, n_space, bufH, S,
            S // n_space, plan.H, w_glob, plan.R, lo, hi, weave, static_offset,
            int(plan.route == "double"), plan.pitch_b, plan.pitch_r, plan.pitch_p,
            int(plan.cluster), float(aaf), plan.threads, plan.smem_bytes, stream)
        cl.check(err, f"{name} launch", n_space)
        LAUNCHES["full"] += 1
        if sp:
            W_loc = S // n_space
            sp.set(kernel="shard_full_kernel", blocks=N * n_space, threads=plan.threads,
                   route="cluster" if plan.cluster else "chunk", k=n_space,
                   smem_bytes=plan.smem_bytes,
                   bytes=(kept.numel() + out.numel()) * kept.element_size(),
                   steps=hi - lo, rows=bufH, cols=W_loc,
                   block_cols=block_width(n_space, W_loc, plan.H), exchange_rows=plan.R,
                   mem_route=plan.route, elem=kept.element_size())


def full_pass(kept: torch.Tensor, offsets, aaf, spec: KernelSpec, n_space: int,
              w_glob: int, plan: Plan) -> torch.Tensor:
    """K4 over a plane pass on `pass_plan`'s ``plan``: ``kept`` [N, bufH, S]
    (storage dtype, contiguous, S = n_space * W_loc) -> the woven plane
    [N, 2*bufH, S] (``offsets`` 0, 1 or a per-field [N] tensor) or, with
    ``offsets`` None, the interpolated rows [N, bufH-1, S]."""
    name = "sharded fused kernel"
    N, bufH, S = kept.shape
    if kept.dtype != cl.storage_dtype(spec):
        raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel spec {spec}")
    _check(name, kept)
    weave_args = _weave_args(offsets, kept.device)
    out = torch.empty((N, 2 * bufH if weave_args[0] else bufH - 1, S), dtype=kept.dtype,
                      device=kept.device)
    lib = cl.load()
    scratch = _full_scratch(plan, N * n_space, spec, kept)
    carry = [None, None]  # the chunk route's carried row, [N, 9, S] a launch
    if not plan.cluster:
        carry = [torch.empty((N, _MAPS, S), dtype=spec.acc_dtype, device=kept.device)
                 for _ in range(2)]
    # one kept row: one launch over no steps, which weaves the row
    spans = [(1, bufH)] if plan.cluster else [
        (lo, min(lo + plan.R, bufH)) for lo in range(1, max(bufH, 2), plan.R)]
    with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
        for k, (lo, hi) in enumerate(spans):
            _launch_full(lib, plan, spec, kept, out, weave_args, scratch,
                         carry[(k + 1) & 1], carry[k & 1], n_space, w_glob, lo, hi, aaf, name)
    return out


def full_chunk(kept: torch.Tensor, out: torch.Tensor, offsets, gin: torch.Tensor,
               gout: torch.Tensor, lo: int, hi: int, aaf, spec: KernelSpec,
               w_glob: int) -> None:
    """K4 over steps lo..hi-1 of ONE shard, the chunk route's launch with
    the span and the carried rows in the caller's hands: ``kept`` [N, bufH,
    W] (storage dtype, contiguous; taps clamp at its columns 0 and W-1) ->
    rows of ``out``, the woven [N, 2*bufH, W] (``offsets`` 0, 1 or a
    per-field [N] tensor) or with ``offsets`` None the interpolated [N,
    bufH-1, W].  ``gin`` / ``gout`` [N, 9, W] (accumulator dtype): the
    smoothed row lo-1, read when lo > 1, and row hi-1, written when hi <
    bufH.  Raw maps are zero at columns >= ``w_glob`` (0: all of them)."""
    name = "sharded fused kernel (one-shard chunk)"
    N, bufH, W = kept.shape
    if kept.dtype != cl.storage_dtype(spec) or out.dtype != kept.dtype or \
            gin.dtype != spec.acc_dtype or gout.dtype != spec.acc_dtype:
        raise ValueError(f"{name}: dtypes {kept.dtype}, {out.dtype}, {gin.dtype}, "
                         f"{gout.dtype} do not match the kernel spec {spec}")
    _check(name, kept, out, gin, gout)
    weave_args = _weave_args(offsets, kept.device)
    rows = 2 * bufH if weave_args[0] else bufH - 1
    if tuple(out.shape) != (N, rows, W) or tuple(gin.shape) != (N, _MAPS, W) or \
            gin.shape != gout.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)}, carries {tuple(gin.shape)} "
                         f"{tuple(gout.shape)} for kept {tuple(kept.shape)}")
    if not 1 <= lo < hi <= bufH:
        raise ValueError(f"{name}: steps {lo}..{hi - 1} outside 1..{bufH - 1}")
    lib = cl.load()
    plan = full_plan(1, W, bufH, kept.element_size(), cl.max_smem_bytes(kept.device),
                     cluster=False)
    scratch = _full_scratch(plan, N, spec, kept)
    with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
        _launch_full(lib, plan, spec, kept, out, weave_args, scratch, gin, gout, 1,
                     max(0, min(w_glob, W)), lo, hi, aaf, name)


def _launch_smooth(lib, plan: Plan, spec: KernelSpec, raw, out, n_space: int, base: int,
                   steps: int, name: str) -> None:
    """One K5 launch over steps base..base+steps-1 (the caller holds the
    device and LAUNCH_LOCK)."""
    with span(LAUNCH) as sp:
        C, bufHp1, S = raw.shape
        code, sse2, stream = cl.launch_codes(spec, raw.device)
        err = lib.sno_shard_smooth_launch(
            code, sse2, plan.cols, raw.data_ptr(), out.data_ptr(), C, n_space, bufHp1 - 1, S,
            S // n_space, plan.H, plan.R, base, steps, plan.pitch_b, int(plan.cluster),
            plan.threads, plan.smem_bytes, stream)
        cl.check(err, f"{name} launch", n_space)
        LAUNCHES["smooth"] += 1
        if sp:
            sp.set(kernel="shard_smooth_kernel", blocks=C * n_space, threads=plan.threads,
                   smem_bytes=plan.smem_bytes,
                   bytes=(raw.numel() + out.numel()) * raw.element_size())


def smooth_pass(raw: torch.Tensor, spec: KernelSpec, n_space: int,
                chunk_rows: int | None = None) -> torch.Tensor:
    """K5 over a plane pass: ``raw`` [C, bufH+1, S] (accumulator dtype, rows
    0 and bufH zero) -> the smoothed rows [C, bufH-1, S]."""
    name = "sharded smoothing kernel"
    C, bufHp1, S = raw.shape
    bufH = bufHp1 - 1
    if raw.dtype != spec.acc_dtype:
        raise ValueError(f"{name}: dtype {raw.dtype} does not match the kernel spec {spec}")
    _check(name, raw)
    out = torch.empty((C, bufH - 1, S), dtype=raw.dtype, device=raw.device)
    if out.numel() == 0:
        return out
    lib = cl.load()
    W_loc = S // n_space
    plan = smooth_plan(n_space, W_loc, bufH, cl.max_smem_bytes(raw.device), chunk_rows)
    chunks = [(0, bufH - 1)] if plan.cluster else [
        (base, min(plan.R, bufH - 1 - base)) for base in range(0, bufH - 1, plan.R)]
    with torch.cuda.device(raw.device), cl.LAUNCH_LOCK:
        for base, steps in chunks:
            _launch_smooth(lib, plan, spec, raw, out, n_space, base, steps, name)
    return out


def smooth_chunk(raw: torch.Tensor, out: torch.Tensor, base: int, steps: int,
                 spec: KernelSpec) -> None:
    """K5 over steps base..base+steps-1 of ONE shard: ``raw`` [C, bufH+1, W]
    (accumulator dtype, rows 0 and bufH zero; the box clamps at its columns
    0 and W-1) -> rows base.. of ``out`` [C, bufH-1, W], seeded from ``out``
    row base-1 (zero at base 0)."""
    name = "sharded smoothing kernel (one-shard chunk)"
    C, bufHp1, W = raw.shape
    if raw.dtype != spec.acc_dtype or out.dtype != raw.dtype:
        raise ValueError(f"{name}: dtypes {raw.dtype}, {out.dtype} do not match the "
                         f"kernel spec {spec}")
    _check(name, raw, out)
    if tuple(out.shape) != (C, bufHp1 - 2, W):
        raise ValueError(f"{name}: out {tuple(out.shape)} for raw {tuple(raw.shape)}")
    if not (0 <= base and 0 < steps and base + steps <= bufHp1 - 2):
        raise ValueError(f"{name}: steps {base}..{base + steps - 1} outside "
                         f"0..{bufHp1 - 3}")
    lib = cl.load()
    plan = smooth_plan(1, W, bufHp1 - 1, cl.max_smem_bytes(raw.device), cluster=False)
    with torch.cuda.device(raw.device), cl.LAUNCH_LOCK:
        _launch_smooth(lib, plan, spec, raw, out, 1, base, steps, name)


def prepare(kept: torch.Tensor, spec: KernelSpec, w_glob: int) -> torch.Tensor:
    """The chunked route's raw maps: ``kept`` [N, bufH, S] -> [9, N, bufH+1,
    S] in the accumulator dtype, zero in rows 0 and bufH and at columns >=
    ``w_glob``; taps clamp at columns 0 and S-1."""
    with span(LAUNCH) as sp:
        name = "sharded prepare kernel"
        if kept.dtype != cl.storage_dtype(spec):
            raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel spec {spec}")
        _check(name, kept)
        N, bufH, S = kept.shape
        raw = torch.empty((_MAPS, N, bufH + 1, S), dtype=spec.acc_dtype, device=kept.device)
        lib = cl.load()
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
            err = lib.sno_shard_prepare_launch(code, sse2, kept.data_ptr(), raw.data_ptr(),
                                               N, bufH, S, w_glob, stream)
        cl.check(err, f"{name} launch")
        LAUNCHES["prepare"] += 1
        if sp:
            sp.set(kernel="shard_prepare_kernel", blocks=row_blocks(bufH + 1, S, N),
                   threads=ROW_THREADS, smem_bytes=0,
                   bytes=kept.numel() * kept.element_size() + raw.numel() * raw.element_size())
        return raw


def _weave_args(offsets, device):
    """(weave flag, static offset, int32 offsets or None) of ``offsets``:
    None (no weave), 0, 1 or a per-field tensor."""
    if offsets is None:
        return 0, 0, None
    if isinstance(offsets, torch.Tensor):
        return 1, -1, offsets.to(device=device, dtype=torch.int32).contiguous()
    return 1, offsets, None


def finalize(kept: torch.Tensor, sm: torch.Tensor, aaf, spec: KernelSpec,
             offsets=None) -> torch.Tensor:
    """The chunked route's priority select: ``kept`` [N, bufH, S] and the
    smoothed maps ``sm`` [9, N, bufH-1, S] -> the interpolated rows [N,
    bufH-1, S] (storage dtype), or with ``offsets`` (0, 1 or a per-field
    tensor) the woven plane [N, 2*bufH, S]."""
    with span(LAUNCH) as sp:
        name = "sharded finalize kernel"
        N, bufH, S = kept.shape
        if kept.dtype != cl.storage_dtype(spec) or sm.dtype != spec.acc_dtype:
            raise ValueError(f"{name}: dtypes {kept.dtype}, {sm.dtype} do not match the "
                             f"kernel spec {spec}")
        if tuple(sm.shape) != (_MAPS, N, bufH - 1, S):
            raise ValueError(f"{name}: smoothed {tuple(sm.shape)} for kept {tuple(kept.shape)}")
        _check(name, kept, sm)
        weave, static_offset, offs = _weave_args(offsets, kept.device)
        out = torch.empty((N, 2 * bufH if weave else bufH - 1, S), dtype=kept.dtype,
                          device=kept.device)
        lib = cl.load()
        code, sse2, stream = cl.launch_codes(spec, kept.device)
        with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
            err = lib.sno_shard_finalize_launch(
                code, sse2, kept.data_ptr(), sm.data_ptr(), out.data_ptr(),
                None if offs is None else offs.data_ptr(), N, bufH, S, weave, static_offset,
                float(aaf), stream)
        cl.check(err, f"{name} launch")
        LAUNCHES["finalize"] += 1
        if sp:
            sp.set(kernel="shard_finalize_kernel", blocks=row_blocks(bufH, S, N),
                   threads=ROW_THREADS, smem_bytes=0,
                   bytes=(kept.numel() + out.numel()) * kept.element_size()
                   + sm.numel() * sm.element_size())
        return out


def occupancy(kernel: str, spec: KernelSpec, plan: Plan, n_space: int,
              device: torch.device) -> dict:
    """What the card makes of a plan: registers and spill bytes a thread,
    blocks a SM, and clusters of ``n_space`` blocks resident at once (-1
    without a cluster).  ``kernel``: "full" (K4) or "smooth" (K5)."""
    lib = cl.load()
    code, sse2, _ = cl.launch_codes(spec, device)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device), cl.LAUNCH_LOCK:
        err = lib.sno_shard_query(0 if kernel == "full" else 1, code, sse2, plan.cols,
                                  plan.threads, plan.smem_bytes,
                                  n_space if plan.cluster else 1, out)
    cl.check(err, "sharded kernel occupancy query")
    return {"registers": out[0], "spill_bytes": out[1], "blocks_per_sm": out[2],
            "clusters": out[3]}
