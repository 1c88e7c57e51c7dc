"""ctypes bindings of the width-sharded kernels in ``csrc/shard.cu``.

``full_pass`` launches K4 (``shard_full_kernel``) over a whole plane pass:
every shard and field, all rows.  ``smooth_pass`` launches K5
(``shard_smooth_kernel``), the chunked route's smoothing walk, between
``prepare`` (``shard_prepare_kernel``) and ``finalize``
(``shard_finalize_kernel``).  They are the CUDA steps of
``parallel.fused_smooth``; the kernels are built with the rest of the
library (``ops.deint_kernel.build``).  Each function checks its tensors,
launches or raises, and adds one to its ``LAUNCHES`` count per launch.

Launch geometry (pure Python, ``full_plan`` / ``smooth_plan``): a block
computes its shard's ``W_loc`` columns plus a halo of ``H = 3R`` columns a
side (none past the plane's edges), and the halo of its carried row is
refreshed from the neighbouring shards every R rows, R from ``chunk_rows``.
Two routes, never chosen silently:

  cluster  ``n_space <= MAX_CLUSTER``: the shards of a field (K4) or of a
           (map, field) row (K5) form one thread-block cluster and exchange
           the halo through distributed shared memory; one launch a plane
           pass.  A cluster the card cannot schedule raises RuntimeError.
  chunk    a mesh row of more shards than a cluster holds: the same kernel,
           one launch per chunk of R rows, the carried row passing through
           device memory between launches (ceil((bufH-1) / R) launches).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sangnom_tpu_torch.ops import deint_kernel as dk
from sangnom_tpu_torch.ops.primitives import KernelSpec

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"full": 0, "smooth": 0, "prepare": 0, "finalize": 0}

# The most blocks a cluster takes (the portable limit on sm_90).
MAX_CLUSTER = 8
# Rows between halo exchanges when the caller gives none: the fastest R of
# the 1x4 1080 passes on an H100 (tools/shard_ab.py; PERF.md section 6).
CLUSTER_ROWS = 4

_MAPS = 9
_RING_ROWS = 5  # K4's kept-row ring slots (csrc/shard.cu kRing)
_NO_CLUSTER = -1  # the launchers' code for a cluster that cannot be scheduled
_bound = False


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
    for cols, max_cols in ((1, 64), (4, 2040), (8, 8184)):
        if W_c <= max_cols:
            return cols, _round_up(-(-W_c // cols) + 8 // cols, 32)
    raise ValueError(f"sharded kernel: {W_c} columns in a block (at most 8184)")


def cluster_rows(n_space: int, W_loc: int, n_steps: int,
                 chunk_rows: int | None = None) -> tuple[int, int]:
    """(R, H): rows between halo exchanges (``chunk_rows``, or
    ``CLUSTER_ROWS`` when None) and the halo width 3R (0 for one shard,
    which has no halo).  H <= W_loc, so a halo comes from the adjacent
    shard only."""
    R = max(1, min(chunk_rows or CLUSTER_ROWS, n_steps, W_loc // 3))
    return R, (3 * R if n_space > 1 else 0)


def block_width(n_space: int, W_loc: int, H: int) -> int:
    """The widest block: an inner shard's W_loc + 2H (W_loc + H with two
    shards, the whole plane with one)."""
    return W_loc + min(n_space - 1, 2) * H


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


def full_plan(n_space: int, W_loc: int, bufH: int, elem: int, limit: int,
              chunk_rows: int | None = None) -> Plan:
    """K4's plan for a pass of ``bufH`` kept rows, shards of ``W_loc``
    columns, ``elem``-byte samples, under a block's shared-memory
    ``limit``: the first of the routes double, single, global that fits."""
    n_steps = bufH - 1
    R, H = cluster_rows(n_space, W_loc, n_steps, chunk_rows)
    W_c = block_width(n_space, W_loc, H)
    cols, threads = shard_shape(W_c)
    cluster = n_space <= MAX_CLUSTER
    pitch_b = _round_up(W_c + cols + 8, 4)
    pitch_r = _round_up(W_c + cols + 8, 16)
    pitch_p = _round_up(threads * cols, 16)
    xb = 2 * 2 * _MAPS * H * 4 if cluster else 0
    buf = _MAPS * pitch_b * 4
    rp = _MAPS * pitch_p * elem
    ring = _RING_ROWS * pitch_r * elem
    launches = 1 if cluster else -(-n_steps // R)
    for route, smem in (("double", 2 * buf + rp + ring + xb),
                        ("single", buf + rp + ring + xb), ("global", ring + xb)):
        if smem <= limit:
            return Plan(R, H, cols, threads, cluster, launches, route, smem,
                        pitch_b, pitch_r, pitch_p)
    raise ValueError(f"sharded fused kernel: block width {W_c} exceeds shared memory")


def smooth_plan(n_space: int, W_loc: int, bufH: int, limit: int,
                chunk_rows: int | None = None) -> Plan:
    """K5's plan for a pass of ``bufH`` kept rows (bufH-1 smoothed rows):
    a double-buffered line row and the cluster exchange's buffer."""
    n_steps = bufH - 1
    R, H = cluster_rows(n_space, W_loc, n_steps, chunk_rows)
    W_c = block_width(n_space, W_loc, H)
    cols, threads = shard_shape(W_c)
    cluster = n_space <= MAX_CLUSTER
    pitch = _round_up(W_c + cols + 8, 4)
    smem = 2 * pitch * 4 + (2 * 2 * H * 4 if cluster else 0)
    if smem > limit:
        raise ValueError(f"sharded smoothing kernel: block width {W_c} exceeds "
                         "shared memory")
    return Plan(R, H, cols, threads, cluster, 1 if cluster else -(-n_steps // R),
                "double", smem, pitch, 0, 0)


def _lib() -> ctypes.CDLL:
    global _bound
    lib = dk._load()
    if not _bound:
        i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
        lib.sno_shard_full_launch.argtypes = [
            i, i, i,  # dtype, sse2, cols
            p, p, p, p, p, p, p,  # kept, dst, offsets, gbuf, grp, gin, gout
            i, i, i, i, i, i, i,  # N, n, bufH, S, W_loc, H, w_glob
            i, i, i, i, i, i,  # R, lo, hi, weave, static_offset, dbuf
            i, i, i, i,  # pitch_b, pitch_r, pitch_p, cluster_mode
            d, i, i, p]  # aaf, threads, smem, stream
        lib.sno_shard_smooth_launch.argtypes = [
            i, i, i, p, p,  # dtype, sse2, cols, raw, out
            i, i, i, i, i, i, i,  # C, n, bufH, S, W_loc, H, R
            i, i, i, i,  # base, steps, pitch, cluster_mode
            i, i, p]  # threads, smem, stream
        lib.sno_shard_prepare_launch.argtypes = [i, i, p, p, i, i, i, i, p]
        lib.sno_shard_finalize_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, i, d, p]
        lib.sno_shard_query.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.sno_shard_full_launch, lib.sno_shard_smooth_launch,
                   lib.sno_shard_prepare_launch, lib.sno_shard_finalize_launch,
                   lib.sno_shard_query):
            fn.restype = ctypes.c_int
        _bound = True
    return lib


def check_launch(lib, err: int, what: str, cluster: int) -> None:
    """Raise on a failed launch: RuntimeError naming the cluster when none
    of ``cluster`` blocks can be scheduled, else the CUDA error."""
    if err == _NO_CLUSTER:
        raise RuntimeError(f"{what}: a cluster of {cluster} blocks cannot be "
                           "scheduled on this card (cudaOccupancyMaxActiveClusters is 0)")
    dk._check(lib, err, what)


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors must lie on one CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _codes(spec: KernelSpec, device: torch.device):
    """(dtype code, sse2 flag, stream) of a launch."""
    code = dk._DTYPE_CODE[dk._storage_dtype(spec)]
    sse2 = int(spec.sse2 and not spec.is_float)
    return code, sse2, torch.cuda.current_stream(device).cuda_stream


def full_pass(kept: torch.Tensor, offsets, aaf, spec: KernelSpec, n_space: int,
              w_glob: int, chunk_rows: int | None = None) -> torch.Tensor:
    """K4 over a plane pass: ``kept`` [N, bufH, S] (storage dtype, contiguous,
    S = n_space * W_loc) -> the woven plane [N, 2*bufH, S] (``offsets`` 0, 1
    or a per-field [N] tensor) or, with ``offsets`` None, the interpolated
    rows [N, bufH-1, S]."""
    name = "sharded fused kernel"
    N, bufH, S = kept.shape
    W_loc = S // n_space
    if kept.dtype != dk._storage_dtype(spec):
        raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel spec {spec}")
    _check(name, kept)
    weave, static_offset, offs = _weave_args(offsets, kept.device)
    out = torch.empty((N, 2 * bufH if weave else bufH - 1, S), dtype=kept.dtype,
                      device=kept.device)
    lib = _lib()
    plan = full_plan(n_space, W_loc, bufH, kept.element_size(), dk._max_smem_bytes(lib, kept.device),
                     chunk_rows)
    blocks = N * n_space
    gbuf = grp = None
    if plan.route == "global":
        gbuf = torch.empty((blocks, _MAPS, plan.pitch_b), dtype=spec.acc_dtype,
                           device=kept.device)
        grp = torch.empty((blocks, _MAPS, plan.pitch_p), dtype=kept.dtype,
                          device=kept.device)
    carry = [None, None]  # the chunk route's carried row, [N, 9, S] a launch
    if not plan.cluster:
        carry = [torch.empty((N, _MAPS, S), dtype=spec.acc_dtype, device=kept.device)
                 for _ in range(2)]
    spans = [(1, bufH)] if plan.cluster else [
        (lo, min(lo + plan.R, bufH)) for lo in range(1, bufH, plan.R)]
    code, sse2, stream = _codes(spec, kept.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(kept.device):
        for k, (lo, hi) in enumerate(spans):
            err = lib.sno_shard_full_launch(
                code, sse2, plan.cols, kept.data_ptr(), out.data_ptr(), ptr(offs),
                ptr(gbuf), ptr(grp), ptr(carry[(k + 1) & 1]), ptr(carry[k & 1]), N,
                n_space, bufH, S, W_loc, plan.H, w_glob, plan.R, lo, hi, weave,
                static_offset, int(plan.route == "double"), plan.pitch_b, plan.pitch_r,
                plan.pitch_p, int(plan.cluster), float(aaf), plan.threads,
                plan.smem_bytes, stream)
            check_launch(lib, err, f"{name} launch", n_space)
            LAUNCHES["full"] += 1
    return out


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
    lib = _lib()
    W_loc = S // n_space
    plan = smooth_plan(n_space, W_loc, bufH, dk._max_smem_bytes(lib, raw.device), chunk_rows)
    chunks = [(0, bufH - 1)] if plan.cluster else [
        (base, min(plan.R, bufH - 1 - base)) for base in range(0, bufH - 1, plan.R)]
    code, sse2, stream = _codes(spec, raw.device)
    with torch.cuda.device(raw.device):
        for base, steps in chunks:
            err = lib.sno_shard_smooth_launch(
                code, sse2, plan.cols, raw.data_ptr(), out.data_ptr(), C, n_space, bufH,
                S, W_loc, plan.H, plan.R, base, steps, plan.pitch_b, int(plan.cluster),
                plan.threads, plan.smem_bytes, stream)
            check_launch(lib, err, f"{name} launch", n_space)
            LAUNCHES["smooth"] += 1
    return out


def prepare(kept: torch.Tensor, spec: KernelSpec, w_glob: int) -> torch.Tensor:
    """The chunked route's raw maps: ``kept`` [N, bufH, S] -> [9, N, bufH+1,
    S] in the accumulator dtype, zero in rows 0 and bufH and at columns >=
    ``w_glob``; taps clamp at columns 0 and S-1."""
    name = "sharded prepare kernel"
    if kept.dtype != dk._storage_dtype(spec):
        raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel spec {spec}")
    _check(name, kept)
    N, bufH, S = kept.shape
    raw = torch.empty((_MAPS, N, bufH + 1, S), dtype=spec.acc_dtype, device=kept.device)
    lib = _lib()
    code, sse2, stream = _codes(spec, kept.device)
    with torch.cuda.device(kept.device):
        err = lib.sno_shard_prepare_launch(code, sse2, kept.data_ptr(), raw.data_ptr(),
                                           N, bufH, S, w_glob, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["prepare"] += 1
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
    name = "sharded finalize kernel"
    N, bufH, S = kept.shape
    if kept.dtype != dk._storage_dtype(spec) or sm.dtype != spec.acc_dtype:
        raise ValueError(f"{name}: dtypes {kept.dtype}, {sm.dtype} do not match the "
                         f"kernel spec {spec}")
    if tuple(sm.shape) != (_MAPS, N, bufH - 1, S):
        raise ValueError(f"{name}: smoothed {tuple(sm.shape)} for kept {tuple(kept.shape)}")
    _check(name, kept, sm)
    weave, static_offset, offs = _weave_args(offsets, kept.device)
    out = torch.empty((N, 2 * bufH if weave else bufH - 1, S), dtype=kept.dtype,
                      device=kept.device)
    lib = _lib()
    code, sse2, stream = _codes(spec, kept.device)
    with torch.cuda.device(kept.device):
        err = lib.sno_shard_finalize_launch(
            code, sse2, kept.data_ptr(), sm.data_ptr(), out.data_ptr(),
            None if offs is None else offs.data_ptr(), N, bufH, S, weave, static_offset,
            float(aaf), stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["finalize"] += 1
    return out


def occupancy(kernel: str, spec: KernelSpec, plan: Plan, n_space: int,
              device: torch.device) -> dict:
    """What the card makes of a plan: registers and spill bytes a thread,
    blocks a SM, and clusters of ``n_space`` blocks resident at once (-1
    without a cluster).  ``kernel``: "full" (K4) or "smooth" (K5)."""
    lib = _lib()
    code, sse2, _ = _codes(spec, device)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.sno_shard_query(0 if kernel == "full" else 1, code, sse2, plan.cols,
                                  plan.threads, plan.smem_bytes,
                                  n_space if plan.cluster else 1, out)
    dk._check(lib, err, "sharded kernel occupancy query")
    return {"registers": out[0], "spill_bytes": out[1], "blocks_per_sm": out[2],
            "clusters": out[3]}
