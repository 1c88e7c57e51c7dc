"""The hand-written CUDA kernels of the pool-compat pass, and their plain twins.

Three wrappers, each launching one kernel of ``csrc/pool.cu`` and replacing
one TPU kernel of ``sangnom_tpu/ops/pool_carry.py``:

  ``smooth_pool_``   K3, ``_smooth_rows_pallas`` (body ``_pool_smooth_kernel``):
                     smooths pool rows 1..P-1 of a ``[9, P+1, S]`` pool in place.
  ``smooth_split3_`` K6, ``_smooth_rows_split3`` (body
                     ``_pool_smooth_tail_kernel``): the same smoothing on the
                     split carry ``(row0 [9, S], body [9, P-1, S], tail [9, S])``,
                     body in place.
  ``interp_fused``   K7, ``interp_field_pool_fused`` (body ``_pool_fused_kernel``):
                     a whole plane pass on the split carry, returning the
                     interpolated rows.

Each wrapper checks shapes, dtypes and contiguity, then on a CPU tensor runs
its plain PyTorch twin (the ``*_plain`` functions) and on a CUDA tensor
launches the kernel or raises.  The kernels
are built with the field kernel's library (``deint_kernel.build``).
``LAUNCHES`` counts launches per kernel.
"""

from __future__ import annotations

import ctypes

import torch

from sangnom_tpu_torch.ops import deint_kernel as dk
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.ops.reference import smooth_scan

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"smooth": 0, "split3": 0, "fused": 0}

_MAPS = 9
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = dk._load()
    if not _bound:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sno_pool_smooth_launch.argtypes = [
            i, i, i, p, i, i, i, i, p]  # dtype sse2 cols pool P S threads smem stream
        lib.sno_pool_smooth_split3_launch.argtypes = [
            i, i, i, p, p, p, i, i, i, i, p]  # ... row0 body tail P S ...
        lib.sno_pool_fused_launch.argtypes = [
            i, i, i, p, p, p, p, p,  # dtype sse2 cols kept interp row0 body tail
            i, i, i, i, ctypes.c_double, i, i, p]  # bufH_p w P S aaf threads smem stream
        for fn in (lib.sno_pool_smooth_launch, lib.sno_pool_smooth_split3_launch,
                   lib.sno_pool_fused_launch):
            fn.restype = ctypes.c_int
        _bound = True
    return lib


def _check_acc(name: str, spec: KernelSpec, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != spec.acc_dtype:
            raise ValueError(f"{name}: pool dtype {t.dtype} does not match the "
                             f"kernel spec {spec}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: pool tensors must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: pool tensors on different devices")


def _check_split(name: str, spec: KernelSpec, row0, body, tail) -> tuple[int, int]:
    """(P, S) of a valid split carry, or ValueError."""
    if body.dim() != 3 or body.shape[0] != _MAPS:
        raise ValueError(f"{name}: body must be [9, P-1, S], got {tuple(body.shape)}")
    S = body.shape[2]
    for t, what in ((row0, "row0"), (tail, "tail")):
        if tuple(t.shape) != (_MAPS, S):
            raise ValueError(f"{name}: {what} must be [9, {S}], got {tuple(t.shape)}")
    _check_acc(name, spec, body, row0, tail)
    return body.shape[1] + 1, S


def _common(spec: KernelSpec, S: int, device: torch.device):
    """(dtype code, sse2 flag, cols, threads, stream) of a launch."""
    cols, threads = dk.launch_shape(S)
    code = dk._DTYPE_CODE[dk._storage_dtype(spec)]
    sse2 = int(spec.sse2 and not spec.is_float)
    return code, sse2, cols, threads, torch.cuda.current_stream(device).cuda_stream


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
    name = "pool smooth kernel"
    if pool.dim() != 3 or pool.shape[0] != _MAPS:
        raise ValueError(f"{name}: pool must be [9, P+1, S], got {tuple(pool.shape)}")
    _check_acc(name, spec, pool)
    if pool.device.type == "cpu":
        return smooth_pool_plain_(pool, spec)
    P, S = pool.shape[1] - 1, pool.shape[2]
    if P < 2:
        return pool
    lib = _lib()
    code, sse2, cols, threads, stream = _common(spec, S, pool.device)
    with torch.cuda.device(pool.device):
        err = lib.sno_pool_smooth_launch(code, sse2, cols, pool.data_ptr(), P, S,
                                         threads, 2 * S * 4, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["smooth"] += 1
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
    name = "pool split3 kernel"
    P, S = _check_split(name, spec, row0, body, tail)
    if body.device.type == "cpu":
        return smooth_split3_plain_(row0, body, tail, spec)
    if P < 2:
        return body
    lib = _lib()
    code, sse2, cols, threads, stream = _common(spec, S, body.device)
    with torch.cuda.device(body.device):
        err = lib.sno_pool_smooth_split3_launch(
            code, sse2, cols, row0.data_ptr(), body.data_ptr(), tail.data_ptr(),
            P, S, threads, 2 * S * 4, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["split3"] += 1
    return body


# --- K7 --------------------------------------------------------------------

def interp_fused_plain(kept, row0, body, tail, aaf, spec: KernelSpec):
    """Plain twin of `interp_fused`: the plain plane pass
    (``pool_carry.interp_field_pool``) on the joined carry."""
    from sangnom_tpu_torch.ops.pool_carry import interp_field_pool

    pool = torch.cat([row0[:, None], body, tail[:, None]], dim=1)
    interp = interp_field_pool(kept, pool, aaf, spec)
    body.copy_(pool[:, 1:-1])
    return interp


def interp_fused(kept: torch.Tensor, row0: torch.Tensor, body: torch.Tensor,
                 tail: torch.Tensor, aaf, spec: KernelSpec) -> torch.Tensor:
    """One pool-compat plane pass in one kernel: ``kept`` [bufH_p, w]
    (storage dtype, contiguous, 2 <= bufH_p <= P, w <= S) -> interpolated
    rows [bufH_p-1, w]; ``body`` is smoothed in place."""
    name = "pool fused kernel"
    P, S = _check_split(name, spec, row0, body, tail)
    if kept.dim() != 2:
        raise ValueError(f"{name}: kept must be [bufH_p, w], got {tuple(kept.shape)}")
    if kept.device != body.device:
        raise ValueError(f"{name}: kept and pool on different devices")
    if kept.dtype != dk._storage_dtype(spec):
        raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel "
                         f"spec {spec}")
    if not kept.is_contiguous():
        raise ValueError(f"{name}: kept must be contiguous")
    bufH_p, w = kept.shape
    if not 2 <= bufH_p <= P or not 1 <= w <= S:
        raise ValueError(f"{name}: kept {tuple(kept.shape)} does not fit the "
                         f"pool [9, {P + 1}, {S}] (needs 2 <= rows <= P)")
    if kept.device.type == "cpu":
        return interp_fused_plain(kept, row0, body, tail, aaf, spec)
    lib = _lib()
    smem = _MAPS * S * 4 + 4 * w * kept.element_size()
    if smem > dk._max_smem_bytes(lib, kept.device):
        raise ValueError(f"{name}: pool stride {S} exceeds shared memory")
    code, sse2, cols, threads, stream = _common(spec, S, kept.device)
    interp = torch.empty((bufH_p - 1, w), dtype=kept.dtype, device=kept.device)
    with torch.cuda.device(kept.device):
        err = lib.sno_pool_fused_launch(
            code, sse2, cols, kept.data_ptr(), interp.data_ptr(),
            row0.data_ptr(), body.data_ptr(), tail.data_ptr(), bufH_p, w, P, S,
            float(aaf), threads, smem, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["fused"] += 1
    return interp
