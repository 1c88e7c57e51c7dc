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

Each wrapper checks shapes, dtypes and layout, then on a CPU tensor runs
its plain PyTorch twin (the ``*_plain`` functions) and on a CUDA tensor
launches its kernel or raises.  Kept rows may be strided (a field read in
place from its frame); columns must be contiguous.  The kernels are built
with the field kernel's library (``deint_kernel.build``).  ``LAUNCHES``
counts launches per kernel; a K7 pass counts one "prepare", one "split3"
and one "finalize".
"""

from __future__ import annotations

import ctypes

import torch

from sangnom_tpu_torch.ops import deint_kernel as dk
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.ops.reference import (
    error_maps_list,
    finalize_select_from_taps,
    pair_taps,
    smooth_scan,
)

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"smooth": 0, "split3": 0, "prepare": 0, "finalize": 0}

_MAPS = 9
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = dk._load()
    if not _bound:
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.sno_pool_smooth_launch.argtypes = [
            i, i, i, p, i, i, i, p]  # dtype sse2 cols pool P S threads stream
        lib.sno_pool_smooth_split3_launch.argtypes = [
            i, i, i, p, p, p, i, i, i, p]  # ... row0 body tail P S threads stream
        lib.sno_pool_prepare_launch.argtypes = [
            i, i, p, p, ll, i, i, i, i, p]  # dtype sse2 kept body pitch P R w S stream
        lib.sno_pool_finalize_launch.argtypes = [
            i, i, p, p, p, ll, i, i, i, i,  # dtype sse2 kept body interp pitch P R w S
            ctypes.c_double, p]  # aaf stream
        for fn in (lib.sno_pool_smooth_launch, lib.sno_pool_smooth_split3_launch,
                   lib.sno_pool_prepare_launch, lib.sno_pool_finalize_launch):
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
    if kept.dtype != dk._storage_dtype(spec):
        raise ValueError(f"{name}: dtype {kept.dtype} does not match the kernel "
                         f"spec {spec}")
    bufH_p, w = kept.shape
    if kept.stride(1) != 1 or kept.stride(0) < w:
        raise ValueError(f"{name}: kept rows must be contiguous (column stride 1), "
                         f"got strides {kept.stride()}")
    if not 2 <= bufH_p <= P or not 1 <= w <= S:
        raise ValueError(f"{name}: kept {tuple(kept.shape)} does not fit the "
                         f"pool [9, {P + 1}, {S}] (needs 2 <= rows <= P)")


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
                                         threads, stream)
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
            P, S, threads, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["split3"] += 1
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
    name = "pool prepare kernel"
    P, S = _check_body(name, spec, body)
    _check_kept(name, spec, kept, P, S, body.device)
    if kept.device.type == "cpu":
        return prepare_pool_plain_(kept, body, spec)
    bufH_p, w = kept.shape
    lib = _lib()
    code, sse2, _, _, stream = _common(spec, S, kept.device)
    with torch.cuda.device(kept.device):
        err = lib.sno_pool_prepare_launch(code, sse2, kept.data_ptr(), body.data_ptr(),
                                          kept.stride(0), P, bufH_p - 1, w, S, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["prepare"] += 1
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
    name = "pool finalize kernel"
    P, S = _check_body(name, spec, body)
    _check_kept(name, spec, kept, P, S, body.device)
    if kept.device.type == "cpu":
        return finalize_pool_plain(kept, body, aaf, spec)
    bufH_p, w = kept.shape
    out = torch.empty((bufH_p - 1, w), dtype=kept.dtype, device=kept.device)
    lib = _lib()
    code, sse2, _, _, stream = _common(spec, S, kept.device)
    with torch.cuda.device(kept.device):
        err = lib.sno_pool_finalize_launch(
            code, sse2, kept.data_ptr(), body.data_ptr(), out.data_ptr(),
            kept.stride(0), P, bufH_p - 1, w, S, float(aaf), stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["finalize"] += 1
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
