"""ctypes bindings of the width-sharded kernels in ``csrc/shard.cu``.

``full_chunk`` launches K4 (``shard_full_kernel``) and ``smooth_chunk`` K5
(``shard_smooth_kernel``), one chunk of R global steps over every shard and
field of a plane pass.  They are the CUDA steps of the chunk loops in
``parallel.fused_smooth``, whose plain steps take the same arguments.  The
kernels are built with the rest of the library (``ops.deint_kernel.build``).
Each function checks its tensors, launches or raises, and adds one to its
``LAUNCHES`` count.
"""

from __future__ import annotations

import ctypes

import torch

from sangnom_tpu_torch.ops import deint_kernel as dk
from sangnom_tpu_torch.ops.primitives import KernelSpec

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"full": 0, "smooth": 0}

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
        lib.sno_shard_full_launch.argtypes = [
            i, i, i,  # dtype, sse2, cols
            p, p, p, p, p, p,  # keptx, smx, smout, dst, offsets, gsm
            i, i, i, i, i, i,  # n_space, N, bufH, W_loc, HALO, w_glob
            i, i, i, i,  # base, steps, weave, static_offset
            ctypes.c_double, i, i, p]  # aaf, threads, smem, stream
        lib.sno_shard_smooth_launch.argtypes = [
            i, i, i, p, p, p,  # dtype, sse2, cols, smx, rawx, out
            i, i, i, i, i, i, i,  # n_space, C, bufH, W_loc, HK, base, steps
            i, i, p]  # threads, smem, stream
        lib.sno_shard_full_launch.restype = ctypes.c_int
        lib.sno_shard_smooth_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors must lie on one CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _common(spec: KernelSpec, W_ext: int, device: torch.device):
    """(dtype code, sse2 flag, cols, threads, stream) of a launch."""
    cols, threads = dk.launch_shape(W_ext)
    code = dk._DTYPE_CODE[dk._storage_dtype(spec)]
    sse2 = int(spec.sse2 and not spec.is_float)
    return code, sse2, cols, threads, torch.cuda.current_stream(device).cuda_stream


def full_chunk(keptx, smx, out, offsets, base: int, steps: int, HALO: int,
               w_glob: int, aaf, spec: KernelSpec) -> torch.Tensor:
    """K4 over global steps base..base+steps-1: ``keptx`` [n, N, bufH, W_ext]
    (storage dtype), ``smx`` [n, N, 9, W_ext] the carried row, ``out`` the
    full-width plane [N, 2*bufH or bufH-1, n*W_loc], ``offsets`` None (no
    weave), 0, 1 or a per-field [N] tensor.  Returns the chunk's last
    smoothed row [n, N, 9, W_loc]."""
    name = "sharded fused kernel"
    n, N, bufH, W_ext = keptx.shape
    W_loc = W_ext - 2 * HALO
    if tuple(smx.shape) != (n, N, _MAPS, W_ext) or smx.dtype != spec.acc_dtype:
        raise ValueError(f"{name}: carry {tuple(smx.shape)} {smx.dtype} does not "
                         f"match kept {tuple(keptx.shape)}")
    if keptx.dtype != dk._storage_dtype(spec) or out.dtype != keptx.dtype:
        raise ValueError(f"{name}: dtype {keptx.dtype} does not match the kernel "
                         f"spec {spec}")
    weave = offsets is not None
    if tuple(out.shape) != (N, 2 * bufH if weave else bufH - 1, n * W_loc):
        raise ValueError(f"{name}: output {tuple(out.shape)} for kept "
                         f"{tuple(keptx.shape)}")
    _check(name, keptx, smx, out)
    lib = _lib()
    offs, static_offset = None, 0
    if isinstance(offsets, torch.Tensor):
        offs = offsets.to(device=keptx.device, dtype=torch.int32).contiguous()
        static_offset = -1  # per-field offsets, read by the kernel
    elif weave:
        static_offset = offsets
    limit = dk._max_smem_bytes(lib, keptx.device)
    ring_bytes = 4 * W_ext * keptx.element_size()
    sm_bytes = _MAPS * W_ext * 4
    gsm = None
    if sm_bytes + ring_bytes <= limit:
        smem = sm_bytes + ring_bytes
    elif ring_bytes <= limit:
        gsm = torch.empty((n * N, _MAPS, W_ext), dtype=spec.acc_dtype,
                          device=keptx.device)
        smem = ring_bytes
    else:
        raise ValueError(f"{name}: halo-extended width {W_ext} exceeds shared memory")
    smout = torch.empty((n, N, _MAPS, W_loc), dtype=spec.acc_dtype,
                        device=keptx.device)
    code, sse2, cols, threads, stream = _common(spec, W_ext, keptx.device)
    with torch.cuda.device(keptx.device):
        err = lib.sno_shard_full_launch(
            code, sse2, cols, keptx.data_ptr(), smx.data_ptr(), smout.data_ptr(),
            out.data_ptr(), None if offs is None else offs.data_ptr(),
            None if gsm is None else gsm.data_ptr(), n, N, bufH, W_loc, HALO,
            w_glob, base, steps, int(weave), static_offset, float(aaf), threads,
            smem, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["full"] += 1
    return smout


def smooth_chunk(smx, rawx, out, base: int, steps: int, HK: int,
                 spec: KernelSpec) -> None:
    """K5 over global steps base..base+steps-1: ``smx`` [n, C, W_ext] the
    carried row, ``rawx`` [n, C, bufH+1, W_ext] the raw maps, ``out``
    [n, C, bufH-1, W_loc] (rows base.. written)."""
    name = "sharded smoothing kernel"
    n, C, bufHp1, W_ext = rawx.shape
    W_loc = W_ext - 2 * HK
    if (tuple(smx.shape) != (n, C, W_ext)
            or tuple(out.shape) != (n, C, bufHp1 - 2, W_loc)):
        raise ValueError(f"{name}: carry {tuple(smx.shape)} and output "
                         f"{tuple(out.shape)} do not match raw {tuple(rawx.shape)}")
    for t in (smx, rawx, out):
        if t.dtype != spec.acc_dtype:
            raise ValueError(f"{name}: dtype {t.dtype} does not match the kernel "
                             f"spec {spec}")
    _check(name, smx, rawx, out)
    lib = _lib()
    smem = 2 * W_ext * 4
    if smem > dk._max_smem_bytes(lib, rawx.device):
        raise ValueError(f"{name}: halo-extended width {W_ext} exceeds shared memory")
    code, sse2, cols, threads, stream = _common(spec, W_ext, rawx.device)
    with torch.cuda.device(rawx.device):
        err = lib.sno_shard_smooth_launch(
            code, sse2, cols, smx.data_ptr(), rawx.data_ptr(), out.data_ptr(),
            n, C, bufHp1 - 1, W_loc, HK, base, steps, threads, smem, stream)
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["smooth"] += 1
