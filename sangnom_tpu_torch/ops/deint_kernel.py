"""The hand-written CUDA kernel for field interpolation, and its plain twin.

`deinterlace_field_batch_fused` (woven full-height output) and
`interpolate_field_batch` (interpolated rows only) launch
``csrc/deint.cu::deint_kernel``, which replaces the TPU package's
``ops/pallas_kernel.py::_kernel`` (launched there by ``_deint_chunk`` and
``_interp_chunk``).  On a CPU tensor each wrapper runs its plain PyTorch
version instead; on a CUDA tensor it launches the kernel or raises.

The kernel library (this kernel and the pool kernels of ``ops/pool_kernel``)
is compiled with nvcc for sm_90a at first use, one nvcc per source in
``csrc/``, all started together, into ``sangnom_tpu_torch/_build/`` (rebuilt
when a source or header is newer), and bound with ctypes.  ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from sangnom_tpu_torch.core.fields import _split_plane
from sangnom_tpu_torch.core.geometry import width_tiers
from sangnom_tpu_torch.ops import reference
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.ops.sangnom import Offset, weave_assemble

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_LIB = _BUILD_DIR / "libsangnom_cuda.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
]

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

_lib: ctypes.CDLL | None = None
_max_smem: dict[int, int] = {}

# Storage dtype -> the C launcher's dtype code.
_DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_MAPS = 9
_RING_ROWS = 4  # kept-row ring slots


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(verbose: bool = False) -> float:
    """Compile the kernel library if it is missing or older than a source.
    Returns the seconds spent compiling (0.0 when it was up to date).
    ``verbose`` adds ptxas's register and shared-memory report to stdout."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in _SRC_DIR.iterdir())
    if _LIB.exists() and _LIB.stat().st_mtime >= newest and not verbose:
        return 0.0
    _BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = _LIB.with_name(f"{_LIB.name}.{tag}")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    try:
        cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", str(src), "-o", str(obj)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
            if verbose:
                print(err, end="")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, _LIB)  # atomic: a concurrent build never sees a partial file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB))
        lib.sno_max_smem.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.sno_max_smem.restype = ctypes.c_int
        lib.sno_error_string.argtypes = [ctypes.c_int]
        lib.sno_error_string.restype = ctypes.c_char_p
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sno_deint_launch.argtypes = [
            i, i, i,  # dtype, sse2, cols
            p, p, p, p, p,  # src, dst, offsets, global buffer and raw scratch
            i, i, i, i,  # n_fields, bufH, w, S
            i, i, i,  # pitch_b, pitch_r, pitch_p
            ctypes.c_longlong,  # in_frame_stride
            i, i, i, i,  # interlaced, weave, static_offset, dbuf
            ctypes.c_double,  # aaf
            i, i,  # threads, smem_bytes
            p,  # stream
        ]
        lib.sno_deint_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.sno_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _max_smem_bytes(lib: ctypes.CDLL, device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _max_smem:
        v = ctypes.c_int(0)
        _check(lib, lib.sno_max_smem(idx, ctypes.byref(v)), "shared-memory query")
        _max_smem[idx] = v.value
    return _max_smem[idx]


def launch_shape(S: int) -> tuple[int, int]:
    """(columns per thread, threads per block) covering S smoothed columns:
    thread t owns the contiguous columns t*cols .. t*cols+cols-1; one column
    per thread up to 512 columns, else 4 columns per thread (<= 512
    threads), else 8 (<= 1024 threads).  The kernel is instantiated for
    exactly these column counts.  (A 2-column build spilled 1 KB per thread
    under ptxas for sm_90a and ran the 1080 chroma launch 5x slower than 4
    columns on an H100: 12.0 against 2.4 ms.)"""
    for cols, max_threads in ((1, 512), (4, 512), (8, 1024)):
        n = -(-S // cols)
        if n <= max_threads:
            return cols, max(32, -(-n // 32) * 32)
    raise ValueError(f"plane too wide for the CUDA kernel: {S} smoothed columns "
                     "(at most 8192)")


class LaunchPlan(NamedTuple):
    """How one launch lays out its memory (see ``csrc/deint.cu``).

    ``route``: "double" (two shared smoothing buffers, one barrier a row
    step), "single" (one shared buffer, two barriers) or "global" (buffer and
    raw slices in global scratch, two barriers).  ``pitch_b``: elements of a
    smoothing-buffer row (4 pad columns, S, and the right pad);
    ``pitch_r``: of a kept-row ring row; ``pitch_p``: of a raw-slice row.
    ``smem_bytes``: the dynamic shared memory the launch asks for."""

    cols: int
    threads: int
    route: str
    smem_bytes: int
    pitch_b: int
    pitch_r: int
    pitch_p: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def launch_plan(w: int, S: int, elem: int, limit: int) -> LaunchPlan:
    """The launch plan for a plane of width ``w``, ``S`` smoothed columns
    and ``elem``-byte samples under a block's shared-memory ``limit``: the
    first route whose shared memory fits, in the order double, single,
    global.  Raises ValueError if not even the kept-row ring fits."""
    cols, threads = launch_shape(S)
    pitch_b = _round_up(S + cols + 8, 4)
    pitch_r = _round_up(w + cols + 8, 16)
    pitch_p = _round_up(threads * cols, 16)
    buf = _MAPS * pitch_b * 4
    rp = _MAPS * pitch_p * elem
    ring = _RING_ROWS * pitch_r * elem
    for route, smem in (("double", 2 * buf + rp + ring), ("single", buf + rp + ring),
                        ("global", ring)):
        if smem <= limit:
            return LaunchPlan(cols, threads, route, smem, pitch_b, pitch_r, pitch_p)
    raise ValueError(f"deint kernel: plane width {w} exceeds shared memory")


def _storage_dtype(spec: KernelSpec) -> torch.dtype:
    if spec.is_float:
        return torch.float32
    return torch.uint8 if spec.mask == 0xFF else torch.uint16


def _launch(src: torch.Tensor, out: torch.Tensor, spec: KernelSpec, aaf,
            n_fields: int, bufH: int, w: int, stride: int,
            interlaced: int, weave: bool, offset: Offset) -> None:
    """Validate and launch; ``src`` is [N, bufH, w] kept rows, or with
    ``interlaced`` (1 tff, 2 bff) an [N/2, 2*bufH, w] interlaced plane."""
    global LAUNCHES
    device = src.device
    if device.type != "cuda":
        raise ValueError(f"deint kernel needs a CUDA tensor, got {device}")
    if src.dtype != _storage_dtype(spec):
        raise ValueError(f"deint kernel: dtype {src.dtype} does not match the "
                         f"kernel spec {spec}")
    if not src.is_contiguous():
        raise ValueError("deint kernel: input must be contiguous")
    if stride < w:
        raise ValueError(f"deint kernel: stride {stride} < width {w}")
    _, _, S = width_tiers(w, bufH, stride, spec)
    lib = _load()
    plan = launch_plan(w, S, src.element_size(), _max_smem_bytes(lib, device))
    gbuf = grp = None
    if plan.route == "global":
        gbuf = torch.empty((n_fields, _MAPS, plan.pitch_b), dtype=spec.acc_dtype,
                           device=device)
        grp = torch.empty((n_fields, _MAPS, plan.pitch_p), dtype=src.dtype,
                          device=device)
    offs = None
    if isinstance(offset, int):
        if offset not in (0, 1):
            raise ValueError(f"deint kernel: offset {offset} not in (0, 1)")
        static_offset = offset
    else:
        static_offset = -1  # per-field offsets, read by the kernel
        offs = torch.as_tensor(offset, dtype=torch.int32, device=device)
        if offs.shape != (n_fields,) or not offs.is_contiguous():
            raise ValueError(f"deint kernel: offsets {tuple(offs.shape)} for "
                             f"{n_fields} fields")
    stream = torch.cuda.current_stream(device).cuda_stream
    in_frame_stride = src.shape[1] * w
    with torch.cuda.device(device):
        err = lib.sno_deint_launch(
            _DTYPE_CODE[src.dtype], int(spec.sse2 and not spec.is_float), plan.cols,
            src.data_ptr(), out.data_ptr(),
            None if offs is None else offs.data_ptr(),
            None if gbuf is None else gbuf.data_ptr(),
            None if grp is None else grp.data_ptr(),
            n_fields, bufH, w, S, plan.pitch_b, plan.pitch_r, plan.pitch_p,
            in_frame_stride, interlaced, int(weave), static_offset,
            int(plan.route == "double"), float(aaf), plan.threads,
            plan.smem_bytes, stream,
        )
    _check(lib, err, "deint kernel launch")
    LAUNCHES += 1


def deinterlace_field_batch_plain(
    kept: torch.Tensor, offset: Offset, aaf, spec: KernelSpec, stride: int,
    interlaced_tff: bool | None = None,
) -> torch.Tensor:
    """Plain version of `deinterlace_field_batch_fused`: split the fields,
    interpolate with the plain path, weave."""
    if interlaced_tff is not None:
        kept = _split_plane(kept, interlaced_tff)
    interp = reference.interpolate_field_batch(kept, aaf, spec, stride)
    return weave_assemble(kept, interp, offset)


def deinterlace_field_batch_fused(
    kept: torch.Tensor, offset: Offset, aaf, spec: KernelSpec, stride: int,
    interlaced_tff: bool | None = None,
) -> torch.Tensor:
    """[N, bufH, w] kept fields -> the complete deinterlaced plane
    [N, 2*bufH, w]: kept and interpolated rows interleaved per ``offset``
    (an int, or a per-frame [N] int32 tensor of 0/1), the boundary line
    duplicated.

    ``interlaced_tff`` not None: ``kept`` is an INTERLACED [N/2, 2*bufH, w]
    plane and output frame 2j+b is built from field b of input frame j
    (True: b=0 is the top field); the kernel reads the fields in place.
    """
    if kept.device.type == "cpu":
        return deinterlace_field_batch_plain(kept, offset, aaf, spec, stride,
                                             interlaced_tff)
    if kept.dim() != 3:
        raise ValueError(f"deint kernel: expected [N, H, W], got {tuple(kept.shape)}")
    if interlaced_tff is None:
        n_fields, bufH, w = kept.shape
        interlaced = 0
    else:
        n_in, H, w = kept.shape
        if H % 2:
            raise ValueError(f"deint kernel: interlaced height {H} is odd")
        n_fields, bufH = 2 * n_in, H // 2
        interlaced = 1 if interlaced_tff else 2
    out = torch.empty((n_fields, 2 * bufH, w), dtype=kept.dtype,
                      device=kept.device)
    if out.numel():
        _launch(kept, out, spec, aaf, n_fields, bufH, w, stride, interlaced,
                True, offset)
    return out


def interpolate_field_batch(
    kept: torch.Tensor, aaf, spec: KernelSpec, stride: int
) -> torch.Tensor:
    """[N, bufH, w] kept fields (storage dtype) -> [N, bufH-1, w]
    interpolated lines in the same dtype."""
    if kept.device.type == "cpu":
        return reference.interpolate_field_batch(kept, aaf, spec, stride)
    if kept.dim() != 3:
        raise ValueError(f"deint kernel: expected [N, H, W], got {tuple(kept.shape)}")
    N, bufH, w = kept.shape
    out = torch.empty((N, max(bufH - 1, 0), w), dtype=kept.dtype,
                      device=kept.device)
    if out.numel():
        _launch(kept, out, spec, aaf, N, bufH, w, stride, 0, False, 0)
    return out


# read by ops.sangnom.deinterlace_plane_batch: this backend weaves in-kernel
interpolate_field_batch.fused_weave = deinterlace_field_batch_fused
