"""Native scalar oracle for verification, loaded with ctypes.

Compiles the clean-room C++ oracle (``native/oracle.cpp``, a copy of the TPU
package's ``sangnom_tpu/oracle/oracle.cpp``, kept byte-identical by a test)
with g++ into ``sangnom_tpu_torch/_build/`` and binds its plain C entry
points.  It is an independent scalar implementation of the C numerics
contract, with the reference's shared pool as an option, used to check the
port; nothing in the filter path calls it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from sangnom_tpu_torch.core.formats import VideoFormat
from sangnom_tpu_torch.core.geometry import buffer_stride_elems, scaled_aa_thresholds

_SRC = Path(__file__).resolve().parent / "native" / "oracle.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LIB = _BUILD_DIR / "liboracle.so"

_lib: ctypes.CDLL | None = None

_ENTRY = {
    np.dtype(np.uint8): ("sno_deint_u8", ctypes.c_uint8, ctypes.c_int32),
    np.dtype(np.uint16): ("sno_deint_u16", ctypes.c_uint16, ctypes.c_int32),
    np.dtype(np.float32): ("sno_deint_f32", ctypes.c_float, ctypes.c_float),
}


def _compile() -> Path:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    base = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-shared",
            "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(base[:2] + ["-march=native"] + base[2:], check=True,
                       capture_output=True, text=True)
    except subprocess.CalledProcessError:
        # toolchains without -march=native
        subprocess.run(base, check=True, capture_output=True, text=True)
    os.replace(tmp, _LIB)  # atomic: a concurrent build never sees a partial file
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_compile()))
        for name, ptr_t, pool_t in _ENTRY.values():
            common = [
                ctypes.POINTER(ptr_t), ctypes.POINTER(ptr_t),
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ]
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = common
            fnp = getattr(lib, name + "_pool")
            fnp.restype = None
            fnp.argtypes = common + [ctypes.POINTER(pool_t), ctypes.c_long]
        _lib = lib
    return _lib


def make_pool_oracle(stride: int, pool_rows: int, is_float: bool) -> np.ndarray:
    """A fresh shared pool for pool-compat calls: [9, pool_rows+1, stride]
    zeros in the oracle's accumulator dtype."""
    return np.zeros((9, pool_rows + 1, stride),
                    np.float32 if is_float else np.int32)


def deinterlace_plane_oracle(src: np.ndarray, offset: int, dh: bool,
                             aaf: float, stride: int,
                             pool: np.ndarray | None = None) -> np.ndarray:
    """One plane through the native oracle.  src: [h_src, w]; returns
    [h_out, w] in the same dtype.  ``aaf`` is the pre-scaled float
    threshold (the oracle truncates it to the pixel type).  ``pool``: a
    shared pool from `make_pool_oracle`, mutated in place (pool-compat mode,
    reference src/SangNom2.cpp:265-272)."""
    lib = _load()
    name, ptr_t, pool_t = _ENTRY[src.dtype]
    h_src, w = src.shape
    h_out = 2 * h_src if dh else h_src
    src = np.ascontiguousarray(src)
    dst = np.zeros((h_out, w), dtype=src.dtype)
    args = [
        src.ctypes.data_as(ctypes.POINTER(ptr_t)),
        dst.ctypes.data_as(ctypes.POINTER(ptr_t)),
        w, h_src, stride, int(offset), int(dh), ctypes.c_float(aaf),
    ]
    if pool is None:
        getattr(lib, name)(*args)
    else:
        if (not pool.flags["C_CONTIGUOUS"] or pool.ndim != 3
                or pool.shape[0] != 9 or pool.shape[1] <= h_out // 2
                or pool.shape[2] != stride or pool.dtype != np.dtype(pool_t)):
            raise ValueError(f"pool must be a contiguous [9, P+1, {stride}] "
                             f"{np.dtype(pool_t).name} array with P >= {h_out // 2}")
        getattr(lib, name + "_pool")(
            *args, pool.ctypes.data_as(ctypes.POINTER(pool_t)), pool.shape[1] - 1)
    return dst


def sangnom2_clip_oracle(
    frames: list[list[np.ndarray]],
    fmt: VideoFormat,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    parities: list[bool] | None = None,
    pool_compat: bool = False,
) -> list[list[np.ndarray]]:
    """A whole clip (frames of [h, w] planes) through the native oracle; with
    ``pool_compat=True`` ONE luma-geometry pool is threaded through every
    processed plane of every frame in order, as the reference's
    constructor-allocated pool is (src/SangNom2.cpp:303-310, 265-272)."""
    from sangnom_tpu_torch.ops.sangnom import field_offset_py

    aafs = scaled_aa_thresholds(aa, aac, fmt)
    h0, w0 = frames[0][0].shape
    stride = buffer_stride_elems(w0, fmt.component_size)
    pool = None
    if pool_compat:
        pool = make_pool_oracle(stride, (2 * h0 if dh else h0) // 2, fmt.is_float)
    process = [luma, chroma, chroma]
    out = []
    for n, planes in enumerate(frames):
        offset = field_offset_py(order, parities[n] if parities is not None else True)
        fout = []
        for i, p in enumerate(planes):
            if i >= 3:
                fout.append(np.repeat(p, 2, axis=0) if dh else p.copy())
            elif not dh and not process[i]:
                fout.append(p.copy())
            else:
                fout.append(deinterlace_plane_oracle(p, offset, dh, aafs[i],
                                                     stride, pool))
        out.append(fout)
    return out


def sangnom2_frame_oracle(
    planes: list[np.ndarray],
    fmt: VideoFormat,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    frame_parity: bool = True,
) -> list[np.ndarray]:
    """One frame ([h, w] numpy planes) through the native oracle, with the
    filter's orchestration contract (GetFrame semantics, reference
    src/SangNom2.cpp:332-397)."""
    return sangnom2_clip_oracle([planes], fmt, order, aa, aac, dh, luma, chroma,
                                parities=[frame_parity])[0]
