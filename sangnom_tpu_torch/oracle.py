"""Native scalar oracle for verification, loaded with ctypes.

Compiles the TPU package's clean-room C++ oracle
(``sangnom_tpu/oracle/oracle.cpp``, read by path, never imported) with g++
into ``sangnom_tpu_torch/_build/`` and binds its plain C entry points.  It is
an independent scalar implementation of the C numerics contract, used to
check the port; nothing in the filter path calls it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from sangnom_tpu_torch.core.formats import VideoFormat
from sangnom_tpu_torch.core.geometry import buffer_stride_elems, scaled_aa_thresholds

_SRC = Path(__file__).resolve().parent.parent / "sangnom_tpu" / "oracle" / "oracle.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LIB = _BUILD_DIR / "liboracle.so"

_lib: ctypes.CDLL | None = None

_ENTRY = {
    np.dtype(np.uint8): ("sno_deint_u8", ctypes.c_uint8),
    np.dtype(np.uint16): ("sno_deint_u16", ctypes.c_uint16),
    np.dtype(np.float32): ("sno_deint_f32", ctypes.c_float),
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
        for name, ptr_t in _ENTRY.values():
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.POINTER(ptr_t), ctypes.POINTER(ptr_t),
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ]
        _lib = lib
    return _lib


def deinterlace_plane_oracle(src: np.ndarray, offset: int, dh: bool,
                             aaf: float, stride: int) -> np.ndarray:
    """One plane through the native oracle.  src: [h_src, w]; returns
    [h_out, w] in the same dtype.  ``aaf`` is the pre-scaled float
    threshold (the oracle truncates it to the pixel type)."""
    lib = _load()
    name, ptr_t = _ENTRY[src.dtype]
    h_src, w = src.shape
    h_out = 2 * h_src if dh else h_src
    src = np.ascontiguousarray(src)
    dst = np.zeros((h_out, w), dtype=src.dtype)
    getattr(lib, name)(
        src.ctypes.data_as(ctypes.POINTER(ptr_t)),
        dst.ctypes.data_as(ctypes.POINTER(ptr_t)),
        w, h_src, stride, int(offset), int(dh), ctypes.c_float(aaf),
    )
    return dst


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
    from sangnom_tpu_torch.ops.sangnom import field_offset_py

    offset = field_offset_py(order, frame_parity)
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    stride = buffer_stride_elems(planes[0].shape[1], fmt.component_size)
    process = [luma, chroma, chroma]
    out = []
    for i, p in enumerate(planes):
        if i >= 3:
            out.append(np.repeat(p, 2, axis=0) if dh else p.copy())
            continue
        if not dh and not process[i]:
            out.append(p.copy())
            continue
        out.append(deinterlace_plane_oracle(p, offset, dh, aafs[i], stride))
    return out
