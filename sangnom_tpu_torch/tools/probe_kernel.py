"""ctypes bindings of the probe kernels in ``csrc/probes.cu``.

``dynrow`` launches K10 (``dynrow_kernel``), ``calibrate`` K8
(``line_kernel`` and, for the mm and step arms, ``mm_kernel`` and
``step_kernel``) and ``isolate`` K9 (``isolate_kernel``).  The kernels are
built with the rest of the library (``ops.deint_kernel.build``).  Each
function checks its tensors, launches or raises, and adds one to its
``LAUNCHES`` count.
"""

from __future__ import annotations

import ctypes

import torch

from sangnom_tpu_torch.ops import deint_kernel as dk

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"dynrow": 0, "calibrate": 0, "isolate": 0}

# Arm name -> the kernel's arm code (csrc/probes.cu enum Arm / IsoArm).
CALIBRATE_CODES = {name: i for i, name in enumerate((
    "add", "roll", "roll3", "roll_sub", "concat_rot", "jroll", "where",
    "shift_and", "min", "mul", "mix", "troll_sub", "troll3", "tadd", "tmix",
    "rolladd", "trolladd", "trolladd8", "vshift1", "vshift6", "rolladd2",
    "rollvshift", "mmbf16", "mmf32", "mmint8", "mmroll", "stepv", "stepm",
    "stepmbf", "steph"))}
ISOLATE_CODES = {name: i for i, name in enumerate((
    "roll2chz", "ramt", "hboxtree", "hboxsub", "hboxwb", "hboxfull", "roll2ch",
    "hboxprod", "hboxk", "bigslab", "slab3d", "slab3d1", "unroll", "fori",
    "bigshift", "smallshift"))}

_G = 120
_bound = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = dk._load()
    if not _bound:
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sno_probe_dynrow_launch.argtypes = [i, p, p, i, i, i, p]
        lib.sno_probe_calibrate_launch.argtypes = [i, p, p, p, i, i, i, p]
        lib.sno_probe_isolate_launch.argtypes = [i, i, i, p, p, i, i, p]
        for f in (lib.sno_probe_dynrow_launch, lib.sno_probe_calibrate_launch,
                  lib.sno_probe_isolate_launch):
            f.restype = ctypes.c_int
        _bound = True
    return lib


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def dynrow(kept: torch.Tensor, steps: int) -> torch.Tensor:
    """K10: [H, S] u8/i32 -> [steps, 1, S] int32."""
    name = "dynamic-row probe kernel"
    _check(name, kept)
    if kept.dim() != 2 or kept.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"{name}: expected [H, S] u8 or i32, got "
                         f"{tuple(kept.shape)} {kept.dtype}")
    H, S = kept.shape
    out = torch.empty((steps, 1, S), dtype=torch.int32, device=kept.device)
    if not out.numel():
        return out
    lib = _lib()
    with torch.cuda.device(kept.device):
        err = lib.sno_probe_dynrow_launch(int(kept.dtype == torch.uint8), kept.data_ptr(),
                                          out.data_ptr(), H, S, steps, _stream(kept))
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["dynrow"] += 1
    return out


def calibrate(src: torch.Tensor, kind: str, k: int, steps: int,
              m: torch.Tensor | None = None) -> torch.Tensor:
    """K8: one arm on [G, w] int32 -> [steps, G, 128] int32 (the transposed
    arms write columns 120..127 as zeros).  ``m``: the permutation matrix of
    the mm and step-m arms, in the layout ``csrc/probes.cu`` documents
    (``calibrate_vpu.kernel_matrix``)."""
    name = "calibration kernel"
    _check(name, src)
    G, w = src.shape
    if G != _G or src.dtype != torch.int32 or w % 128 or not 128 <= w <= 2048:
        raise ValueError(f"{name}: input {tuple(src.shape)} {src.dtype}, expected "
                         f"[{_G}, w] int32 with w a multiple of 128 up to 2048")
    if kind not in CALIBRATE_CODES or k < 1:
        raise ValueError(f"{name}: arm {kind!r} with k={k}")
    needs_m = kind.startswith("mm") or kind in ("stepm", "stepmbf")
    if needs_m != (m is not None):
        raise ValueError(f"{name}: arm {kind!r} {'needs' if needs_m else 'takes no'} matrix")
    if m is not None:
        _check(name, m)
    alloc = torch.zeros if kind == "mmroll" else torch.empty  # mmroll adds into out
    out = alloc((steps, G, 128), dtype=torch.int32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.sno_probe_calibrate_launch(
            CALIBRATE_CODES[kind], src.data_ptr(), None if m is None else m.data_ptr(),
            out.data_ptr(), w, k, steps, _stream(src))
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["calibrate"] += 1
    return out


def isolate(src: torch.Tensor, kind: str, k: int, steps: int) -> torch.Tensor:
    """K9: one arm on [G, 2048] int32 -> [steps, G, 128] int32."""
    name = "step-isolation kernel"
    _check(name, src)
    if tuple(src.shape) != (_G, 2048) or src.dtype != torch.int32:
        raise ValueError(f"{name}: input {tuple(src.shape)} {src.dtype}, expected "
                         f"[{_G}, 2048] int32")
    base = kind.removesuffix("_iota")
    amount = 0
    if base.startswith("ramt"):
        base, amount = "ramt", int(base[4:]) % 2048
    if base not in ISOLATE_CODES or k < 1:
        raise ValueError(f"{name}: arm {kind!r} with k={k}")
    out = torch.empty((steps, _G, 128), dtype=torch.int32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.sno_probe_isolate_launch(ISOLATE_CODES[base], int(kind.endswith("_iota")),
                                           amount, src.data_ptr(), out.data_ptr(), k,
                                           steps, _stream(src))
    dk._check(lib, err, f"{name} launch")
    LAUNCHES["isolate"] += 1
    return out
