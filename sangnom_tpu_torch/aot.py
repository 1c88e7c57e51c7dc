"""Prewarmed artifacts: what a fresh process would otherwise build first.

The reference is an AOT-compiled .so: its first frame at any resolution
costs nothing beyond the library load (reference src/SangNom2.cpp:312-329).
A fresh process of this package pays, before its first output, the nvcc
build of the CUDA kernel library (``ops.cuda_library``) and its load; there
is no traced program to serialize, because PyTorch runs eagerly.  So an
artifact directory holds:

* the kernel library, built once into the directory under its
  `cuda_library.source_hash` (``libsangnom_cuda-<hash>.so``); a process
  with this module configured loads it from there and never runs nvcc;
* one small JSON artifact per dispatch: (kind, format, per-plane shapes and
  dtypes, statics, device name and compute capability), with the library
  hash it was made against.

Usage::

    sangnom-tpu-torch prewarm --aot DIR --size WxH --format F [params]
    sangnom-tpu-torch IN OUT --aot DIR [params]

A dispatch whose artifact is present and current counts a hit in `STATS`;
a missing, corrupt or stale one (another library hash or device) counts a
miss, and a corrupt or stale one prints a warning.  Hit or miss, the
dispatch runs the same code, so the output bits are the same: an artifact
is a fast-start record, never a correctness surface.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

#: process-wide artifact directory (None = disabled); set via configure()
_AOT_DIR: Path | None = None
_CACHE: dict[str, bool] = {}  # key -> whether its artifact is usable
_LOCK = threading.Lock()
#: observability: dispatches served from artifacts, and the misses
STATS = {"hits": 0, "misses": 0}
_SUFFIX = ".json"


def configure(aot_dir: str | os.PathLike | None) -> None:
    """Enable (or disable with None) artifact lookup for this process."""
    global _AOT_DIR
    with _LOCK:
        _AOT_DIR = Path(aot_dir) if aot_dir else None
        _CACHE.clear()
        STATS["hits"] = STATS["misses"] = 0


def is_configured() -> bool:
    return _AOT_DIR is not None


def library_path() -> Path | None:
    """The configured directory's kernel library of the current
    `cuda_library.source_hash`, or None (unconfigured, or not there)."""
    aot_dir = _AOT_DIR
    if aot_dir is None:
        return None
    from sangnom_tpu_torch.ops import cuda_library

    path = aot_dir / cuda_library.library_name()
    return path if path.exists() else None


def device_identity(device: str | torch.device = "cuda") -> dict:
    """The device part of a key: the type, and for a card its name and
    compute capability (a program for one card never serves another)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"type": dev.type}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"type": "cuda", "name": torch.cuda.get_device_name(idx),
            "capability": list(torch.cuda.get_device_capability(idx))}


def _canonical(kind: str, fmt_name: str, shapes, statics: dict,
               device) -> dict:
    return {
        "kind": kind,
        "fmt": fmt_name,
        "shapes": [[list(s), str(d)] for s, d in shapes],
        "statics": {k: statics[k] for k in sorted(statics)},
        "device": device_identity(device),
    }


def program_key(kind: str, fmt_name: str, shapes, statics: dict, *,
                device: str | torch.device = "cuda") -> str:
    """Human-scannable, collision-safe artifact name."""
    canon = json.dumps(_canonical(kind, fmt_name, shapes, statics, device),
                       sort_keys=True)
    h = hashlib.sha256(canon.encode()).hexdigest()[:16]
    n, hh, w = shapes[0][0]
    return f"{kind}-{fmt_name}-{w}x{hh}x{n}-{h}"


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype ('uint8', 'uint16', ...)."""
    return str(dtype).removeprefix("torch.")


def plane_shapes(planes) -> tuple:
    """((shape, dtype_str), ...) for key construction from live tensors."""
    return tuple((tuple(p.shape), _dtype_name(p.dtype)) for p in planes)


def filter_statics(order: int, aa: int, aac: int, dh: bool, luma: bool,
                   chroma: bool, opt: int, numerics: str) -> dict:
    """The static-argument identity of the whole-batch filter dispatch —
    ONE definition shared by prewarm and lookup, so the key cannot drift
    between them."""
    return dict(order=order, aa=aa, aac=aac, dh=bool(dh), luma=bool(luma),
                chroma=bool(chroma), opt=opt, numerics=numerics)


def bob_statics(aa: int, aac: int, tff: bool, opt: int,
                numerics: str) -> dict:
    return dict(aa=aa, aac=aac, tff=bool(tff), opt=opt, numerics=numerics)


def _write_atomic(path: Path, blob: bytes) -> None:
    # unique temp per writer + atomic rename: concurrent readers never see
    # a torn file, and concurrent prewarms of the same combo never share a
    # temp path (last rename wins with a complete artifact either way)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        try:
            os.write(fd, blob)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:  # do not leave orphaned temp files next to the artifacts
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_program(aot_dir, kind: str, fmt, shapes, statics: dict, *,
                 device: str | torch.device = "cuda") -> Path:
    """Write one dispatch's artifact; returns its path.  For a card, the
    kernel library of the current sources is built into ``aot_dir`` first
    (nvcc), unless it is already there."""
    from sangnom_tpu_torch.ops import cuda_library

    if kind not in ("filter", "bob"):
        raise ValueError(f"unknown AOT program kind {kind!r}")
    aot_dir = Path(aot_dir)
    aot_dir.mkdir(parents=True, exist_ok=True)
    if torch.device(device).type == "cuda":
        lib = aot_dir / cuda_library.library_name()
        if not lib.exists():
            cuda_library.compile_library(lib)
    art = {**_canonical(kind, fmt.name, shapes, statics, device),
           "library": cuda_library.source_hash()}
    path = aot_dir / f"{program_key(kind, fmt.name, shapes, statics, device=device)}{_SUFFIX}"
    _write_atomic(path, json.dumps(art, sort_keys=True).encode())
    return path


def _check_artifact(path: Path, want: dict) -> None:
    """Raise ValueError unless the artifact at ``path`` is ``want`` (its
    canonical key and the current library hash), and for a card the
    library is in the artifact directory."""
    try:
        got = json.loads(path.read_bytes())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"not an artifact: {e}") from None
    if not isinstance(got, dict):
        raise ValueError("not an artifact")
    if got.get("library") != want["library"]:
        raise ValueError(f"built for kernel library {got.get('library')}, "
                         f"the sources are {want['library']}")
    if got != want:
        raise ValueError("its key does not match its name")
    if want["device"]["type"] == "cuda":
        from sangnom_tpu_torch.ops import cuda_library

        if not (path.parent / cuda_library.library_name()).exists():
            raise ValueError("the kernel library is missing")


def _args_from(art: dict):
    """(fmt, zero planes on the artifact's device) of an artifact."""
    from sangnom_tpu_torch.core.formats import get_format

    dev = "cuda" if art["device"]["type"] == "cuda" else art["device"]["type"]
    planes = [torch.zeros(tuple(s), dtype=getattr(torch, d), device=dev)
              for s, d in art["shapes"]]
    return get_format(art["fmt"]), planes


def warm_call(path) -> float:
    """Run one artifact's dispatch once on zeros of its shapes, on its
    device, to its end: the kernel library loads (from the configured
    directory) and every kernel of the dispatch launches at this geometry.
    Returns the wall seconds."""
    from sangnom_tpu_torch.core.clip import Clip

    t0 = time.perf_counter()
    art = json.loads(Path(path).read_bytes())
    fmt, planes = _args_from(art)
    st = art["statics"]
    if art["kind"] == "bob":
        from sangnom_tpu_torch.core.fields import bob

        out = bob(Clip(planes, fmt, tff=st["tff"]), aa=st["aa"], aac=st["aac"],
                  opt=st["opt"], numerics=st["numerics"])
    else:
        from sangnom_tpu_torch.api import sangnom2

        out = sangnom2(Clip(planes, fmt), order=st["order"], aa=st["aa"],
                       aac=st["aac"], dh=st["dh"], luma=st["luma"],
                       chroma=st["chroma"], opt=st["opt"],
                       numerics=st["numerics"])
    if out.planes[0].device.type == "cuda":
        torch.cuda.synchronize(out.planes[0].device)
    return time.perf_counter() - t0


def lookup(kind: str, fmt_name: str, shapes, statics: dict, *,
           device: str | torch.device = "cuda") -> bool:
    """Whether this dispatch is served from a prewarmed artifact; counts a
    hit or a miss.  Cheap when unconfigured (one attribute check);
    artifacts are read once per process and negative results are cached
    too.  The lock guards only the dict: the cold read runs outside it."""
    aot_dir = _AOT_DIR  # snapshot: configure(None) must not race a
    if aot_dir is None:  # dispatch into `None / key` (TypeError)
        return False
    key = program_key(kind, fmt_name, shapes, statics, device=device)
    with _LOCK:
        if key in _CACHE:
            ok = _CACHE[key]
            STATS["hits" if ok else "misses"] += 1
            return ok
    path = aot_dir / f"{key}{_SUFFIX}"
    ok = False
    if path.exists():
        from sangnom_tpu_torch.ops import cuda_library

        want = {**_canonical(kind, fmt_name, shapes, statics, device),
                "library": cuda_library.source_hash()}
        try:
            _check_artifact(path, want)
            ok = True
        except (OSError, ValueError) as e:  # corrupt or stale -> miss
            print(f"warning: AOT artifact {path.name} unusable ({e}); "
                  f"falling back to jit", file=sys.stderr)
    with _LOCK:
        _CACHE[key] = ok
        STATS["hits" if ok else "misses"] += 1
    return ok
