"""The one CUDA library of the port's kernels: its build, its load, and
what every launcher shares of it.

The library (``csrc/*.cu``: the field kernel of ``ops/deint_kernel``, the
pool kernels of ``ops/pool_kernel``, the width-sharded kernels of
``parallel/shard_kernel`` and the probes of ``tools/probe_kernel``) is
compiled with nvcc for sm_90a at first use, one nvcc per source, all
started together, into ``sangnom_tpu_torch/_build/`` or the directory given
to `set_build_dir`, and loaded with ctypes.  A built library is keyed by
`source_hash` (the sources, the nvcc flags and the target arch), never by
file times, so a fresh checkout of the same sources reuses it and any edit
rebuilds it.  When `sangnom_tpu_torch.aot` is configured and its directory
holds the library of this `source_hash`, the library is loaded from there
and nvcc never runs: an ``--aot DIR`` run wins over ``--cache-dir``
(`set_build_dir`), which serves only when DIR holds no matching library.
One build and load runs per process, whatever the number of threads that
ask for the library first; launches from several threads are serialized
(`LAUNCH_LOCK`).  ``BUILDS`` counts nvcc builds and ``LIB_PATH`` names the
library file that was loaded.

Each launcher module declares its entry points' argument types as data
(`declare`); the load binds them once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.utils.profiling import BUILD, count, span

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
]

# nvcc builds of the kernel library run by this process.
BUILDS = 0
# The library file this process loaded (None before the first load).
LIB_PATH: Path | None = None
# Held around every call into the library that launches a kernel: each
# launcher sets its kernel's dynamic shared-memory limit to the launch's size
# and then launches, so two host threads launching one kernel at different
# sizes must not interleave (the launch that meets the other's smaller limit
# fails with "invalid argument").
LAUNCH_LOCK = threading.Lock()
# The launchers' code for a cluster that cannot be scheduled.
NO_CLUSTER = -1
# Storage dtype -> the launchers' dtype code.
DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
# Shared memory the CUDA runtime reserves on a SM for each resident block.
SMEM_RESERVED = 1024

_build_dir = SRC_DIR.parent / "_build"
_lib: ctypes.CDLL | None = None
# Serializes the library's build and first load: the hosts call the filter
# from several threads, and two first calls must not both run nvcc into the
# same object files.
_BUILD_LOCK = threading.RLock()
_DECLARED: list[dict] = []
_CTYPES = {"i": ctypes.c_int, "p": ctypes.c_void_p, "q": ctypes.c_longlong,
           "d": ctypes.c_double, "P": ctypes.POINTER(ctypes.c_int)}
_max_smem: dict[int, int] = {}
_cards: dict[int, Card] = {}
_clusters: dict = {}  # (device, key) -> a cluster fits the card


def nvcc() -> str:
    """The nvcc executable: on PATH, else under CUDA_HOME / CUDA_PATH or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    """The directory the library is built into and loaded from."""
    return _build_dir


def _lib_file() -> Path:
    return _build_dir / "libsangnom_cuda.so"


def set_build_dir(path: str | os.PathLike) -> None:
    """Build the kernel library into, and load it from, ``path`` (created
    at the build).  Raises ValueError once the library is loaded from
    another directory."""
    global _build_dir
    new = Path(path).expanduser().resolve()
    with _BUILD_LOCK:
        if new == _build_dir.resolve():
            return
        if _lib is not None:
            raise ValueError(f"the kernel library is already loaded from "
                             f"{_build_dir}; cannot switch to {new}")
        _build_dir = new


def source_hash() -> str:
    """The key of a kernel library: a hash of every file in ``csrc/`` (name
    and bytes) and of the nvcc flags, which hold the target arch."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.iterdir()):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def library_name() -> str:
    """The file name of this `source_hash`'s library in an artifact
    directory (`sangnom_tpu_torch.aot`)."""
    return f"libsangnom_cuda-{source_hash()}.so"


def build(verbose: bool = False) -> float:
    """Compile the kernel library into the build directory unless the one
    there was built from this `source_hash`.  Returns the seconds spent
    compiling (0.0 when it was up to date).  ``verbose`` rebuilds and adds
    ptxas's register and shared-memory report to stdout."""
    with _BUILD_LOCK, span(BUILD):
        key = source_hash()
        lib = _lib_file()
        kf = lib.with_name(lib.name + ".key")
        if not verbose and lib.exists() and kf.exists() and kf.read_text() == key:
            return 0.0
        dt = compile_library(lib, verbose)
        tmp = kf.with_name(f"{kf.name}.{os.getpid()}.tmp")
        tmp.write_text(key)
        os.replace(tmp, kf)
        return dt


def compile_library(lib: Path, verbose: bool = False) -> float:
    """Run nvcc: build the kernel library of ``csrc/`` into the file ``lib``
    (its directory created), one nvcc per source in parallel, then a link;
    the file appears atomically.  Returns the seconds spent."""
    global BUILDS
    lib = Path(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    sources = sorted(SRC_DIR.glob("*.cu"))
    exe = nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [lib.parent / f"{src.stem}.{tag}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    BUILDS += 1
    count("builds")
    t0 = time.perf_counter()
    try:
        cmds = [[exe, *NVCC_FLAGS, *ptxas, "-c", str(src), "-o", str(obj)]
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
        cmd = [exe, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return time.perf_counter() - t0


def declare(entry_points: dict[str, str]) -> None:
    """Declare entry points of the library: name -> argument types, one
    letter each (i int, q long long, d double, p pointer, P int pointer;
    spaces ignored), every one returning an int error code.  Bound at the
    load, or now where the library is loaded already."""
    with _BUILD_LOCK:
        _DECLARED.append(entry_points)
        if _lib is not None:
            _bind(_lib, entry_points)


def _bind(lib: ctypes.CDLL, entry_points: dict[str, str]) -> None:
    for name, args in entry_points.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[c] for c in args.replace(" ", "")]
        fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The loaded library, built first unless current (or loaded from the
    `aot` directory), its declared entry points bound."""
    global _lib, LIB_PATH
    if _lib is not None:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None:  # another thread loaded it while we waited
            return _lib
        from sangnom_tpu_torch import aot

        path = aot.library_path()
        if path is None:
            build()
            path = _lib_file()
        lib = ctypes.CDLL(str(path))
        lib.sno_error_string.argtypes = [ctypes.c_int]
        lib.sno_error_string.restype = ctypes.c_char_p
        _bind(lib, {"sno_max_smem": "iP"})
        for entry_points in _DECLARED:
            _bind(lib, entry_points)
        _lib, LIB_PATH = lib, Path(path)
    return _lib


def check(err: int, what: str, cluster: int = 0) -> None:
    """Raise on a failed library call: RuntimeError naming the cluster
    where no cluster of ``cluster`` blocks can be scheduled, else the CUDA
    error."""
    if err == NO_CLUSTER and cluster:
        raise RuntimeError(f"{what}: a cluster of {cluster} blocks cannot be "
                           "scheduled on this card (cudaOccupancyMaxActiveClusters is 0)")
    if err != 0:
        msg = load().sno_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def storage_dtype(spec: KernelSpec) -> torch.dtype:
    """The dtype the kernels store ``spec``'s samples in."""
    if spec.is_float:
        return torch.float32
    return torch.uint8 if spec.mask == 0xFF else torch.uint16


def launch_codes(spec: KernelSpec, device: torch.device):
    """(dtype code, sse2 flag, stream) of a launch."""
    sse2 = int(spec.sse2 and not spec.is_float)
    return DTYPE_CODE[storage_dtype(spec)], sse2, torch.cuda.current_stream(device).cuda_stream


def device_index(device: torch.device) -> int:
    """``device``'s index, the current device for a bare "cuda"."""
    return device.index if device.index is not None else torch.cuda.current_device()


def max_smem_bytes(device: torch.device) -> int:
    """The opt-in shared memory a block may use on ``device``."""
    idx = device_index(device)
    if idx not in _max_smem:
        v = ctypes.c_int(0)
        check(load().sno_max_smem(idx, ctypes.byref(v)), "shared-memory query")
        _max_smem[idx] = v.value
    return _max_smem[idx]


class Card(NamedTuple):
    """What the plans need of a card: its SMs, the shared memory a block
    may use, the shared memory of one SM, and the device index to ask
    whether a cluster fits (None: figures made away from the card, which
    take every cluster route as planned)."""

    sms: int
    smem_block: int
    smem_sm: int
    device: int | None = None


# An H100 SXM's figures, for plans made away from the card.
H100 = Card(132, 232448, 233472)


def card_figures(device: torch.device) -> Card:
    """The card's `Card`, queried once a device."""
    idx = device_index(device)
    card = _cards.get(idx)
    if card is None:
        props = torch.cuda.get_device_properties(idx)
        card = _cards[idx] = Card(props.multi_processor_count,
                                  max_smem_bytes(torch.device("cuda", idx)),
                                  props.shared_memory_per_multiprocessor, idx)
    return card


def cluster_fits(device: int | None, key, clusters) -> bool:
    """Whether the card schedules a launch's cluster: ``clusters()``, the
    clusters resident at once, asked once a device and ``key`` (the
    kernel and every figure of its launch the answer depends on)."""
    k = (device, key)
    if k not in _clusters:
        _clusters[k] = clusters() > 0
    return _clusters[k]
