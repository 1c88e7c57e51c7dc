"""The hand-written CUDA kernel for field interpolation, and its plain twin.

`deinterlace_field_batch_fused` (woven full-height output) and
`interpolate_field_batch` (interpolated rows only) launch
``csrc/deint.cu::deint_kernel``, which replaces the TPU package's
``ops/pallas_kernel.py::_kernel`` (launched there by ``_deint_chunk`` and
``_interp_chunk``).  On a CPU tensor each wrapper runs its plain PyTorch
version instead; on a CUDA tensor it launches the kernel or raises.

One block walks a field, so the kernel takes at most ``FIELD_COLS`` (2048)
smoothed columns, 4 a thread.  A wider field (`wide_plan`) runs as the
width-sharded kernel K4 runs a field (``parallel.shard_kernel.full_pass``):
the plane edge-padded to a width of k shards, ``k`` blocks of a field, each
of 4-column threads, in one thread-block cluster (one launch a pass; past
``MAX_CLUSTER`` blocks, or where the card cannot schedule the cluster, one
launch a chunk of rows), the output cropped back.  Its launches count in
``shard_kernel.LAUNCHES["full"]``, not in ``LAUNCHES``, and its fields on
the card's cluster route in the ``cluster_fields`` counter; on a CPU tensor
`_wide` runs K4's plain version with the same k, padding and crop (and
counts nothing).

The kernel library (this kernel and the pool kernels of ``ops/pool_kernel``)
is compiled with nvcc for sm_90a at first use, one nvcc per source in
``csrc/``, all started together, into ``sangnom_tpu_torch/_build/`` or the
directory given to `set_build_dir`, and bound with ctypes.  A built library
is keyed by `source_hash` (the sources, the nvcc flags and the target
arch), never by file times, so a fresh checkout of the same sources reuses
it and any edit rebuilds it.  When `sangnom_tpu_torch.aot` is configured
and its directory holds the library of this `source_hash`, the library is
loaded from there and nvcc never runs: an ``--aot DIR`` run wins over
``--cache-dir`` (`set_build_dir`), which serves only when DIR holds no
matching library.  One build and load runs per process, whatever the number
of threads that ask for the library first; launches from several threads
are serialized (`LAUNCH_LOCK`).  ``LAUNCHES`` counts kernel launches, so a
run can show that it went through the kernel; ``BUILDS`` counts nvcc builds
and ``LIB_PATH`` names the library file that was loaded.
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

from sangnom_tpu_torch.core.fields import _split_plane
from sangnom_tpu_torch.core.geometry import creep_bound, round_up, width_tiers
from sangnom_tpu_torch.ops import reference
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.ops.sangnom import Offset, weave_assemble
from sangnom_tpu_torch.utils.profiling import BUILD, LAUNCH, count, span

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
# nvcc builds of the kernel library run by this process.
BUILDS = 0
# The library file this process loaded (None before the first load).
LIB_PATH: Path | None = None

_lib: ctypes.CDLL | None = None
_max_smem: dict[int, int] = {}
# Serializes the library's build and first load: the hosts call the filter
# from several threads, and two first calls must not both run nvcc into the
# same object files.
_BUILD_LOCK = threading.RLock()
# Held around every call into the library that launches a kernel (here and
# in ops/pool_kernel, parallel/shard_kernel, tools/probe_kernel): each
# launcher sets its kernel's dynamic shared-memory limit to the launch's size
# and then launches, so two host threads launching one kernel at different
# sizes must not interleave (the launch that meets the other's smaller limit
# fails with "invalid argument").
LAUNCH_LOCK = threading.Lock()

# The most columns one block of a one-block walk takes (`launch_shape`, 8 a
# thread past 2048): the pool walk's reach (ops/pool_kernel.walk_plan).
MAX_COLS = 8192
# The most smoothed columns one block of the field kernel takes: 512 threads
# of 4 columns.  Wider fields take the wide route (`wide_plan`), each block
# within the 4-column build (``shard_kernel.MAX_BLOCK_4``): one block of
# 8-column threads, capped at 64 registers, spilled its carry and walked a
# 3840-column field 5.6x slower a row step than the 4-column build at 1920.
FIELD_COLS = 2048
# The wide route's blocks, halos included: at most WIDE_BLOCK columns (256
# threads of 4 columns) where a cluster of at most MAX_CLUSTER blocks holds
# the field, else at most shard_kernel.MAX_BLOCK_4 (512 threads); a halo
# exchange every WIDE_ROWS rows.  The fastest of the (k, R) sweep of K4's
# pass at 3840 x 1080 kept rows on an H100 (chip_smoke.wide_k_sweep; PERF.md
# section 6): 24 fields 3.98 ms at 4 blocks of 960 columns and R 8, 6.20 at
# 2 blocks of 1920 and R 4; 120 fields alike at 2 and 4 blocks.
WIDE_BLOCK = 1016
WIDE_ROWS = 8
# An H100's opt-in shared memory a block, for plans made away from the card.
H100_SMEM = 232448
_CLUSTER_OK: dict = {}  # (device, spec, k, K4 plan) -> a cluster fits the card

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


def set_build_dir(path: str | os.PathLike) -> None:
    """Build the kernel library into, and load it from, ``path`` (created
    at the build).  Raises ValueError once the library is loaded from
    another directory."""
    global _BUILD_DIR, _LIB
    new = Path(path).expanduser().resolve()
    with _BUILD_LOCK:
        if new == _BUILD_DIR.resolve():
            return
        if _lib is not None:
            raise ValueError(f"the kernel library is already loaded from "
                             f"{_BUILD_DIR}; cannot switch to {new}")
        _BUILD_DIR, _LIB = new, new / _LIB.name


def source_hash() -> str:
    """The key of a kernel library: a hash of every file in ``csrc/`` (name
    and bytes) and of the nvcc flags, which hold the target arch."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_SRC_DIR.iterdir()):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def library_name() -> str:
    """The file name of this `source_hash`'s library in an artifact
    directory (`sangnom_tpu_torch.aot`)."""
    return f"libsangnom_cuda-{source_hash()}.so"


def _key_file(lib: Path) -> Path:
    return lib.with_name(lib.name + ".key")


def build(verbose: bool = False) -> float:
    """Compile the kernel library into the build directory unless the one
    there was built from this `source_hash`.  Returns the seconds spent
    compiling (0.0 when it was up to date).  ``verbose`` rebuilds and adds
    ptxas's register and shared-memory report to stdout."""
    with _BUILD_LOCK, span(BUILD):
        return _build(verbose)


def _build(verbose: bool) -> float:
    key = source_hash()
    kf = _key_file(_LIB)
    if (not verbose and _LIB.exists() and kf.exists()
            and kf.read_text() == key):
        return 0.0
    dt = compile_library(_LIB, verbose)
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
    sources = sorted(_SRC_DIR.glob("*.cu"))
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [lib.parent / f"{src.stem}.{tag}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    BUILDS += 1
    count("builds")
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
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return time.perf_counter() - t0


def _load() -> ctypes.CDLL:
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
            path = _LIB
        lib = ctypes.CDLL(str(path))
        lib.sno_max_smem.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.sno_max_smem.restype = ctypes.c_int
        lib.sno_error_string.argtypes = [ctypes.c_int]
        lib.sno_error_string.restype = ctypes.c_char_p
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.sno_deint_launch.argtypes = [
            i, i, i,  # dtype, sse2, cols
            p, p, p,  # src, dst, offsets
            i, i, i, i,  # n_fields, bufH, w, S
            i, i, i,  # pitch_b, pitch_r, pitch_p
            ctypes.c_longlong,  # in_frame_stride
            i, i, i, i,  # interlaced, weave, static_offset, dbuf
            ctypes.c_double,  # aaf
            i, i,  # threads, smem_bytes
            p,  # stream
        ]
        lib.sno_deint_launch.restype = ctypes.c_int
        _lib, LIB_PATH = lib, Path(path)
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
    """(columns per thread, threads per block) covering S columns of a
    one-block walk: thread t owns the contiguous columns t*cols ..
    t*cols+cols-1; one column per thread up to 512 columns, else 4 columns
    per thread (<= 512 threads), else 8 (<= 1024 threads).  The field
    kernel is instantiated for 1 and 4 columns and takes at most
    ``FIELD_COLS``; the pool walk (``ops/pool_kernel``) for all three.  (A
    2-column build spilled 1 KB per thread under ptxas for sm_90a and ran
    the 1080 chroma launch 5x slower than 4 columns on an H100: 12.0
    against 2.4 ms.)"""
    for cols, max_threads in ((1, 512), (4, 512), (8, 1024)):
        n = -(-S // cols)
        if n <= max_threads:
            return cols, max(32, -(-n // 32) * 32)
    raise ValueError(f"plane too wide for the CUDA kernel: {S} smoothed columns "
                     "(at most 8192)")


class LaunchPlan(NamedTuple):
    """How one launch lays out its memory (see ``csrc/deint.cu``).

    ``route``: "double" (two shared smoothing buffers, one barrier a row
    step) or "single" (one shared buffer, two barriers).  ``pitch_b``: elements of a
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
    first route whose shared memory fits, double or single (on an H100 the
    single route fits every width up to ``FIELD_COLS``).  Raises ValueError
    past ``FIELD_COLS`` smoothed columns (the wide route's, `wide_plan`) or
    where neither route fits."""
    if S > FIELD_COLS:
        raise ValueError(f"deint kernel: {S} smoothed columns take the wide route "
                         f"(wide_plan), one block at most {FIELD_COLS}")
    cols, threads = launch_shape(S)
    pitch_b = _round_up(S + cols + 8, 4)
    pitch_r = _round_up(w + cols + 8, 16)
    pitch_p = _round_up(threads * cols, 16)
    buf = _MAPS * pitch_b * 4
    rp = _MAPS * pitch_p * elem
    ring = _RING_ROWS * pitch_r * elem
    for route, smem in (("double", 2 * buf + rp + ring), ("single", buf + rp + ring)):
        if smem <= limit:
            return LaunchPlan(cols, threads, route, smem, pitch_b, pitch_r, pitch_p)
    raise ValueError(f"deint kernel: plane width {w} exceeds shared memory")


class FieldPlan(NamedTuple):
    """How a field pass runs on the card.  ``k`` 1: K1 over S smoothed
    columns, ``W_loc`` = S, ``plan`` a `LaunchPlan`.  ``k`` > 1 (S past
    ``FIELD_COLS``): K4 over ``k`` shards of ``W_loc`` columns of the plane
    edge-padded to ``width`` = k * W_loc, ``plan`` a
    ``parallel.shard_kernel.Plan`` (its ``cluster``: one launch a pass, else
    a launch a chunk of R rows)."""

    k: int
    W_loc: int
    plan: tuple

    @property
    def width(self) -> int:
        return self.k * self.W_loc


def wide_plan(w: int, bufH: int, stride: int, spec: KernelSpec, limit: int,
              cluster: bool | None = None) -> FieldPlan:
    """The plan of a pass over fields of width ``w`` and ``bufH`` kept rows
    at buffer ``stride``, under a block's shared-memory ``limit``.

    S = ``width_tiers(...)[2]`` up to ``FIELD_COLS``: K1's plan, as ever.
    Past it: K4 over k >= 2 blocks of 4-column threads, every block (own
    columns and halos, a halo exchange every ``WIDE_ROWS`` rows) within
    ``WIDE_BLOCK`` columns at the least such k up to ``MAX_CLUSTER``, else
    within ``shard_kernel.MAX_BLOCK_4`` at the least such k (3840 gives k =
    4, 15360 k = 8), over the plane padded to the stride itself where the
    clamp there is observable (stride < ``creep_bound``; k then divides it)
    and else to the least multiple of k at or past ``creep_bound``: as
    ``parallel.sharding._sharded_pad_width`` pads a 1 x k mesh, clamping
    there changes no output column.  The cluster route up to
    ``MAX_CLUSTER`` blocks (``cluster`` None), the chunk route beyond or
    with ``cluster`` False.  A pure function of the shapes."""
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    elem = _storage_dtype(spec).itemsize
    S = width_tiers(w, bufH, stride, spec)[2]
    if S <= FIELD_COLS:
        return FieldPlan(1, S, launch_plan(w, S, elem, limit))
    creep = creep_bound(w, bufH, spec)

    def padded(k):
        return stride if stride < creep else round_up(creep, k)

    def cut(k):
        width = padded(k)
        if width % k:
            return None
        return k, width // k, sk.cluster_rows(k, width // k, bufH - 1, WIDE_ROWS)[1]

    k = next((j for j in range(2, sk.MAX_CLUSTER + 1)
              if (c := cut(j)) and sk.block_width(*c) <= WIDE_BLOCK), None)
    if k is None:
        k = sk.least_split(cut, padded(1), sk.MAX_BLOCK_4, k0=2)
    use = cluster is not False and k <= sk.MAX_CLUSTER
    W_loc = padded(k) // k
    return FieldPlan(k, W_loc, sk.full_plan(k, W_loc, bufH, elem, limit, WIDE_ROWS,
                                            cluster=use))


def _card_plan(w: int, bufH: int, stride: int, spec: KernelSpec,
               device: torch.device) -> FieldPlan:
    """`wide_plan` on the card: a cluster the card cannot schedule (no
    cluster of k blocks resident, ``sno_shard_query``) takes the chunk
    route, decided before any launch; the query's answer is kept for the
    plan and the card."""
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    limit = _max_smem_bytes(_load(), device)
    fp = wide_plan(w, bufH, stride, spec, limit)
    if fp.k == 1 or not fp.plan.cluster:
        return fp
    key = (device.index, spec, fp.k, fp.plan)
    if key not in _CLUSTER_OK:
        _CLUSTER_OK[key] = sk.occupancy("full", spec, fp.plan, fp.k, device)["clusters"] > 0
    return fp if _CLUSTER_OK[key] else wide_plan(w, bufH, stride, spec, limit,
                                                 cluster=False)


def _wide(kept: torch.Tensor, offset, aaf, spec: KernelSpec, stride: int,
          interlaced_tff: bool | None = None) -> torch.Tensor:
    """The wide route, for fields past one block (S > ``FIELD_COLS``):
    ``kept`` [N, bufH, w] fields (an interlaced plane with
    ``interlaced_tff``, split first) -> the woven plane (``offset`` 0, 1 or
    per field) or, with ``offset`` None, the interpolated rows; K4 over
    `wide_plan`'s k shards of the edge-padded plane, cropped to w.  On a
    tensor off the card, K4's plain version (``parallel.fused_smooth``) with
    the same k, padding and crop."""
    from sangnom_tpu_torch.parallel import fused_smooth as fs
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    if interlaced_tff is not None:
        kept = _split_plane(kept, interlaced_tff)
    N, bufH, w = kept.shape
    on_card = kept.device.type == "cuda"
    if on_card:
        fp = _card_plan(w, bufH, stride, spec, kept.device)
    else:
        fp = wide_plan(w, bufH, stride, spec, H100_SMEM)
    if fp.k == 1:
        raise ValueError(f"deint kernel: {w} columns at stride {stride} take one block, "
                         "not the wide route")
    width = fp.width
    if width > w:  # edge replication: taps past w read the edge pixel
        pad = fs._signed(kept)[..., -1:].expand(N, bufH, width - w)
        kept = torch.cat([fs._signed(kept), pad], dim=2).view(kept.dtype)
    kept = kept.contiguous()
    offs = None if offset is None else fs._offsets(offset, kept)
    if on_card:
        out = sk.full_pass(kept, offs, aaf, spec, fp.k, w, WIDE_ROWS, fp.plan.cluster)
        if fp.plan.cluster:
            count("cluster_fields", N)
    else:
        out = fs._fused_full(kept, aaf, spec, fp.k, w, WIDE_ROWS, offs)
    return out if width == w else out[..., :w].contiguous()


def _is_wide(w: int, bufH: int, stride: int, spec: KernelSpec) -> bool:
    return width_tiers(w, bufH, stride, spec)[2] > FIELD_COLS


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
    with span(LAUNCH) as sp:
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
        with torch.cuda.device(device), LAUNCH_LOCK:
            err = lib.sno_deint_launch(
                _DTYPE_CODE[src.dtype], int(spec.sse2 and not spec.is_float), plan.cols,
                src.data_ptr(), out.data_ptr(),
                None if offs is None else offs.data_ptr(),
                n_fields, bufH, w, S, plan.pitch_b, plan.pitch_r, plan.pitch_p,
                in_frame_stride, interlaced, int(weave), static_offset,
                int(plan.route == "double"), float(aaf), plan.threads,
                plan.smem_bytes, stream,
            )
        _check(lib, err, "deint kernel launch")
        LAUNCHES += 1
        if sp:
            sp.set(kernel="deint_kernel", blocks=n_fields, threads=plan.threads,
                   smem_bytes=plan.smem_bytes,
                   bytes=(src.numel() + out.numel()) * src.element_size())


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
    if n_fields and _is_wide(w, bufH, stride, spec):
        return _wide(kept, offset, aaf, spec, stride, interlaced_tff)
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
    if N and bufH >= 2 and _is_wide(w, bufH, stride, spec):
        return _wide(kept, None, aaf, spec, stride)
    out = torch.empty((N, max(bufH - 1, 0), w), dtype=kept.dtype,
                      device=kept.device)
    if out.numel():
        _launch(kept, out, spec, aaf, N, bufH, w, stride, 0, False, 0)
    return out


# read by ops.sangnom.deinterlace_plane_batch: this backend weaves in-kernel
interpolate_field_batch.fused_weave = deinterlace_field_batch_fused
