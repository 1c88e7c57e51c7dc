"""Pool-compat mode: bit-exact emulation of the reference's SHARED buffer
pool (``pool_compat=True``).

The reference allocates ONE 9-map pool sized by the LUMA geometry
(stride S = ceil32(luma width), P = luma bufferHeight; reference
src/SangNom2.cpp:287-288, 303-310) and reuses it for every plane of every
frame without clearing it.  Each plane pass

  * prepares only rows 1..h_p/2-1, columns 0..w_p-1 (src/SangNom2.cpp:75-124),
  * smooths the FULL pool, rows 1..P-1 over the full stride, in place
    (src/SangNom2.cpp:268-270),
  * finalizes from rows 1..h_p/2-1, columns 0..w_p-1 (src/SangNom2.cpp:272).

So a chroma pass reads the previous pass's smoothed data in the rows and
columns it did not prepare, and unaligned luma widths carry their pad
columns across frames.  This module threads the pool as explicit state:
planes Y -> U -> V within a frame, frames in clip order.  Rows 0 and P are
never written, so a pool from `init_pool` keeps them zero.

The pool is carried in the public layout ``[9, P+1, S]``, accumulator dtype,
and updated IN PLACE by every pass (the reference smooths in place); callers
that must keep their pool (``ops.sangnom.sangnom2_pool_stream``) hand over a
copy.  Plane passes:

  ``interp_field_pool``       plain: prepare, ``smooth_scan``, finalize (opt=0)
  ``interp_field_pool_k3``    the same with K3 (``pool_kernel.smooth_pool_``)
                              smoothing
  ``interp_field_pool_split3``  the same with K6 on the split carry (``POOL_SPLIT3``)
  ``interp_field_pool_fused``   K7, the whole pass as prepare, walk and finalize
                                kernels (``POOL_FUSED``); the default kernel route

The first three are `_pool_pass` with their own smoothing.

The frame-parallel path (``POOL_FAST``, off by default as in the TPU
package): where `_frames_independent` proves that no frame can observe the
pool a previous frame left, each frame starts from a fresh pool, and chunks
of ``POOL_FAST_BATCH`` frames take each plane pass together
(`interp_field_pool_batch`: ``pool_kernel.interp_batch``, three launches a
chunk and plane whatever the chunk's frame count).

The split carry is ``(row0 [9, S], body [9, P-1, S], tail [9, S])``: pool
row 0, rows 1..P-1 and row P in three tensors.

A sequential call on the card's kernel route, from a fresh pool or a
carried one, is replayed as one CUDA graph from its second call with the
same signature on (``ops/pool_graph``): the same launches on the same data,
issued by one graph launch instead of 144 for the 8-frame 1080i bob.
"""

from __future__ import annotations

import numpy as np
import torch

from sangnom_tpu_torch.core.formats import VideoFormat
from sangnom_tpu_torch.core.geometry import (
    aaf_as_pixel,
    buffer_height,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from sangnom_tpu_torch.ops import pool_graph, pool_kernel
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.ops.reference import (
    error_maps_list,
    finalize_select_from_taps,
    pair_taps,
)
from sangnom_tpu_torch.ops.sangnom import field_offset_py
from sangnom_tpu_torch.utils.logging import log_dispatch
from sangnom_tpu_torch.utils.profiling import POOL_BATCH_PASS, POOL_PASS, span

# Kernel-route arm flags (read per call).  POOL_FUSED (K7: prepare, walk
# and finalize kernels) is the default on the GPU: an H100 runs it fastest
# in all three pool calls of PERF.md §5 (the K3 and K6 arms issue ~150
# tensor ops a pass from the host).  On the TPU the fused kernel was slower
# (sangnom_tpu/ops/pool_carry.py:156-175).  POOL_FUSED wins over
# POOL_SPLIT3; with both off the route is K3.
POOL_SPLIT3 = False
POOL_FUSED = True
# The frame-parallel path (`_sangnom2_pool_batched`): off by default, as
# in the TPU package (sangnom_tpu/ops/pool_carry.py:134-146), where it lost
# to the sequential walk at every chunk size and one hardware run recorded a
# bit-identity failure that was never localized.  Engages only on the kernel
# route (opt != 0), with no caller pool, where `_frames_independent` holds.
POOL_FAST = False
POOL_FAST_BATCH = 16


def init_pool(luma_width: int, luma_h_out: int, fmt: VideoFormat,
              device: torch.device | str = "cuda") -> torch.Tensor:
    """A fresh pool [9, bufferHeight+1, stride] of zeros in the accumulator
    dtype (the reference's pool is fresh pages, zero in practice)."""
    spec = KernelSpec.from_format(fmt)
    stride = buffer_stride_elems(luma_width, fmt.component_size)
    return torch.zeros((9, buffer_height(luma_h_out) + 1, stride),
                       dtype=spec.acc_dtype, device=device)


def pool_from_numpy(arr: np.ndarray, fmt: VideoFormat,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """A pool in the public numpy form [9, P+1, S] (int32, or float32 for
    float formats; e.g. the TPU package's pool state) as a tensor."""
    dtype = np.float32 if fmt.is_float else np.int32
    arr = np.asarray(arr)
    if arr.ndim != 3 or arr.shape[0] != 9 or arr.dtype != dtype:
        raise ValueError(f"pool must be [9, P+1, S] {np.dtype(dtype).name}, got "
                         f"{arr.shape} {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)


def pool_to_numpy(pool: torch.Tensor) -> np.ndarray:
    """The pool in its public numpy form [9, P+1, S]."""
    return pool.cpu().numpy()


def _prepare(kept: torch.Tensor, maps_out: torch.Tensor, spec: KernelSpec):
    """Write the raw maps of the kept pairs into ``maps_out`` [9, R, w] (a
    view of the pool) and return the pairs' (taps, preds) for the finalize."""
    k = kept.to(spec.acc_dtype)
    taps, preds = pair_taps(k[:-1], k[1:], spec)
    maps_out.copy_(torch.stack(error_maps_list(taps, preds)))
    return taps, preds


def _pool_pass(kept: torch.Tensor, maps: torch.Tensor, smooth, aaf,
               spec: KernelSpec) -> torch.Tensor:
    """One plane pass: prepare the kept pairs into ``maps`` (pool rows
    1..bufH_p-1, columns 0..w-1, a view of the carry; the rest of the pool
    keeps the previous pass's smoothed data), ``smooth()`` the whole carry
    in place, finalize from ``maps``.  Returns the interpolated rows
    [bufH_p-1, w] in the storage dtype."""
    bufH_p, w = kept.shape
    if bufH_p >= 2:
        taps, preds = _prepare(kept, maps, spec)
    smooth()
    if bufH_p < 2:
        return kept.new_zeros((0, w))
    return finalize_select_from_taps(taps, preds, maps, aaf, spec).to(kept.dtype)


def interp_field_pool(kept: torch.Tensor, pool: torch.Tensor, aaf,
                      spec: KernelSpec) -> torch.Tensor:
    """One plane pass against the shared pool, in place: the plain pass
    (opt=0), as the TPU package's ``interp_field_pool``.

    kept: [bufH_p, w] storage-dtype kept field; pool: [9, P+1, S] carried
    pool.  Returns the interpolated rows [bufH_p-1, w] in the storage dtype.
    """
    bufH_p, w = kept.shape
    return _pool_pass(kept, pool[:, 1:bufH_p, :w],
                      lambda: pool_kernel.smooth_pool_plain_(pool, spec), aaf, spec)


def interp_field_pool_k3(kept: torch.Tensor, pool: torch.Tensor, aaf,
                         spec: KernelSpec) -> torch.Tensor:
    """The K3 arm of the kernel route (the TPU package's default,
    ``interp_field_pool_tm``): `interp_field_pool` with the smoothing in K3."""
    bufH_p, w = kept.shape
    return _pool_pass(kept, pool[:, 1:bufH_p, :w],
                      lambda: pool_kernel.smooth_pool_(pool, spec), aaf, spec)


def interp_field_pool_split3(kept: torch.Tensor, carry, aaf,
                             spec: KernelSpec) -> torch.Tensor:
    """The plane pass on the split carry, smoothing through K6 (the TPU
    package's ``interp_field_pool_split3``)."""
    row0, body, tail = carry
    bufH_p, w = kept.shape
    return _pool_pass(kept, body[:, : bufH_p - 1, :w],
                      lambda: pool_kernel.smooth_split3_(row0, body, tail, spec),
                      aaf, spec)


def interp_field_pool_fused(kept: torch.Tensor, carry, aaf,
                            spec: KernelSpec) -> torch.Tensor:
    """The whole plane pass through K7 (prepare, walk and finalize kernels),
    on the split carry; ``kept`` may be a strided view.  A degenerate plane
    (kept field < 2 rows) only smooths, as the TPU package does
    (sangnom_tpu/ops/pool_carry.py:403-412)."""
    row0, body, tail = carry
    bufH_p, w = kept.shape
    if bufH_p < 2:
        pool_kernel.smooth_split3_(row0, body, tail, spec)
        return kept.new_zeros((0, w))
    return pool_kernel.interp_fused(kept, row0, body, tail, aaf, spec)


def _pool_split(pool: torch.Tensor):
    """[9, P+1, S] -> the split carry (row0, body, tail), fresh tensors."""
    return tuple(x.clone(memory_format=torch.contiguous_format)
                 for x in (pool[:, 0], pool[:, 1:-1], pool[:, -1]))


def _pool_join(carry) -> torch.Tensor:
    """Inverse of `_pool_split`."""
    row0, body, tail = carry
    return torch.cat([row0[:, None], body, tail[:, None]], dim=1)


def _plane_pass(opt: int, device: torch.device):
    """(plane pass, whether it takes the split carry) for ``opt``: 0 the
    plain pass; otherwise the kernel route, whose wrappers run their plain
    twins on CPU tensors (opt=1 refuses those)."""
    if opt == 0:
        return interp_field_pool, False
    if opt == 1 and device.type != "cuda":
        from sangnom_tpu_torch.api import SangNomError

        raise SangNomError("SangNom2: opt=1 requires a CUDA backend.")
    if POOL_FUSED:
        return interp_field_pool_fused, True
    if POOL_SPLIT3:
        return interp_field_pool_split3, True
    return interp_field_pool_k3, False


def _assemble_into(out: torch.Tensor, kept: torch.Tensor, interp: torch.Tensor,
                   offset: int) -> None:
    """Weave kept and interpolated rows into ``out`` [2*bufH_p, w], the
    boundary missing line duplicated (reference src/SangNom2.cpp:376-391)."""
    if offset == 0:
        out[0::2] = kept
        out[1:-1:2] = interp
        out[-1] = kept[-1]
    else:
        out[1::2] = kept
        out[2::2] = interp
        out[0] = kept[0]


def _frames_independent(luma_width: int, luma_h: int, fmt: VideoFormat,
                        dh: bool, luma: bool) -> bool:
    """True when every frame's pool-compat output is provably independent of
    the carried pool, so frames may be processed IN PARALLEL bit-exactly
    (the TPU package's proof, sangnom_tpu/ops/pool_carry.py:715-744).

    Proof: the first plane processed in a frame is luma (``dh`` processes
    every plane; otherwise ``luma=True`` is required).  Its prepare
    overwrites pool rows 1..P-1 over cols 0..w-1; its smoothing pass reads
    exactly raw rows 1..P, the row-0 seed, and — through the stride-clamped
    7-tap box — cols 0..S-1.  When ``w == S`` (stride-aligned luma width)
    and the luma kept field spans the full buffer height (even ``h`` or
    ``dh``), every cell that pass can read is either freshly prepared (rows
    1..P-1) or one of the pool's two NEVER-written rows 0/P, which are zero
    for the life of any pool this module makes (`init_pool` zeroes them; no
    pass writes them; reference src/SangNom2.cpp:79 vs 129-133).  The luma
    pass is therefore a pure function of the frame, the chroma passes read
    only this frame's luma/chroma residue, and frame k's output and final
    pool never depend on frame k-1.  The carried-state cases (``w !=
    stride``: pad-column carry; ``luma=False`` without dh: U inherits the
    last frame's V) stay on the sequential loop."""
    return (
        (dh or luma)
        and buffer_stride_elems(luma_width, fmt.component_size) == luma_width
        and (dh or luma_h % 2 == 0)
    )


def _frame_index(ks: list[int], n: int, device):
    """An index of frames ``ks`` of a batch of ``n``: a slice where they are
    evenly spaced (all of them, or the bob's alternate frames), else an
    index tensor."""
    if len(ks) == n:
        return slice(None)
    step = ks[1] - ks[0] if len(ks) > 1 else 1
    if ks == list(range(ks[0], ks[-1] + 1, step)):
        return slice(ks[0], ks[-1] + 1, step)
    return torch.tensor(ks, device=device)


def _offset_groups(offsets: list[int], device):
    """(offset, frame index) for each offset 0/1 that some frame has."""
    return [(o, _frame_index(ks, len(offsets), device))
            for o in (0, 1) if (ks := [k for k, off in enumerate(offsets) if off == o])]


def _gather_kept_batch(p: torch.Tensor, offsets: list[int], dh: bool) -> torch.Tensor:
    """Kept-field rows of K frames' plane [K, h, w] -> [K, bufH_p, w]: a
    view for dh or one offset, else the per-frame rows gathered."""
    if dh:
        return p
    groups = _offset_groups(offsets, p.device)
    if len(groups) == 1:
        return p[:, groups[0][0]::2]
    kept = p.new_empty((p.shape[0], p.shape[1] // 2, p.shape[2]))
    for o, f in groups:
        kept[f] = p[f, o::2]
    return kept


def _assemble_batch(out: torch.Tensor, kept: torch.Tensor, interp: torch.Tensor,
                    offsets: list[int]) -> None:
    """`_assemble_into` for K frames: ``out`` [K, 2*bufH_p, w], frame k
    woven at ``offsets[k]``."""
    for o, f in _offset_groups(offsets, out.device):
        if o == 0:
            out[f, 0::2] = kept[f]
            out[f, 1:-1:2] = interp[f]
            out[f, -1] = kept[f, -1]
        else:
            out[f, 1::2] = kept[f]
            out[f, 2::2] = interp[f]
            out[f, 0] = kept[f, 0]


def interp_field_pool_batch(kept: torch.Tensor, carry, aaf,
                            spec: KernelSpec) -> torch.Tensor:
    """One plane pass of K frames, each on its own pool, through
    ``pool_kernel.interp_batch`` (the TPU package's
    ``interp_field_pool_tm_batch``, in the port's frame-major layout).
    ``kept`` [K, bufH_p, w]; ``carry`` the batched split carry (row0 [K, 9,
    S], body [K, 9, P-1, S], tail [K, 9, S]), updated in place.  A degenerate
    plane (kept field < 2 rows) only smooths, as the sequential pass does.
    Returns the interpolated rows [K, bufH_p-1, w]."""
    row0, body, tail = carry
    K, bufH_p, w = kept.shape
    if bufH_p < 2:
        pool_kernel.smooth_batch_(row0, body, tail, spec)
        return kept.new_zeros((K, 0, w))
    return pool_kernel.interp_batch(kept, row0, body, tail, aaf, spec)


def _sangnom2_pool_batched(planes, outs, passes, offsets: list[int], dh: bool,
                           spec: KernelSpec, P: int, S: int) -> torch.Tensor:
    """The frame-parallel path (the `_frames_independent` fast path):
    each frame starts from a fresh zero pool — provably what the sequential
    history would hand it — and chunks of `POOL_FAST_BATCH` frames take
    each plane pass together.  Writes the processed planes into ``outs``;
    returns the final pool, the last frame's [9, P+1, S] (equal to the
    sequential final pool, since no state crosses frames here)."""
    N = planes[0].shape[0]
    device = planes[0].device
    K = max(1, POOL_FAST_BATCH)
    last = None
    for s in range(0, N, K):
        e = min(N, s + K)
        zeros = torch.zeros((e - s, 9, S), dtype=spec.acc_dtype, device=device)
        carry = (zeros, torch.zeros((e - s, 9, P - 1, S), dtype=spec.acc_dtype,
                                    device=device), zeros)
        offs = offsets[s:e]
        for i, aaf in passes:
            kept = _gather_kept_batch(planes[i][s:e], offs, dh)
            with span(POOL_BATCH_PASS) as sp:
                if sp:
                    sp.set(frames=e - s, plane=i)
                interp = interp_field_pool_batch(kept, carry, aaf, spec)
            _assemble_batch(outs[i][s:e], kept, interp, offs)
        last = (zeros[-1], carry[1][-1], zeros[-1])
    return _pool_join(last)


def sangnom2_pool_impl(
    planes,
    parity,
    fmt: VideoFormat,
    order: int,
    aa: int,
    aac: int,
    dh: bool,
    luma: bool,
    chroma: bool,
    pool0: torch.Tensor | None = None,
    numerics: str = "c",
    opt: int = -1,
):
    """The whole clip with the shared-pool semantics: frames in order,
    planes Y -> U -> V within a frame, as the reference passes them.

    ``parity``: host bool array, read only for order=0.  ``pool0``: the
    carried pool [9, P+1, S] to start from, UPDATED IN PLACE (None: a fresh
    one).  Returns (out_planes, final_pool).

    With ``POOL_FAST`` set, the kernel route (opt != 0), no ``pool0`` and
    `_frames_independent`, frames run in chunks through the frame-parallel
    path (`_sangnom2_pool_batched`); everything else takes frames in
    order.  A caller's pool0 always takes the sequential loop: the path
    recreates each frame's pool from zeros, which a pool0 made elsewhere
    need not equal (the CLI's windowed stream carries one).

    On CUDA planes the sequential kernel route replays the whole call as
    one CUDA graph from its signature's second call on (`pool_graph`): the
    returned planes are then the caller's own copies, and ``pool0`` is
    updated in place as the eager call updates it."""
    device = planes[0].device
    spec = KernelSpec.from_format(fmt, sse2=(numerics == "sse2"))
    N, h0, w0 = planes[0].shape
    h_out0 = 2 * h0 if dh else h0
    want = (9, buffer_height(h_out0) + 1,
            buffer_stride_elems(w0, fmt.component_size))
    if pool0 is not None and ((tuple(pool0.shape), pool0.dtype, pool0.device)
                              != (want, spec.acc_dtype, device)):
        raise ValueError(
            f"pool_compat: pool {tuple(pool0.shape)} {pool0.dtype} on "
            f"{pool0.device} does not fit the clip (needs {want} "
            f"{spec.acc_dtype} on {device})")
    plane_pass, split = _plane_pass(opt, device)
    batched = (POOL_FAST and opt != 0 and pool0 is None
               and _frames_independent(w0, h0, fmt, dh, luma))
    log_dispatch(
        fmt=fmt.name,
        backend=(interp_field_pool_batch if batched else plane_pass).__name__,
        acc_dtype=spec.acc_dtype, order=order, aa=aa, aac=aac, dh=dh, luma=luma,
        chroma=chroma, opt=opt, pool_compat=True, frames=N, height=h0, width=w0,
        device=device,
    )
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    process = [luma, chroma, chroma]
    offsets = [field_offset_py(order, bool(parity[n]) if order == 0 else True)
               for n in range(N)]

    def call(planes, pool0):  # the caller's, or a graph's static copies
        outs: list[torch.Tensor] = []
        passes = []  # (plane index, threshold) of the planes through the pool
        for i, p in enumerate(planes):
            n, h, w = p.shape
            if i >= 3:
                # alpha: passthrough, line-doubled under dh (the reference
                # never feeds it through the pool, src/SangNom2.cpp:347)
                outs.append(torch.stack([p, p], dim=2).reshape(n, 2 * h, w) if dh else p)
            elif not dh and not process[i]:
                outs.append(p)  # skipped plane: the pool is untouched
            else:
                outs.append(p.new_empty((n, 2 * h if dh else h, w)))
                passes.append((i, aaf_as_pixel(aafs[i], fmt)))
        if batched:
            P, S = want[1] - 1, want[2]
            return tuple(outs), _sangnom2_pool_batched(planes, outs, passes, offsets,
                                                       dh, spec, P, S)
        pool = init_pool(w0, h_out0, fmt, device) if pool0 is None else pool0
        carry = _pool_split(pool) if split else pool
        for f in range(N):
            off = offsets[f]
            for i, aaf in passes:
                src = planes[i][f]
                kept = src if dh else src[off::2]
                with span(POOL_PASS) as sp:
                    if sp:
                        sp.set(frame=f, plane=i)
                    interp = plane_pass(kept, carry, aaf, spec)
                _assemble_into(outs[i][f], kept, interp, off)
        if split:
            pool.copy_(_pool_join(carry))
        return tuple(outs), pool

    if not pool_graph.engages(device, opt, batched):
        return call(planes, pool0)
    key = pool_graph.call_key(
        planes, torch.cuda.current_stream(device).cuda_stream, pool0 is None, fmt.name,
        offsets, order, aa, aac, dh, luma, chroma, numerics, opt,
        (POOL_FUSED, POOL_SPLIT3))
    return pool_graph.CACHE.run(key, planes, pool0, call)

