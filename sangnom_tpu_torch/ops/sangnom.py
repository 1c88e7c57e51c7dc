"""Frame orchestration: field selection, plane dispatch, assembly, batching.

The functional equivalent of the reference's `GetFrame` (reference
src/SangNom2.cpp:332-397): pick the kept field per `order`, copy it through,
interpolate the missing lines, duplicate the one uninterpolatable boundary
line, honor the `luma`/`chroma` plane masks and `dh` height doubling, as a
clip -> clip transform batched over frames.

Backend dispatch (the analogue of the reference's opt member-function
selection, src/SangNom2.cpp:312-329):
  opt = -1  auto: the CUDA kernel for CUDA tensors, the plain path otherwise
  opt =  0  the plain PyTorch path (the parity target, like the reference's C)
  opt =  1  the CUDA kernel; tensors on any other device are refused
"""

from __future__ import annotations

import threading
from typing import Callable, Union

import numpy as np
import torch

from sangnom_tpu_torch.core.clip import Clip, where_storage
from sangnom_tpu_torch.core.formats import VideoFormat
from sangnom_tpu_torch.core.geometry import (
    aaf_as_pixel,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from sangnom_tpu_torch.ops import reference as ref_backend
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.utils.logging import log_dispatch
from sangnom_tpu_torch.utils.profiling import CALL, PLANE, count, span

Offset = Union[int, torch.Tensor]


def _pick_backend(opt: int, device: torch.device) -> Callable:
    """The batched interpolation function for the requested backend."""
    if opt == 0:
        return ref_backend.interpolate_field_batch
    from sangnom_tpu_torch.ops import deint_kernel

    if device.type == "cuda":
        return deint_kernel.interpolate_field_batch
    if opt == 1:
        from sangnom_tpu_torch.api import SangNomError

        raise SangNomError("SangNom2: opt=1 requires a CUDA backend.")
    return ref_backend.interpolate_field_batch


def deinterlace_plane_batch(
    src: torch.Tensor,
    offsets: Offset,
    dh: bool,
    aaf,
    spec: KernelSpec,
    stride: int,
    interp_fn: Callable,
    plane_width: int | None = None,
    interlaced_tff: bool | None = None,
    on_kept: Callable | None = None,
) -> torch.Tensor:
    """One plane, all frames: [N, h_src, w] -> [N, h_out, w].

    The per-plane body of GetFrame (reference src/SangNom2.cpp:361-393):
    kept-field copy, boundary-line duplication, interpolation.  ``offsets``
    is an int (orders 1/2) or a per-frame [N] int32 tensor (order 0).

    ``plane_width`` not None: the width-sharded path (parallel.sharding),
    where ``src`` is edge-padded past the plane's true width, which it
    passes on to ``interp_fn``.  Its weave (``fused_weave.sharded``, the
    number of width shards) runs when a shard is at least 9 columns wide.

    ``interlaced_tff`` not None (requires dh): ``src`` is an interlaced
    [N/2, h, w] plane whose fields are the dh sources (the bob pipeline);
    the CUDA kernel reads the fields in place, other paths split here.

    ``on_kept``: called once the pass's kernel input is issued (the kept
    rows; on the field kernel's wide route their copy with its edge pad,
    which that weave makes and calls it after), before the kernel.
    """
    if interlaced_tff is not None:
        if not dh:
            raise ValueError("interlaced input requires dh=True")
        h_src = src.shape[1] // 2
    else:
        h_src = src.shape[1]
    bufH = (2 * h_src if dh else h_src) // 2

    if dh:
        kept = src  # dh: the whole source is the kept field
    elif isinstance(offsets, int):
        kept = src[:, offsets::2]  # a view, copied once by the pass below
    else:
        kept = where_storage(
            (offsets == 0)[:, None, None], src[:, 0::2], src[:, 1::2]
        )

    # The CUDA backend emits the complete woven plane (kept rows,
    # interpolated rows and the boundary duplicate) from the kernel.
    fused_weave = getattr(interp_fn, "fused_weave", None)
    weave_ok = fused_weave is not None and bufH >= 2
    shards = getattr(fused_weave, "sharded", 0)
    if weave_ok and plane_width is None and not shards:
        return fused_weave(kept, offsets, aaf, spec, stride,
                           interlaced_tff=interlaced_tff, on_ready=on_kept)
    kept = kept.contiguous()
    if on_kept is not None:
        on_kept()
    if interlaced_tff is not None:
        from sangnom_tpu_torch.core.fields import split_plane

        kept = split_plane(src, interlaced_tff)
    if weave_ok and shards and kept.shape[2] // shards >= 9:
        # the sharded weave; thinner shards interpolate, then weave below
        return fused_weave(kept, offsets, aaf, spec, stride,
                           plane_width=plane_width)
    if plane_width is None:
        interp = interp_fn(kept, aaf, spec, stride)
    else:
        interp = interp_fn(kept, aaf, spec, stride, plane_width=plane_width)
    return weave_assemble(kept, interp, offsets)


def weave_assemble(
    kept: torch.Tensor, interp: torch.Tensor, offsets: Offset
) -> torch.Tensor:
    """Interleave kept [N, bufH, w] and interpolated [N, bufH-1, w] rows per
    ``offsets``, with the boundary missing line duplicated (reference
    src/SangNom2.cpp:379-391): offset 0 -> bottom missing line := last kept
    line; offset 1 -> top missing line := first kept line."""
    N, bufH, w = kept.shape

    def weave(top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
        return torch.stack([top, bottom], dim=2).reshape(N, 2 * bufH, w)

    if isinstance(offsets, int):
        if offsets == 0:
            return weave(kept, torch.cat([interp, kept[:, -1:]], dim=1))
        return weave(torch.cat([kept[:, :1], interp], dim=1), kept)
    is0 = (offsets == 0)[:, None, None]
    top = where_storage(is0, kept, torch.cat([kept[:, :1], interp], dim=1))
    bottom = where_storage(
        is0, torch.cat([interp, kept[:, -1:]], dim=1), kept
    )
    return weave(top, bottom)


# Device copies of order=0 offsets, by (device, repeats, pattern): every bob
# call of a clip length reads the same alternating pattern, so it crosses to
# the card once.  Filled up to _OFFSETS_MAX patterns and never emptied, so no
# copy is freed while a launch on any stream may still read it.
_OFFSETS: dict = {}
_OFFSETS_MAX = 64


def field_offsets(order: int, parity, device: torch.device,
                  repeats: int = 1) -> Offset:
    """Per-frame kept-field offset (reference src/SangNom2.cpp:336-341):
    order=0 consults the per-frame host parity (GetParity), 1 keeps the
    top field, 2 the bottom one.  ``repeats``: the order=0 offsets that
    many times over (U and V in one launch)."""
    if order == 1:
        return 0
    if order == 2:
        return 1
    offs = np.where(np.asarray(parity, dtype=bool), 0, 1).astype(np.int32)
    if device.type == "cpu":
        return torch.from_numpy(np.tile(offs, repeats))
    key = (device, repeats, offs.tobytes())
    t = _OFFSETS.get(key)
    if t is None:
        offs = np.tile(offs, repeats)
        count("h2d_copies")
        count("h2d_bytes", offs.nbytes)
        t = torch.from_numpy(offs).to(device)  # synchronous: complete for every stream
        if len(_OFFSETS) < _OFFSETS_MAX:
            _OFFSETS[key] = t
    return t


def field_offset_py(order: int, frame_parity: bool) -> int:
    """Scalar `field_offsets` for one frame (the native-oracle wrapper)."""
    if order == 0:
        return 0 if frame_parity else 1
    return 0 if order == 1 else 1


def sangnom2_impl(
    planes,
    parity,
    fmt: VideoFormat,
    order: int,
    aa: int,
    aac: int,
    dh: bool,
    luma: bool,
    chroma: bool,
    opt: int,
    numerics: str = "c",
    interlaced_tff: bool | None = None,
    interp_fn: Callable | None = None,
    plane_widths: tuple | None = None,
    stride: int | None = None,
):
    """The whole-frame-batch transform over plane tensors.

    ``parity``: host bool array, read only for order=0.  ``numerics``: "c"
    (the parity target) or "sse2" (the reference's second numeric contract,
    see ops.primitives.KernelSpec).  The width-sharded path
    (parallel.sharding) passes its own ``interp_fn``, the planes' true
    ``plane_widths`` (its planes are edge-padded) and the luma ``stride``;
    by default the backend follows ``opt`` and the stride the luma plane."""
    device = planes[0].device
    if interp_fn is None:
        interp_fn = _pick_backend(opt, device)
    spec = KernelSpec.from_format(fmt, sse2=(numerics == "sse2"))
    log_dispatch(
        fmt=fmt.name, backend=interp_fn.__module__, acc_dtype=spec.acc_dtype,
        order=order, aa=aa, aac=aac, dh=dh, luma=luma, chroma=chroma, opt=opt,
        frames=planes[0].shape[0], height=planes[0].shape[1],
        width=planes[0].shape[2], device=device,
    )
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    if stride is None:
        stride = buffer_stride_elems(planes[0].shape[2], fmt.component_size)
    process = [luma, chroma, chroma]
    offsets = field_offsets(order, parity, device)

    def width_of(i):
        return None if plane_widths is None else plane_widths[i]

    out: dict[int, torch.Tensor] = {}
    chroma_planes = [
        i for i in (1, 2)
        if i < len(planes) and (dh or process[i])
    ]
    uv_batched = len(chroma_planes) == 2 and planes[1].shape == planes[2].shape

    def uv_pass(side: bool = False) -> torch.Tensor:
        # U and V share geometry, threshold and offsets: one batched launch
        with span(PLANE) as sp:
            if side:  # issued on the second stream, beside the luma pass
                count("overlap_passes")
            uv = torch.cat([planes[1], planes[2]], dim=0)
            if sp:
                _plane_counts(sp, "uv", uv, interlaced_tff)
                if side:
                    sp.set(stream="side")
            offs2 = field_offsets(order, parity, device, repeats=2)
            # output frames per plane, doubled for interlaced (bob) input
            n = planes[1].shape[0] * (1 if interlaced_tff is None else 2)
            res = deinterlace_plane_batch(
                uv, offs2, dh=dh, aaf=aaf_as_pixel(aafs[1], fmt), spec=spec,
                stride=stride, interp_fn=interp_fn, plane_width=width_of(1),
                interlaced_tff=interlaced_tff,
            )
        out[1], out[2] = res[:n], res[n:]
        return res

    def plane_pass(i: int, on_kept: Callable | None = None) -> None:
        with span(PLANE) as sp:
            if sp:
                _plane_counts(sp, i, planes[i], interlaced_tff)
            out[i] = deinterlace_plane_batch(
                planes[i], offsets, dh=dh, aaf=aaf_as_pixel(aafs[i], fmt),
                spec=spec, stride=stride, interp_fn=interp_fn,
                plane_width=width_of(i), interlaced_tff=interlaced_tff,
                on_kept=on_kept,
            )

    beside = False
    if uv_batched and (dh or process[0]):
        from sangnom_tpu_torch.ops import deint_kernel

        beside = deint_kernel.overlap_uv(
            (planes[0].shape, planes[1].shape), [p.device for p in planes[:3]],
            dh=dh, interlaced=interlaced_tff is not None, stride=stride,
            spec=spec, kernel=interp_fn is deint_kernel.interpolate_field_batch,
            plane_widths=plane_widths,
        )
    if beside:
        _beside(device, lambda on_kept: plane_pass(0, on_kept),
                lambda: uv_pass(side=True))
    elif uv_batched:
        uv_pass()

    for i, p in enumerate(planes):
        if i in out:
            continue
        if i >= 3:
            # Alpha: passthrough, line-doubled under dh (the reference caps
            # at 3 planes and leaves dst alpha uninitialized,
            # src/SangNom2.cpp:347).
            n, h, w = p.shape
            out[i] = torch.stack([p, p], dim=2).reshape(n, 2 * h, w) if dh else p
            continue
        if not dh and not process[i]:
            # Unprocessed plane: verbatim copy (reference
            # src/SangNom2.cpp:369-374); dh forces every plane (361-366).
            out[i] = p
            continue
        plane_pass(i)
    return tuple(out[i] for i in range(len(planes)))


# A second CUDA stream a (host thread, device), for the U+V pass that runs
# beside the luma pass (`_beside`); the CLI's and the hosts' threads each get
# their own.
_SIDE = threading.local()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    streams = _SIDE.__dict__.setdefault("streams", {})
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
    return s


def _beside(device: torch.device, first: Callable, second: Callable) -> None:
    """Issue the luma pass ``first(on_kept)`` on the caller's stream and
    the U+V pass ``second()`` on this thread's second stream; the caller's
    stream then waits for the second, so every output is complete for the
    caller's later work and nothing synchronizes the device.

    The second stream starts once the luma kernel's input is issued
    (``on_kept``: on the wide route the kept rows' one copy with the edge
    pad), which is after the caller's state at entry: so the luma kernel
    is ready before the U+V copies are and takes its SMs first, one block
    a SM.  The U+V pass runs on its ``deint_kernel.side_plan``, whose
    blocks cannot share a SM with a luma block, so it fills only the SMs
    left free.  Started at entry instead, the U+V copies and kernel ran
    beside K4's launch on the maa pass, and K4's walk took 6.6 ms in most
    calls against 3.95 alone (H100).  On maa's turned pass, with the U+V
    blocks as planned (98.6 KB) beside K4's (115.7 KB), the calls' rate
    swung 2276-2810 frames/s from run to run (H100).

    The U+V output, allocated on the second stream, is marked in use on
    the caller's, so the allocator does not hand its memory to the second
    stream's next pass before the caller's work on it is done.  What the
    second pass only reads (the planes, the offsets) is freed after the
    caller's wait, so later work never overwrites it early."""
    from sangnom_tpu_torch.ops import deint_kernel

    caller = torch.cuda.current_stream(device)
    side = _side_stream(device)
    first(lambda: side.wait_event(caller.record_event()))
    with torch.cuda.stream(side), deint_kernel.beside():
        res = second()
    res.record_stream(caller)
    caller.wait_stream(side)


def _plane_counts(sp, plane, src: torch.Tensor, interlaced_tff) -> None:
    """A plane span's counts, and the ``u16_fields`` counter: the fields
    the pass walks with 2-byte samples (the uint16 build of the kernel)."""
    fields = src.shape[0] * (1 if interlaced_tff is None else 2)
    elem = src.element_size()
    sp.set(plane=plane, fields=fields, bytes=src.numel() * elem, elem=elem)
    if elem == 2:
        count("u16_fields", fields)


def sangnom2_op(
    clip: Clip,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    pool_compat: bool = False,
    numerics: str = "c",
) -> Clip:
    """The filter op; parameters are validated by the API layer
    (sangnom_tpu_torch.api).

    ``pool_compat=True`` reproduces the reference's shared buffer pool
    (ops/pool_carry.py): frames run in order, the pool carried across planes
    and frames."""
    if pool_compat:
        from sangnom_tpu_torch.ops.pool_carry import sangnom2_pool_impl

        planes, _ = sangnom2_pool_impl(
            clip.planes, clip.parity_array(), clip.format, order, aa, aac, dh,
            luma, chroma, numerics=numerics, opt=opt,
        )
        return clip.with_planes(planes)
    _maybe_aot(clip, order, aa, aac, dh, luma, chroma, opt, numerics)
    if order == 0:
        planes = _order0_static_split(
            clip, clip.parity_array(), aa, aac, dh, luma, chroma, opt,
            numerics,
        )
    else:
        planes = sangnom2_impl(
            clip.planes, None, clip.format, order, aa, aac, dh, luma, chroma,
            opt, numerics=numerics,
        )
    return clip.with_planes(planes)


def _maybe_aot(clip: Clip, order, aa, aac, dh, luma, chroma, opt,
               numerics) -> bool:
    """Count this filter dispatch as served from a prewarmed artifact (a hit)
    or not (a miss) when ``sangnom_tpu_torch.aot`` is configured; the
    dispatch runs the same code either way, so the output bits are the same.
    Called only on the path the artifacts describe (pool_compat stays off
    it, as in the TPU package).  Returns whether it was a hit."""
    from sangnom_tpu_torch import aot

    if not aot.is_configured():
        return False
    return aot.lookup(
        "filter", clip.format.name, aot.plane_shapes(clip.planes),
        aot.filter_statics(order, aa, aac, dh, luma, chroma, opt, numerics),
        device=clip.device)


def sangnom2_pool_stream(
    clip: Clip,
    pool_state: torch.Tensor | None,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    numerics: str = "c",
    opt: int = -1,
):
    """One chunk of a pool-compat stream: ``sangnom2(pool_compat=True)``
    taking and returning the pool state [9, P+1, S], so a windowed caller
    produces the same output as one whole-clip call.  ``pool_state=None``
    starts a fresh stream; the caller's pool is never modified.  Returns
    (out_clip, pool)."""
    from sangnom_tpu_torch.api import _validate, _validate_numerics
    from sangnom_tpu_torch.ops.pool_carry import sangnom2_pool_impl

    with span(CALL) as sp:
        if sp:
            sp.set(entry="sangnom2_pool_stream", path="pool", frames_in=clip.num_frames)
        _validate("SangNom2", clip, order, aa, aac, opt)
        _validate_numerics("SangNom2", numerics)
        pool0 = None
        if pool_state is not None:
            pool0 = pool_state.to(device=clip.device, copy=True)
        planes, pool = sangnom2_pool_impl(
            clip.planes, clip.parity_array(), clip.format, order, aa, aac, dh,
            luma, chroma, pool0=pool0, numerics=numerics, opt=opt,
        )
        out = clip.with_planes(planes)
        if sp:
            sp.set(frames_out=out.num_frames)
    return out, pool


def _order0_static_split(clip, parity, aa, aac, dh, luma, chroma, opt,
                         numerics):
    """order=0 with host parity: a UNIFORM batch collapses to order 1 or 2
    (static offsets); a mixed batch (bob's alternation) passes per-frame
    offsets, which the CUDA kernel reads as data."""
    offs = np.where(parity, 0, 1)
    if (offs == offs[0]).all():
        order_s = 1 if offs[0] == 0 else 2
        return sangnom2_impl(
            clip.planes, None, clip.format, order_s, aa, aac, dh, luma,
            chroma, opt, numerics=numerics,
        )
    return sangnom2_impl(
        clip.planes, parity, clip.format, 0, aa, aac, dh, luma, chroma, opt,
        numerics=numerics,
    )
