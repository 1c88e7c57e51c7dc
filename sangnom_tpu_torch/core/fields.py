"""Field-geometry clip utilities: SeparateFields / DoubleWeave / bob.

The reference's double-rate mode needs the host to prepare the clip ("user
must call std.SeparateFields().std.DoubleWeave() before use" for order=0,
reference src/SangNom2.cpp:18-23).  These are those host utilities, with
AviSynth's field semantics:

- `separate_fields`: each interlaced frame -> two half-height field frames,
  ordered by the clip's field dominance (tff); per-field parity recorded.
- `double_weave`: frame n = weave of fields (n, n+1): same frame count,
  double height, parity from the leading field.
- `bob`: the whole double-rate deinterlace:
  separate_fields -> double_weave -> SangNom2(order=0).
"""

from __future__ import annotations

import numpy as np
import torch

from sangnom_tpu_torch.core.clip import Clip, where_storage
from sangnom_tpu_torch.utils.profiling import CALL, span


def split_plane(p: torch.Tensor, tff: bool) -> torch.Tensor:
    """[N, H, W] -> [2N, H/2, W] field frames in dominance order (row index
    2r+b factors as [r, b])."""
    n, h, w = p.shape
    rb = p.reshape(n, h // 2, 2, w)
    if not tff:
        rb = rb.flip(2)
    return rb.permute(0, 2, 1, 3).reshape(2 * n, h // 2, w)


def separate_fields(clip: Clip, tff: bool | None = None) -> Clip:
    """[N, H, W] frames -> [2N, H/2, W] field frames.

    Field order follows ``tff`` (default: the clip's flag): tff=True emits
    (top, bottom) per frame, and the parity array marks each top field True.
    """
    if clip.height % 2:
        raise ValueError("separate_fields: height must be even.")
    tff = clip.tff if tff is None else tff
    parity = np.tile(np.array([tff, not tff]), clip.num_frames)
    return Clip(
        [split_plane(p, tff) for p in clip.planes],
        clip.format,
        parity=parity,
        tff=tff,
        props={**clip.props, "field_based": True},
    )


def weave(clip: Clip) -> Clip:
    """Inverse of separate_fields: field pairs (2k, 2k+1) -> [N/2, 2h, W]."""
    if clip.num_frames % 2:
        raise ValueError("weave: field count must be even.")
    parity = clip.parity_array()

    def join(p: torch.Tensor) -> torch.Tensor:
        m, h, w = p.shape
        pairs = p.reshape(m // 2, 2, h, w)
        return _weave_pair(pairs[:, 0], pairs[:, 1], parity[0::2])

    props = {k: v for k, v in clip.props.items() if k != "field_based"}
    return Clip([join(p) for p in clip.planes], clip.format,
                tff=clip.get_parity(0), props=props)


def _weave_pair(first, second, first_is_top: np.ndarray):
    """Interleave two field batches by the first field's host parity."""
    m, h, w = first.shape
    top_first = torch.stack([first, second], dim=2).reshape(m, 2 * h, w)
    bot_first = torch.stack([second, first], dim=2).reshape(m, 2 * h, w)
    sel = torch.from_numpy(np.ascontiguousarray(first_is_top)).to(first.device)
    return where_storage(sel[:, None, None], top_first, bot_first)


def double_weave(clip: Clip) -> Clip:
    """Field frames -> same-count full-height frames: frame n weaves fields
    (n, n+1); the last frame weaves (N-1, N-1), like AviSynth's final
    duplicated pairing."""
    parity = clip.parity_array()

    def dw(p: torch.Tensor) -> torch.Tensor:
        nxt = torch.cat([p[1:], p[-1:]], dim=0)
        return _weave_pair(p, nxt, parity)

    return Clip(
        [dw(p) for p in clip.planes],
        clip.format,
        parity=clip.parity,
        tff=clip.tff,
        props=clip.props,
    )


def bob(clip: Clip, aa: int = 48, aac: int = 0, luma: bool = True,
        chroma: bool = True, opt: int = -1, tff: bool | None = None,
        pool_compat: bool = False, numerics: str = "c") -> Clip:
    """Double-rate deinterlace: SeparateFields -> DoubleWeave ->
    SangNom2(order=0) (the reference's documented recipe,
    src/SangNom2.cpp:18-23).  Returns 2N full-height frames.

    Fused path: the filter reads only the kept field of each woven frame,
    and DoubleWeave puts field n at frame n's kept-field parity, so
    ``SangNom2(order=0)`` on the woven clip equals ``SangNom2(order=0,
    dh=True)`` on the fields.  The interlaced planes go straight to the
    filter, whose CUDA kernel reads the fields in place.  A plane mask that
    is off, an alpha plane, or pool_compat needs the discarded field's data
    and takes the explicit pipeline.
    """
    with span(CALL) as sp:
        if sp:
            sp.set(entry="bob", path="pool" if pool_compat else "main",
                   frames_in=clip.num_frames)
        out = _bob(clip, aa, aac, luma, chroma, opt, tff, pool_compat, numerics)
        if sp:
            sp.set(frames_out=out.num_frames)
    return out


def _bob(clip: Clip, aa: int, aac: int, luma: bool, chroma: bool, opt: int,
         tff: bool | None, pool_compat: bool, numerics: str) -> Clip:
    """`bob`'s body, inside its call span."""
    from sangnom_tpu_torch.api import _validate, _validate_numerics, sangnom2

    tff_r = clip.tff if tff is None else tff
    fused = (luma and (chroma or clip.format.num_planes == 1)
             and not pool_compat
             and clip.format.num_planes <= 3 and clip.height % 2 == 0)
    if fused:
        # the woven height IS the input height, so this validates the same
        # geometry as the explicit pipeline
        _validate("SangNom2", clip, 0, aa, aac, opt)
        _validate_numerics("SangNom2", numerics)
        from sangnom_tpu_torch import aot

        if aot.is_configured():
            # counts a hit or a miss; the dispatch below is the same either way
            aot.lookup("bob", clip.format.name, aot.plane_shapes(clip.planes),
                       aot.bob_statics(aa, aac, tff_r, opt, numerics),
                       device=clip.device)
        planes = bob_impl(clip.planes, clip.format, aa, aac, tff_r, opt,
                          numerics)
        return Clip(
            list(planes), clip.format,
            parity=np.tile(np.array([tff_r, not tff_r]), clip.num_frames),
            tff=tff_r, props={**clip.props, "field_based": True},
        )
    fields = separate_fields(clip, tff=tff)
    woven = double_weave(fields)
    return sangnom2(woven, order=0, aa=aa, aac=aac, luma=luma,
                    chroma=chroma, opt=opt, pool_compat=pool_compat,
                    numerics=numerics)


def bob_impl(planes, fmt, aa: int, aac: int, tff: bool, opt: int,
             numerics: str):
    """SeparateFields -> order=0 dh filter on the interlaced planes, with
    the alternating parity as per-frame offsets (``interlaced_tff``)."""
    from sangnom_tpu_torch.ops.sangnom import sangnom2_impl

    parity = np.tile(np.array([tff, not tff]), planes[0].shape[0])
    return sangnom2_impl(
        tuple(planes), parity, fmt, order=0, aa=aa, aac=aac, dh=True,
        luma=True, chroma=True, opt=opt, numerics=numerics,
        interlaced_tff=tff,
    )
