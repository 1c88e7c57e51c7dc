"""Device meshes and the sharded filter entry point.

`sangnom2_sharded` is the multi-device analogue of the host's frame-MT in
the reference (MT_MULTI_INSTANCE, reference src/SangNom2.h:63-66): frames
shard over the ``data`` mesh axis with no communication, and optionally each
plane's width shards over the ``space`` axis with halo exchange
(parallel.width_sharded).

A mesh is a ``[data, space]`` grid of torch devices, and a device may fill
several slots: ``default_mesh(1, 4, devices=["cuda:0"] * 4)`` runs four
width shards on one card, ``["cpu"] * 8`` is a CPU mesh.  Every ``space``
slot of a data row must be one device for now; width halos across devices
come with the multi-host (torch.distributed) port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sangnom_tpu_torch.core.clip import Clip
from sangnom_tpu_torch.ops.sangnom import sangnom2_impl
from sangnom_tpu_torch.parallel.width_sharded import interpolate_field_width_sharded


class Mesh:
    """A named ``[data, space]`` grid of torch devices."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "space")):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {grid.shape} for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def default_mesh(data: Optional[int] = None, space: int = 1,
                 devices=None) -> Mesh:
    """A ('data', 'space') mesh over the available devices.

    ``devices`` defaults to every CUDA device (never the CPU); a device may
    repeat.  ``data`` defaults to len(devices) // space.  'data' shards
    frames; 'space' shards plane width (halo exchange)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if data is None:
        data = max(1, len(devices) // space)
    n = data * space
    if n > len(devices) or n == 0:
        raise ValueError(f"mesh {data}x{space} needs {n} devices, have {len(devices)}")
    grid = np.empty((data, space), dtype=object)
    for k, d in enumerate(devices[:n]):
        grid[k // space, k % space] = d
    return Mesh(grid, ("data", "space"))


def _sharded_pad_width(
    w_i: int, h_i: int, stride: int, n_space: int, fmt, dh: bool
) -> int:
    """Padded width for one plane under width sharding: the least multiple
    of ``n_space`` that provably preserves the full-stride semantics.

    The reference smooths every plane over the LUMA-derived buffer stride
    (SURVEY.md §2 quirk 6), so subsampled chroma carries up to 2x padding.
    Clamping the box at or past the observable-creep / integer-decay bound
    (core.geometry.creep_bound) is invisible in the trimmed output, so the
    globally padded array the shards divide stops there instead of at the
    full stride: at 1080 4:2:0 this halves the sharded chroma compute and
    every chroma halo exchange."""
    from sangnom_tpu_torch.core.geometry import creep_bound
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    spec = KernelSpec.from_format(fmt)
    bufH = h_i if dh else h_i // 2
    creep = creep_bound(w_i, bufH, spec)
    s_eff = min(stride, -(-creep // n_space) * n_space)
    # keep shards at least as wide as the full-stride case would allow the
    # fused kernel (or, for narrow strides, no narrower than stride/n)
    return max(s_eff, min(stride, n_space * 9))


def _validate_width_sharding(stride: int, n_space: int) -> None:
    """Every plane is padded to the luma-derived buffer stride before
    sharding, so the only requirements are on the stride itself."""
    if stride % n_space:
        raise ValueError(
            f"buffer stride {stride} does not divide across "
            f"{n_space} 'space' shards"
        )
    if stride // n_space < 3:
        # halo exchange reaches only the adjacent shard; every tap spans
        # <= 3 columns, so each shard must own at least 3
        raise ValueError(
            f"local width {stride // n_space} < 3: too many 'space' "
            f"shards for stride {stride}"
        )


def _row_devices(mesh: Mesh, data_axis: str, space_axis: Optional[str]):
    """The device of each data row; a width-sharded row must be one device."""
    grid = mesh.devices
    if mesh.axis_names.index(data_axis) != 0:
        grid = grid.T
    rows = []
    for row in grid:
        if space_axis and any(d != row[0] for d in row):
            raise NotImplementedError(
                f"width sharding across devices is not yet ported: the "
                f"'{space_axis}' slots of a mesh row must be one device, got "
                f"{[str(d) for d in row]} (width halos across devices come "
                "with the multi-host torch.distributed port)"
            )
        rows.append(row[0])
    return rows


def _sharded_interp(smooth: str, n_space: int):
    """The width-sharded interpolation for sangnom2_impl; with the fused
    arm it carries the sharded weave."""

    def interp_fn(kept, aaf, spec, stride, plane_width=None):
        return interpolate_field_width_sharded(kept, aaf, spec, n_space,
                                               plane_width, smooth=smooth)

    if smooth == "fused":
        from sangnom_tpu_torch.parallel.fused_smooth import deinterlace_fused_full

        def fused_weave(kept, offsets, aaf, spec, stride, plane_width=None):
            return deinterlace_fused_full(kept, offsets, aaf, spec, n_space,
                                          plane_width)

        fused_weave.sharded = n_space
        interp_fn.fused_weave = fused_weave
    elif smooth == "chunked":
        # on the card the finalize kernel weaves; elsewhere interpolate, then
        # weave, as the unwoven path does
        from sangnom_tpu_torch.ops.sangnom import weave_assemble
        from sangnom_tpu_torch.parallel.fused_smooth import deinterlace_chunked

        def chunked_weave(kept, offsets, aaf, spec, stride, plane_width=None):
            if kept.device.type == "cuda":
                return deinterlace_chunked(kept, offsets, aaf, spec, n_space, plane_width)
            return weave_assemble(kept, interp_fn(kept, aaf, spec, stride, plane_width),
                                  offsets)

        chunked_weave.sharded = n_space
        interp_fn.fused_weave = chunked_weave
    return interp_fn


def sangnom2_sharded(
    clip: Clip,
    mesh: Mesh,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    threads: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    data_axis: str = "data",
    space_axis: Optional[str] = None,
    smooth: Optional[str] = None,
    numerics: str = "c",
    pool_compat: bool = False,
) -> Clip:
    """SangNom2 over a device mesh.

    Frames shard over ``data_axis`` (padded to divide evenly, then trimmed):
    each data row's frames go to its device, run there, and come back to the
    clip's device.  If ``space_axis`` is given, plane widths also shard over
    it, with halo exchange.  ``smooth`` overrides the opt-derived width-
    sharded backend ("scan" | "chunked" | "fused" | "fused_noweave"; see
    width_sharded.interpolate_field_width_sharded); on a CPU mesh the kernel
    arms run their plain versions.  ``numerics`` selects the numerics
    contract as on the single-device surface ("c" | "sse2").

    ``pool_compat`` is NOT supported under sharding and raises: the pool
    is cross-frame state (frames must run in order, so the data axis is
    meaningless there), and width-sharding the sequential pool scan is
    rejected on value.  Use ``sangnom2(pool_compat=True)``.
    """
    from sangnom_tpu_torch.api import (  # surface parity
        SangNomError, _validate, _validate_geometry, _validate_numerics)
    from sangnom_tpu_torch.core.geometry import buffer_stride_elems

    # the opt=1 device gate is against the mesh, below
    _validate("SangNom2", None, order, aa, aac, opt)
    _validate_geometry("SangNom2", clip.format, clip.height)
    _validate_numerics("SangNom2", numerics)
    if pool_compat:
        raise SangNomError(
            "SangNom2: pool_compat is not supported under sharding (the "
            "pool is sequential cross-frame state; see docs/MULTICHIP.md) "
            "— use the single-device sangnom2(pool_compat=True)."
        )
    del threads

    n_data = mesh.shape[data_axis]
    n_space = mesh.shape[space_axis] if space_axis else 1
    devices = _row_devices(mesh, data_axis, space_axis)
    on_cuda = all(d.type == "cuda" for d in devices)
    if opt == 1 and not on_cuda:
        raise SangNomError("SangNom2: opt=1 requires a CUDA backend.")
    fmt = clip.format
    stride = buffer_stride_elems(clip.width, fmt.component_size)
    if space_axis:
        _validate_width_sharding(stride, n_space)

    N = clip.num_frames
    pad = (-N) % n_data
    widths = tuple(p.shape[2] for p in clip.planes)
    planes = []
    for p in clip.planes:
        if pad:
            zeros = torch.zeros((pad,) + p.shape[1:], dtype=torch.int16
                                if p.dtype == torch.uint16 else p.dtype, device=p.device)
            p = torch.cat([p, zeros.view(p.dtype)])
        if space_axis and p.shape[2] < stride:
            # pad toward the buffer stride with EDGE REPLICATION: pixel taps
            # that clamp at the true width then read the replicated edge
            # pixel (loadPixel semantics), while the zero-defined raw-map
            # padding is re-created in the sharded arms by a global-column
            # mask.  The padded width stops at the creep/decay bound
            # (_sharded_pad_width).
            s_eff = _sharded_pad_width(p.shape[2], p.shape[1], stride,
                                       n_space, fmt, dh)
            if p.shape[2] < s_eff:
                edge = p[:, :, -1:].expand(-1, -1, s_eff - p.shape[2])
                p = torch.cat([p, edge], dim=2)
        planes.append(p)
    parity = clip.parity_array()
    if pad:
        parity = np.concatenate([parity, np.zeros(pad, dtype=bool)])

    if space_axis:
        # opt=0 keeps the per-row-exchange scan (the parity target); opt=1
        # the fused K4 kernel; auto: K4 on CUDA, the scan elsewhere
        if smooth is None:
            if opt == 0:
                smooth = "scan"
            elif opt == 1:
                smooth = "fused"
            else:
                smooth = "fused" if on_cuda else "scan"
        elif smooth not in ("scan", "chunked", "fused", "fused_noweave"):
            # a typo'd name would otherwise fall through every backend
            # match and silently run the scan arm
            raise ValueError(
                f"smooth={smooth!r}: expected one of 'scan', 'chunked', "
                "'fused', 'fused_noweave'."
            )
        impl_kw = dict(interp_fn=_sharded_interp(smooth, n_space),
                       plane_widths=widths, stride=stride)
    elif smooth is not None:
        # smooth selects among WIDTH-sharded backends; ignoring it on a
        # data-only mesh would let an A/B harness measure the wrong arm
        raise ValueError(
            f"smooth={smooth!r} requires space_axis (width sharding); "
            "data-parallel shards run the per-shard backend picked by opt."
        )
    else:
        impl_kw = {}  # the per-device default backend

    per = (N + pad) // n_data
    outs = []
    for d, device in enumerate(devices):
        sl = slice(d * per, (d + 1) * per)
        local = [p[sl].to(device) for p in planes]
        res = sangnom2_impl(local, parity[sl], fmt, order, aa, aac, dh, luma,
                            chroma, opt, numerics=numerics, **impl_kw)
        outs.append([r.to(clip.device) for r in res])
    out_planes = [torch.cat([o[i] for o in outs])[:N, :, :w].contiguous()
                  for i, w in enumerate(widths)]
    return clip.with_planes(out_planes)
