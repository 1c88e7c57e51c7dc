"""The hand-written CUDA kernel for field interpolation, and its plain twin.

`deinterlace_field_batch_fused` (woven full-height output) and
`interpolate_field_batch` (interpolated rows only) launch
``csrc/deint.cu::deint_kernel``, which replaces the TPU package's
``ops/pallas_kernel.py::_kernel`` (launched there by ``_deint_chunk`` and
``_interp_chunk``).  On a CUDA tensor each wrapper launches the kernel or
raises; on a CPU tensor it runs its plain PyTorch version instead.

Each pass is planned once (`field_plan`); the plan decides the route, the
overlap rule (`overlap_uv`) reads its blocks and shared memory, and the
launch runs it.  One block walks a field, so the kernel takes at most
``FIELD_COLS`` (2048) smoothed columns, 4 a thread.  A wider field
(`wide_plan`) runs as the width-sharded kernel K4 runs a field
(``parallel.shard_kernel.full_pass``): the plane edge-padded to a width of k
shards, ``k`` blocks of a field, each of 4-column threads, in one
thread-block cluster (one launch a pass; past ``MAX_CLUSTER`` blocks, or
where the card cannot schedule the cluster, one launch a chunk of rows), the
output cropped back.  Its launches count in ``shard_kernel.LAUNCHES["full"]``,
not in ``LAUNCHES``, and its fields on the card's cluster route in the
``cluster_fields`` counter; on a CPU tensor the wide route runs K4's plain
version with the same k, padding and crop (and counts no cluster field).
On either, the ``wide_row_steps`` counter adds the pass's fields times its
serial row steps (kept rows less one).

The kernel is built and loaded with the rest of the library
(``ops.cuda_library``).  ``LAUNCHES`` counts kernel launches, so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import torch

from sangnom_tpu_torch.core.fields import split_plane
from sangnom_tpu_torch.core.geometry import creep_bound, round_up, width_tiers
from sangnom_tpu_torch.ops import cuda_library as cl
from sangnom_tpu_torch.ops import reference
from sangnom_tpu_torch.ops.launch_geometry import (
    MAX_CLUSTER, block_width, launch_shape, least_split)
from sangnom_tpu_torch.ops.primitives import KernelSpec
from sangnom_tpu_torch.ops.sangnom import Offset, weave_assemble
from sangnom_tpu_torch.parallel import shard_kernel as sk
from sangnom_tpu_torch.utils.profiling import LAUNCH, count, span

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

# The most smoothed columns one block of the field kernel takes: 512 threads
# of 4 columns.  Wider fields take the wide route (`wide_plan`), each block
# within the 4-column build (``shard_kernel.MAX_BLOCK_4``): one block of
# 8-column threads, capped at 64 registers, spilled its carry and walked a
# 3840-column field 5.6x slower a row step than the 4-column build at 1920.
FIELD_COLS = 2048
# The wide route's blocks, halos included: at most WIDE_BLOCK columns (256
# threads of 4 columns) where a cluster of at most MAX_CLUSTER blocks holds
# the field, else at most shard_kernel.MAX_BLOCK_4 (512 threads); a halo
# exchange every WIDE_FIELD_ROWS rows.  The fastest of the (k, R) sweep of
# K4's pass at 3840 x 1080 kept rows on an H100 (chip_smoke.wide_k_sweep;
# PERF.md section 6): 24 fields 3.98 ms at 4 blocks of 960 columns and R 8,
# 6.20 at 2 blocks of 1920 and R 4; 120 fields alike at 2 and 4 blocks.
WIDE_BLOCK = 1016
WIDE_FIELD_ROWS = 8
# A call's U+V pass runs beside its luma pass where the SMs the luma pass
# leaves free hold at least this share of the U+V blocks.  Each block walks
# its fields' rows serially, so a pass takes as long on few SMs as on many:
# only independent work fills the idle ones.
OVERLAP_SHARE = 0.5

_MAPS = 9
_RING_ROWS = 4  # kept-row ring slots

cl.declare({
    # dtype sse2 cols | src dst offsets | n_fields bufH w S | pitch_b pitch_r
    # pitch_p | in_frame_stride | interlaced weave static_offset dbuf | aaf |
    # threads smem_bytes | stream
    "sno_deint_launch": "iii ppp iiii iii q iiii d ii p",
})


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
    pitch_b = round_up(S + cols + 8, 4)
    pitch_r = round_up(w + cols + 8, 16)
    pitch_p = round_up(threads * cols, 16)
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
    edge-padded to ``width`` = k * W_loc, ``plan`` the
    ``shard_kernel.pass_plan`` it launches (its ``cluster``: one launch a
    pass, else a launch a chunk of R rows).  ``blocks``: the pass's grid,
    fields x k."""

    k: int
    W_loc: int
    plan: tuple
    blocks: int

    @property
    def width(self) -> int:
        return self.k * self.W_loc

    @property
    def smem_bytes(self) -> int:
        """The shared memory a block of the pass asks for."""
        return self.plan.smem_bytes


def wide_plan(w: int, bufH: int, stride: int, spec: KernelSpec) -> tuple[int, int]:
    """(k, W_loc): K4's split of a pass over fields of width ``w`` and
    ``bufH`` kept rows at buffer ``stride`` past ``FIELD_COLS`` smoothed
    columns.  k >= 2 blocks of 4-column threads, every block (own columns
    and halos, a halo exchange every ``WIDE_FIELD_ROWS`` rows) within
    ``WIDE_BLOCK`` columns at the least such k up to ``MAX_CLUSTER``, else
    within ``shard_kernel.MAX_BLOCK_4`` at the least such k (3840 gives k =
    4, 15360 k = 8), over the plane padded to the stride itself where the
    clamp there is observable (stride < ``creep_bound``; k then divides it)
    and else to the least multiple of k at or past ``creep_bound``: as
    ``parallel.sharding._sharded_pad_width`` pads a 1 x k mesh, clamping
    there changes no output column.  A pure function of the shapes."""
    creep = creep_bound(w, bufH, spec)

    def padded(k):
        return stride if stride < creep else round_up(creep, k)

    def cut(k):
        width = padded(k)
        if width % k:
            return None
        return k, width // k, sk.cluster_rows(k, width // k, bufH - 1, WIDE_FIELD_ROWS)[1]

    k = next((j for j in range(2, MAX_CLUSTER + 1)
              if (c := cut(j)) and block_width(*c) <= WIDE_BLOCK), None)
    if k is None:
        k = least_split(cut, padded(1), sk.MAX_BLOCK_4, k0=2)
    return k, padded(k) // k


@functools.lru_cache(maxsize=256)
def field_plan(fields: int, w: int, bufH: int, stride: int, spec: KernelSpec,
               card: cl.Card) -> FieldPlan:
    """The one plan of a pass over ``fields`` fields of width ``w`` and
    ``bufH`` kept rows at buffer ``stride`` on ``card`` (``cl.H100`` away
    from the card): up to ``FIELD_COLS`` smoothed columns (S =
    ``width_tiers(...)[2]``) K1's `launch_plan`; past it K4's
    ``shard_kernel.pass_plan`` over `wide_plan`'s split, which applies the
    one-wave shared memory and the card's answer on the cluster.  The
    overlap rule reads it and the launch runs it."""
    S = width_tiers(w, bufH, stride, spec)[2]
    if S <= FIELD_COLS:
        plan = launch_plan(w, S, cl.storage_dtype(spec).itemsize, card.smem_block)
        return FieldPlan(1, S, plan, fields)
    k, W_loc = wide_plan(w, bufH, stride, spec)
    plan = sk.pass_plan(fields, k, W_loc, bufH, spec, card, WIDE_FIELD_ROWS)
    return FieldPlan(k, W_loc, plan, fields * k)


def blocks_per_sm(fp: FieldPlan, card: cl.Card) -> int:
    """Blocks of the pass ``fp`` one SM holds by shared memory, which
    bounds every plan of K1 and K4 before threads or registers do."""
    return card.smem_sm // (fp.smem_bytes + cl.SMEM_RESERVED)


def side_plan(fp: FieldPlan, card: cl.Card) -> FieldPlan:
    """``fp`` as it runs beside a leading pass (`overlap_rule`), whose
    blocks each ask for more than half a SM's shared memory: a K1 pass asks
    for at least half a SM's less the reserve, so no SM holds a block of
    each, while two of its own still fit on one.  Its blocks then take
    only the SMs the leader leaves free: a K1 block of the turned maa's
    U+V pass (98.6 KB) fits beside a K4 block (115.7 KB) as planned, and
    K4's clusters stepped slower beside them.  K4 (``k`` > 1) as planned."""
    floor = card.smem_sm // 2 - cl.SMEM_RESERVED
    if fp.k > 1 or fp.smem_bytes >= floor:
        return fp
    return fp._replace(plan=fp.plan._replace(smem_bytes=floor))


def overlap_rule(lead: FieldPlan, other: FieldPlan, card: cl.Card) -> bool:
    """Whether ``other`` runs beside ``lead``: where no SM can take two of
    the leader's blocks, the SMs it leaves free are the card's less its
    blocks, and ``other`` goes beside it, on its `side_plan`, where those
    SMs hold at least ``OVERLAP_SHARE`` of its blocks."""
    if blocks_per_sm(lead, card) > 1:
        return False
    free = max(card.sms - lead.blocks, 0)
    return free * blocks_per_sm(side_plan(other, card), card) >= OVERLAP_SHARE * other.blocks


def overlap_uv(shapes, devices, *, dh: bool, interlaced: bool, stride: int,
               spec: KernelSpec, kernel: bool, plane_widths=None,
               card: cl.Card | None = None) -> bool:
    """Whether a call's batched U+V pass runs on a second stream beside
    its luma pass, which leads on the caller's stream (`overlap_rule` on
    their `field_plan`s, the plans their launches run).  The luma pass
    leads: no chroma plane has more rows than the luma plane, so no U+V
    walk is the longer.

    ``shapes``: the luma plane's [N, H, W] and the U plane's, None for a
    pass that does not run; ``devices``: every plane's device; ``kernel``:
    the passes run this module's kernels.  False for a single pass, off the
    kernels, for the width-sharded path (``plane_widths`` given), off the
    card, for planes on more than one device, and where a pass launches
    nothing.  ``card``: the card's figures (default: queried)."""
    if (None in shapes or not kernel or plane_widths is not None
            or devices[0].type != "cuda" or len(set(devices)) > 1):
        return False
    card = card or cl.card_figures(devices[0])
    plans = []
    for i, (n, h, w) in enumerate(shapes):
        fields = n * (2 if interlaced else 1) * (2 if i else 1)
        h_src = h // 2 if interlaced else h
        bufH = (2 * h_src if dh else h_src) // 2
        if not fields or not w or bufH < 2:
            return False
        plans.append(field_plan(fields, w, bufH, stride, spec, card))
    return overlap_rule(*plans, card)


def _wide_input(kept: torch.Tensor, fp: FieldPlan,
                interlaced_tff: bool | None = None) -> torch.Tensor:
    """K4's input on ``fp`` (k > 1): ``kept`` [N, bufH, w] fields (an
    interlaced plane with ``interlaced_tff``, split first; a strided view
    of a plane's rows is copied once) edge-padded to the plan's width,
    contiguous."""
    from sangnom_tpu_torch.parallel import fused_smooth as fs

    if interlaced_tff is not None:
        kept = split_plane(kept, interlaced_tff)
    N, bufH, w = kept.shape
    if fp.width > w:  # edge replication: taps past w read the edge pixel
        pad = fs.signed(kept)[..., -1:].expand(N, bufH, fp.width - w)
        return torch.cat([fs.signed(kept), pad], dim=2).view(kept.dtype)
    return kept.contiguous()


def _wide(kept: torch.Tensor, fp: FieldPlan, w: int, offset, aaf,
          spec: KernelSpec) -> torch.Tensor:
    """The wide route on ``fp`` (k > 1): ``kept`` its `_wide_input`, [N,
    bufH, fp.width] -> the woven plane (``offset`` 0, 1 or per field) or,
    with ``offset`` None, the interpolated rows; K4 over the plan's k
    shards, cropped to ``w``.  On a tensor off the card, K4's plain version
    (``parallel.fused_smooth``) with the same k, padding and crop."""
    from sangnom_tpu_torch.parallel import fused_smooth as fs

    N, bufH, width = kept.shape
    offs = None if offset is None else fs.check_offsets(offset, kept)
    if kept.device.type == "cuda":
        out = sk.full_pass(kept, offs, aaf, spec, fp.k, w, fp.plan)
        if fp.plan.cluster:
            count("cluster_fields", N)
    else:
        out = fs.fused_full_plain(kept, aaf, spec, fp.k, w, WIDE_FIELD_ROWS, offs)
    count("wide_row_steps", N * (bufH - 1))
    return out if width == w else out[..., :w].contiguous()


def _plan(kept: torch.Tensor, fields: int, bufH: int, w: int, stride: int,
          spec: KernelSpec) -> FieldPlan:
    card = cl.card_figures(kept.device) if kept.device.type == "cuda" else cl.H100
    fp = field_plan(fields, w, bufH, stride, spec, card)
    return side_plan(fp, card) if getattr(_SIDE, "on", False) else fp


# Whether this thread's passes run beside a leading pass (`beside`).
_SIDE = threading.local()


@contextlib.contextmanager
def beside():
    """Within: this thread's field passes run beside a leading pass on
    another stream (``ops.sangnom._beside``), each launch on its
    `side_plan`."""
    was = getattr(_SIDE, "on", False)
    _SIDE.on = True
    try:
        yield
    finally:
        _SIDE.on = was


def _launch(src: torch.Tensor, out: torch.Tensor, fp: FieldPlan, spec: KernelSpec,
            aaf, n_fields: int, bufH: int, w: int, stride: int,
            interlaced: int, weave: bool, offset: Offset) -> None:
    """Validate and launch K1 on ``fp``; ``src`` is [N, bufH, w] kept rows,
    or with ``interlaced`` (1 tff, 2 bff) an [N/2, 2*bufH, w] interlaced
    plane."""
    global LAUNCHES
    with span(LAUNCH) as sp:
        device = src.device
        if src.dtype != cl.storage_dtype(spec):
            raise ValueError(f"deint kernel: dtype {src.dtype} does not match the "
                             f"kernel spec {spec}")
        if not src.is_contiguous():
            raise ValueError("deint kernel: input must be contiguous")
        plan, S = fp.plan, fp.W_loc
        lib = cl.load()
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
        code, sse2, stream = cl.launch_codes(spec, device)
        in_frame_stride = src.shape[1] * w
        with torch.cuda.device(device), cl.LAUNCH_LOCK:
            err = lib.sno_deint_launch(
                code, sse2, plan.cols, src.data_ptr(), out.data_ptr(),
                None if offs is None else offs.data_ptr(),
                n_fields, bufH, w, S, plan.pitch_b, plan.pitch_r, plan.pitch_p,
                in_frame_stride, interlaced, int(weave), static_offset,
                int(plan.route == "double"), float(aaf), plan.threads,
                plan.smem_bytes, stream,
            )
        cl.check(err, "deint kernel launch")
        LAUNCHES += 1
        if sp:
            sp.set(kernel="deint_kernel", blocks=n_fields, threads=plan.threads,
                   smem_bytes=plan.smem_bytes,
                   bytes=(src.numel() + out.numel()) * src.element_size(),
                   elem=src.element_size(), rows=bufH, cols=w, smoothed=S,
                   cols_per_thread=plan.cols)


def deinterlace_field_batch_plain(
    kept: torch.Tensor, offset: Offset, aaf, spec: KernelSpec, stride: int,
    interlaced_tff: bool | None = None,
) -> torch.Tensor:
    """Plain version of `deinterlace_field_batch_fused`: split the fields,
    interpolate with the plain path, weave."""
    if interlaced_tff is not None:
        kept = split_plane(kept, interlaced_tff)
    interp = reference.interpolate_field_batch(kept, aaf, spec, stride)
    return weave_assemble(kept, interp, offset)


def deinterlace_field_batch_fused(
    kept: torch.Tensor, offset: Offset, aaf, spec: KernelSpec, stride: int,
    interlaced_tff: bool | None = None, on_ready=None,
) -> torch.Tensor:
    """[N, bufH, w] kept fields -> the complete deinterlaced plane
    [N, 2*bufH, w]: kept and interpolated rows interleaved per ``offset``
    (an int, or a per-frame [N] int32 tensor of 0/1), the boundary line
    duplicated.

    ``interlaced_tff`` not None: ``kept`` is an INTERLACED [N/2, 2*bufH, w]
    plane and output frame 2j+b is built from field b of input frame j
    (True: b=0 is the top field); the kernel reads the fields in place.

    ``kept`` may be a strided view of a plane's rows: the wide route copies
    it once with its edge pad (`_wide_input`), K1 once as it is.
    ``on_ready``: called once that input is issued, before the launch
    (``ops.sangnom._beside`` starts the call's second stream there).
    """
    _check_input(kept, stride)
    if interlaced_tff is None:
        n_fields, bufH, w = kept.shape
        interlaced = 0
    else:
        n_in, H, w = kept.shape
        if H % 2:
            raise ValueError(f"deint kernel: interlaced height {H} is odd")
        n_fields, bufH = 2 * n_in, H // 2
        interlaced = 1 if interlaced_tff else 2
    fp = _plan(kept, n_fields, bufH, w, stride, spec) if n_fields * bufH * w else None
    wide = fp is not None and fp.k > 1
    kept = _wide_input(kept, fp, interlaced_tff) if wide else kept.contiguous()
    if on_ready is not None:
        on_ready()
    if wide:
        return _wide(kept, fp, w, offset, aaf, spec)
    if kept.device.type == "cpu":
        return deinterlace_field_batch_plain(kept, offset, aaf, spec, stride,
                                             interlaced_tff)
    out = torch.empty((n_fields, 2 * bufH, w), dtype=kept.dtype,
                      device=kept.device)
    if fp is not None:
        _launch(kept, out, fp, spec, aaf, n_fields, bufH, w, stride, interlaced,
                True, offset)
    return out


def interpolate_field_batch(
    kept: torch.Tensor, aaf, spec: KernelSpec, stride: int
) -> torch.Tensor:
    """[N, bufH, w] kept fields (storage dtype) -> [N, bufH-1, w]
    interpolated lines in the same dtype."""
    _check_input(kept, stride)
    N, bufH, w = kept.shape
    if not (N and bufH >= 2 and w):
        fp = None
    elif (fp := _plan(kept, N, bufH, w, stride, spec)).k > 1:
        return _wide(_wide_input(kept, fp), fp, w, None, aaf, spec)
    if kept.device.type == "cpu":
        return reference.interpolate_field_batch(kept, aaf, spec, stride)
    out = torch.empty((N, max(bufH - 1, 0), w), dtype=kept.dtype,
                      device=kept.device)
    if fp is not None:
        _launch(kept, out, fp, spec, aaf, N, bufH, w, stride, 0, False, 0)
    return out


def _check_input(kept: torch.Tensor, stride: int) -> None:
    if kept.dim() != 3:
        raise ValueError(f"deint kernel: expected [N, H, W], got {tuple(kept.shape)}")
    if stride < kept.shape[2]:
        raise ValueError(f"deint kernel: stride {stride} < width {kept.shape[2]}")


# read by ops.sangnom.deinterlace_plane_batch: this backend weaves in-kernel
interpolate_field_batch.fused_weave = deinterlace_field_batch_fused
