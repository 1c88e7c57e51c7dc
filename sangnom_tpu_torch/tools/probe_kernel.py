"""ctypes bindings of the probe kernels in ``csrc/probes.cu``.

``dynrow`` launches K10 (``dynrow_kernel``), ``calibrate`` K8
(``line_kernel`` and ``step_kernel``, counted as "calibrate", and for the
mm arms ``mm_kernel`` or ``mmf32_kernel``, counted as "mm") and ``isolate``
K9 (``isolate_kernel``).  The kernels are built with the rest of the library
(``ops.cuda_library``).  Each function checks its tensors, launches
or raises, and adds one to its ``LAUNCHES`` count.

``line_plan``, ``isolate_plan`` and ``dynrow_plan`` give the grid a K8, K9
or K10 launch runs on (the launcher passes their numbers to the kernel
library, which refuses a grid its kernel's layout does not need): C columns
a thread, threads and blocks, the route of the rolls, the exchanges and
block barriers a chain iteration, the shared bytes and K10's output rows a
thread.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sangnom_tpu_torch.ops import cuda_library as cl

# Kernel launches since import (or since the caller last reset them).
LAUNCHES = {"dynrow": 0, "calibrate": 0, "mm": 0, "isolate": 0}

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
_W = 2048

cl.declare({
    "sno_probe_dynrow_launch": "ipp iiiiiiii p",
    "sno_probe_calibrate_launch": "iippp iiiiii p",
    "sno_probe_isolate_launch": "iiiii pp iiiii p",
})

# The C, contiguous columns a thread, each kernel is built for: the winner of
# a sweep of C over 4 and 8 on the card (PERF.md section 6).  line_kernel 4:
# twice the warps on a line hide the exchange's barrier for mix, the cost
# model's blend; step_kernel and isolate_kernel 8: half the shuffles a column
# for their five slabs.
LINE_COLS = 4     # csrc/probes.cu kLineC
ISOLATE_COLS = 8  # kIsoC

# K8 line arms by how they exchange: no exchange, the padded scratch's
# static-offset loads, two chains; the roll's shift where it is not 1.
_NO_EXCHANGE = ("add", "tadd", "where", "shift_and", "min", "mul")
_VSHIFT = ("vshift1", "vshift6")
_TWO_CHAINS = ("rolladd2", "rollvshift")
_SHIFT = {"roll3": 3, "troll3": 3, "trolladd8": 8, "concat_rot": -1}
_MM = ("mmbf16", "mmf32", "mmint8", "mmroll")
_STEP = ("stepv", "stepm", "stepmbf", "steph")
# csrc/probes.cu's layout constants (kStepEW, kIsoEW, kPad); its launchers
# refuse a plan that disagrees with them.
_STEP_EDGE_WORDS = 16  # step_kernel: edge words a warp an exchange
_ISO_EDGE_WORDS = 24   # isolate_kernel: the same
_PAD = 16              # padded scratch columns past the line
_MM_THREADS = 128      # mm_kernel: 4 warps a 16-row tile (kMmThreads)
_F32_THREADS = 128     # mmf32_kernel: 4 x 4 patches of a tile (kF32Threads)
_ROLL_COLS = 16        # mmroll's line: columns a thread (kRollC)
_DYN_ROWS = 2          # dynrow_kernel: output rows a thread (kDynR)
_DYN_THREADS = 128     # kDynThreads


class Plan(NamedTuple):
    """One K8 or K9 launch (``csrc/probes.cu``), as the launcher runs it.

    ``cols``: C, the contiguous columns a thread owns (mm arms: a
    tensor-core accumulator pair, 2; mmroll's line, 16; mmf32's 4 x 4
    patch, 4; K10: 16 bytes of a row).  ``route``: how a chain iteration
    moves values between
    threads: "none" (no exchange), "shuffle" (registers and warp shuffles;
    a line of several warps also trades each warp's edge values through
    shared memory behind one barrier), "line" (the whole line through a
    shared buffer, for shifts of C columns or more), "pad" (a shared store
    and a static-offset load, what vshift1/vshift6 measure), "shuffle+pad"
    (rollvshift: x through shuffles, u through the padded scratch) or
    "matrix" (the mm arms' product of a 16-row tile, the new z through
    shared memory), "matrix+shuffle" (mmroll: the product, and its line
    through shuffles and warp edges) or "vector" (K10: 16-byte loads and
    stores, no exchange).  ``exchanges``: rolls of a line (or a tap round,
    or the tile's operand) a chain iteration; ``barriers``: block barriers
    a chain iteration; ``smem_bytes``: dynamic shared memory.  ``shift``:
    K9 ramtN's shift on the shuffle route (-3..3), the launcher's template
    choice; 0 elsewhere.  ``rows``: K10's output rows a thread; 1
    elsewhere."""

    cols: int
    threads: int
    blocks: int
    route: str
    exchanges: int
    barriers: int
    smem_bytes: int
    shift: int = 0
    rows: int = 1


def step_cols(w: int) -> int:
    """step_kernel's C on a line of w: 8, or 4 where w / 8 threads would be
    several warps but not whole ones (w = 384, 640, ...)."""
    return 4 if w // 8 > 32 and (w // 8) % 32 else 8


def line_plan(kind: str, w: int) -> Plan:
    """K8's launch for arm ``kind`` on [G, w].  A line (a row of the slab,
    n = w; roll_sub's a column, n = G) of n / C threads up to 32 shares a
    one-warp block (two lines of 16 lanes or fewer a warp); a longer line,
    a whole number of warps, takes a block.  C is ``LINE_COLS``, or
    ``step_cols(w)`` for the step arms."""
    if kind not in CALIBRATE_CODES:
        raise ValueError(f"calibration kernel: unknown arm {kind!r}")
    if kind in _MM:
        # a block a 16-row tile of z [G*w/128, 128] (mmroll: at least one a
        # line); shared memory holds the operand tile twice (bf16 or s8) and
        # mmroll's warp edges, mmf32's m [128, 128] and z^T [128, 16] twice
        tiles = (_G * w // 128 + 15) // 16
        if kind == "mmf32":
            return Plan(4, _F32_THREADS, tiles, "matrix", 1, 1, (128 * 128 + 2 * 128 * 16) * 4)
        tile_bytes = 2 * 16 * 128 * (1 if kind == "mmint8" else 2)
        if kind == "mmroll":
            return Plan(_ROLL_COLS, _MM_THREADS, max(tiles, _G), "matrix+shuffle", 2, 1,
                        tile_bytes + 2 * (_MM_THREADS // 32) * 4)
        return Plan(2, _MM_THREADS, tiles, "matrix", 1, 1, tile_bytes)
    n = _G if kind == "roll_sub" else w
    cols = step_cols(w) if kind in _STEP else LINE_COLS
    lanes = n // cols
    multi = lanes > 32
    nw = lanes // 32 if multi else 1
    if kind in _STEP:
        mm = kind in ("stepm", "stepmbf")
        smem = (16 * 128 * 2 + 4 * w if mm else 0) + (
            2 * _STEP_EDGE_WORDS * nw * 4 if multi else 0)
        return Plan(cols, max(lanes, 32), _G, "shuffle", 3 if kind == "steph" else 4,
                    3 if multi or mm else 0, smem)
    per_block = 1 if multi else (2 if lanes <= 16 else 1)
    lines = w if kind == "roll_sub" else _G
    grid = (cols, lanes if multi else 32, lines // per_block)
    buf = per_block * 2 * (n + _PAD) * 4  # a padded line's two buffers
    if kind in _NO_EXCHANGE:
        return Plan(*grid, "none", 0, 0, 0)
    if kind in _VSHIFT:
        return Plan(*grid, "pad", 1, 1, buf)
    shift = _SHIFT.get(kind, 1)
    if abs(shift) >= cols:
        return Plan(*grid, "line", 1, 1, per_block * 2 * n * 4)
    chains = 2 if kind == "rolladd2" else 1
    edges = 2 * chains * nw * abs(shift) * 4 if multi else 0
    if kind == "rollvshift":
        return Plan(*grid, "shuffle+pad", 2, 1, buf + edges)
    return Plan(*grid, "shuffle", 2 if kind in _TWO_CHAINS else 1, int(multi), edges)


def _ramt_shift(amount: int) -> int:
    """ramtN's shift as the nearest signed one: N mod W in (-W/2, W/2]."""
    return amount if amount <= _W // 2 else amount - _W


def isolate_plan(kind: str) -> Plan:
    """K9's launch for arm ``kind`` (``_iota`` and ``ramtN`` included): one
    block a row of the input, W / C threads (C = ``ISOLATE_COLS``), so a
    line spans several warps.  ramtN goes through shuffles where its shift
    (N mod W, signed) is 1-3 columns, else through the whole line in shared
    memory; unroll and fori trade b's window in their first slab exchange."""
    cols = ISOLATE_COLS
    base = kind.removesuffix("_iota")
    amount = None
    if base.startswith("ramt") and base[4:].isdigit():
        base, amount = "ramt", int(base[4:]) % _W
    if base not in ISOLATE_CODES or (base == "ramt") != (amount is not None):
        raise ValueError(f"step-isolation kernel: unknown arm {kind!r}")
    lanes = _W // cols
    edges = 2 * _ISO_EDGE_WORDS * (lanes // 32) * 4
    grid = (cols, lanes, _G)
    if base == "ramt":
        shift = _ramt_shift(amount)
        if 0 < abs(shift) <= 3:
            return Plan(*grid, "shuffle", 1, 1, edges, shift=shift)
        return Plan(*grid, "line", 1, 1, edges + 2 * 5 * _W * 4)
    rolls = {"roll2chz": 2, "roll2ch": 2, "bigshift": 1, "smallshift": 1,
             "slab3d1": 1}.get(base, 3)
    taps = int(base in ("unroll", "fori"))  # b's round, on the first slab barrier
    return Plan(*grid, "shuffle", rolls + taps, rolls, edges)


def dynrow_plan(H: int, S: int, steps: int, u8: bool) -> Plan:
    """K10's launch on a [H, S] plane (u8, else i32) over ``steps`` output
    rows: thread i owns the C = 16 / itemsize contiguous columns of group
    i % groups (groups = ceil(S / C)) in the ``rows`` output rows from
    (i // groups) * rows, ``threads`` a block, enough blocks for every
    (row group, column group) pair."""
    if H < 1 or S < 1 or steps < 1:
        raise ValueError(f"dynamic-row probe: empty plane or no steps ({H}, {S}, {steps})")
    cols = 16 if u8 else 4
    n = -(-S // cols) * -(-steps // _DYN_ROWS)
    return Plan(cols, _DYN_THREADS, -(-n // _DYN_THREADS), "vector", 0, 0, 0, rows=_DYN_ROWS)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    u8 = kept.dtype == torch.uint8
    plan = dynrow_plan(H, S, steps, u8)
    lib = cl.load()
    with torch.cuda.device(kept.device), cl.LAUNCH_LOCK:
        err = lib.sno_probe_dynrow_launch(int(u8), kept.data_ptr(), out.data_ptr(), H, S,
                                          steps, plan.cols, plan.rows, plan.blocks,
                                          plan.threads, plan.smem_bytes, _stream(kept))
    cl.check(err, f"{name} launch")
    LAUNCHES["dynrow"] += 1
    return out


def calibrate(src: torch.Tensor, kind: str, k: int, steps: int,
              m: torch.Tensor | None = None) -> torch.Tensor:
    """K8: one arm on [G, w] int32 -> [steps, G, 128] int32 (the transposed
    arms write columns 120..127 as zeros), on ``line_plan(kind, w)``.
    ``m``: the permutation matrix of the mm and step-m arms, in the layout
    ``csrc/probes.cu`` documents (``calibrate_vpu.kernel_matrix``)."""
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
    plan = line_plan(kind, w)
    alloc = torch.zeros if kind == "mmroll" else torch.empty  # mmroll adds into out
    out = alloc((steps, G, 128), dtype=torch.int32, device=src.device)
    lib = cl.load()
    with torch.cuda.device(src.device), cl.LAUNCH_LOCK:
        err = lib.sno_probe_calibrate_launch(
            CALIBRATE_CODES[kind], plan.cols, src.data_ptr(),
            None if m is None else m.data_ptr(), out.data_ptr(), w, k, steps, plan.blocks,
            plan.threads, plan.smem_bytes, _stream(src))
    cl.check(err, f"{name} launch")
    LAUNCHES["mm" if kind in _MM else "calibrate"] += 1
    return out


def isolate(src: torch.Tensor, kind: str, k: int, steps: int) -> torch.Tensor:
    """K9: one arm on [G, 2048] int32 -> [steps, G, 128] int32, on
    ``isolate_plan(kind)``."""
    name = "step-isolation kernel"
    _check(name, src)
    if tuple(src.shape) != (_G, 2048) or src.dtype != torch.int32:
        raise ValueError(f"{name}: input {tuple(src.shape)} {src.dtype}, expected "
                         f"[{_G}, 2048] int32")
    if k < 1:
        raise ValueError(f"{name}: arm {kind!r} with k={k}")
    plan = isolate_plan(kind)
    base = kind.removesuffix("_iota")
    amount = 0
    if base.startswith("ramt"):
        base, amount = "ramt", int(base[4:]) % _W
    out = torch.empty((steps, _G, 128), dtype=torch.int32, device=src.device)
    lib = cl.load()
    with torch.cuda.device(src.device), cl.LAUNCH_LOCK:
        err = lib.sno_probe_isolate_launch(
            ISOLATE_CODES[base], plan.cols, int(kind.endswith("_iota")), amount, plan.shift,
            src.data_ptr(), out.data_ptr(), k, steps, plan.blocks, plan.threads,
            plan.smem_bytes, _stream(src))
    cl.check(err, f"{name} launch")
    LAUNCHES["isolate"] += 1
    return out
