"""Cost model of the field kernel on the card: peaks, op counts, measured
op-class rates and the roofline figures built from them.

Three kinds of numbers live here:

- The card's peaks (``PEAK_BYTES_S``, ``PEAK_INT32_S``) and the
  int32 operations the algorithm needs per column (``OPS_PREPARE``,
  ``OPS_SMOOTH``, ``OPS_FINALIZE``): ``bound`` turns bytes and operations
  into the least time the card could take.  ``chip_smoke.py`` takes its
  bounds from here.
- ``kernel_ops_per_frame``: the algorithmic vector-op count per frame of the
  TPU package's kernel accounting (its width tiers, the packed u8
  smoothing), kept equal to that package's count so the two report the same
  ops per frame.
- ``MEASURED_OP_RATES``: op-class rates measured on the card by
  ``tools.calibrate_vpu`` (``CALIBRATION_CARD`` names the card and its power
  limit), ``STEP_OP_CLASSES``: the operations of one row step of
  ``csrc/deint.cu`` per column in those classes, and from the two
  ``predicted_step_time_s`` and ``utilization``.
"""

from __future__ import annotations

import subprocess

from sangnom_tpu_torch.core.formats import VideoFormat
from sangnom_tpu_torch.core.geometry import buffer_stride_elems, width_tiers
from sangnom_tpu_torch.ops.primitives import KernelSpec

# ---- the card's peaks and the bound --------------------------------------

# HBM bytes/s (H100 SXM data sheet) and int32 operations/s: the SM's issue
# ceiling, 4 schedulers x 32 lanes a clock x 132 SMs x 1.98 GHz boost.  An
# SM's integer ALU pipe (IADD3, LOP3, SHF, VIMNMX) takes 64 lanes a clock and
# its FMA pipe (IMAD, and adds and moves issued as IMAD.IADD / IMAD.MOV)
# another 64: tools.sass_mix shows the calibration's add arm issuing 26 of
# its 32 adds an unrolled loop as IMAD.IADD, and that arm runs above 64
# lanes a clock.  The ceiling is half the data sheet's 67 TFLOP/s float32
# rate, which counts an FMA as two.  A three-input instruction (IADD3, LOP3)
# can still do two counted operations in one issue.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 128 * 132 * 1.98e9
# Dense tensor-core rates (H100 SXM data sheet), for the mm arms: bf16
# FLOP/s and int8 OP/s; and the FP32 cores' FMA rate, 128 FMA lanes a clock
# x 132 SMs x 1.98 GHz, an FMA counted as two FLOPs (mmf32).
PEAK_BF16_S = 989e12
PEAK_INT8_S = 1979e12
PEAK_FP32_S = 132 * 128 * 2 * 1.98e9
# The counterpart of the TPU package's VPU_PEAK_OPS, for ``utilization``.
INT32_PEAK_OPS = {"h100": PEAK_INT32_S}
# int32 operations the algorithm needs, per column (reference
# src/SangNom2.cpp:74-273): prepare of one kept pair (4 predictors x 6 + 9
# absolute differences x 2), smoothing of one row of 9 maps (9 x (2
# vertical + 6 box adds + 2 writeback)), finalize of one pixel (8 min + 16
# compare/select + 3 threshold + 4 average).
OPS_PREPARE, OPS_SMOOTH, OPS_FINALIZE = 42, 90, 31


def bound(nbytes: float, ops: float, peak: float = PEAK_INT32_S) -> tuple[float, str]:
    """(least ms the card could take, what binds it) for ``ops`` operations
    at ``peak`` a second (int32 by default) and ``nbytes`` of traffic."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---- the TPU package's op accounting -------------------------------------

# Per-column vector ops per row step of the TPU kernel: 105 on the active
# width (widen, pair update, error maps, finalize, cast) and 99 on the
# smoothing width (vertical 3-sum, 3-roll box, writeback); float runs the
# clamped box (243 on the smoothing width); u8 C numerics pack two maps a
# lane (55 on the smoothing width, +16 pack/unpack on the active width).
OPS_PER_COL_ACT = 105
OPS_PER_COL_SM = 99
OPS_PER_COL_SM_FLOAT = 243
OPS_PER_COL_SM_PACKED = 55
OPS_PER_COL_ACT_PACK_EXTRA = 16


def _packed_smoothing(spec: KernelSpec) -> bool:
    """u8 C numerics: the TPU kernel packs two maps per int32 lane."""
    return not spec.is_float and not spec.sse2 and spec.mask == 0xFF


def kernel_ops_per_frame(fmt: VideoFormat, width: int, height: int,
                         dh: bool, luma: bool = True,
                         chroma: bool = True) -> int:
    """Total kernel vector ops for one frame of the given config."""
    stride = buffer_stride_elems(width, fmt.component_size)
    spec = KernelSpec.from_format(fmt)
    if _packed_smoothing(spec):
        per_act = OPS_PER_COL_ACT + OPS_PER_COL_ACT_PACK_EXTRA
        per_sm = OPS_PER_COL_SM_PACKED
    else:
        per_act = OPS_PER_COL_ACT
        per_sm = OPS_PER_COL_SM_FLOAT if spec.is_float else OPS_PER_COL_SM
    process = [luma, chroma, chroma]
    total = 0
    for i in range(min(fmt.num_planes, 3)):
        if not dh and not process[i]:
            continue
        pw, ph = fmt.plane_dims(width, height, i)
        bufH = (2 * ph if dh else ph) // 2
        if bufH < 2:
            continue
        W_act, W_sm, _ = width_tiers(pw, bufH, stride, spec)
        total += (bufH - 1) * (per_act * W_act + per_sm * W_sm)
    return total


# ---- measured rates and the step prediction ------------------------------

# Element-ops/s per op class, in calibrate_vpu.OPS_PER_ITER units, measured
# by chip_smoke.py phase 13 (tools.calibrate_vpu.calibrate): the differential
# rate (K=32 -> 96, 4 -> 12 for the step arms) of each arm on a [120, 2048]
# int32 slab over 512 steps, best of 3, with the probe kernels' layout
# (tools.probe_kernel: 4 contiguous columns a thread for the line arms, as
# csrc/deint.cu, 8 for the step arms; a roll by a few columns through warp
# shuffles, one barrier a roll on a 2048-column line).
# `where` is one min instruction for its 2 cost-model ops, so it reads twice
# `min`; the tensor-core arms count elements shifted, not multiply-adds.
CALIBRATION_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
MEASURED_OP_RATES = {
    "add": 23198585677560.164,
    "mul": 16190057498401.145,
    "min": 15160135176549.574,
    "roll": 3759347556677.5054,
    "shift_and": 21118175200743.38,
    "where": 30272855524643.64,
    "mix": 23006198431842.242,
    "rolladd": 6516689205446.707,
    "mmbf16": 132750313516.98303,
    "mmint8": 274511917861.3227,
    "stepv": 3080810947847.1733,
    "stepm": 405954534946.55505,
}

# Operations of one row step of csrc/deint.cu per column, in the
# calibration's classes (1080 luma: the active and smoothed widths are both
# the 1920 columns; a thread owns 4 contiguous columns).  Each value that
# enters a thread's registers from a neighbouring thread's columns through
# shared memory counts as roll: a 12-value window for 4 columns brings 8,
# so 2 a column.  Loads and stores of the thread's own columns are not
# counted.
#   row b+1: its window from the kept-row ring (2 roll, 3 shift_and to
#     unpack 12 u8 values for 4 columns), its 2 mirror predictors (2 add, 1
#     mul, x4 shift + >>3 + mask = 3 shift_and each); pair (b-1, b) and its
#     predictors are carried, not recomputed
#   raw[b+1]: 9 absolute differences (1 add + 1 abs counted as min); the
#     vertical sum, 9 maps x 2 adds (acc + raw[b+1] before the barrier,
#     sm[b] + raw[b+1] after it); raw[b+1] through the u8 raw slice, 9
#     packs and 9 unpacks (shift_and)
#   box: 9 maps x (2 roll for the window, 6 adds, writeback >>4 and mask)
#   finalize: taps and predictors from the carry; the 8-min tree, 8
#     equality selects of two operands (3 ops each) and the vertical /
#     threshold select (5), the average (2 add, shift, mask)
#   no index clamps: the rows carry replicated edge pads
STEP_OP_CLASSES = {
    "roll": 2 + 9 * 2,                            # 20
    "add": 2 * 2 + 9 + 18 + 9 * 6 + 2,            # 87
    "mul": 2,                                     # 2
    "min": 9 + 8,                                 # 17
    "shift_and": 3 + 2 * 3 + 18 + 9 * 2 + 2,      # 47
    "where": 8 * 3 + 5,                           # 29
}


def predicted_step_time_s(g: int, W: int) -> float:
    """Measured-rate prediction of one row step of the field kernel over g
    fields of W columns: each class's operations over its measured rate."""
    elems = g * W
    return sum(n * elems / MEASURED_OP_RATES[k] for k, n in STEP_OP_CLASSES.items())


def utilization(fps: float, fmt: VideoFormat, width: int, height: int,
                dh: bool, chip: str = "h100") -> dict:
    """Achieved op/s at ``fps`` against the card's int32 peak and against
    the measured rate of the kernel-shaped blend (``mix``).

    The ops per frame are ``kernel_ops_per_frame``'s: the TPU kernel's
    accounting (its width tiers, two u8 maps packed a lane), not a count of
    what ``csrc/deint.cu`` issues (``STEP_OP_CLASSES`` is that), so the
    shares compare the card's rate with the TPU package's op budget."""
    ops = kernel_ops_per_frame(fmt, width, height, dh)
    peak = INT32_PEAK_OPS[chip]
    achievable = MEASURED_OP_RATES["mix"]
    achieved = ops * fps
    return {
        "ops_per_frame": ops,
        "achieved_ops_per_s": achieved,
        "int32_peak_ops_per_s": peak,
        "utilization": achieved / peak,
        "measured_achievable_ops_per_s": achievable,
        "vs_measured_achievable": achieved / achievable,
    }
