"""The card's peaks that the roofline shares are taken against.

PEAK_BYTES_S: HBM bandwidth of one NVIDIA H100 SXM (80 GB HBM3), from the
data sheet, at the full 700 W power limit.

PEAK_INT32_S: int32 operations a second.  The data sheet gives no integer
rate, so this is derived: 4 schedulers x 32 lanes issued a clock x 132 SMs x
1.98 GHz boost clock, 33.45 T/s, half the data sheet's 67 TFLOP/s float32
rate (which counts an FMA as two).  An SM's integer ALU pipe and its FMA
pipe each take 64 lanes a clock, and the issue width caps their sum.
"""

PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 128 * 132 * 1.98e9

# int32 operations the algorithm needs per column (reference
# src/SangNom2.cpp:74-273): prepare of one kept pair (4 predictors x 6 + 9
# absolute differences x 2), smoothing of one row of 9 maps (9 x (2
# vertical + 6 box adds + 2 writeback)), finalize of one pixel (8 min + 16
# compare/select + 3 threshold + 4 average).
OPS_PREPARE, OPS_SMOOTH, OPS_FINALIZE = 42, 90, 31


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take for ``nbytes`` of traffic and
    ``ops`` int32 operations: the larger of the two bounds."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_INT32_S)
