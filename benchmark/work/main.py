"""Work of the main path (no shared pool): each field interpolated on its
own zero-defined buffers."""

from __future__ import annotations

from benchmark.peaks import OPS_FINALIZE, OPS_PREPARE, OPS_SMOOTH
from benchmark.work import field_passes, sample_bytes, stride_of


def smoothed_columns(w: int, bufH: int, stride: int, mask: int) -> int:
    """Columns whose smoothing can reach an output: w + 3 a row of creep
    (+3 box taps), and for integer samples at most w + 3 x decay rows + 6,
    since a zero padding column decays to exactly 0 within that many rows
    (from the pixel type's largest value, ``mask``); never past the stride."""
    m, hops = mask, 0
    while m:
        m, hops = (7 * m) >> 4, hops + 1
    return min(stride, w + 3 * bufH + 3, w + 3 * hops + 6)


def deint_work(n_fields: int, bufH: int, w: int, S: int, elem: int = 1):
    """(bytes, ops) of the fields of one plane: kept rows in, woven plane
    out; every pair prepared, every row of S columns smoothed, every missing
    pixel finalized."""
    nbytes = n_fields * bufH * w * elem * 3  # read bufH rows, write 2*bufH
    ops = n_fields * (bufH - 1) * (w * (OPS_PREPARE + OPS_FINALIZE) + S * OPS_SMOOTH)
    return nbytes, ops


def call_work(config: dict, traffic: dict) -> tuple[int, int]:
    """(bytes, ops) of one call, samples at their stored size."""
    elem = sample_bytes(config)
    mask = (1 << 8 * elem) - 1  # the pixel type's, which the C path wraps to
    stride = stride_of(config["width"])
    nbytes = ops = 0
    for n, bufH, w in field_passes(config, traffic):
        b, o = deint_work(n, bufH, w, smoothed_columns(w, bufH, stride, mask), elem)
        nbytes, ops = nbytes + b, ops + o
    return nbytes, ops
