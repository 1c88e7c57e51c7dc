"""Work of the main path (no shared pool): each field interpolated on its
own zero-defined buffers."""

from __future__ import annotations

from benchmark.peaks import OPS_FINALIZE, OPS_PREPARE, OPS_SMOOTH
from benchmark.work import field_passes, stride_of


def smoothed_columns(w: int, bufH: int, stride: int, bits: int) -> int:
    """Columns whose smoothing can reach an output: w + 3 a row of creep
    (+3 box taps), and for integer samples at most w + 3 x decay rows + 6,
    since a zero padding column decays to exactly 0 within that many rows;
    never past the stride."""
    m, hops = (1 << bits) - 1, 0
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
    """(bytes, ops) of one call."""
    bits = config["bits"]
    stride = stride_of(config["width"])
    nbytes = ops = 0
    for n, bufH, w in field_passes(config, traffic):
        b, o = deint_work(n, bufH, w, smoothed_columns(w, bufH, stride, bits))
        nbytes, ops = nbytes + b, ops + o
    return nbytes, ops
