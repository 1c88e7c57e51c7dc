"""Work of the shared-pool mode (``pool_compat=True``): every plane pass
prepares its kept pairs into the one pool [9, P+1, S], smooths all of rows
1..P-1 over the full stride, and finalizes its own rows."""

from __future__ import annotations

from benchmark.peaks import OPS_FINALIZE, OPS_PREPARE, OPS_SMOOTH
from benchmark.work import field_passes, planes_of, sample_bytes, stride_of


def pool_fused_work(P: int, S: int, bufH_p: int, w: int, elem: int = 1):
    """(bytes, ops) of one plane pass.  Bytes: body rows 1..P-1 written;
    the old body read only where no kept pair prepares it (rows beyond R =
    bufH_p-1, columns from w); rows 0 and P read; the kept plane read and
    the interpolated rows written.  Ops: the smoothing plus the prepare and
    finalize of the R kept pairs."""
    R = bufH_p - 1
    body = (P - 1) * S
    nbytes = 9 * 4 * (body + (body - R * w) + 2 * S) + (2 * bufH_p - 1) * w * elem
    ops = body * OPS_SMOOTH + R * w * (OPS_PREPARE + OPS_FINALIZE)
    return nbytes, ops


def call_work(config: dict, traffic: dict) -> tuple[int, int]:
    """(bytes, ops) of one call: a pass a plane a frame, samples at their
    stored size."""
    w0, h0 = planes_of(config)[0]
    P, S = h0 // 2, stride_of(w0)
    elem = sample_bytes(config)
    nbytes = ops = 0
    for n, bufH_p, w in field_passes(config, traffic):
        b, o = pool_fused_work(P, S, bufH_p, w, elem)
        nbytes, ops = nbytes + n * b, ops + n * o
    return nbytes, ops
