"""Device traces: a profiler over a steady stretch of the window, and its
reduction to the numbers the per-layer metrics and the breakdown read.

The stretch runs from the first to the last event of the benchmark's own
markers (``bench.*`` ranges, recorded on the host around what it times).
Busy time is the union of the card's kernel, memcpy and memset intervals
inside the stretch; an idle gap is named by the innermost host event
running at its midpoint.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")
MARK = "bench."
TOP = 10
# host events searched back from a gap's midpoint for the innermost one
_LOOKBACK = 512


def profiler():
    """A started torch.profiler over the card and the calling thread's host
    ops."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def mark(name: str):
    """A host range the stretch is measured between."""
    import torch

    return torch.profiler.record_function(MARK + name)


def events(prof) -> list[tuple[str, str, int, int]]:
    """(kind, name, start ns, end ns) of every complete event of a stopped
    profiler, read back from its Chrome trace (a temporary file), whose
    ``cat`` is the kind."""
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    out = []
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X":
            s = float(e["ts"]) * 1e3
            out.append((e.get("cat", ""), e.get("name", ""), int(s),
                        int(s + float(e.get("dur", 0)) * 1e3)))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(evs) -> dict | None:
    """The stretch's numbers, or None where the trace holds no marker or no
    device activity: ``stretch_s``, ``busy_s``, ``kernels`` (launches) and
    ``kernel_s`` (their summed durations), and the breakdown's
    ``device_ops`` and ``idle_gaps`` ([name, seconds], largest first)."""
    marks = [(s, e) for k, n, s, e in evs if k == "user_annotation" and n.startswith(MARK)]
    if not marks:
        return None
    t0, t1 = min(s for s, _ in marks), max(e for _, e in marks)
    dev, by_op = [], defaultdict(int)
    kernels = kernel_ns = 0
    for k, n, s, e in evs:
        if k not in DEVICE_KINDS:
            continue
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        dev.append((s, e))
        by_op[n] += e - s
        if k == "kernel":
            kernels += 1
            kernel_ns += e - s
    if not dev:
        return None
    busy = _union(dev)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if t1 > prev:
        gaps.append((prev, t1))
    return {
        "stretch_s": (t1 - t0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": kernels,
        "kernel_s": kernel_ns * 1e-9,
        "device_ops": _top({n: v * 1e-9 for n, v in by_op.items()}),
        "idle_gaps": _top(_name_gaps(gaps, evs)),
    }


def _name_gaps(gaps, evs) -> dict:
    """Seconds of idle gaps by the innermost host event at each midpoint."""
    host = sorted((s, e, n) for k, n, s, e in evs if k in HOST_KINDS)
    starts = [h[0] for h in host]
    named = defaultdict(int)
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for hs, he, hn in host[max(0, i - _LOOKBACK):i][::-1]:
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, hn)
        named[best[1] if best else "(no host event)"] += e - s
    return {n: v * 1e-9 for n, v in named.items()}


def _top(d: dict) -> list:
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_pct(trace: dict | None) -> float | None:
    """The device's idle share of the stretch, in percent."""
    if not trace or trace["stretch_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["stretch_s"])
