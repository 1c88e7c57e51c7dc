"""The closed loop of `api_call_planes`, with the kernels' device time also
split by the `sangnom/launch` span that issued each, in a traced run.

Traffic parameters: those of `api_call`.  With ``trace`` off a run is
`api_call.run` itself.  With it on, a run is `api_call_planes.run`, whose
profiler this driver wraps once more to read the events of the window's
stretch as well; ``obs["launch_kernels"]`` then holds, for each kernel a
launch span names (its ``kernel`` count), the device seconds of the
stretch's kernels issued inside such spans, those kernels, the spans that
issued them and the ``steps`` those spans count (the serial row steps a
K4 launch walks), in the share of each span's kernel time inside the
stretch.  A kernel goes to the launch span holding its CUDA
launch call, matched by the profiler's correlation id as
`api_call_planes.attribute` matches it; a kernel whose launch call the
profiler dropped is left out, and its span with it.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import Counter

from benchmark import harness, spans, trace
from benchmark.drivers import api_call_planes as planes


def run(cell: harness.Cell, call=None) -> harness.Outcome:
    """One run; ``call`` replaces the entry (the tests break it there)."""
    if not cell.trace:
        return planes.run(cell, call)
    keep: dict = {}
    start = trace.profiler
    trace.profiler = lambda: _Events(start(), keep)
    try:
        out = planes.run(cell, call)
    finally:
        trace.profiler = start
    records = out.obs.get("span_records", [])
    out.obs["launch_kernels"] = lk = attribute(records, keep.get("events", []))
    if lk:
        print("launch groups: " + ", ".join(
            f"{k} {v['kernel_s']:.6f} s ({v['kernels']} kernels, {v['launches']} launches, "
            f"{v['steps']} steps)" for k, v in sorted(lk.items())), file=sys.stderr)
    if records:
        print(f"K4 launches: {dict(k4_shapes(records))}; a call's counters: "
              f"{dict(call_counters(records))}", file=sys.stderr)
    return out


class _Events:
    """A started profiler whose export also hands the events that the
    attribution reads (`api_call_planes.events_of`) to ``keep``."""

    def __init__(self, prof, keep: dict):
        self.prof, self._keep = prof, keep

    def export_chrome_trace(self, path):
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            self._keep["events"] = planes.events_of(json.load(f))

    def __getattr__(self, name):
        return getattr(self.prof, name)


def attribute(records, events) -> dict | None:
    """{kernel named by the launch span: {"kernel_s", "kernels",
    "launches", "steps"}} over the stretch: each device kernel whose launch
    call lies inside a `sangnom/launch` span, its time clipped to the
    stretch; ``launches`` the spans with such a kernel and ``steps`` the
    sum of their ``steps`` counts (0 where a span has none), each in the
    share of its kernels' time that lies inside the stretch, so a launch
    cut at either end counts the steps the time counted holds.  Records as
    `benchmark.spans` reads them, events as `api_call_planes.events_of`
    gives them; None without a stretch, records, or a mapping of their
    clock onto the trace's."""
    evs = [e[:4] for e in events]
    marks = [(s, e) for k, n, s, e in evs if k == "user_annotation" and n.startswith(trace.MARK)]
    if not marks or not records:
        return None
    off = spans.offset_ns(records, evs)
    if off is None:
        return None
    t0, t1 = min(s for s, _ in marks), max(e for _, e in marks)
    launches = sorted((r[5] + off, r[6] + off, r[0]) for r in records if r[4] == planes.LAUNCH)
    starts = [s for s, _, _ in launches]
    issued = {}  # correlation id -> the launch span holding the call
    for k, n, s, e, c in events:
        if k in planes.LAUNCH_KINDS and c is not None:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= launches[i][1]:
                issued[c] = launches[i][2]
    counts = {r[0]: r[7] for r in records if r[4] == planes.LAUNCH}
    spent: dict = {}  # launch span -> [its kernels' ns, of them inside the stretch]
    out: dict = {}
    for k, n, s, e, c in events:
        span_id = issued.get(c) if c is not None else None
        if k != "kernel" or span_id is None:
            continue
        ns = spent.setdefault(span_id, [0, 0])
        ns[0] += e - s
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        ns[1] += e - s
        g = out.setdefault(counts[span_id].get("kernel", "?"),
                           {"kernel_s": 0.0, "kernels": 0, "launches": 0, "steps": 0})
        g["kernel_s"] += (e - s) * 1e-9
        g["kernels"] += 1
    for span_id, (whole, inside) in spent.items():
        if inside:
            sc = counts[span_id]
            g = out[sc.get("kernel", "?")]
            g["launches"] += 1
            g["steps"] += sc.get("steps", 0) * inside / whole
    return out


K4_COUNTS = ("k", "cols", "steps", "rows", "route", "block_cols", "exchange_rows", "mem_route")
COUNTERS = ("cluster_fields", "wide_row_steps", "overlap_passes")


def k4_shapes(records) -> Counter:
    """How many K4 launch spans of the records had each tuple of
    `K4_COUNTS` (None where a span lacks the count)."""
    return Counter(tuple(r[7].get(c) for c in K4_COUNTS) for r in records
                   if r[4] == planes.LAUNCH and r[7].get("kernel") == "shard_full_kernel")


def call_counters(records) -> Counter:
    """How many calls of the records summed their spans' `COUNTERS` to
    each tuple."""
    calls: dict = {}
    for r in records:
        c = calls.setdefault(r[2], [0] * len(COUNTERS))
        for i, name in enumerate(COUNTERS):
            c[i] += r[7].get(name, 0)
    return Counter(tuple(c) for c in calls.values())


def step_us(obs: dict, kernel: str) -> float | None:
    """Device microseconds a serial row step of ``kernel``'s launches over
    the stretch: their kernels' time over their spans' ``steps``; None
    without the attribution, such a kernel, or steps counted."""
    g = (obs.get("launch_kernels") or {}).get(kernel)
    if not g or g["steps"] <= 0 or g["kernel_s"] <= 0:
        return None
    return 1e6 * g["kernel_s"] / g["steps"]
