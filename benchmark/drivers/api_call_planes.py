"""The closed loop of `api_call`, with the kernels' device time split by
plane group in a traced run.

Traffic parameters: those of `api_call`.  With ``trace`` off a run is
`api_call.run` itself.  With it on, the program's spans are on exactly
while each profiler `api_call` starts runs (as `benchmark.spans`' tool
turns them on), and the records of the last one, the window's stretch, go
to the readers under ``obs["span_records"]``.

Each device kernel of the stretch is attributed by the profiler's
correlation id: the kernel, the CUDA launch call that issued it, the
`sangnom/launch` span holding that call, and that span's enclosing
`sangnom/plane` span, whose ``plane`` count names the group (0 the luma
plane, "uv" U and V in one launch).  Matched by id and not by order, a
kernel whose launch call the profiler dropped is left out alone.
``obs["plane_kernels"]``: each group's kernel seconds and kernels inside
the stretch, and the field kernel's seconds in all and attributed.
``obs["plane_work"]``: each group's (bytes, ops) a call, counted from its
planes' shapes by `benchmark.work.main`, whatever implements the filter.
The spans read are the plane and launch spans with their ``plane`` count,
nothing newer.
"""

from __future__ import annotations

import bisect
import json
import sys

from benchmark import harness, spans, trace
from benchmark.drivers import api_call
from benchmark.peaks import least_seconds
from benchmark.work import field_passes, sample_bytes, stride_of
from benchmark.work.main import deint_work, smoothed_columns

PLANE, LAUNCH = "sangnom/plane", "sangnom/launch"
FIELD_KERNEL = "deint_kernel"
# the kinds of the host's launch calls in a trace, each with its correlation id
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


def run(cell: harness.Cell, call=None) -> harness.Outcome:
    """One run; ``call`` replaces the entry (the tests break it there)."""
    if not cell.trace:
        return api_call.run(cell, call)
    keep: dict = {}
    start = trace.profiler
    trace.profiler = lambda: _Traced(start(), keep)
    try:
        out = api_call.run(cell, call)
    finally:
        trace.profiler = start
    records = keep.get("records", [])
    out.obs["span_records"] = records
    out.obs["plane_kernels"] = pk = attribute(records, keep.get("events", []))
    out.obs["plane_work"] = group_work(cell.config, cell.traffic)
    if pk and pk["groups"]:
        groups = ", ".join(f"{g} {v['kernel_s']:.6f} s ({v['kernels']} kernels)"
                           for g, v in sorted(pk["groups"].items()))
        share = pk["field_attributed_s"] / pk["field_kernel_s"] if pk["field_kernel_s"] else 0.0
        print(f"plane groups: {groups}; {FIELD_KERNEL} attributed {100 * share:.2f}% of "
              f"{pk['field_kernel_s']:.6f} s", file=sys.stderr)
    return out


class _Traced:
    """A started profiler with the program's spans on until it stops; at
    its stop the span records, at its export the events
    (`events_of`), go to ``keep``."""

    def __init__(self, prof, keep: dict):
        from sangnom_tpu_torch.utils import profiling

        self.prof, self._keep, self._profiling = prof, keep, profiling
        profiling.enable()

    def stop(self):
        self.prof.stop()
        self._profiling.disable()
        self._keep["records"] = self._profiling.drain()

    def export_chrome_trace(self, path):
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            self._keep["events"] = events_of(json.load(f))

    def __getattr__(self, name):
        return getattr(self.prof, name)


def events_of(data: dict) -> list[tuple]:
    """(kind, name, start ns, end ns, correlation id or None) of the
    complete events of a Chrome trace that the attribution reads: the
    card's, the host's launch calls, and the host ranges of the
    benchmark's marks and the program's spans."""
    out = []
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        kind, name = e.get("cat", ""), e.get("name", "")
        if (kind in trace.DEVICE_KINDS or (kind in LAUNCH_KINDS and "Launch" in name)
                or name.startswith((trace.MARK, "sangnom/"))):
            s = float(e["ts"]) * 1e3
            out.append((kind, name, int(s), int(s + float(e.get("dur", 0)) * 1e3),
                        (e.get("args") or {}).get("correlation")))
    return out


def _group(span_id, by_id) -> str | None:
    """The ``plane`` count of the innermost `PLANE` span enclosing the
    record ``span_id``, as a string."""
    r = by_id.get(span_id)
    while r is not None:
        if r[4] == PLANE and "plane" in r[7]:
            return str(r[7]["plane"])
        r = by_id.get(r[1])
    return None


def attribute(records, events) -> dict | None:
    """The stretch's kernels by plane group: ``groups`` ({group:
    {"kernel_s", "kernels"}}, each kernel's time clipped to the stretch),
    ``field_kernel_s`` (every `FIELD_KERNEL` kernel's) and
    ``field_attributed_s`` (those in a group).  Records as
    `benchmark.spans` reads them, events as `events_of` gives them; None
    without a stretch, records, or a mapping of their clock onto the
    trace's."""
    evs = [e[:4] for e in events]
    marks = [(s, e) for k, n, s, e in evs if k == "user_annotation" and n.startswith(trace.MARK)]
    if not marks or not records:
        return None
    off = spans.offset_ns(records, evs)
    if off is None:
        return None
    t0, t1 = min(s for s, _ in marks), max(e for _, e in marks)
    by_id = {r[0]: r for r in records}
    launches = sorted((r[5] + off, r[6] + off, r[0]) for r in records if r[4] == LAUNCH)
    starts = [s for s, _, _ in launches]
    issued = {}  # correlation id -> the launch span holding the call
    for k, n, s, e, c in events:
        if k in LAUNCH_KINDS and c is not None:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= launches[i][1]:
                issued[c] = launches[i][2]
    groups: dict = {}
    field_ns = attributed_ns = 0
    for k, n, s, e, c in events:
        s, e = max(s, t0), min(e, t1)
        if k != "kernel" or e <= s:
            continue
        group = _group(issued.get(c), by_id) if c is not None else None
        if FIELD_KERNEL in n:
            field_ns += e - s
            attributed_ns += (e - s) if group is not None else 0
        if group is not None:
            g = groups.setdefault(group, [0, 0])
            g[0] += e - s
            g[1] += 1
    return {"groups": {g: {"kernel_s": ns * 1e-9, "kernels": n} for g, (ns, n) in groups.items()},
            "field_kernel_s": field_ns * 1e-9, "field_attributed_s": attributed_ns * 1e-9}


def group_work(config: dict, traffic: dict) -> dict:
    """(bytes, ops) a call of each plane group: each plane by its index as
    a string, and "uv" for planes 1 and 2 together, samples at their
    stored size (as `benchmark.work.main.call_work` counts the call)."""
    elem = sample_bytes(config)
    mask = (1 << 8 * elem) - 1
    stride = stride_of(config["width"])
    per_plane = [deint_work(n, bufH, w, smoothed_columns(w, bufH, stride, mask), elem)
                 for n, bufH, w in field_passes(config, traffic)]
    out = {str(i): work for i, work in enumerate(per_plane)}
    if len(per_plane) >= 3:
        out["uv"] = tuple(a + b for a, b in zip(per_plane[1], per_plane[2]))
    return out


def group_roofline_pct(obs: dict, group: str) -> float | None:
    """The least time the card could take for a call's work of ``group``
    over the device time a call of the kernels attributed to it, in
    percent; None without spans, an attributed kernel or a stretch."""
    pk, work, tr = obs.get("plane_kernels"), obs.get("plane_work") or {}, obs.get("trace")
    g = pk["groups"].get(group) if pk else None
    if not g or g["kernel_s"] <= 0 or group not in work or not tr or not tr.get("calls"):
        return None
    return 100.0 * least_seconds(*work[group]) * tr["calls"] / g["kernel_s"]
