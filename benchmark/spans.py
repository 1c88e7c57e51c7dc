"""The program's spans on a device trace's clock, and what three per-layer
readings take from them: a kernel wrapper's host time a launch, the host
time of the layers above the wrappers a call, and the card's idle time
while the calling thread is inside a call.

Records are what ``sangnom_tpu_torch.utils.profiling.drain()`` returns, read
by position: (id, parent, call, thread, name, start ns, end ns, counts,
mirrored).  Events are ``trace.events(prof)`` of the profiler that ran while
the spans were on.  A span recorded on a thread the profiler records also
opened a host range of its name; the median difference between such spans'
starts and their ranges' is the offset from the program's clock to the
trace's, and every thread's spans take it.  The mapping is the
benchmark's own, not the program's, so that no change to the program can
move a reading by moving it.

Nothing in `BENCHMARK.json` reads these yet: the drivers hand the readers
no records.  Until they do, the tool below measures them:

    python3 -m benchmark.spans --workload bob1080i.api --seed 7 --seconds 20 [--spans 0]

runs the cell as ``benchmark.run --trace 1`` does, with the program's spans
on exactly while each profiler runs (``--spans 0``: off, for the cost of
having them on), and prints the result line with the reduction added under
"spans".  A ``cli_stream`` cell (the traffic's own files, listed or not)
runs its CLI child with the spans on for the whole run; "spans" then holds
the stream's stages a second (`stream_seconds`) and, with ``--trace 1``,
how many device-to-host copies fall inside a writer's download span.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time

T0 = time.perf_counter()

from benchmark import trace  # noqa: E402

CALL, LAUNCH = "sangnom/call", "sangnom/launch"
DOWNLOAD = "sangnom/download"
# The CLI stream's stages, on its reader, main and writer threads
STREAM_STAGES = ("sangnom/parse", "sangnom/upload", "sangnom/wait_input", "sangnom/filter",
                 "sangnom/wait_writer", "sangnom/wait_output", DOWNLOAD,
                 "sangnom/serialize", "sangnom/write")
HOST_RANGE_KINDS = ("user_annotation", "cpu_op")


def offset_ns(records, evs) -> int | None:
    """Nanoseconds from the records' clock to the events': the median, over
    mirrored records, of the start of the same-named host range nearest
    the record (after a first guess from each name's first pair)."""
    mirrored = sorted((r for r in records if r[8]), key=lambda r: r[5])
    ranges: dict = {}
    for k, n, s, _ in evs:
        if k in HOST_RANGE_KINDS and n.startswith("sangnom/"):
            ranges.setdefault(n, []).append(s)
    for v in ranges.values():
        v.sort()
    firsts: dict = {}
    for r in mirrored:
        firsts.setdefault(r[4], r[5])
    guesses = sorted(ranges[n][0] - t for n, t in firsts.items() if n in ranges)
    if not guesses:
        return None
    guess = guesses[len(guesses) // 2]
    diffs = []
    for r in mirrored:
        starts = ranges.get(r[4])
        if starts:
            want = r[5] + guess
            i = bisect.bisect_left(starts, want)
            diffs.append(min(starts[max(0, i - 1):i + 1], key=lambda s: abs(s - want)) - r[5])
    diffs.sort()
    return diffs[len(diffs) // 2]


def _outermost_call(rec, by_id):
    """The id of ``rec``'s outermost enclosing `CALL` span (itself
    included), or None."""
    found, r = None, rec
    while r is not None:
        if r[4] == CALL:
            found = r[0]
        r = by_id.get(r[1])
    return found


def _overlap(a, b) -> int:
    """Total length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def reduce(records, evs) -> dict | None:
    """The stretch's span numbers, or None where the trace has no stretch
    or the records no mirrored span: ``stretch_ns``; ``calls`` (outermost
    `CALL` spans inside the stretch), ``call_ns`` (their summed host time)
    and ``call_launch_ns`` (the `LAUNCH` spans' time inside them);
    ``launches`` and ``launch_ns`` (every `LAUNCH` span inside the stretch);
    ``idle_in_call_ns`` (device idle time while a call is open);
    ``launch_runtime_share`` (the share of launch spans holding a CUDA
    launch call of the runtime); ``offset_ns``."""
    marks = [(s, e) for k, n, s, e in evs if k == "user_annotation" and n.startswith(trace.MARK)]
    if not marks or not records:
        return None
    off = offset_ns(records, evs)
    if off is None:
        return None
    t0, t1 = min(s for s, _ in marks), max(e for _, e in marks)
    recs = [(r[0], r[1], r[2], r[3], r[4], r[5] + off, r[6] + off) for r in records]
    by_id = {r[0]: r for r in recs}
    inside = [r for r in recs if t0 <= r[5] and r[6] <= t1]
    calls = {r[0]: r for r in inside if r[4] == CALL and _outermost_call(r, by_id) == r[0]}
    launches = [r for r in inside if r[4] == LAUNCH]
    call_launch = sum(r[6] - r[5] for r in launches if _outermost_call(r, by_id) in calls)
    busy = trace._union([(max(s, t0), min(e, t1)) for k, _, s, e in evs
                         if k in trace.DEVICE_KINDS and min(e, t1) > max(s, t0)])
    idle, prev = [], t0
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = e
    if t1 > prev:
        idle.append((prev, t1))
    open_calls = trace._union([(r[5], r[6]) for r in calls.values()])
    rt = sorted(s for k, n, s, e in evs if k == "cuda_runtime" and "Launch" in n)
    holding = sum(1 for r in launches
                  if bisect.bisect_left(rt, r[5]) < bisect.bisect_right(rt, r[6]))
    return {
        "stretch_ns": t1 - t0,
        "calls": len(calls),
        "call_ns": sum(r[6] - r[5] for r in calls.values()),
        "call_launch_ns": call_launch,
        "launches": len(launches),
        "launch_ns": sum(r[6] - r[5] for r in launches),
        "idle_in_call_ns": _overlap(idle, [tuple(iv) for iv in open_calls]),
        "launch_runtime_share": holding / len(launches) if launches else None,
        "offset_ns": off,
    }


def launch_host_us(red) -> float | None:
    """Mean host time of a `LAUNCH` span in the stretch, in us."""
    if not red or not red["launches"]:
        return None
    return red["launch_ns"] / red["launches"] / 1e3


def orchestration_host_ms(red) -> float | None:
    """Host time of a call inside its outermost `CALL` span and outside
    every `LAUNCH` span, averaged over the stretch's calls, in ms."""
    if not red or not red["calls"]:
        return None
    return (red["call_ns"] - red["call_launch_ns"]) / red["calls"] / 1e6


def device_idle_in_call_pct(red) -> float | None:
    """Percent of the stretch in which the card is idle while the calling
    thread is inside a `CALL` span."""
    if not red or red["stretch_ns"] <= 0:
        return None
    return 100.0 * red["idle_in_call_ns"] / red["stretch_ns"]


def stream_seconds(records) -> list:
    """The CLI stream's stages a second of its run: for each whole second
    from the first record, the frames downloaded for writing and each
    stage's summed seconds, every span counted in the second it starts in,
    the threads' waits included."""
    if not records:
        return []
    base = min(r[5] for r in records)
    out: dict = {}
    for r in records:
        if r[4] not in STREAM_STAGES:
            continue
        sec = out.setdefault(int((r[5] - base) // 1_000_000_000), {"frames": 0})
        sec[r[4]] = sec.get(r[4], 0.0) + (r[6] - r[5]) * 1e-9
        if r[4] == DOWNLOAD:
            sec["frames"] += r[7].get("frames", 0)
    return [dict(second=k, **out[k]) for k in sorted(out)]


def download_cover(records, evs) -> tuple[int, int] | None:
    """(device-to-host copies, those that overlap a writer thread's
    `DOWNLOAD` span after the mapping), or None without a mapping."""
    off = offset_ns(records, evs)
    if off is None:
        return None
    spans = trace._union([(r[5] + off, r[6] + off) for r in records if r[4] == DOWNLOAD])
    starts = [s for s, _ in spans]
    copies = [(s, e) for k, n, s, e in evs if k == "gpu_memcpy" and "DtoH" in n]
    hit = 0
    for s, e in copies:
        i = bisect.bisect_right(starts, e) - 1
        hit += i >= 0 and spans[i][1] >= s
    return len(copies), hit


# --- the tool ---------------------------------------------------------------

def _keep_events(keep: dict) -> None:
    """Patch `trace.events` to keep the events it exports in ``keep``."""
    events = trace.events

    def exported(prof):
        keep["events"] = evs = events(prof)
        return evs

    trace.events = exported


def _spans_with_profilers(on: bool, keep: dict):
    """Patch `trace` so each profiler it starts has the program's spans on
    (when ``on``) until it stops, keeps the last stopped one's records and
    the events exported."""
    from sangnom_tpu_torch.utils import profiling

    start = trace.profiler

    class Traced:
        def __init__(self):
            self.prof = start()
            if on:
                profiling.enable()

        def stop(self):
            self.prof.stop()
            profiling.disable()
            keep["records"] = profiling.drain()

        def __getattr__(self, name):
            return getattr(self.prof, name)

    trace.profiler = Traced
    _keep_events(keep)


def _child(out: str, argv: list) -> int:
    """The CLI child of a stream cell, with the spans on for its run; the
    records (and with a profiler the events) go to the file ``out``."""
    from benchmark.drivers import cli_child
    from sangnom_tpu_torch.utils import profiling

    keep: dict = {}
    _keep_events(keep)
    profiling.enable()
    rc = cli_child.main(argv)
    profiling.disable()
    recs = [list(r) for r in profiling.drain()]
    evs = [e for e in keep.get("events", ())
           if e[0] in trace.DEVICE_KINDS or e[1].startswith("sangnom/")
           or e[0] == "cuda_runtime" or e[1].startswith(trace.MARK)]
    with open(out, "w") as f:
        json.dump({"records": recs, "events": evs}, f)
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child-out"]:
        return _child(argv[1], argv[2:])
    p = argparse.ArgumentParser(prog="benchmark.spans", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    import os
    import tempfile

    from benchmark import harness

    spec = harness.load_spec()
    config, traffic = harness.cell_files(args.workload)
    cell = harness.Cell(name=args.workload, config=config, traffic=traffic, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace), t0=T0)
    drv = harness.driver(traffic["driver"])
    keep: dict = {}
    if traffic["driver"] == "cli_stream":
        fd, path = tempfile.mkstemp(prefix="bench-spans-", suffix=".json")
        os.close(fd)
        try:
            out = drv.run(cell, child_argv=[sys.executable, "-m", "benchmark.spans",
                                            "--child-out", path])
            with open(path) as f:
                keep = json.load(f)
        finally:
            os.unlink(path)
    else:
        _spans_with_profilers(bool(args.spans), keep)
        out = drv.run(cell)
    line = harness.result_line(spec, cell, out, "gpu")
    recs, evs = keep.get("records", []), keep.get("events", [])
    red = reduce(recs, evs)
    tr = out.obs.get("trace")
    spans = {"records": len(recs), "reduction": red,
             "launch_host_us": launch_host_us(red),
             "orchestration_host_ms": orchestration_host_ms(red),
             "device_idle_in_call_pct": device_idle_in_call_pct(red),
             "stretch_call_ms": (1e3 * tr["stretch_s"] / tr["calls"]
                                 if tr and tr.get("calls") else None)}
    if traffic["driver"] == "cli_stream":
        spans["stream_seconds"] = stream_seconds(recs)
        spans["d2h_copies_in_download"] = download_cover(recs, evs)
    line["spans"] = spans
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
