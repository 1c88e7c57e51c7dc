"""The port's span layer: named, timed spans and counters at its layer
boundaries, from the API down to each kernel launch and through the CLI's
stream stages, and a trace context that puts them beside the card's kernels.

Usage:
    with tracing():                              # spans on for the block
        out = sangnom2(clip)
    records = drain()                            # [Record, ...], buffer cleared

    with profile_trace("/tmp/sangnom-trace"):    # a Chrome trace file
        out = sangnom2(clip)

Spans are off by default.  Off, `span` tests one module flag and returns one
shared no-op object: it allocates nothing, reads no clock and opens no
profiler range; `count` returns at the same test.  `tracing()` (or
`enable()` / `disable()`) turns them on, from any thread.  On, each span
appends one `Record` to a bounded in-memory buffer (``CAPACITY`` records; a
record past it is dropped and counted under ``spans_dropped``):

  id, parent   the span, and the innermost open span on the same thread (0: none)
  call         shared by every span under one top-level call: the outermost
               span opens it, unless the span is given ``call=`` (the CLI's
               threads give the window index)
  thread       the recording thread's name
  name         "sangnom/<stage>" (README, "Spans and counters", lists them)
  start_ns, end_ns   ``time.perf_counter_ns()``
  counts       the span's counts (frames, bytes, grid, ...) and what
               `count` added while it was the innermost open span
  mirrored     True where a torch.profiler ran on the thread: the span
               also opened a profiler range of its name (all but the
               names in ``UNMIRRORED``, the launches)

The mirrored ranges name the program's stages in the profiler's own trace,
and they fix the offset between the buffer's clock and the trace's
(`clock_offset`): spans of other threads take the same offset, as the
process has one clock.

For an operator: ``SANGNOM_TPU_TORCH_TRACE=<dir>`` turns spans on for the
whole process and writes them at exit as a Chrome trace,
``<dir>/spans-<pid>.json``, a row a thread, on ``perf_counter``'s clock.
`profile_trace` writes one trace of the profiler's events (the card's
kernels and copies) and every thread's spans, mapped onto its clock.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

TRACE_ENV = "SANGNOM_TPU_TORCH_TRACE"

# The span names, one set for the port (README, "Spans and counters").
CALL = "sangnom/call"                    # a public call; the outermost opens the call id
PLANE = "sangnom/plane"                  # one plane's pass over all frames
POOL_PASS = "sangnom/pool_pass"          # one frame's plane pass through the pool
POOL_BATCH_PASS = "sangnom/pool_batch_pass"  # a chunk of frames' plane pass
LAUNCH = "sangnom/launch"                # a kernel wrapper on the card
BUILD = "sangnom/build"                  # the kernel library's build (check)
PARSE, UPLOAD = "sangnom/parse", "sangnom/upload"  # reading a window
FILTER = "sangnom/filter"                # the CLI's filter call on a window
WAIT_INPUT, WAIT_WRITER = "sangnom/wait_input", "sangnom/wait_writer"
WAIT_OUTPUT = "sangnom/wait_output"      # the writer thread, idle
DOWNLOAD, SERIALIZE, WRITE = "sangnom/download", "sangnom/serialize", "sangnom/write"
WINDOW, WINDOW_WAIT = "sangnom/window", "sangnom/window_wait"  # hosts' windows
HOST_FETCH = "sangnom/host_fetch"        # a pool_compat fetch through the host
# Spans that open no profiler range: a launch's range would cost more than
# 5% of a pool_compat call's host time (144 launches a call; PERF.md).
UNMIRRORED = frozenset({LAUNCH})
# Records the buffer holds before it drops (a compat call makes about 200).
CAPACITY = 1 << 18
# Zero-length spans opened by `profile_trace` on its own thread, so that
# the trace's clock is fixed even where nothing else runs there.
CLOCK_MARK = "sangnom/clock_mark"
# Synthetic Chrome-trace thread ids of the span rows (tid = base + index).
_TID_BASE = 0x5A000000


class Record(NamedTuple):
    id: int
    parent: int
    call: int
    thread: str
    name: str
    start_ns: int
    end_ns: int
    counts: dict
    mirrored: bool


_ON = False
_BUF: list = []
_COUNTERS: dict = {}
_COUNT_LOCK = threading.Lock()
_IDS = itertools.count(1)
_CALLS = itertools.count(1)
_TLS = threading.local()
_clock = time.perf_counter_ns


class _Stack(list):
    """A thread's open spans, innermost last, and the thread's name."""

    __slots__ = ("name",)


def _stack() -> _Stack:
    try:
        return _TLS.stack
    except AttributeError:
        st = _TLS.stack = _Stack()
        st.name = threading.current_thread().name
        return st


def _profiler_range():
    """The cheapest profiler range this torch offers: a C++ context manager
    where present, else ``record_function``."""
    fast = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)
    return fast if fast is not None else torch.autograd.profiler.record_function


_RANGE = _profiler_range()
_AP = torch.autograd.profiler
_PROFILER_ON_THREAD = torch._C._autograd._profiler_enabled
# torch's process-wide "a profiler runs" flag, where this torch has it: a
# plain attribute, tested before the per-thread query
_HAS_FLAG = hasattr(_AP, "_is_profiler_enabled")


class _Noop:
    """The shared object `span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **counts) -> None:
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("id", "parent", "call", "name", "counts", "t0", "_range", "_st")

    def __init__(self, name: str, call, counts: dict):
        self.name, self.call, self.counts = name, call, counts

    def __bool__(self):
        return True

    def set(self, **counts) -> None:
        """Add (or overwrite) counts of this span."""
        self.counts.update(counts)

    def __enter__(self):
        st = self._st = _stack()
        if st:
            outer = st[-1]
            self.parent = outer.id
            if self.call is None:
                self.call = outer.call
        else:
            self.parent = 0
            if self.call is None:
                self.call = next(_CALLS)
        self.id = next(_IDS)
        st.append(self)
        rng = None
        if ((not _HAS_FLAG or _AP._is_profiler_enabled) and _PROFILER_ON_THREAD()
                and self.name not in UNMIRRORED):
            # the clock is read inside the range, so its cost stays outside
            # the span and the two start at the same moment
            rng = _RANGE(self.name)
            rng.__enter__()
        self._range = rng
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        rng = self._range
        if rng is not None:
            rng.__exit__(None, None, None)
        st = self._st
        if st[-1] is self:
            st.pop()
        else:
            st.remove(self)
        if len(_BUF) < CAPACITY:
            _BUF.append((self.id, self.parent, self.call, st.name, self.name, self.t0, t1,
                         self.counts, rng is not None))
        else:
            _add("spans_dropped", 1)
        return False


def span(name: str, call: int | None = None, **counts):
    """A context manager timing one stage, ``name`` ("sangnom/<stage>"),
    with ``counts``; ``call`` sets the call id of a top-level span.  While
    spans are off it returns one shared no-op object, which is falsy, so a
    caller computes counts only when they are recorded:

        with span("sangnom/launch") as sp:
            if sp:
                sp.set(kernel="deint", blocks=n)
    """
    if not _ON:
        return _NOOP
    return _Span(name, call, counts)


def _add(name: str, n) -> None:
    with _COUNT_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` and to the counts of the innermost
    open span of this thread (nothing while spans are off)."""
    if not _ON:
        return
    _add(name, n)
    st = _stack()
    if st:
        c = st[-1].counts
        c[name] = c.get(name, 0) + n


def enable() -> None:
    """Turn spans on for the process (every thread)."""
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


@contextlib.contextmanager
def tracing():
    """Spans on inside the block; off after it, unless they were on before."""
    was = _ON
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def drain() -> list:
    """The buffered records (`Record`), oldest first; the buffer is
    cleared."""
    out = _BUF[:]
    del _BUF[: len(out)]
    return [Record._make(r) for r in out]


def counters() -> dict:
    """The counters' totals since the process started (each advances only
    while spans are on)."""
    with _COUNT_LOCK:
        return dict(_COUNTERS)


# --- one clock with the profiler's trace ------------------------------------

def clock_offset(records, marks) -> int | None:
    """Nanoseconds to add to a record's times to put them on a profiler
    trace's clock: the median difference between each mirrored record's
    start and the start of the trace's range of the same name nearest it.
    ``marks`` are (name, start ns) of the trace's host ranges.  None where
    no mirrored record has a range."""
    import bisect

    mirrored = [r for r in records if r.mirrored]
    if not mirrored:
        return None
    by_name: dict = {}
    for name, start in marks:
        by_name.setdefault(name, []).append(start)
    for v in by_name.values():
        v.sort()
    firsts = {}
    for r in sorted(mirrored, key=lambda r: r.start_ns):
        firsts.setdefault(r.name, r.start_ns)
    guesses = sorted(by_name[n][0] - t for n, t in firsts.items() if n in by_name)
    if not guesses:
        return None
    guess = guesses[len(guesses) // 2]
    diffs = []
    for r in mirrored:
        starts = by_name.get(r.name)
        if not starts:
            continue
        want = r.start_ns + guess
        i = bisect.bisect_left(starts, want)
        near = min(starts[max(0, i - 1):i + 1], key=lambda s: abs(s - want))
        diffs.append(near - r.start_ns)
    diffs.sort()
    return diffs[len(diffs) // 2]


def write_chrome(path: str, records, offset_ns: int = 0, base: dict | None = None,
                 totals: dict | None = None) -> None:
    """Write ``records`` as a Chrome trace at ``path``: a complete event a
    span (its ids and counts as args), shifted by ``offset_ns``, a row a
    thread, added to the trace object ``base`` where given, with the
    counters' ``totals`` (default: `counters()`) under "sangnom_counters"."""
    data = base if base is not None else {"traceEvents": []}
    out = data.setdefault("traceEvents", [])
    pid, tids = os.getpid(), {}
    for r in records:
        tid = tids.get(r.thread)
        if tid is None:
            tid = tids[r.thread] = _TID_BASE + len(tids)
            out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                        "args": {"name": f"sangnom spans: {r.thread}"}})
        out.append({"ph": "X", "cat": "sangnom_span", "name": r.name, "pid": pid,
                    "tid": tid, "ts": (r.start_ns + offset_ns) / 1e3,
                    "dur": (r.end_ns - r.start_ns) / 1e3,
                    "args": {"id": r.id, "parent": r.parent, "call": r.call,
                             **r.counts}})
    data["sangnom_counters"] = counters() if totals is None else totals
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the context (the
    CPU, and the card's kernels where the process has one) with spans on;
    on exit, write it into ``log_dir`` as a Chrome trace
    (``trace-<pid>.json``, readable by Perfetto or chrome://tracing), every
    thread's spans added on the kernels' timeline, a row a thread.
    Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = _ON
    enable()
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    t_start, before = _clock(), counters()
    try:
        with span(CLOCK_MARK):
            pass
        yield log_dir
    finally:
        with span(CLOCK_MARK):
            pass
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if was:
            records = [Record._make(r) for r in _BUF[:] if r[5] >= t_start]
        else:
            disable()
            records = [r for r in drain() if r.start_ns >= t_start]
        path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        marks = [(e.get("name", ""), int(float(e["ts"]) * 1e3))
                 for e in data.get("traceEvents", ())
                 if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")
                 and e.get("name", "").startswith("sangnom/")]
        after = counters()
        totals = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        write_chrome(path, records, clock_offset(records, marks) or 0, base=data,
                     totals=totals)


def _write_at_exit(log_dir: str) -> None:
    records = drain()
    os.makedirs(log_dir, exist_ok=True)
    write_chrome(os.path.join(log_dir, f"spans-{os.getpid()}.json"), records)


if os.environ.get(TRACE_ENV):
    enable()
    atexit.register(_write_at_exit, os.environ[TRACE_ENV])
