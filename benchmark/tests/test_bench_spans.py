"""`benchmark/spans.py` on hand-built records and events, with numbers
worked out by hand, and its tool's patched profiler on a tiny CPU cell."""

from __future__ import annotations

import pytest

from benchmark import spans, trace
from benchmark.tests.conftest import tiny_cell

OFF = 100_000  # the trace's clock minus the records'


def _rec(i, parent, call, name, s, e, thread="MainThread", mirrored=False, **counts):
    """A record whose times are given on the trace's clock."""
    return (i, parent, call, thread, name, s - OFF, e - OFF, counts, mirrored)


EVENTS = [
    ("user_annotation", "bench.call", 1000, 5000),
    ("user_annotation", "bench.sync", 5000, 9000),
    ("user_annotation", "bench.call", 9000, 13000),
    ("user_annotation", "bench.sync", 13000, 20000),
    ("cpu_op", "sangnom/call", 1100, 4900),
    ("cpu_op", "sangnom/call", 9100, 12900),
    ("cuda_runtime", "cudaLaunchKernel", 2100, 2200),
    ("cuda_runtime", "cudaLaunchKernel", 10100, 10200),
    ("kernel", "k", 3000, 8000),
    ("kernel", "k", 11000, 16000),
]
RECORDS = [
    _rec(1, 0, 1, "sangnom/call", 1100, 4900, mirrored=True),
    _rec(2, 1, 1, "sangnom/launch", 2000, 2500),
    _rec(3, 0, 2, "sangnom/call", 9100, 12900, mirrored=True),
    _rec(4, 3, 2, "sangnom/plane", 9500, 12000),
    _rec(5, 4, 2, "sangnom/launch", 10000, 11000),
    _rec(6, 0, 3, "sangnom/call", 30000, 31000),  # after the stretch
]


def test_offset_is_the_median_pairing():
    assert spans.offset_ns(RECORDS, EVENTS) == OFF
    assert spans.offset_ns([r for r in RECORDS if not r[8]], EVENTS) is None
    # each span pairs with the nearest range of its name; a range with no
    # span is passed over; the median of +40, 0 and -3 ns is 0
    recs = [_rec(1, 0, 1, "sangnom/a", 100, 200, mirrored=True),
            _rec(2, 0, 2, "sangnom/b", 300, 400, mirrored=True),
            _rec(3, 0, 3, "sangnom/a", 900, 950, mirrored=True)]
    evs = [("cpu_op", "sangnom/a", 140, 200), ("cpu_op", "sangnom/b", 300, 400),
           ("user_annotation", "sangnom/a", 897, 950), ("cpu_op", "sangnom/a", 5000, 6000)]
    assert spans.offset_ns(recs, evs) == OFF


def test_reduce_and_the_three_readings():
    red = spans.reduce(RECORDS, EVENTS)
    assert red["stretch_ns"] == 19000
    assert red["calls"] == 2 and red["call_ns"] == 3800 + 3800
    assert red["launches"] == 2 and red["launch_ns"] == 500 + 1000
    assert red["call_launch_ns"] == 1500
    # idle [1000, 3000], [8000, 11000], [16000, 20000]; calls [1100, 4900],
    # [9100, 12900]: 1900 + 1900 inside calls
    assert red["idle_in_call_ns"] == 3800
    assert red["launch_runtime_share"] == 1.0
    assert spans.launch_host_us(red) == pytest.approx(0.75)
    assert spans.orchestration_host_ms(red) == pytest.approx((7600 - 1500) / 2 / 1e6)
    assert spans.device_idle_in_call_pct(red) == pytest.approx(100 * 3800 / 19000)
    # per call, its self time plus its launches' time is the call's span
    assert red["call_ns"] == red["call_launch_ns"] + (7600 - 1500)


def test_reduce_without_a_stretch_or_spans_is_none():
    assert spans.reduce(RECORDS, EVENTS[4:]) is None
    assert spans.reduce([], EVENTS) is None
    for f in (spans.launch_host_us, spans.orchestration_host_ms,
              spans.device_idle_in_call_pct):
        assert f(None) is None


def test_a_nested_call_counts_once_under_the_outermost():
    recs = RECORDS[:2] + [_rec(7, 1, 1, "sangnom/call", 1500, 4000),
                          _rec(8, 7, 1, "sangnom/launch", 3000, 3500)]
    red = spans.reduce(recs, EVENTS)
    assert red["calls"] == 1 and red["call_ns"] == 3800
    assert red["call_launch_ns"] == 500 + 500 and red["launches"] == 2
    # the second launch holds no runtime launch call
    assert red["launch_runtime_share"] == 0.5


def test_stream_seconds_and_download_cover():
    s = 1_000_000_000
    recs = [
        _rec(1, 0, 0, "sangnom/filter", 0, s // 4, mirrored=True),
        _rec(2, 0, 0, "sangnom/download", s // 2, s // 2 + 1000, "sangnom-writer", frames=16),
        _rec(3, 0, 1, "sangnom/write", s // 2 + 2000, s + 10, "sangnom-writer"),
        _rec(4, 0, 1, "sangnom/download", s + 100, s + 300, "sangnom-writer", frames=16),
        _rec(5, 0, 1, "sangnom/parse", s + 400, s + 900, "sangnom-reader", frames=8),
    ]
    secs = spans.stream_seconds(recs)
    assert [x["second"] for x in secs] == [0, 1]
    assert secs[0]["frames"] == 16 and secs[1]["frames"] == 16
    assert secs[0]["sangnom/filter"] == pytest.approx(0.25)
    assert secs[0]["sangnom/write"] == pytest.approx((s // 2 - 1990) * 1e-9)
    assert secs[1]["sangnom/parse"] == pytest.approx(500e-9)
    evs = [("cpu_op", "sangnom/filter", 0, s // 4),
           ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", s // 2 + 10, s // 2 + 900),
           ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", s + 200, s + 5000),
           ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", s + 400, s + 5000),
           ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", s + 100, s + 200)]
    assert spans.download_cover(recs, evs) == (3, 2)


def test_the_tool_turns_spans_on_with_each_profiler(monkeypatch):
    from sangnom_tpu_torch.utils import profiling

    monkeypatch.setattr(trace, "profiler", trace.profiler)
    monkeypatch.setattr(trace, "events", trace.events)
    keep: dict = {}
    spans._spans_with_profilers(True, keep)
    cell = tiny_cell("bob1080i.api", seconds=2.0, trace=True)
    from benchmark.drivers import api_call

    out = api_call.run(cell)
    assert not profiling._ON and profiling.drain() == []
    recs = keep["records"]
    calls = [r for r in recs if r[4] == "sangnom/call"]
    assert calls and all(r[8] for r in calls)
    red = spans.reduce(recs, keep["events"])
    assert red["calls"] == out.obs["trace"]["calls"] if out.obs.get("trace") else red["calls"] > 0
    assert red["launches"] == 0  # the CPU runs the plain path: no launch
    assert spans.orchestration_host_ms(red) > 0


def test_the_stream_child_returns_every_threads_spans(tmp_path):
    import sys

    from benchmark.drivers import cli_stream

    out = tmp_path / "spans.json"
    cell = tiny_cell("bob1080i.stream", seconds=1.0)
    res = cli_stream.run(cell, child_argv=[sys.executable, "-m", "benchmark.spans",
                                           "--child-out", str(out)])
    assert all(v <= lim for _, v, lim in res.checks), res.checks
    import json

    keep = json.loads(out.read_text())
    threads = {(r[3], r[4]) for r in keep["records"]}
    assert {("sangnom-reader", "sangnom/parse"), ("MainThread", "sangnom/filter"),
            ("sangnom-writer", "sangnom/write")} <= threads
    secs = spans.stream_seconds(keep["records"])
    assert sum(s["frames"] for s in secs) == res.attempted
