"""The port's span layer (sangnom_tpu_torch.utils.profiling): off by
default at one flag test, records with parent and call ids from any thread,
counters, the bounded buffer, one clock with torch.profiler, and the spans
the API, the pool, the CLI's three threads and the hosts' window runner
record, on the CPU.  The ``cuda`` cases hold each launch span against its
kernel on the card.  This module imports neither JAX nor the test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import json
import os
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch import Clip, bob, sangnom2  # noqa: E402
from sangnom_tpu_torch import cli as tcli  # noqa: E402
from sangnom_tpu_torch.io import write_y4m  # noqa: E402
from sangnom_tpu_torch.ops import pool_graph  # noqa: E402
from sangnom_tpu_torch.utils import profiling as pr  # noqa: E402

PKG = Path(pr.__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def spans_off():
    """Every case starts and ends with spans off and the buffer empty."""
    pr.disable()
    pr.drain()
    yield
    pr.disable()
    pr.drain()


def _clip(n=2, h=16, w=32, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 256, (n, h, w), dtype=np.uint8),
              rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
              rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)]
    return Clip.from_numpy(planes, "YUV420P8", device=device)


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_returns_one_shared_object_and_records_nothing():
    a, b = pr.span("sangnom/x"), pr.span("sangnom/y", call=3, frames=1)
    assert a is b and not a
    with a as sp:
        sp.set(frames=2)
    before = pr.counters()
    pr.count("frames_in", 5)
    bob(_clip())
    bob(_clip(), pool_compat=True)
    assert pr.drain() == [] and pr.counters() == before


def test_nesting_gives_parent_and_call_ids():
    with pr.tracing():
        with pr.span("sangnom/a") as a:
            with pr.span("sangnom/b", frames=2) as b:
                pass
        with pr.span("sangnom/c") as c:
            pass
        with pr.span("sangnom/d", call=41) as d:
            with pr.span("sangnom/e"):
                pass
    assert not pr._ON
    recs = {r.name: r for r in pr.drain()}
    assert recs["sangnom/a"].parent == 0 and recs["sangnom/b"].parent == a.id
    assert recs["sangnom/b"].call == recs["sangnom/a"].call != recs["sangnom/c"].call
    assert recs["sangnom/d"].call == recs["sangnom/e"].call == 41
    assert recs["sangnom/e"].parent == d.id and recs["sangnom/c"].id == c.id
    assert recs["sangnom/b"].counts == {"frames": 2} and b.id != a.id
    for r in recs.values():
        assert r.thread == "MainThread" and r.end_ns >= r.start_ns and not r.mirrored
    assert recs["sangnom/a"].start_ns <= recs["sangnom/b"].start_ns
    assert recs["sangnom/b"].end_ns <= recs["sangnom/a"].end_ns


def test_a_second_thread_records_its_own_stack():
    seen = {}

    def work():
        with pr.span("sangnom/t_outer"):
            with pr.span("sangnom/t_inner") as sp:
                seen["id"] = sp.id

    with pr.tracing():
        with pr.span("sangnom/main"):
            t = threading.Thread(target=work, name="spans-test-thread")
            t.start()
            t.join()
    recs = {r.name: r for r in pr.drain()}
    outer, inner = recs["sangnom/t_outer"], recs["sangnom/t_inner"]
    assert outer.thread == inner.thread == "spans-test-thread"
    assert outer.parent == 0 and inner.parent == outer.id and inner.id == seen["id"]
    assert outer.call == inner.call != recs["sangnom/main"].call


def test_counts_attach_to_the_open_span_and_counters_total():
    before = pr.counters()
    with pr.tracing():
        with pr.span("sangnom/outer"):
            with pr.span("sangnom/inner") as sp:
                pr.count("frames_in", 3)
                pr.count("frames_in")
                sp.set(bytes=10)
            pr.count("bytes_read", 7)
        pr.count("bytes_read", 1)  # no open span: the counter only
    recs = {r.name: r for r in pr.drain()}
    assert recs["sangnom/inner"].counts == {"frames_in": 4, "bytes": 10}
    assert recs["sangnom/outer"].counts == {"bytes_read": 7}
    after = pr.counters()
    assert after["frames_in"] - before.get("frames_in", 0) == 4
    assert after["bytes_read"] - before.get("bytes_read", 0) == 8


def test_the_bound_drops_and_counts(monkeypatch):
    dropped = pr.counters().get("spans_dropped", 0)
    monkeypatch.setattr(pr, "CAPACITY", 5)
    with pr.tracing():
        for _ in range(8):
            with pr.span("sangnom/x"):
                pass
    assert len(pr.drain()) == 5
    assert pr.counters()["spans_dropped"] - dropped == 3


def test_mirrored_spans_and_the_profiler_range_agree():
    from torch.profiler import ProfilerActivity, profile

    other = []

    def work():
        with pr.span("sangnom/off_thread"):
            other.append(1)

    with pr.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                with pr.span("sangnom/mirror_a"):
                    with pr.span("sangnom/mirror_b"):
                        with pr.span(pr.LAUNCH):
                            pass
            t = threading.Thread(target=work)
            t.start()
            t.join()
    recs = pr.drain()
    evs = [e for e in prof.events() if e.name.startswith("sangnom/")]
    mirrored = [r for r in recs if r.mirrored]
    assert {r.name for r in mirrored} == {"sangnom/mirror_a", "sangnom/mirror_b"}
    assert len(mirrored) == 10
    # the thread the profiler does not record opens no range, nor does a
    # launch span (its range would cost too much a pool_compat call)
    (off,) = [r for r in recs if r.name == "sangnom/off_thread"]
    assert not off.mirrored and all(e.name != "sangnom/off_thread" for e in evs)
    launches = [r for r in recs if r.name == pr.LAUNCH]
    assert len(launches) == 5 and not any(r.mirrored for r in launches)
    assert all(e.name != pr.LAUNCH for e in evs)
    # the profiler's events, in ns on its own clock, from its Chrome trace
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        data = json.loads(Path(path).read_text())
    marks = sorted((e["name"], int(float(e["ts"]) * 1e3), int(float(e["dur"]) * 1e3))
                   for e in data["traceEvents"]
                   if e.get("ph") == "X" and e.get("name", "").startswith("sangnom/"))
    off_ns = pr.clock_offset(recs, [(n, s) for n, s, _ in marks])
    assert off_ns is not None
    for name in ("sangnom/mirror_a", "sangnom/mirror_b"):
        spans = sorted(r.start_ns + off_ns for r in mirrored if r.name == name)
        ranges = sorted(s for n, s, _ in marks if n == name)
        assert len(spans) == len(ranges) == 5
        for a, b in zip(spans, ranges):
            assert abs(a - b) < 50_000, (name, a - b)


def test_clock_offset_pairs_each_span_with_its_range():
    def rec(i, name, start):
        return pr.Record(i, 0, i, "MainThread", name, start, start + 10, {}, True)

    recs = [rec(1, "sangnom/a", 100), rec(2, "sangnom/b", 300), rec(3, "sangnom/a", 900),
            pr.Record(4, 0, 4, "w", "sangnom/c", 50, 60, {}, False)]
    # ranges 1000 ns later, one a few ns off, and one range with no span
    marks = [("sangnom/a", 1100), ("sangnom/b", 1304), ("sangnom/a", 1898),
             ("sangnom/a", 5000), ("other", 1)]
    assert pr.clock_offset(recs, marks) == 1000
    assert pr.clock_offset(recs[3:], marks) is None
    assert pr.clock_offset(recs, [("other", 1)]) is None


def test_bob_and_pool_compat_calls_record_their_layers():
    clip = _clip(n=3)
    with pr.tracing():
        out = bob(clip)
        pool_out = bob(clip, pool_compat=True)
    by = _by_name(pr.drain())
    calls = [r for r in by["sangnom/call"] if r.parent == 0]
    assert [r.counts["path"] for r in calls] == ["main", "pool"]
    main, pool = calls
    # no upload on the CPU: the offsets' h2d counters stay off the call
    assert main.counts == {"entry": "bob", "path": "main", "frames_in": 3,
                           "frames_out": out.num_frames}
    planes = [r for r in by["sangnom/plane"] if r.call == main.call]
    assert sorted(str(r.counts["plane"]) for r in planes) == ["0", "uv"]
    (uv,) = [r for r in planes if r.counts["plane"] == "uv"]
    assert uv.counts["fields"] == 2 * 2 * 3 and uv.counts["bytes"] == 2 * 3 * 8 * 16
    assert all(r.parent == main.id for r in planes)
    # the pool bob's recipe calls sangnom2 inside: one call id, nested calls
    inner = [r for r in by["sangnom/call"] if r.parent == pool.id]
    assert [r.counts["entry"] for r in inner] == ["sangnom2"]
    passes = by["sangnom/pool_pass"]
    assert len(passes) == 3 * pool_out.num_frames
    assert all(r.call == pool.call for r in passes)
    assert Counter(r.counts["plane"] for r in passes) == {0: 6, 1: 6, 2: 6}
    assert [r.counts["frame"] for r in passes[:3]] == [0, 0, 0]


def test_order0_offsets_cross_to_the_device_once_a_pattern():
    from sangnom_tpu_torch.ops.sangnom import field_offsets

    parity = np.tile(np.array([False, True]), 13)  # a length no other case uses
    want = np.where(parity, 0, 1).astype(np.int32)
    meta = torch.device("meta")
    with pr.tracing():
        before = pr.counters().get("h2d_copies", 0)
        one = [field_offsets(0, parity, meta) for _ in range(3)]
        two = [field_offsets(0, parity, meta, repeats=2) for _ in range(3)]
        grown = pr.counters().get("h2d_copies", 0) - before
    assert all(t is one[0] for t in one) and all(t is two[0] for t in two)
    assert one[0].shape == (26,) and two[0].shape == (52,) and grown == 2
    cpu = torch.device("cpu")
    assert field_offsets(0, parity, cpu).tolist() == want.tolist()
    assert field_offsets(0, parity, cpu, repeats=2).tolist() == np.tile(want, 2).tolist()
    assert field_offsets(1, parity, meta) == 0 and field_offsets(2, parity, meta, repeats=2) == 1


@pytest.mark.cuda
def test_bob_uploads_its_offsets_once_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    clip = _clip(n=13, device="cuda")  # a length no other case uses
    with pr.tracing():
        counts = []
        for _ in range(3):
            before = pr.counters().get("h2d_copies", 0)
            out = bob(clip)
            counts.append(pr.counters().get("h2d_copies", 0) - before)
    assert counts == [2, 0, 0]  # luma's offsets and U+V's, on the first call only
    cpu = bob(Clip([p.cpu() for p in clip.planes], clip.format, tff=clip.tff))
    for a, b in zip(out.planes, cpu.planes):
        assert torch.equal(a.cpu(), b)


def test_other_entries_record_a_call():
    from sangnom_tpu_torch import sangnom
    from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream

    clip = _clip(n=2)
    with pr.tracing():
        sangnom2(clip, order=1)
        sangnom(clip, order=0)
        sangnom2_pool_stream(clip, None)
    calls = [r for r in pr.drain() if r.name == "sangnom/call"]
    assert [(r.counts["entry"], r.counts["path"]) for r in calls] == [
        ("sangnom2", "main"), ("sangnom", "main"), ("sangnom2_pool_stream", "pool")]
    assert all(r.counts["frames_in"] == r.counts["frames_out"] == 2 for r in calls)


def _y4m(tmp_path, n=5):
    rng = np.random.default_rng(7)
    clip = Clip.from_numpy(
        [rng.integers(0, 256, (n, 16, 32), dtype=np.uint8),
         rng.integers(0, 256, (n, 8, 16), dtype=np.uint8),
         rng.integers(0, 256, (n, 8, 16), dtype=np.uint8)], "YUV420P8", device="cpu")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), clip, interlace="t")
    return src, n, 16 * 32 * 3 // 2


@pytest.mark.parametrize("flags", [["--bob"], []])
def test_cli_stream_stages_on_three_threads(tmp_path, flags):
    src, n, frame_bytes = _y4m(tmp_path)
    args = [str(src), None, *flags, "--window", "2", "--device", "cpu", "--overlap-write"]
    off, on = tmp_path / "off.y4m", tmp_path / "on.y4m"
    assert tcli.main([str(off) if a is None else a for a in args]) == 0
    assert pr.drain() == []
    with pr.tracing():
        assert tcli.main([str(on) if a is None else a for a in args]) == 0
    by = _by_name(pr.drain())
    assert on.read_bytes() == off.read_bytes()
    rate = 2 if flags else 1

    def threads(name):
        return {r.thread for r in by[name]}

    assert threads("sangnom/parse") == threads("sangnom/upload") == {"sangnom-reader"}
    assert threads("sangnom/filter") == threads("sangnom/wait_input") == {"MainThread"}
    for name in ("sangnom/wait_output", "sangnom/download", "sangnom/serialize",
                 "sangnom/write"):
        assert threads(name) == {"sangnom-writer"}, name
    assert threads("sangnom/wait_writer") == {"MainThread"}
    assert sum(r.counts["frames"] for r in by["sangnom/parse"]) == n
    assert sum(r.counts["bytes"] for r in by["sangnom/parse"]) == n * frame_bytes
    assert sum(r.counts["bytes"] for r in by["sangnom/upload"]) == n * frame_bytes
    assert sum(r.counts["frames"] for r in by["sangnom/filter"]) == n
    assert sum(r.counts["frames"] for r in by["sangnom/download"]) == rate * n
    assert sum(r.counts["bytes"] for r in by["sangnom/download"]) == rate * n * frame_bytes
    header = on.read_bytes().index(b"\n") + 1
    assert sum(r.counts["bytes"] for r in by["sangnom/write"]) == on.stat().st_size - header
    # a window's stages carry its index as their call id, on every thread
    windows = sorted(r.call for r in by["sangnom/parse"])
    assert windows == list(range(3))
    assert sorted(r.call for r in by["sangnom/filter"]) == windows
    assert sorted(r.call for r in by["sangnom/download"]) == windows
    for f in by["sangnom/filter"]:
        assert f.counts["window"] == f.call
        kids = [r for r in by["sangnom/call"] if r.parent == f.id]
        assert len(kids) == 1 and kids[0].call == f.call


def test_window_runner_spans_hits_and_misses():
    from sangnom_tpu_torch.hosts.window import WindowRunner

    clip = _clip(n=4, h=8, w=16)
    frames = [{"planes": [p[i].numpy() for p in clip.planes], "parity": True}
              for i in range(4)]
    runner = WindowRunner(4, "YUV420P8", {"order": 1}, tff=True, batch=2, device="cpu")
    before = pr.counters()
    with pr.tracing():
        for k in range(4):
            start = (k // 2) * 2
            runner.get(k, lambda s=start: frames[s:s + 2])
    recs = [r for r in pr.drain() if r.name == "sangnom/window"]
    assert [r.counts["start"] for r in recs] == [0, 0, 2, 2]
    assert [r.counts.get("window_misses", 0) for r in recs] == [1, 0, 1, 0]
    assert [r.counts.get("window_hits", 0) for r in recs] == [0, 1, 0, 1]
    after = pr.counters()
    assert after["window_hits"] - before.get("window_hits", 0) == 2
    assert after["window_misses"] - before.get("window_misses", 0) == 2


def test_profile_trace_puts_every_thread_on_the_trace(tmp_path):
    src, n, _ = _y4m(tmp_path)
    with pr.profile_trace(str(tmp_path / "trace")):
        assert tcli.main([str(src), str(tmp_path / "o.y4m"), "--bob", "--window", "2",
                          "--device", "cpu", "--overlap-write"]) == 0
    assert not pr._ON and pr.drain() == []
    (trace,) = (tmp_path / "trace").glob("trace-*.json")
    data = json.loads(trace.read_text())
    evs = data["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in evs
            if e.get("ph") == "M" and e.get("cat") is None
            and str(e.get("args", {}).get("name", "")).startswith("sangnom spans: ")}
    assert set(rows.values()) >= {"sangnom spans: MainThread", "sangnom spans: sangnom-reader",
                                  "sangnom spans: sangnom-writer"}
    spans = [e for e in evs if e.get("cat") == "sangnom_span"]
    assert {e["name"] for e in spans} >= {"sangnom/parse", "sangnom/filter",
                                          "sangnom/call", "sangnom/write"}
    assert data["sangnom_counters"]["frames_in"] == n
    # the main thread's spans sit on their mirrored profiler ranges
    ranges = sorted(float(e["ts"]) for e in evs
                    if e.get("cat") in ("user_annotation", "cpu_op")
                    and e.get("name") == "sangnom/filter")
    mapped = sorted(float(e["ts"]) for e in spans if e["name"] == "sangnom/filter")
    assert len(mapped) == len(ranges) == 3
    for a, b in zip(mapped, ranges):
        assert abs(a - b) < 50, (a, b)


def test_trace_env_writes_spans_at_exit(tmp_path):
    code = ("import numpy as np, sangnom_tpu_torch as T\n"
            "c = T.Clip.from_numpy([np.zeros((2, 8, 16), np.uint8)], 'GRAY8', device='cpu')\n"
            "T.bob(c)\n")
    env = dict(os.environ, SANGNOM_TPU_TORCH_TRACE=str(tmp_path / "spans"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=PKG.parent)
    (path,) = (tmp_path / "spans").glob("spans-*.json")
    evs = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in evs if e.get("ph") == "X"].count("sangnom/call") == 1
    assert any(e.get("ph") == "M" and e["args"]["name"] == "sangnom spans: MainThread"
               for e in evs)


def test_off_path_has_no_profiler_range_outside_the_span_layer():
    """Off costs one flag test: the package opens no record_function of its
    own, and the old always-on stage scope is gone."""
    hits = []
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        if path.name != "profiling.py" and "record_function" in text:
            hits.append(str(path))
        if "stage_scope" in text:
            hits.append(str(path))
    assert hits == []


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sangnom_tpu_torch.ops import cuda_library as cl

    cl.build()


def _launches_against_kernels(fn):
    """Run ``fn`` under a profiler with spans on, behind a kernel that keeps
    the card busy for about 25 ms, so that every kernel ``fn`` launches
    starts after its wrapper returned; returns (launch spans mapped onto
    the trace's clock, runtime launch calls and kernels by correlation
    id)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with pr.tracing():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with pr.span("sangnom/test_clock"):  # a mirrored span fixes the offset
                torch.cuda._sleep(50_000_000)
                fn()
            torch.cuda.synchronize()
    recs = pr.drain()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        evs = json.loads(Path(path).read_text())["traceEvents"]
    marks = [(e["name"], int(float(e["ts"]) * 1e3)) for e in evs
             if e.get("ph") == "X" and e.get("name", "").startswith("sangnom/")]
    off = pr.clock_offset(recs, marks)
    assert off is not None
    launches = [(r.counts.get("kernel"), r.start_ns + off, r.end_ns + off)
                for r in recs if r.name == "sangnom/launch"]
    runtime, kernels = {}, {}
    for e in evs:
        if e.get("ph") != "X" or "correlation" not in e.get("args", {}):
            continue
        s = int(float(e["ts"]) * 1e3)
        iv = (e["name"], s, s + int(float(e.get("dur", 0)) * 1e3))
        if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]:
            runtime[e["args"]["correlation"]] = iv
        elif e.get("cat") == "kernel":
            kernels[e["args"]["correlation"]] = iv
    return launches, runtime, kernels


def _deint_launches():
    """The field kernel's woven launch through its wrapper: no upload, so
    nothing in the call waits for the card."""
    from sangnom_tpu_torch.core.formats import get_format
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    spec = KernelSpec.from_format(get_format("GRAY8"))
    kept = torch.randint(0, 256, (4, 32, 128), dtype=torch.uint8, device="cuda")
    return lambda: dk.deinterlace_field_batch_fused(kept, 0, 20.0, spec, 128)


def _pool_launches():
    """One K7 plane pass: the prepare, walk and finalize wrappers."""
    from sangnom_tpu_torch.core.formats import get_format
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    spec = KernelSpec.from_format(get_format("GRAY8"))
    kept = torch.randint(0, 256, (32, 128), dtype=torch.uint8, device="cuda")
    carry = [torch.zeros(shape, dtype=spec.acc_dtype, device="cuda")
             for shape in ((9, 128), (9, 31, 128), (9, 128))]
    return lambda: pk.interp_fused(kept, *carry, 20.0, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_deint_launches, _pool_launches])
def test_each_launch_span_holds_its_kernel_launch_on_card(make):
    _card()
    launches, runtime, kernels = _launches_against_kernels(make())
    assert launches and all(k for k, _, _ in launches)
    for kernel, s, e in launches:
        inside = [c for c, (n, rs, re_) in runtime.items() if s <= rs and re_ <= e]
        assert len(inside) == 1, (kernel, s, e)
        (name, ks, _) = kernels[inside[0]]
        assert kernel in name, (kernel, name)
        # the span ends once the wrapper returned, before the card runs it
        assert e < ks, (kernel, e, ks)


@pytest.mark.cuda
def test_a_bob_call_records_its_launches_on_card():
    _card()
    clip = _clip(n=2, h=64, w=128, device="cuda")
    # a pool_compat call replayed as a CUDA graph launches no wrapper: drop
    # the graphs so this call runs eagerly
    pool_graph.CACHE.clear()
    for pool_compat, n in ((False, 2), (True, 3 * 3 * 4)):
        with pr.tracing():
            bob(clip, opt=1, pool_compat=pool_compat)
        recs = pr.drain()
        launches = [r for r in recs if r.name == "sangnom/launch"]
        assert len(launches) == n, (pool_compat, len(launches))
        (call,) = [r for r in recs if r.name == "sangnom/call" and r.parent == 0]
        assert all(r.call == call.call for r in launches)
        assert all({"kernel", "blocks", "threads", "smem_bytes", "bytes"} <= set(r.counts)
                   for r in launches)
