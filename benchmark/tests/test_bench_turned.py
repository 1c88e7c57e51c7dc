"""The cell `maa2160p.turned` (maa's turned SangNom pass through the API)
and its driver `api_call_launches`.  On the CPU at tiny size: a sound run
is correct, traced or not; each planted fault and the SSE2 control come out
not correct.  On hand-built records and events: each kernel goes to the
launch span of its launch call by correlation id, a dropped launch call
leaves its kernel and span out, and without spans, steps or a match
`wide_step_us` gives None.  The cell's work counts.  On the card, a traced
run reads `wide_step_us` from its K4 launches."""

from __future__ import annotations

import pytest

from benchmark import harness, peaks
from benchmark.drivers import api_call, api_call_launches as launches
from benchmark.tests import faults
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.controls import control_run

CELL = "maa2160p.turned"


def _line(cell, out) -> dict:
    return harness.result_line(harness.load_spec(), cell, out, cell.device)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    from sangnom_tpu_torch.utils import profiling

    cell = tiny_cell(CELL, trace=traced, seconds=2.0)
    out = launches.run(cell)
    line = _line(cell, out)
    assert line["correct"] and out.attempted >= cell.traffic["sample_calls"]
    assert cell.config["filter"]["kwargs"] == {"order": 1, "aa": 48, "aac": 0}
    assert cell.traffic["driver"] == "api_call_launches"
    assert not profiling._ON
    if traced:
        assert any(r[4] == "sangnom/call" and r[8] for r in out.obs["span_records"])
        # the CPU runs the plain path: no launch, no kernel, no reading
        assert not out.obs["launch_kernels"]
        for m in ("wide_step_us", "luma_roofline_pct", "chroma_roofline_pct"):
            assert m not in line["metrics"]
        assert "host_issue_ms" in line["metrics"]
    else:
        assert "launch_kernels" not in out.obs


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_reads_not_correct(fault):
    cell = tiny_cell(CELL)
    entry, fn, _ = api_call.entry_of(cell)
    bad = faults.broken(lambda clip, **kw: fn(clip), entry, fault)
    out = launches.run(cell, call=lambda clip: bad(clip))
    assert not _line(cell, out)["correct"] and out.failed > 0


def test_sse2_control_reads_not_correct():
    cell = tiny_cell(CELL)
    line = _line(cell, control_run(cell))
    assert not line["correct"] and line["checks"]["px_mismatch"]["value"] > 0


def test_the_cells_work():
    _, config, traffic = harness.find_cell(harness.load_spec(), CELL)
    assert (config["width"], config["height"], traffic["frames"]) == (2160, 3840, 24)
    work = harness.work(traffic["work"]).call_work(config, traffic)
    assert work == (447897600, 24497048160)
    # bound by operations: 0.732 ms a call at peak
    assert peaks.least_seconds(*work) == pytest.approx(24497048160 / peaks.PEAK_INT32_S)


OFF = 100_000  # the trace's clock minus the records'
K4 = "void shard_full_kernel<unsigned char, false, 4, true>(...)"
K1 = "void deint_kernel<unsigned char, false, 4>(...)"


def _rec(i, parent, name, s, e, mirrored=False, **counts):
    """A record of call 1 whose times are given on the trace's clock."""
    return (i, parent, 1, "MainThread", name, s - OFF, e - OFF, counts, mirrored)


RECORDS = [
    _rec(1, 0, "sangnom/call", 1100, 4900, mirrored=True),
    _rec(2, 1, "sangnom/plane", 1200, 2900, mirrored=True, plane=0, cluster_fields=24,
         wide_row_steps=46056),
    _rec(3, 2, "sangnom/launch", 2000, 2500, kernel="shard_full_kernel", steps=1919, k=4),
    _rec(4, 1, "sangnom/plane", 3000, 4800, mirrored=True, plane="uv", overlap_passes=1),
    _rec(5, 4, "sangnom/launch", 3500, 4000, kernel="deint_kernel"),
    _rec(6, 2, "sangnom/launch", 2600, 2800, kernel="shard_full_kernel", steps=1, k=4),
]
EVENTS = [
    ("user_annotation", "bench.call", 1000, 5000, None),
    ("user_annotation", "bench.sync", 5000, 14000, None),
    ("cpu_op", "sangnom/call", 1100, 4900, None),
    ("cpu_op", "sangnom/plane", 1200, 2900, None),
    ("cpu_op", "sangnom/plane", 3000, 4800, None),
    ("cuda_runtime", "cudaLaunchKernel", 1300, 1350, 9),  # the kept-row copy, outside a launch span
    ("cuda_runtime", "cudaLaunchKernelExC", 2100, 2200, 7),
    ("cuda_runtime", "cudaLaunchKernelExC", 2650, 2700, 6),
    ("cuda_runtime", "cudaLaunchKernel", 3600, 3700, 8),
    ("kernel", "elementwise_kernel", 1400, 1500, 9),
    ("kernel", K4, 5000, 9000, 7),
    ("kernel", K1, 6000, 8000, 8),
    ("kernel", K4, 9000, 16000, 6),  # runs past the stretch: 5000 ns of 7000 inside
]


def test_each_kernel_goes_to_the_launch_span_of_its_call():
    got = launches.attribute(RECORDS, EVENTS)
    assert got == {
        "shard_full_kernel": {"kernel_s": pytest.approx(9000e-9), "kernels": 2, "launches": 2,
                              "steps": pytest.approx(1919 + 5 / 7)},
        "deint_kernel": {"kernel_s": pytest.approx(2000e-9), "kernels": 1, "launches": 1,
                         "steps": 0}}
    assert launches.attribute(RECORDS, EVENTS[::-1]) == got


def test_a_dropped_launch_call_leaves_its_kernel_and_span_out():
    evs = [e for e in EVENTS if e[4] != 6 or e[0] == "kernel"]
    got = launches.attribute(RECORDS, evs)["shard_full_kernel"]
    assert got == {"kernel_s": pytest.approx(4000e-9), "kernels": 1, "launches": 1,
                   "steps": 1919}
    # a kernel with no launch call's id
    evs = [e if e[4] != 7 else e[:4] + (None,) for e in EVENTS]
    got = launches.attribute(RECORDS, evs)["shard_full_kernel"]
    assert (got["kernels"], got["steps"]) == (1, pytest.approx(5 / 7))


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_a_launch_cut_by_the_stretch_counts_its_steps_inside(cut):
    """A launch of 1000 steps whose kernel runs 8000 ns, of which 2000,
    8000 or 5000 lie inside the stretch (cut at its start, whole, cut at
    its end), counts 250, 1000 or 625 steps, so the step time reads the
    same 8 ns."""
    s0, t0, t1 = (-6000, 1000, 5000)[cut], 0, 10_000
    recs = [_rec(1, 0, "sangnom/call", 100, 200, mirrored=True),
            _rec(2, 1, "sangnom/launch", 300, 400, kernel="shard_full_kernel", steps=1000)]
    evs = [("user_annotation", "bench.call", t0, t1, None),
           ("cpu_op", "sangnom/call", 100, 200, None),
           ("cuda_runtime", "cudaLaunchKernelExC", 320, 340, 5),
           ("kernel", K4, s0, s0 + 8000, 5)]
    got = launches.attribute(recs, evs)["shard_full_kernel"]
    inside = min(s0 + 8000, t1) - max(s0, t0)
    assert got["steps"] == pytest.approx(1000 * inside / 8000)
    assert got["kernel_s"] == pytest.approx(inside * 1e-9)
    assert harness.reader("wide_step_us")({"launch_kernels": {"shard_full_kernel": got}}) == \
        pytest.approx(1e-3 * 8)


def test_wide_step_us():
    read = harness.reader("wide_step_us")
    obs = {"launch_kernels": launches.attribute(RECORDS, EVENTS)}
    assert read(obs) == pytest.approx(1e6 * 9000e-9 / (1919 + 5 / 7))
    # a program whose K4 spans count no steps (the parent's), no spans, no
    # mirrored span to fix the clock, no stretch, no launch calls, no K4
    stepless = [r[:7] + ({k: v for k, v in r[7].items() if k != "steps"},) + r[8:]
                for r in RECORDS]
    unmirrored = [r[:8] + (False,) for r in RECORDS]
    no_k4 = [r for r in RECORDS if r[7].get("kernel") != "shard_full_kernel"]
    for recs, evs in ((stepless, EVENTS), ([], EVENTS), (unmirrored, EVENTS),
                      (RECORDS, EVENTS[2:]), (no_k4, EVENTS),
                      (RECORDS, [e for e in EVENTS if e[0] != "cuda_runtime"])):
        assert read({"launch_kernels": launches.attribute(recs, evs)}) is None
    assert read({}) is None


def test_k4_shapes_and_a_calls_counters():
    assert launches.k4_shapes(RECORDS) == {
        (4, None, 1919, None, None, None, None, None): 1,
        (4, None, 1, None, None, None, None, None): 1}
    assert launches.call_counters(RECORDS) == {(24, 46056, 1): 1}


@pytest.mark.cuda
def test_traced_run_on_card_reads_the_step(cuda):
    cell = tiny_cell(CELL, seconds=2.0, trace=True, device=cuda, width=2160, height=64)
    out = launches.run(cell)
    line = _line(cell, out)
    assert line["correct"]
    k4 = out.obs["launch_kernels"]["shard_full_kernel"]
    assert k4["launches"] == k4["kernels"] > 0 and k4["steps"] <= 31 * k4["launches"]
    assert k4["steps"] > 31 * (k4["launches"] - 2)
    assert line["metrics"]["wide_step_us"]["value"] > 0
    for m in ("luma_roofline_pct", "chroma_roofline_pct"):
        assert 0 < line["metrics"][m]["value"] < 105
