"""The cell `yuv422p10_1080i.api` (the 10-bit 4:2:2 1080i bob through the
API) and its driver `api_call_planes`.  On the CPU at tiny size: a sound
run is correct, traced or not; each planted fault and the depth control
come out not correct.  On hand-built records and events: each kernel goes
to one plane group by its launch call's correlation id, a dropped launch
call leaves the others attributed, and without spans or a match the
readers give None.  The cell's work counts, whole and by plane group.  On
the card, a traced run attributes every field kernel to a group."""

from __future__ import annotations

import pytest

from benchmark import harness, peaks
from benchmark.drivers import api_call, api_call_planes as planes
from benchmark.tests import faults
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.controls import control_run

CELL = "yuv422p10_1080i.api"


def _line(cell, out) -> dict:
    return harness.result_line(harness.load_spec(), cell, out, cell.device)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    from sangnom_tpu_torch.utils import profiling

    cell = tiny_cell(CELL, trace=traced, seconds=1.0 if traced else 0.5)
    out = planes.run(cell)
    line = _line(cell, out)
    assert line["correct"] and out.attempted >= cell.traffic["sample_calls"]
    assert cell.config["format"] == "YUV422P10" and cell.traffic["driver"] == "api_call_planes"
    assert not profiling._ON
    if traced:
        recs = out.obs["span_records"]
        assert any(r[4] == "sangnom/call" and r[8] for r in recs)
        # the CPU runs the plain path: no launch, no kernel, no reading
        assert out.obs["plane_kernels"] in (None, {"groups": {}, "field_kernel_s": 0.0,
                                                   "field_attributed_s": 0.0})
        assert "luma_roofline_pct" not in line["metrics"]
        assert "chroma_roofline_pct" not in line["metrics"]
        assert "host_issue_ms" in line["metrics"]
    else:
        assert "span_records" not in out.obs


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_reads_not_correct(fault):
    cell = tiny_cell(CELL)
    entry, fn, _ = api_call.entry_of(cell)
    bad = faults.broken(lambda clip, **kw: fn(clip), entry, fault)
    out = planes.run(cell, call=lambda clip: bad(clip))
    assert not _line(cell, out)["correct"] and out.failed > 0


def test_depth_control_reads_not_correct():
    cell = tiny_cell(CELL)
    line = _line(cell, control_run(cell))
    assert not line["correct"] and line["checks"]["px_mismatch"]["value"] > 0


def test_the_cells_work_whole_and_by_plane_group():
    _, config, traffic = harness.find_cell(harness.load_spec(), CELL)
    assert harness.work(traffic["work"]).call_work(config, traffic) == (1492992000, 41043340800)
    work = planes.group_work(config, traffic)
    assert work["0"] == (746496000, 20242252800)
    assert work["uv"] == (746496000, 20801088000)
    assert tuple(map(sum, zip(work["0"], work["uv"]))) == (1492992000, 41043340800)
    # bound by operations: 0.605 ms of luma, 0.622 ms of U+V at peak
    assert peaks.least_seconds(*work["0"]) == pytest.approx(20242252800 / peaks.PEAK_INT32_S)
    assert peaks.least_seconds(*work["uv"]) == pytest.approx(20801088000 / peaks.PEAK_INT32_S)


OFF = 100_000  # the trace's clock minus the records'
FIELD = "void deint_kernel<unsigned short, false, 4>(...)"


def _rec(i, parent, name, s, e, mirrored=False, **counts):
    """A record of call 1 whose times are given on the trace's clock."""
    return (i, parent, 1, "MainThread", name, s - OFF, e - OFF, counts, mirrored)


RECORDS = [
    _rec(1, 0, "sangnom/call", 1100, 4900, mirrored=True),
    _rec(2, 1, "sangnom/plane", 1200, 2900, mirrored=True, plane="uv"),
    _rec(3, 2, "sangnom/launch", 2000, 2500),
    _rec(4, 1, "sangnom/plane", 3000, 4800, mirrored=True, plane=0),
    _rec(5, 4, "sangnom/launch", 3500, 4000),
]
EVENTS = [
    ("user_annotation", "bench.call", 1000, 5000, None),
    ("user_annotation", "bench.sync", 5000, 14000, None),
    ("cpu_op", "sangnom/call", 1100, 4900, None),
    ("cpu_op", "sangnom/plane", 1200, 2900, None),
    ("cpu_op", "sangnom/plane", 3000, 4800, None),
    ("cuda_runtime", "cudaLaunchKernel", 1300, 1350, 9),  # the U/V cat, outside a launch span
    ("cuda_runtime", "cudaLaunchKernel", 2100, 2200, 7),
    ("cuda_runtime", "cudaLaunchKernel", 3600, 3700, 8),
    ("kernel", "CatArrayBatchedCopy", 1400, 1500, 9),
    ("kernel", FIELD, 5000, 9000, 7),
    ("kernel", FIELD, 9000, 16000, 8),  # runs past the stretch: 5000 ns inside
]


def test_each_kernel_goes_to_the_plane_span_of_its_launch_call():
    got = planes.attribute(RECORDS, EVENTS)
    assert got["groups"] == {"uv": {"kernel_s": 4000 * 1e-9, "kernels": 1},
                             "0": {"kernel_s": 5000 * 1e-9, "kernels": 1}}
    assert got["field_kernel_s"] == got["field_attributed_s"] == 9000 * 1e-9
    # the order of the events does not matter, only the ids
    assert planes.attribute(RECORDS, EVENTS[::-1]) == got


def test_a_dropped_launch_call_leaves_the_others_attributed():
    evs = [e for e in EVENTS if e[4] != 8 or e[0] == "kernel"]
    got = planes.attribute(RECORDS, evs)
    assert got["groups"] == {"uv": {"kernel_s": 4000 * 1e-9, "kernels": 1}}
    assert (got["field_kernel_s"], got["field_attributed_s"]) == (9000 * 1e-9, 4000 * 1e-9)
    # a kernel with no launch call's id, or a call outside every launch span
    evs = [e if e[4] != 7 else e[:4] + (None,) for e in EVENTS]
    assert planes.attribute(RECORDS, evs)["groups"] == {"0": {"kernel_s": 5000 * 1e-9, "kernels": 1}}


def _obs(records, events, calls=1):
    _, config, traffic = harness.find_cell(harness.load_spec(), CELL)
    return {"plane_kernels": planes.attribute(records, events),
            "plane_work": planes.group_work(config, traffic),
            "trace": {"calls": calls}}


def test_the_readers():
    luma, chroma = harness.reader("luma_roofline_pct"), harness.reader("chroma_roofline_pct")
    obs = _obs(RECORDS, EVENTS, calls=2)
    assert luma(obs) == pytest.approx(100 * 2 * (20242252800 / peaks.PEAK_INT32_S) / (5000 * 1e-9))
    assert chroma(obs) == pytest.approx(100 * 2 * (20801088000 / peaks.PEAK_INT32_S) / (4000 * 1e-9))
    # no spans, no mirrored span to fix the clock, no stretch, no match, no calls
    unmirrored = [r[:8] + (False,) for r in RECORDS]
    for obs in (_obs([], EVENTS), _obs(unmirrored, EVENTS), _obs(RECORDS, EVENTS[2:]),
                _obs(RECORDS, [e for e in EVENTS if e[0] != "cuda_runtime"]),
                _obs(RECORDS, EVENTS, calls=0), {}):
        assert luma(obs) is None and chroma(obs) is None


def test_events_keep_what_the_attribution_reads():
    data = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": FIELD, "ts": 1.5, "dur": 2.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 0.25,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 1.0, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": "bench.call", "ts": 0.5, "dur": 3},
        {"ph": "X", "cat": "cpu_op", "name": "sangnom/plane", "ts": 0.75, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 0.8, "dur": 0.1},
        {"ph": "i", "cat": "kernel", "name": FIELD, "ts": 2},
    ]}
    assert planes.events_of(data) == [
        ("kernel", FIELD, 1500, 3500, 7), ("cuda_runtime", "cudaLaunchKernel", 1000, 1250, 7),
        ("user_annotation", "bench.call", 500, 3500, None),
        ("cpu_op", "sangnom/plane", 750, 1750, None)]


@pytest.mark.cuda
def test_traced_run_on_card_attributes_every_field_kernel(cuda):
    cell = tiny_cell(CELL, seconds=2.0, trace=True, device=cuda, width=640, height=240)
    out = planes.run(cell)
    line = _line(cell, out)
    assert line["correct"]
    pk = out.obs["plane_kernels"]
    assert set(pk["groups"]) == {"0", "uv"}
    assert pk["field_attributed_s"] >= 0.95 * pk["field_kernel_s"] > 0
    for m in ("luma_roofline_pct", "chroma_roofline_pct"):
        assert 0 < line["metrics"][m]["value"] < 105
