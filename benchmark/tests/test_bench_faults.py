"""The harness on the CPU at tiny sizes, the look for a card skipped: a
sound run comes out correct, and each fault a cell can have, planted under
the timed path, makes it come out not correct."""

from __future__ import annotations

import sys

import pytest

from benchmark import harness
from benchmark.drivers import api_call, cli_stream
from benchmark.tests import faults
from benchmark.tests.conftest import tiny_cell

API = ["bob1080i.api", "maa2160p.api", "bob1080i.compat"]


def _correct(cell, out) -> bool:
    return harness.result_line(harness.load_spec(), cell, out, "cpu")["correct"]


@pytest.mark.parametrize("name", API)
def test_api_cell_sound(name):
    cell = tiny_cell(name)
    out = api_call.run(cell)
    assert _correct(cell, out) and out.attempted >= cell.traffic["sample_calls"]
    assert out.obs["frames"] > 0 and out.obs["window_s"] >= cell.seconds


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", API)
def test_api_cell_catches_fault(name, fault):
    cell = tiny_cell(name)
    entry, fn, kwargs = api_call.entry_of(cell)
    bad = faults.broken(lambda clip, **kw: fn(clip), entry, fault)
    out = api_call.run(cell, call=lambda clip: bad(clip))
    assert not _correct(cell, out)
    assert out.failed > 0


def test_api_traced_run_reports_per_layer_metrics_it_can_read():
    cell = tiny_cell("bob1080i.api", trace=True, seconds=1.0)
    out = api_call.run(cell)
    line = harness.result_line(harness.load_spec(), cell, out, "cpu")
    assert line["correct"] and list(line)[-1] == "checks"
    assert "host_issue_ms" in line["metrics"]
    assert "frames_per_s" not in line["metrics"]


def test_stream_cell_sound():
    cell = tiny_cell("bob1080i.stream", trace=True, seconds=1.0)
    out = cli_stream.run(cell)
    assert _correct(cell, out)
    assert out.obs["stream_frames"] > 0 and out.obs["cpu_s"] > 0
    for m in ("stream_frames_per_s", "host_cpu_ms_per_frame.stream"):
        assert harness.reader(m)(out.obs) > 0


@pytest.mark.parametrize("child", [
    [sys.executable, "benchmark/tests/copy_child.py"],
    *([sys.executable, "-m", "benchmark.tests.faulty_child", f] for f in ("half", "altered")),
], ids=["unchanged", "half", "altered"])
def test_stream_cell_catches_fault(child):
    cell = tiny_cell("bob1080i.stream", seconds=1.0)
    out = cli_stream.run(cell, child_argv=child)
    assert not _correct(cell, out)
