"""The control (`controls.py`: the program's SSE2 numerics at 8 bits, the
top 8 bits of deeper samples; `test_bench_depth.py` runs the latter) comes
out not correct in every cell: on the CPU at tiny size, and on the card at
a size a test run holds.  At the cells' own sizes it is run as
``python3 -m benchmark.tests.controls``."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, tiny_cell
from benchmark.tests.controls import control_run


def _control_fails(cell):
    out = control_run(cell)
    line = harness.result_line(harness.load_spec(), cell, out, cell.device)
    assert not line["correct"]
    assert line["checks"]["px_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_cpu(name):
    _control_fails(tiny_cell(name, seconds=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(cuda, name):
    _control_fails(tiny_cell(name, seconds=1.0, device=cuda, width=640, height=240))
