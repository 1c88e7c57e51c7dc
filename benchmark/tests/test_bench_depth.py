"""The harness on samples deeper than 8 bits: a 10-bit 4:2:2 1080i bob
(SMPTE ST 274 at 10 bits, the HD-SDI master format) on the cells' traffic
mixes.  On the CPU at tiny size a sound run comes out correct, and each
planted fault and the depth control come out not correct.  On the card,
at full size, the reference on the card equals the reference on the CPU,
the depth control comes out not correct, and the program's own run is
judged.  No cell of `BENCHMARK.json` runs this configuration yet."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness, inputs, reference
from benchmark.drivers import api_call
from benchmark.tests import faults
from benchmark.tests.controls import control_run
from benchmark.tests.conftest import tiny_cell

API = ["bob1080i.api", "maa2160p.api", "bob1080i.compat"]


def deep(cell: harness.Cell) -> harness.Cell:
    """``cell`` with its frames at 10 bits, 4:2:2."""
    config = dict(cell.config, format="YUV422P10", bits=10, plane_shifts=[[0, 0], [1, 0], [1, 0]])
    return harness.Cell(**{**cell.__dict__, "config": config})


def _line(cell, out) -> dict:
    return harness.result_line(harness.load_spec(), cell, out, cell.device)


@pytest.mark.parametrize("name", API)
def test_deep_cell_sound(name):
    cell = deep(tiny_cell(name))
    out = api_call.run(cell)
    assert _line(cell, out)["correct"] and out.attempted >= cell.traffic["sample_calls"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", API)
def test_deep_cell_catches_fault(name, fault):
    cell = deep(tiny_cell(name))
    entry, fn, _ = api_call.entry_of(cell)
    bad = faults.broken(lambda clip, **kw: fn(clip), entry, fault)
    out = api_call.run(cell, call=lambda clip: bad(clip))
    assert not _line(cell, out)["correct"] and out.failed > 0


@pytest.mark.parametrize("name", API)
def test_deep_cell_control_fails(name):
    cell = deep(tiny_cell(name))
    line = _line(cell, control_run(cell))
    assert not line["correct"] and line["checks"]["px_mismatch"]["value"] > 0


SEEDS = [2**31 + 101, 2**33 + 7, 3_900_000_021]


@pytest.mark.cuda
def test_deep_bob_at_full_size_on_card(cuda, capsys):
    """The 10-bit 4:2:2 1080i bob, 60 frames a call, 2 clips, a 2 s window.
    The first seed's first clip goes through the reference on the card and
    on the CPU, which must agree; then on each seed the depth control's run
    and the program's, judged as a cell's run is, a JSON line each."""
    config, traffic = harness.cell_files("bob1080i.api")
    cells = [deep(harness.Cell(name="bob1080i.api", config=config, traffic=traffic, seed=seed,
                               seconds=2.0, trace=False, t0=0.0, device=cuda))
             for seed in SEEDS]
    _, _, kwargs = api_call.entry_of(cells[0])
    planes = inputs.frames(cells[0].config, traffic["frames"], inputs.generator(SEEDS[0], cuda), cuda)
    on_card = reference.run("bob", planes, 10, True, kwargs)
    on_cpu = reference.run("bob", [p.cpu() for p in planes], 10, True, kwargs)
    assert on_card[1] == on_cpu[1]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card[0], on_cpu[0]))
    del planes, on_card, on_cpu
    results = []
    for cell in cells:
        cell.t0 = time.perf_counter()
        ctl = _line(cell, control_run(cell))
        cell.t0 = time.perf_counter()
        got = _line(cell, api_call.run(cell))
        results.append((got, ctl))
        with capsys.disabled():
            print(json.dumps({"seed": cell.seed, "program": got, "control": ctl["checks"]}),
                  flush=True)
    assert not any(ctl["correct"] for _, ctl in results)
    assert all(got["correct"] for got, _ in results)
