"""The harness on the CPU: every cell resolves by name, the work counts
match the measuring code they were copied from, the contract's limits on
BENCHMARK.json hold, nothing banned is imported, and the trace reduction
and the metric readers compute what they say."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, inputs, peaks, trace
from benchmark.work import main as work_main
from benchmark.work import pool as work_pool

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell, monkeypatch):
    monkeypatch.chdir(ROOT)
    entry, config, traffic = harness.find_cell(SPEC, cell)
    assert callable(harness.driver(traffic["driver"]).run)
    if "work" in traffic:
        nbytes, ops = harness.work(traffic["work"]).call_work(config, traffic)
        assert nbytes > 0 and ops > 0
    assert traffic["why"] == entry["why"]
    for trace_on in (False, True):
        metrics = harness.metrics_of(SPEC, cell, trace_on)
        assert metrics
        for m in metrics:
            assert callable(harness.reader(m["name"]))
    names = {m["name"] for m in harness.metrics_of(SPEC, cell, False)}
    assert "setup_s" in names and len(names) >= 2


def test_spec_keeps_the_contracts_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    everything = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(set(names)) == len(names)
    for x in everything:
        assert NAME.match(x["name"]), x["name"]
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] and "\t" not in x[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {x["name"] for x in harness.metrics_of(SPEC, cell, False)}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_work_matches_the_measuring_code_it_copies():
    chip_smoke = pytest.importorskip("chip_smoke")
    for n, bufH, w, S in [(120, 540, 1920, 1920), (240, 270, 960, 987),
                          (24, 1080, 3840, 3840), (48, 540, 1920, 1947)]:
        assert work_main.deint_work(n, bufH, w, S) == chip_smoke.deint_work(n, bufH, w, S)
    for P, S, bufH_p, w in [(540, 1920, 540, 1920), (540, 1920, 270, 960)]:
        assert work_pool.pool_fused_work(P, S, bufH_p, w) == chip_smoke.pool_fused_work(P, S, bufH_p, w)
    from sangnom_tpu_torch.utils import cost_model

    assert (peaks.PEAK_BYTES_S, peaks.PEAK_INT32_S) == (cost_model.PEAK_BYTES_S, cost_model.PEAK_INT32_S)
    assert (peaks.OPS_PREPARE, peaks.OPS_SMOOTH, peaks.OPS_FINALIZE) == (
        cost_model.OPS_PREPARE, cost_model.OPS_SMOOTH, cost_model.OPS_FINALIZE)


@pytest.mark.parametrize("cell,work", [
    ("bob1080i.api", (559872000, 30501482400)),
    ("maa2160p.api", (447897600, 24368594400)),
    ("bob1080i.compat", (2739302400, 6282670080)),
])
def test_work_of_the_8_bit_cells(cell, work):
    """Bytes and operations a call, as counted since the cells were made."""
    _, config, traffic = harness.find_cell(SPEC, cell, ROOT)
    assert harness.work(traffic["work"]).call_work(config, traffic) == work


def test_work_counts_samples_at_their_stored_size():
    """A 10-bit 4:2:2 bob: 2 bytes a sample, chroma as tall as luma, and the
    smoothing's decay bound from the uint16 pixel type (14 rows, not 9)."""
    config, traffic = harness.cell_files("bob1080i.api")
    deep = dict(config, format="YUV422P10", bits=10, plane_shifts=[[0, 0], [1, 0], [1, 0]])
    assert work_main.smoothed_columns(960, 540, 1920, 0xFFFF) == 960 + 3 * 14 + 6
    assert work_main.smoothed_columns(960, 540, 1920, 0xFF) == 960 + 3 * 7 + 6
    assert work_main.call_work(deep, traffic) == (1492992000, 41043340800)
    nbytes_8, _ = work_pool.call_work(dict(config, bits=8), dict(traffic, frames=8))
    nbytes_10, _ = work_pool.call_work(dict(config, bits=10), dict(traffic, frames=8))
    # the pool's own bytes stay int32; each pass's kept rows in and rows out double
    assert nbytes_10 - nbytes_8 == 16 * (1079 * 1920 + 2 * 539 * 960)


@pytest.mark.parametrize("seed,w,h,n,digest", [
    (2**31 + 17, 64, 32, 3, "53ca87ae641af8415dd1a3d2e8b9b62d11c3924132d035b2290023d12a7eee04"),
    (2**40 + 3, 60, 24, 2, "7cb574fcc1a909a8e4a95755014bf240d4c6f23d07500cc67eb02198fec050ee"),
])
def test_8_bit_draws_are_unchanged(seed, w, h, n, digest):
    """Two clips of 8-bit frames from one seed, as the drivers draw them,
    hash as they did before deeper samples were drawn."""
    import hashlib

    config, _ = harness.cell_files("bob1080i.api")
    config = dict(config, width=w, height=h)
    gen = inputs.generator(seed, "cpu")
    sha = hashlib.sha256()
    for _ in range(2):
        for p in inputs.frames(config, n, gen, "cpu"):
            assert p.dtype == torch.uint8
            sha.update(p.numpy().tobytes())
    assert sha.hexdigest() == digest


def test_deeper_draws_are_uint16_over_the_depth():
    config, _ = harness.cell_files("bob1080i.api")
    for bits in (10, 12, 16):
        deep = dict(config, width=64, height=32, bits=bits)
        planes = inputs.frames(deep, 4, inputs.generator(3, "cpu"), "cpu")
        assert all(p.dtype == torch.uint16 for p in planes)
        top = max(int(p.to(torch.int32).max()) for p in planes)
        assert (1 << bits) - 64 <= top < 1 << bits
    with pytest.raises(ValueError):
        inputs.frames(dict(config, bits=32), 1, inputs.generator(3, "cpu"), "cpu")


def test_bob_work_bound():
    """The bob call's least time is its operations' (about 0.91 ms)."""
    _, config, traffic = harness.find_cell(SPEC, "bob1080i.api", ROOT)
    nbytes, ops = work_main.call_work(config, traffic)
    assert ops / peaks.PEAK_INT32_S > nbytes / peaks.PEAK_BYTES_S
    assert 0.90e-3 < peaks.least_seconds(nbytes, ops) < 0.92e-3


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_nothing_banned():
    mods = _loaded(
        "from benchmark import harness, run, trace, reference, inputs, peaks\n"
        "from benchmark.drivers import api_call, cli_stream, cli_child\n"
        "from benchmark.work import main, pool\n"
        "import glob\n"
        "for f in glob.glob('benchmark/metrics/*.py'):\n"
        "    harness.reader(f.split('/')[-1][:-3])\n"
        "import sangnom_tpu_torch, sangnom_tpu_torch.cli\n")
    assert not mods & set(harness.BANNED)


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import benchmark.reference")
    assert not mods & {"sangnom_tpu_torch", *harness.BANNED}


def test_banned_names_compare_whole():
    assert "sangnom_tpu_torch" not in harness.BANNED
    sys.modules.setdefault("sangnom_tpu_torch", sys.modules[__name__])
    assert "sangnom_tpu_torch" not in harness.banned_modules()


def _ev(kind, name, s, e):
    return (kind, name, int(s * 1000), int(e * 1000))


def test_trace_reduce():
    evs = [_ev("user_annotation", "bench.call", 0, 10),
           _ev("user_annotation", "bench.sync", 10, 100),
           _ev("cpu_op", "aten::cat", 2, 8),
           _ev("kernel", "k1", 5, 40), _ev("kernel", "k1", 30, 60),
           _ev("gpu_memcpy", "Memcpy HtoD", 70, 80),
           _ev("kernel", "late", 95, 130),
           _ev("cuda_runtime", "cudaDeviceSynchronize", 60, 100),
           _ev("gpu_user_annotation", "sangnom/x", 0, 100)]
    red = trace.reduce(evs)
    assert red["stretch_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(70e-6)  # 5-60, 70-80, 95-100
    assert red["kernels"] == 3 and red["kernel_s"] == pytest.approx((35 + 30 + 5) * 1e-6)
    assert red["device_ops"][0] == ["k1", pytest.approx(65e-6)]
    gaps = dict(red["idle_gaps"])
    assert gaps["aten::cat"] == pytest.approx(5e-6)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(25e-6)
    assert trace.idle_pct(red) == pytest.approx(30.0)
    assert trace.reduce([e for e in evs if not e[1].startswith("bench.")]) is None


def test_readers():
    obs = {"setup_s": 3.5, "window_s": 2.0, "frames": 600, "call_s": [0.01] * 19 + [0.5],
           "quiet_call_s": [0.02] * 19 + [0.5],
           "issue_s": [0.001, 0.003], "work": (3.35e9, 0),
           "trace": {"stretch_s": 1.0, "busy_s": 0.75, "kernels": 6, "kernel_s": 0.5,
                     "calls": 5, "frames": 600},
           "stream_frames": 400, "cpu_s": 2.0}
    r = {m: harness.reader(m)(obs) for m in (
        "setup_s", "frames_per_s", "call_ms_p95", "call_ms_p95.compat",
        "stream_frames_per_s", "device_idle_pct",
        "device_idle_pct.stream", "filter_roofline_pct", "kernels_per_frame",
        "host_issue_ms", "host_cpu_ms_per_frame.stream")}
    assert r["setup_s"] == 3.5 and r["frames_per_s"] == 300
    assert r["call_ms_p95"] == pytest.approx(10.0)
    assert r["call_ms_p95.compat"] == pytest.approx(20.0)
    assert r["stream_frames_per_s"] == 200
    assert r["device_idle_pct"] == r["device_idle_pct.stream"] == pytest.approx(25.0)
    assert r["filter_roofline_pct"] == pytest.approx(1.0)  # 5 calls of 1 ms over 0.5 s
    assert r["kernels_per_frame"] == 0.01
    assert r["host_issue_ms"] == pytest.approx(2.0)
    assert r["host_cpu_ms_per_frame.stream"] == 5.0
    assert all(harness.reader(m)({}) is None for m in r if m != "setup_s")


def test_run_refuses_without_a_card(tmp_path):
    """No card: exit 2 and no result line, also in a directory that holds
    only BENCHMARK.json and the benchmark."""
    import shutil

    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "bob1080i.api",
                              "--seed", "1", "--seconds", "1"], cwd=cwd,
                             capture_output=True, text=True)
        assert out.returncode == 2 and out.stdout == ""
