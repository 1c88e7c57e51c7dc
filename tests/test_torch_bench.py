"""The port's headline bench (sangnom_tpu_torch.bench) on the CPU at tiny sizes.

- Its regression gate gives the root ``bench.py``'s results on every case of
  ``tests/test_bench_gate.py`` that feeds the gate explicit records.
- Its history is the card's own: ``results/cuda_bench_*.json``.
- A tiny run prints the root bench's JSON keys (the utilization keys renamed,
  ``device`` and ``build_s`` added), every parity gate ok.
- A corrupted filter output fails each of its four gates with exit 1.
- Its inputs are the root bench's draws, in the root bench's order.
- It imports nothing of JAX, ``sangnom_tpu`` or the root ``bench``; without a
  card it exits 2 unless ``--device cpu`` is given.
- The SSE2 baseline runs the committed harness binary when no reference tree
  is given, and falls back to the recorded figure, labelled as another
  host's, when the binary cannot run.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench as root_bench  # noqa: E402  (no JAX at module level)

from sangnom_tpu_torch import Clip  # noqa: E402
from sangnom_tpu_torch import bench  # noqa: E402

TINY_KW = dict(width=48, field_height=12, fields=4, calls=2, trials=2, cfg_frames=2,
               cfg_calls=1, cfg_windows=2, pool_frames=4, pool_width_unaligned=40,
               pool_calls=1, pool_windows=2, sse2_frames=1, sse2_runs=1)
# (width, height) of each BASELINE.json case at the tiny size, in CASES order
TINY_DIMS = ((32, 16), (32, 16), (48, 12), (48, 24), (32, 16))


def tiny_sizes(b):
    cases = tuple((n, f, w, h, kw) for (n, f, _, _, kw), (w, h) in zip(b.CASES, TINY_DIMS))
    return dataclasses.replace(b.FULL, cases=cases, **TINY_KW)


TINY = tiny_sizes(bench)


# --- the gate: each explicit-record case of test_bench_gate.py -------------

def _rec(value=None, configs=None, wrap=True, **extra):
    rec = {"metric": "1080p_bob_dh_fps_per_chip"}
    if value is not None:
        rec["value"] = value
    if configs is not None:
        rec["configs"] = configs
    rec.update(extra)
    return {"parsed": rec, "rc": 0} if wrap else rec


def _flatten_wrapped_and_raw(m, tmp_path):
    cfgs = {"cfg1": {"fps": 100.0, "parity": "ok"},
            "cfg2": {"fps": 50.0, "parity": "FAIL"}}
    flat_w = m.flatten_bench(_rec(value=10.0, configs=cfgs, order1_dh_fps=12.0))
    flat_r = m.flatten_bench(_rec(value=10.0, configs=cfgs, order1_dh_fps=12.0, wrap=False))
    assert flat_w == flat_r
    assert flat_w["value"] == 10.0 and flat_w["order1_dh_fps"] == 12.0
    assert "configs.cfg1" in flat_w and "configs.cfg2" not in flat_w
    return flat_w


def _flatten_skips_null_and_nonnumeric(m, tmp_path):
    flat = m.flatten_bench(_rec(value=5.0, pool_compat_fps=None, order1_dh_fps="n/a"))
    assert flat == {"value": 5.0}
    return flat


def _best_of_history_and_pass(m, tmp_path):
    hist = [_rec(value=5700.0), _rec(value=5950.0), _rec(value=5800.0)]
    gate = m.check_regression(_rec(value=5500.0, wrap=False), hist, tolerance=0.10)
    assert gate["ok"] and gate["regressions"] == []
    assert gate["best"]["value"] == 5950.0
    return gate


def _regression_flagged_below_tolerance(m, tmp_path):
    hist = [_rec(value=6000.0, configs={"cfgA": {"fps": 9000.0, "parity": "ok"}})]
    cur = _rec(value=5900.0, configs={"cfgA": {"fps": 6000.0, "parity": "ok"}}, wrap=False)
    gate = m.check_regression(cur, hist, tolerance=0.10)
    assert not gate["ok"]
    assert [r["metric"] for r in gate["regressions"]] == ["configs.cfgA"]
    r = gate["regressions"][0]
    assert r["best"] == 9000.0 and r["current"] == 6000.0
    assert abs(r["drop_pct"] - 33.3) < 0.1
    return gate


def _boundary_exactly_at_tolerance_passes(m, tmp_path):
    gate = m.check_regression(_rec(value=900.0, wrap=False), [_rec(value=1000.0)],
                              tolerance=0.10)
    assert gate["ok"]  # the floor is strictly below best * (1 - tol)
    return gate


def _new_metric_without_history_passes(m, tmp_path):
    cur = _rec(value=1000.0, configs={"new_cfg": {"fps": 1.0, "parity": "ok"}}, wrap=False)
    gate = m.check_regression(cur, [_rec(value=1000.0)])
    assert gate["ok"]
    return gate


def _metric_absent_this_run_passes(m, tmp_path):
    hist = [_rec(value=1000.0, configs={"cfgA": {"fps": 9000.0, "parity": "ok"}})]
    gate = m.check_regression(_rec(value=990.0, wrap=False), hist)
    assert gate["ok"]
    return gate


def _history_loader_skips_garbage(m, tmp_path):
    # each bench reads its own history: BENCH_r*.json at the root for the
    # JAX bench, results/cuda_bench_*.json for the port
    if m is root_bench:
        paths = [tmp_path / f"BENCH_r0{i}.json" for i in (1, 2, 3)]
    else:
        paths = [tmp_path / "results" / f"cuda_bench_r0{i}.json" for i in (1, 2, 3)]
    paths[0].parent.mkdir(parents=True, exist_ok=True)
    paths[0].write_text(json.dumps(_rec(value=100.0)))
    paths[1].write_text("{not json")
    paths[2].write_text(json.dumps(_rec(value=200.0)))
    hist = m.load_bench_history(tmp_path)
    assert len(hist) == 2
    gate = m.check_regression(_rec(value=100.0, wrap=False), hist)
    assert not gate["ok"] and gate["best"]["value"] == 200.0
    return gate


def _flatten_tolerates_null_parsed(m, tmp_path):
    assert m.flatten_bench({"rc": 2, "parsed": None}) == {}
    assert m.flatten_bench("not a dict") == {}
    hist = [_rec(value=100.0), {"rc": 2, "parsed": None}]
    gate = m.check_regression(_rec(value=100.0, wrap=False), hist)
    assert gate["ok"]
    return gate


def _spread_widens_per_metric_tolerance(m, tmp_path):
    hist = [_rec(value=6000.0, configs={"noisy": {"fps": 9600.0, "parity": "ok"},
                                        "stable": {"fps": 9600.0, "parity": "ok"}})]
    cur = _rec(value=5900.0, configs={"noisy": {"fps": 8000.0, "parity": "ok"},
                                      "stable": {"fps": 8000.0, "parity": "ok"}}, wrap=False)
    gate = m.check_regression(cur, hist, tolerance=0.10,
                              spreads={"configs.noisy": 0.30, "configs.stable": 0.02})
    assert [r["metric"] for r in gate["regressions"]] == ["configs.stable"], gate
    assert gate["regressions"][0]["tolerance_pct"] == 10.0  # max(10%, 2%)
    return gate


GATE_CASES = [_flatten_wrapped_and_raw, _flatten_skips_null_and_nonnumeric,
              _best_of_history_and_pass, _regression_flagged_below_tolerance,
              _boundary_exactly_at_tolerance_passes, _new_metric_without_history_passes,
              _metric_absent_this_run_passes, _history_loader_skips_garbage,
              _flatten_tolerates_null_parsed, _spread_widens_per_metric_tolerance]


@pytest.mark.parametrize("case", GATE_CASES, ids=[c.__name__.strip("_") for c in GATE_CASES])
def test_gate_matches_root_bench(case, tmp_path):
    (tmp_path / "root").mkdir()
    (tmp_path / "port").mkdir()
    assert case(bench, tmp_path / "port") == case(root_bench, tmp_path / "root")
    assert bench.REGRESSION_TOL == root_bench.REGRESSION_TOL
    assert bench.GATED_KEYS == root_bench.GATED_KEYS


def test_history_is_the_cards_own_files(tmp_path):
    (tmp_path / "results").mkdir()
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(_rec(value=1.0)))
    (tmp_path / "results" / "BENCH_r02.json").write_text(json.dumps(_rec(value=2.0)))
    (tmp_path / "cuda_bench_root.json").write_text(json.dumps(_rec(value=3.0)))
    (tmp_path / "results" / "cuda_bench_x.txt").write_text(json.dumps(_rec(value=4.0)))
    (tmp_path / "results" / "cuda_bench_a.json").write_text(json.dumps(_rec(value=5.0)))
    assert bench.load_bench_history(tmp_path) == [_rec(value=5.0)]


# --- a tiny run on the CPU -------------------------------------------------

def _root_result_keys() -> set:
    """The keys of the root bench's JSON line: its ``result = {...}``
    literal and the ``regression`` it adds."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["result"]):
            return {k.value for k in node.value.keys} | {"regression"}
    raise AssertionError("no result dict in bench.py")


@pytest.fixture(scope="module")
def tiny_run():
    return bench.run("cpu", TINY)


def test_tiny_run_keys_and_gates(tiny_run):
    res, rc = tiny_run
    assert rc == 0
    renamed = {"vpu_utilization_pct": "utilization_pct",
               "vpu_vs_measured_achievable_pct": "vs_measured_achievable_pct"}
    root_keys = _root_result_keys()
    assert set(renamed) <= root_keys
    want = (root_keys - set(renamed)) | set(renamed.values()) | {"device", "build_s"}
    assert set(res) == want
    assert [c["parity"] for c in res["configs"].values()] == ["ok"] * 5
    assert list(res["configs"]) == [c[0] for c in bench.CASES]
    assert res["value"] > 0 and res["order1_dh_fps"] > 0
    assert res["pool_compat_fps"] > 0 and res["pool_compat_carried_fps"] > 0
    assert res["backend"] == "cpu" and res["batch"] == TINY.fields
    assert res["device"] == {"name": "cpu", "power_limit": None}
    assert len(res["trials_ms"]) == len(res["order1_trials_ms"]) == TINY.trials
    assert res["regression"]["ok"]


def test_main_prints_one_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SIZES", TINY)
    assert bench.main(["--device", "cpu", "--headline-only"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["configs"] == {} and res["pool_compat_fps"] is None and res["value"] > 0


def _flipped(clip):
    """``clip`` with one pixel of its first plane changed."""
    planes = [p.clone() for p in clip.planes]
    p = planes[0]
    v = p[0, 0, 0].item()
    p[0, 0, 0] = v + 1.0 if p.is_floating_point() else int(v) ^ 1
    return clip.with_planes(planes)


def _corrupt_run(monkeypatch, capsys, name, when):
    """Run the tiny bench through ``main`` with ``bench.<name>`` flipping a
    pixel of its output wherever ``when(clip, kwargs)`` holds."""
    real = getattr(bench, name)

    def corrupt(clip, *a, **kw):
        out = real(clip, *a, **kw)
        return _flipped(out) if when(clip, kw) else out

    monkeypatch.setattr(bench, name, corrupt)
    monkeypatch.setattr(bench, "SIZES", TINY)
    rc = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_corrupt_headline_fails(monkeypatch, capsys):
    rc, res = _corrupt_run(monkeypatch, capsys, "sangnom2", lambda clip, kw: True)
    assert rc == 1
    assert res == {"metric": "1080p_bob_dh_fps_per_chip", "value": 0.0,
                   "unit": "frames/s", "vs_baseline": 0.0, "error": "parity"}


def test_corrupt_bob_fails(monkeypatch, capsys):
    rc, res = _corrupt_run(monkeypatch, capsys, "bob", lambda clip, kw: True)
    assert rc == 1
    assert res["error"] == "bob parity" and res["value"] == 0.0


def test_corrupt_config_fails(monkeypatch, capsys):
    rc, res = _corrupt_run(monkeypatch, capsys, "sangnom2",
                           lambda clip, kw: clip.format.name == "GRAY8")
    assert rc == 1
    parity = {n: c["parity"] for n, c in res["configs"].items()}
    assert parity.pop("cfg1_640x480_GRAY8_order1") == "FAIL"
    assert set(parity.values()) == {"ok"}
    assert res["pool_compat_fps"] > 0


def test_corrupt_pool_fails(monkeypatch, capsys):
    rc, res = _corrupt_run(monkeypatch, capsys, "sangnom2",
                           lambda clip, kw: kw.get("pool_compat") and kw.get("opt", -1) != 0)
    assert rc == 1
    assert res["pool_compat_fps"] is None and res["pool_compat_carried_fps"] is None
    assert {c["parity"] for c in res["configs"].values()} == {"ok"}


def test_inputs_replay_root_bench_draws(monkeypatch):
    """The planes the bench uploads are, in order, a literal replay of the
    root bench's draws (bench.py:284-293, :363-367, :205-227) at the tiny
    sizes."""
    from sangnom_tpu.core.formats import get_format as jax_get_format

    seen = []

    class Recording(Clip):
        @classmethod
        def from_numpy(cls, planes, *a, **kw):
            seen.append([np.array(p) for p in planes])
            return Clip.from_numpy(planes, *a, **kw)

    monkeypatch.setattr(bench, "Clip", Recording)
    _, rc = bench.run("cpu", TINY)
    assert rc == 0

    rng = np.random.default_rng(7)
    B, H, W = TINY.fields, TINY.field_height, TINY.width
    want = [[
        rng.integers(0, 256, (B, H, W)).astype(np.uint8),
        rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.uint8),
        rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.uint8),
    ]]
    B_in = B // 2
    want.append([
        rng.integers(0, 256, (B_in, 2 * H, W)).astype(np.uint8),
        rng.integers(0, 256, (B_in, H, W // 2)).astype(np.uint8),
        rng.integers(0, 256, (B_in, H, W // 2)).astype(np.uint8),
    ])
    for _, fname, w, h, _ in TINY.cases:
        fmt = jax_get_format(fname)
        planes = []
        for i in range(fmt.num_planes):
            pw, ph = fmt.plane_dims(w, h, i)
            if fmt.is_float:
                planes.append(rng.random((TINY.cfg_frames, ph, pw), np.float32))
            else:
                top = (1 << (8 * fmt.component_size)) - 1
                planes.append(rng.integers(0, top + 1, (TINY.cfg_frames, ph, pw))
                              .astype(fmt.dtype))
        want.append(planes)

    def same(a, b):
        return len(a) == len(b) and all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))

    it = iter(seen)
    for k, planes in enumerate(want):
        assert any(same(planes, got) for got in it), f"draw {k} not uploaded in order"


def test_no_jax_in_a_bench_process():
    code = f"""
import dataclasses, json, sys
from sangnom_tpu_torch import bench as b
dims = {TINY_DIMS!r}
cases = tuple((n, f, w, h, kw) for (n, f, _, _, kw), (w, h) in zip(b.CASES, dims))
b.SIZES = dataclasses.replace(b.FULL, cases=cases, **{TINY_KW!r})
rc = b.main(["--device", "cpu"])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "sangnom_tpu", "bench"))))
sys.exit(rc)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line, mods = r.stdout.strip().splitlines()
    assert json.loads(mods) == []
    assert json.loads(line)["backend"] == "cpu"


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert bench.main(["--device", "cuda"]) == 2
    assert bench.main(["--device", "no-such-device"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "--device cpu" in captured.err


def test_sse2_baseline_runs_committed_binary(monkeypatch, tmp_path):
    monkeypatch.setenv("SANGNOM_REF_DIR", str(tmp_path / "missing"))
    fps, provenance, live = bench.measure_sse2_baseline(frames=2, runs=1)
    assert fps == live > 0
    assert "measured live on this host" in provenance
    assert "committed tools/sse2_baseline binary" in provenance


def test_sse2_baseline_falls_back_to_recorded(monkeypatch, tmp_path):
    monkeypatch.delenv("SANGNOM_REF_DIR", raising=False)
    monkeypatch.setattr(bench, "SSE2_BINARY", tmp_path / "not-runnable")
    fps, provenance, live = bench.measure_sse2_baseline(frames=2, runs=1)
    assert (fps, live) == (bench.SSE2_MEASURED_FPS_RECORDED, 0.0) == (119.7, 0.0)
    assert provenance.startswith("recorded") and "another host" in provenance
