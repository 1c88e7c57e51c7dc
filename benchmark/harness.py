"""What the benchmark finds by name: cells, configurations, traffic mixes,
drivers, metric readers and work counts, and the result line.

`BENCHMARK.json` (in the working directory, the checkout's root) names the
cells and metrics.  A cell's traffic mix is ``benchmark/workloads/<traffic>
.json``: its driver, the filter mode whose work it counts, and the driver's
parameters.  A configuration is the JSON file `BENCHMARK.json` gives it.  A
metric is read by ``benchmark/metrics/<name>.py``'s ``read(obs)``, which
returns a number or None; a driver is ``benchmark/drivers/<name>.py``'s
``run(ctx)``; a work count is ``benchmark/work/<mode>.py``'s
``call_work(config, traffic)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Top-level module names the process may not hold once the window closes.
BANNED = ("jax", "jaxlib", "flax", "sangnom_tpu")


@dataclasses.dataclass
class Cell:
    """One run of one cell: what a driver is handed."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float  # the harness's start, on time.perf_counter's clock
    device: str = "cuda"
    chips: int = 1


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the observations the metric readers read,
    and each number compared with its limit."""

    obs: dict
    checks: list  # (name, value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    kind: str


def load_spec(root: Path = HERE.parent) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str, root: Path = HERE.parent) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    traffic = load_traffic(w["traffic"])
    if traffic.get("config", w["config"]) != w["config"]:
        raise ValueError(f"{w['traffic']}: made for configuration "
                         f"{traffic['config']!r}, not {w['config']!r}")
    return w, config, traffic


def load_traffic(name: str) -> dict:
    with open(HERE / "workloads" / f"{name}.json") as f:
        return json.load(f)


def cell_files(name: str) -> tuple[dict, dict]:
    """(configuration, traffic) of the traffic mix ``name`` from its own
    files, whether or not `BENCHMARK.json` lists it (the tests and the
    controls run cells that way)."""
    traffic = load_traffic(name)
    with open(HERE / "configs" / f"{traffic['config']}.json") as f:
        return json.load(f), traffic


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def work(mode: str):
    return importlib.import_module(f"benchmark.work.{mode}")


def reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py`` (a name may hold dots,
    so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on.  A metric without a
    ``workloads`` list belongs to every cell (per-layer: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def result_line(spec: dict, cell: Cell, out: Outcome, platform: str) -> dict:
    """The run's result object; its "checks" key comes last."""
    metrics = {}
    for m in metrics_of(spec, cell.name, cell.trace):
        v = reader(m["name"])(out.obs)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": platform, "kind": out.kind, "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {
        "correct": all(v <= lim for _, v, lim in out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": device,
    }
    tr = out.obs.get("trace")
    if cell.trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["stretch_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    return line
