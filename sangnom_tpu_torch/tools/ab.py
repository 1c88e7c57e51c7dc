"""What the A/B tools (``deint_ab``, ``pool_ab``, ``shard_ab``) share.

Each tool times this checkout against another one (e.g. an unpacked
earlier commit) on one CUDA card: it builds each checkout's kernel library
with ptxas's report (``ptxas_report``), then runs worker processes, each
importing the ``sangnom_tpu_torch`` of its checkout, in turns
(``run_turns``: other, this, then the reverse order, per round), and
requires every case's output to agree bit for bit across the arms (SHA-256).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parents[2]  # this checkout


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_report(tree: Path, name_re: str) -> list[str]:
    """Build ``tree``'s kernel library with ptxas -v; the registers and spill
    lines of each kernel instantiation whose mangled name matches
    ``name_re`` (a regex whose first group names the kernel and second, if
    it matched, its template arguments)."""
    code = "from sangnom_tpu_torch.ops import cuda_library as cl; cl.build(verbose=True)"
    p = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                       text=True, env={**os.environ, "PYTHONPATH": str(tree)})
    if p.returncode:
        raise SystemExit(f"build failed in {tree}:\n{p.stderr[-6000:]}")
    out, fn = [], None
    for line in p.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        name = re.search(name_re, fn) if fn else None
        if name and ("Used" in line or "spill" in line):
            out.append(f"{name.group(1)}<{name.group(2) or ''}>: "
                       f"{line.split(':', 1)[-1].strip()}")
    return out


def run_worker(tool: str, tree: Path, args: list[str]) -> dict:
    """Run ``tool`` (a module file) as a worker in ``tree``; its last stdout
    line is its JSON result."""
    cmd = [sys.executable, tool, "--worker", *args]
    p = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": str(tree)})
    if p.returncode:
        raise SystemExit(f"worker in {tree} failed:\n{p.stderr[-6000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def run_turns(order: list[str], rounds: int, work: Callable[[str], dict],
              sha_key: Callable[[str], str] = lambda c: c) -> dict:
    """``work(tag)`` for each tag of ``order`` then of its reverse,
    ``rounds`` times; returns {tag: {case: [ms of every window]}}.  Raises
    SystemExit when two results of one ``sha_key(case)`` differ."""
    ms: dict = {tag: {} for tag in order}
    sha: dict = {}
    for _ in range(rounds):
        for tag in order + order[::-1]:
            for c, v in work(tag)["cases"].items():
                ms[tag].setdefault(c, []).extend(v["ms"])
                if sha.setdefault(sha_key(c), v["sha256"]) != v["sha256"]:
                    raise SystemExit(f"{c}: the {tag} arm's output differs")
    return ms


def report(ms: dict, steps: dict, card_line: str, unit: Callable[[str], str] = lambda c: "ms"
           ) -> dict:
    """Print each case's best ms per arm, the factor first arm / second arm
    and, where ``steps`` gives the serial row steps, the time of a step;
    print and return the JSON summary."""
    tags = list(ms)
    summary = {}
    for c in ms[tags[-1]]:
        best = {tag: min(ms[tag][c]) for tag in tags if c in ms[tag]}
        summary[c] = best
        n = steps.get(c)
        step = "" if not n else "; row step us " + ", ".join(
            f"{tag} {best[tag] / n * 1e3:.3f}" for tag in best)
        factor = (f"; factor {tags[0]}/{tags[1]} {best[tags[0]] / best[tags[1]]:.3f}"
                  if tags[0] in best and tags[1] in best else "")
        print(f"[ab] {c}: " + ", ".join(f"{tag} {best[tag]:.4f} {unit(c)}" for tag in best)
              + f"{factor}{step}; outputs bit-equal | {card_line}", flush=True)
    print(json.dumps({"card": card_line, "best_ms": summary, "windows_ms": ms}))
    return summary
