"""Run one benchmark cell on the card and print its result line.

    python3 -m benchmark.run --workload bob1080i.api --seed 7 --seconds 20 --trace 0

Run from the root of a checkout holding `BENCHMARK.json`.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` the ``breakdown``, and last the
``checks``: each number compared beside its limit, which also end standard
error).  Without a CUDA card, or with fewer than the cell asks for, it exits
2 and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    spec = harness.load_spec()
    entry, config, traffic = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"error: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = harness.Cell(name=args.workload, config=config, traffic=traffic, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace), t0=T0,
                        chips=entry["chips"])
    out = harness.driver(traffic["driver"]).run(cell)
    line = harness.result_line(spec, cell, out, "gpu")
    banned = harness.banned_modules()
    if banned:
        print(f"error: modules loaded that the benchmark may not load: {banned}",
              file=sys.stderr)
        return 3
    parts = out.obs.get("setup_parts")
    if parts:
        print("setup_s parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()),
              file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
