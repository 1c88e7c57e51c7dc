"""The control of every cell: the program with its own SSE2 numerics on
(``numerics="sse2"``: the reference plugin's SIMD path, which shifts
logically and saturates where the C path shifts arithmetically and wraps)
in the timed path's place, judged against the C-path reference.  It breaks
the configurations' guarantee of bit-exact C-path output, and has to come
out not correct.

    python3 -m benchmark.tests.controls --workload bob1080i.api --seeds 1 2 3 [--seconds 2]

prints one JSON line a seed: the control's checks and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import time

from benchmark import harness


def control_run(cell: harness.Cell) -> harness.Outcome:
    """One run of ``cell`` with the program's SSE2 numerics in place."""
    if cell.traffic["driver"] == "cli_stream":
        from benchmark.drivers import cli_stream

        traffic = dict(cell.traffic, cli_args=[*cell.traffic["cli_args"], "--numerics", "sse2"])
        return cli_stream.run(harness.Cell(**{**cell.__dict__, "traffic": traffic}))
    import sangnom_tpu_torch as snt
    from benchmark.drivers import api_call

    name, _, kwargs = api_call.entry_of(cell)
    fn = getattr(snt, name)
    return api_call.run(cell, call=lambda clip: fn(clip, numerics="sse2", **kwargs))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.tests.controls")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    spec = harness.load_spec()
    config, traffic = harness.cell_files(args.workload)
    for seed in args.seeds:
        cell = harness.Cell(name=args.workload, config=config, traffic=traffic, seed=seed,
                            seconds=args.seconds, trace=False, t0=time.perf_counter())
        out = control_run(cell)
        line = harness.result_line(spec, cell, out, "gpu")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": line["correct"],
                          "attempted": out.attempted, "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
