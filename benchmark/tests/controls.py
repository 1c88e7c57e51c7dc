"""The control of every cell: the step below the precision the
configuration states, in the timed path's place, judged against the C-path
reference.  It breaks the configurations' guarantee of bit-exact C-path
output, and has to come out not correct.

- 8-bit cells: the program with its own SSE2 numerics on
  (``numerics="sse2"``: the reference plugin's SIMD path, which shifts
  logically and saturates where the C path shifts arithmetically and
  wraps).
- Cells deeper than 8 bits, where those numerics hardly differ (0-3, 0-3
  and 3-10 of 786432 output samples of a 4-frame 512x96 4:2:2 bob at 10,
  12 and 14 bits): the entry run on the clip's top 8 bits, in the 8-bit
  format of the same subsampling, its output shifted back up
  (`on_top_bits`).

    python3 -m benchmark.tests.controls --workload bob1080i.api --seeds 1 2 3 [--seconds 2]

prints one JSON line a seed: the control's checks and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import re
import time

import torch

from benchmark import harness


def on_top_bits(fn, bits: int, **kwargs):
    """``fn(clip, **kwargs)`` computed from the clip's top 8 bits in the
    8-bit format of its subsampling, the output shifted back to ``bits``."""
    shift = bits - 8

    def call(clip):
        low = clip.with_planes([(p.to(torch.int32) >> shift).to(torch.uint8) for p in clip.planes],
                               format=re.sub(r"\d+$", "8", clip.format.name))
        out = fn(low, **kwargs)
        return out.with_planes([(p.to(torch.int32) << shift).to(clip.format.dtype)
                                for p in out.planes], format=clip.format)

    return call


def control_run(cell: harness.Cell) -> harness.Outcome:
    """One run of ``cell`` with its control in the timed path's place."""
    bits = cell.config["bits"]
    if cell.traffic["driver"] == "cli_stream":
        if bits != 8:
            raise ValueError("the stream driver has a control for 8-bit cells only")
        from benchmark.drivers import cli_stream

        traffic = dict(cell.traffic, cli_args=[*cell.traffic["cli_args"], "--numerics", "sse2"])
        return cli_stream.run(harness.Cell(**{**cell.__dict__, "traffic": traffic}))
    import sangnom_tpu_torch as snt
    from benchmark.drivers import api_call

    name, _, kwargs = api_call.entry_of(cell)
    fn = getattr(snt, name)
    if bits == 8:
        return api_call.run(cell, call=lambda clip: fn(clip, numerics="sse2", **kwargs))
    return api_call.run(cell, call=on_top_bits(fn, bits, **kwargs))


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
