"""The field kernel of this checkout against another checkout's, in turns.

    python -m sangnom_tpu_torch.tools.deint_ab OTHER_CHECKOUT [--reps N] [--rounds R]

For each checkout (this one, and OTHER_CHECKOUT, e.g. an unpacked earlier
commit) it first builds the kernel library with ptxas's report and prints
the registers and spill bytes of every ``deint_kernel`` instantiation.
Then it runs worker processes in turns (other, this, this with the
single-buffer route, then the reverse order, ``--rounds`` times); each
worker imports the ``sangnom_tpu_torch`` of its checkout and times, by CUDA
events, the main path's field-kernel launches at full 1080 size (seed 7,
as ``chip_smoke.py``): the bob's luma launch (120 fields x 540 rows x 1920)
and U/V launch (240 x 270 x 960), the no-weave launch at the dh luma shape
(120 x 540 x 1920), and the whole ``bob`` call (60 interlaced frames ->
120).  The outputs of the checkouts must agree bit for bit (SHA-256 of each
output); the command exits nonzero otherwise.  It prints, per case, each
arm's best ms, the factor other / this, and the time of a row step.  The
"single" arm forces this checkout's two-barrier route
(``deint_kernel.launch_plan``), to show what the one-barrier double buffer
buys.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# case -> serial row steps of one launch (None: a whole call)
CASES = {"bob luma": 539, "bob U/V": 269, "no-weave luma": 539, "bob call": None}


def worker(reps: int, route: str | None) -> dict:
    """Time this process's ``sangnom_tpu_torch`` on the main path's launches."""
    import numpy as np
    import torch

    from sangnom_tpu_torch import Clip, bob, get_format
    from sangnom_tpu_torch.core.geometry import (
        aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds)
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    if route == "single":
        plan_of = dk.launch_plan

        def forced(w, S, elem, limit):
            p = plan_of(w, S, elem, limit)
            if p.route != "double":
                return p
            return p._replace(route="single", smem_bytes=p.smem_bytes - 9 * p.pitch_b * 4)

        dk.launch_plan = forced
    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(7)
    for shape in ((120, 540, 1920), (120, 270, 960), (120, 270, 960)):
        rng.integers(0, 256, shape)  # the dh planes chip_smoke.py draws first
    planes = [rng.integers(0, 256, (60, h, w)).astype(np.uint8)
              for h, w in ((1080, 1920), (540, 960), (540, 960))]
    clip = Clip.from_numpy(planes, fmt, device="cuda", tff=True)
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    stride = buffer_stride_elems(1920, fmt.component_size)
    pf = torch.tensor([0, 1] * 60, dtype=torch.int32, device="cuda")
    luma = clip.planes[0]
    uv = torch.cat([clip.planes[1], clip.planes[2]])
    kept = luma.reshape(120, 540, 1920)
    a_y, a_c = aaf_as_pixel(aafs[0], fmt), aaf_as_pixel(aafs[1], fmt)
    fns = {
        "bob luma": lambda: dk.deinterlace_field_batch_fused(luma, pf, a_y, spec, stride, True),
        "bob U/V": lambda: dk.deinterlace_field_batch_fused(uv, pf.repeat(2), a_c, spec,
                                                            stride, True),
        "no-weave luma": lambda: dk.interpolate_field_batch(kept, a_y, spec, stride),
        "bob call": lambda: bob(clip).planes,
    }

    def cuda_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    res = {}
    for name, fn in fns.items():
        out = fn()
        outs = out if isinstance(out, (list, tuple)) else [out]
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in outs:
            digest.update(t.cpu().numpy().tobytes())
        del out, outs
        res[name] = {"ms": [cuda_ms(fn) for _ in range(3)], "sha256": digest.hexdigest()}
    return {"device": torch.cuda.get_device_name(0), "cases": res}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--route", choices=["single"])
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(a.reps, a.route)))
        return 0
    if a.other is None:
        ap.error("OTHER_CHECKOUT is required")
    # imported here, not at the top: a worker runs this file against the
    # other checkout's package, which may not have it
    from sangnom_tpu_torch.tools import ab
    from sangnom_tpu_torch.tools.ab import HERE

    card = ab.card()
    trees = {"other": a.other.resolve(), "this": HERE, "single": HERE}
    for tag in ("other", "this"):
        for line in ab.ptxas_report(trees[tag], r"(deint_kernel)I(\w+?)EEv"):
            print(f"[ptxas {tag}] {line}", flush=True)

    def work(tag):
        route = ["--route", "single"] if tag == "single" else []
        return ab.run_worker(__file__, trees[tag], ["--reps", str(a.reps), *route])

    ms = ab.run_turns(["other", "this", "single"], a.rounds, work)
    ab.report(ms, CASES, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
