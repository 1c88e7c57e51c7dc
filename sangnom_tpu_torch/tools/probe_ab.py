"""The probe kernels K8-K10 of this checkout against another's, in turns.

    python -m sangnom_tpu_torch.tools.probe_ab OTHER_CHECKOUT [--reps N] [--rounds R]

For each checkout (this one, and OTHER_CHECKOUT, e.g. an unpacked earlier
commit) it first builds the kernel library with ptxas's report and prints
the registers and spill bytes of every ``csrc/probes.cu`` instantiation
(mangled template arguments: ``line_kernel<Li10ELi4>`` is arm 10, C = 4).
Then it runs worker processes in turns (other, this, this, other,
``--rounds`` times); each worker imports the ``sangnom_tpu_torch`` of its
checkout and times by CUDA events, on the tools' [120, 2048] input (seed 0):

  - every K8 arm (``calibrate_vpu.OPS_PER_ITER``) at both chain lengths of
    the calibration's differential (32 and 96 iterations a step, 4 and 12
    for the step arms), 512 steps, and ``mix`` and the four mm arms at k 96
    over 32 steps (the cases ``chip_smoke.py`` times);
  - K9's default arms (``isolate_step.DEFAULT_ARMS`` but ``bigslab@1``,
    which raises), 8 steps;
  - K10 on the 540 x 1920 plane over 542 steps, u8 and i32: the call by
    CUDA events (which, for a launch of a few microseconds, is the host's
    time to issue it) and the kernel's device time by torch.profiler.

The outputs must agree bit for bit (SHA-256 of an 8-step run, and of the
timed run for the ``chip_smoke.py`` cases) across the checkouts; the
command exits nonzero otherwise.  It prints each case's best ms per
checkout, and each K8 arm's differential rate in Tops/s.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

K8_STEPS = 512
K9_STEPS = 8


def device_ms(fn, kernel: str, n: int = 20) -> float:
    """Mean device time of one launch of ``kernel`` (a substring of its
    name) over ``n`` calls of ``fn``, by torch.profiler: for a launch of a
    few microseconds, CUDA events around back-to-back calls time the host's
    issue of them instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and kernel in e.key]
    launches = sum(e.count for e in ev)
    if not launches:
        raise AssertionError(f"the profiler traced no {kernel} launch")
    return sum(e.self_device_time_total for e in ev) / 1e3 / launches


def worker(reps: int) -> dict:
    """Time this process's probe kernels on every case."""
    import numpy as np
    import torch

    from sangnom_tpu_torch.tools import calibrate_vpu as cv
    from sangnom_tpu_torch.tools import isolate_step as iso
    from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn

    src = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (cv.G, cv.W))).to(
        "cuda", torch.int32)
    def cuda_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def sha(out):
        return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()

    res = {}

    def case(name, fn, check):
        fn()
        res[name] = {"ms": [cuda_ms(fn) for _ in range(3)], "sha256": sha(check())}

    for kind in cv.OPS_PER_ITER:
        for k in cv.chain_lengths(kind):
            case(f"K8 {kind} k{k}", lambda kind=kind, k=k: cv.run(src, kind, k, steps=K8_STEPS),
                 lambda kind=kind, k=k: cv.run(src, kind, k, steps=8))
    for kind in ("mix",) + cv.MM_KINDS:
        run = lambda kind=kind: cv.run(src, kind, 96, steps=32)  # noqa: E731
        case(f"K8 {kind} k96 s32", run, run)
    for arm in iso.DEFAULT_ARMS:
        kind, _, k = arm.partition("@")
        if kind == "bigslab":
            continue
        run = lambda kind=kind, k=int(k): iso.run(src, kind, k, steps=K9_STEPS)  # noqa: E731
        case(f"K9 {arm}", run, run)
    for dtype in (np.uint8, np.int32):
        kept = torch.from_numpy(dyn.probe_input(dtype, 540, 1920)).to("cuda")
        run = lambda kept=kept: dyn.dynrow(kept, 542)  # noqa: E731
        name = f"K10 {np.dtype(dtype).name} 540x1920 s542"
        case(name, run, run)
        res[f"{name} device"] = {"ms": [device_ms(run, "dynrow_kernel") for _ in range(3)],
                                 "sha256": res[name]["sha256"]}
    return {"device": torch.cuda.get_device_name(0), "cases": res}


def report(ms: dict, card: str) -> dict:
    """Print the best ms of each case for each checkout, the K8
    differential rates, and return the JSON summary."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv

    best = {}  # case -> {"other" / "this": ms}
    for tag, cases in ms.items():
        for c, windows in cases.items():
            best.setdefault(c, {})[tag] = min(windows)
    for base, arms in best.items():
        print(f"[ab] {base}: " + ", ".join(f"{a} {t:.4f} ms" for a, t in arms.items())
              + f" | {card}", flush=True)
    rates = {}
    for kind in cv.OPS_PER_ITER:
        k1, k2 = cv.chain_lengths(kind)
        t1, t2 = best[f"K8 {kind} k{k1}"], best[f"K8 {kind} k{k2}"]
        elems = (k2 - k1) * cv.OPS_PER_ITER[kind] * K8_STEPS * cv.G * cv.W
        rates[kind] = {a: elems / ((t2[a] - t1[a]) * 1e-3) if t2[a] > t1[a] else 0.0
                       for a in t1 if a in t2}
        print(f"[ab rate] {kind}: " + ", ".join(
            f"{a} {r / 1e12:.3f} Tops/s" for a, r in rates[kind].items()) + f" | {card}",
            flush=True)
    summary = {"card": card, "best_ms": best, "rates_ops_s": rates, "windows_ms": ms}
    print(json.dumps(summary))
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(a.reps)))
        return 0
    if a.other is None:
        ap.error("OTHER_CHECKOUT is required")
    # imported here, not at the top: a worker runs this file against the
    # other checkout's package, which may not have it
    from sangnom_tpu_torch.tools import ab
    from sangnom_tpu_torch.tools.ab import HERE

    card = ab.card()
    trees = {"other": a.other.resolve(), "this": HERE}
    for tag in trees:
        for line in ab.ptxas_report(trees[tag],
                                    r"((?:line|mm|mmf32|step|isolate|dynrow)_kernel)(?:I(\w+?)EEv|E)"):
            print(f"[ptxas {tag}] {line}", flush=True)
    ms = ab.run_turns(
        ["other", "this"], a.rounds,
        lambda tag: ab.run_worker(__file__, trees[tag], ["--reps", str(a.reps)]))
    report(ms, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
