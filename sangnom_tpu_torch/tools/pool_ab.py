"""The pool_compat kernels and calls of this checkout against another's, in turns.

    python -m sangnom_tpu_torch.tools.pool_ab OTHER_CHECKOUT [--reps N] [--rounds R]

For each checkout (this one, and OTHER_CHECKOUT, e.g. an unpacked earlier
commit) it first builds the kernel library with ptxas's report and prints
the registers and spill bytes of every pool kernel instantiation.  Then it
runs worker processes in turns (other, this, this, other, ``--rounds``
times); each worker imports the ``sangnom_tpu_torch`` of its checkout and
times by CUDA events, on the inputs of ``chip_smoke.py`` (seeds 8 and 9):

  - K3 alone at the 1080 luma pass (pool 9 x 541 x 1920, the stale pool of
    a pool_compat bob with the pass's maps prepared into it);
  - a K7 pass (``pool_kernel.interp_fused``) at the 1080 luma and chroma
    passes, on the same stale pool, kept rows contiguous;
  - the pool_compat calls per kernel arm (K3, K6, K7, set by
    ``pool_carry.POOL_SPLIT3`` / ``POOL_FUSED``), in ms per output frame:
    the 1080i bob (16 interlaced frames -> 32), 16 frames of 1280x720 and 30
    frames of 720x480 at ``order=1``.

The outputs must agree bit for bit (SHA-256 of each output) across the
checkouts, and the arms of a call with each other; the command exits
nonzero otherwise.  It prints each case's best ms per checkout and the
factor other / this.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ARMS = {"K3": (False, False), "K6": (True, False), "K7": (False, True)}
CALLS = ("bob1080", "hd720", "sd480")
# case -> serial row steps of one launch (None: a call, ms per output frame)
CASES = {"K3 luma": 539, "K7 luma": 539, "K7 chroma": 539,
         **{f"{c}/{a}": None for c in CALLS for a in ARMS}}


def worker(reps: int) -> dict:
    """Time this process's ``sangnom_tpu_torch`` on the pool cases."""
    import numpy as np
    import torch

    from sangnom_tpu_torch import Clip, bob, get_format, sangnom2
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream

    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(8)
    hd = [rng.integers(0, 256, (16, h, w)).astype(np.uint8)
          for h, w in ((1080, 1920), (540, 960), (540, 960))]
    sd = [rng.integers(0, 256, (30, h, w)).astype(np.uint8)
          for h, w in ((480, 720), (240, 360), (240, 360))]
    rng = np.random.default_rng(9)
    hd720 = [rng.integers(0, 256, (16, h, w)).astype(np.uint8)
             for h, w in ((720, 1280), (360, 640), (360, 640))]
    clip_hd = Clip.from_numpy(hd, fmt, device="cuda", tff=True)
    clip_sd = Clip.from_numpy(sd, fmt, device="cuda")
    clip_720 = Clip.from_numpy(hd720, fmt, device="cuda")
    calls = {
        "bob1080": (lambda: bob(clip_hd, pool_compat=True), 32),
        "hd720": (lambda: sangnom2(clip_720, order=1, pool_compat=True), 16),
        "sd480": (lambda: sangnom2(clip_sd, order=1, pool_compat=True), 30),
    }
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    pc.POOL_SPLIT3, pc.POOL_FUSED = ARMS["K3"]
    _, stale = sangnom2_pool_stream(clip_hd[0:2], None, order=1)  # a stale 1080 pool
    kept = {"luma": clip_hd.planes[0][0, 0::2].contiguous(),
            "chroma": clip_hd.planes[1][0, 0::2].contiguous()}
    aaf = {"luma": aaf_as_pixel(aafs[0], fmt), "chroma": aaf_as_pixel(aafs[1], fmt)}
    k3_pool = stale.clone()
    bufH_p, w = kept["luma"].shape
    pc._prepare(kept["luma"], k3_pool[:, 1:bufH_p, :w], spec)

    def k7(plane):
        carry = pc._pool_split(stale)
        return lambda: pk.interp_fused(kept[plane], *carry, aaf[plane], spec)

    fns = {
        "K3 luma": (lambda p=k3_pool.clone(): pk.smooth_pool_(p, spec), None),
        "K7 luma": (k7("luma"), None),
        "K7 chroma": (k7("chroma"), None),
    }
    for c, (fn, frames) in calls.items():
        for arm in ARMS:
            fns[f"{c}/{arm}"] = (fn, frames)

    def cuda_ms(fn, n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def digest(out) -> str:
        h = hashlib.sha256()
        if hasattr(out, "planes"):
            out = out.planes
        for t in out if isinstance(out, (list, tuple)) else [out]:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    res = {}
    for name, (fn, frames) in fns.items():
        if frames is not None:
            pc.POOL_SPLIT3, pc.POOL_FUSED = ARMS[name.split("/")[1]]
        # the first call's output: K3 on a copy of its pool, K7 on a fresh carry
        first = (pk.smooth_pool_(k3_pool.clone(), spec) if name == "K3 luma"
                 else k7(name.split()[1])() if name.startswith("K7") else fn())
        torch.cuda.synchronize()
        sha = digest(first)
        del first
        n = reps if frames is None else max(1, reps // 5)
        ms = [cuda_ms(fn, n) / (frames or 1) for _ in range(3)]
        res[name] = {"ms": ms, "sha256": sha}
    return {"device": torch.cuda.get_device_name(0), "cases": res}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", type=Path)
    ap.add_argument("--reps", type=int, default=10)
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
        for line in ab.ptxas_report(trees[tag], r"(pool_[a-z0-9]+_kernel)I(\w+?)EEv"):
            print(f"[ptxas {tag}] {line}", flush=True)
    ms = ab.run_turns(
        ["other", "this"], a.rounds,
        lambda tag: ab.run_worker(__file__, trees[tag], ["--reps", str(a.reps)]),
        sha_key=lambda c: c.split("/")[0])  # every arm of a call gives one output
    ab.report(ms, CASES, card, unit=lambda c: "ms" if CASES[c] else "ms/output frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
