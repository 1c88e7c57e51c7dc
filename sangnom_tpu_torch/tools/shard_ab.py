"""The width-sharded kernels and calls of this checkout against another's, in turns.

    python -m sangnom_tpu_torch.tools.shard_ab OTHER_CHECKOUT [--reps N] [--rounds R]

For each checkout (this one, and OTHER_CHECKOUT, e.g. an unpacked earlier
commit) it first builds the kernel library with ptxas's report and prints
the registers and spill bytes of every shard kernel instantiation.  Then it
runs worker processes in turns (other, this, this, other, ``--rounds``
times); each worker imports the ``sangnom_tpu_torch`` of its checkout and
times by CUDA events, on the 1080 dh inputs of ``chip_smoke.py`` (seed 7):

  - K4 over a plane pass on 4 shards (``deinterlace_fused_full``, weave 0):
    the luma pass (120 fields x 540 rows x 1920) and the U+V pass (240 x 270
    x 988), at ``chunk_rows`` R = 1, 2, 4, 8 and 16 (the R sweep);
  - K5 over the luma pass's raw maps (9 x 120 map rows, 4 shards) at the
    same R; this checkout's ``smooth_full_width``, the other's
    ``smooth_sharded_chunked`` where it has no whole-plane entry;
  - the calls: ``sangnom2_sharded`` dh and woven bob on 1x4 and 2x2 meshes
    of the card through K4, the 1x4 dh call through the K5 route
    (``smooth="chunked"``), and the single-device K1 bob call.

The outputs must agree bit for bit (SHA-256) across the checkouts and, for
a case of the sweep, across R; the command exits nonzero otherwise.  It
prints each case's best ms per checkout, the factor other / this, and a
pass's row step.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

SWEEP = (1, 2, 4, 8, 16)
# case -> serial row steps of one launch (None: a whole call)
CASES = {**{f"K4 luma pass R{r}": 539 for r in SWEEP},
         **{f"K4 U+V pass R{r}": 269 for r in SWEEP},
         **{f"K5 luma pass R{r}": 539 for r in SWEEP},
         "1x4 K4 dh": None, "1x4 K4 bob": None, "2x2 K4 dh": None, "2x2 K4 bob": None,
         "1x4 K5 dh": None, "K1 bob": None}


def worker(reps: int) -> dict:
    """Time this process's ``sangnom_tpu_torch`` on the sharded cases."""
    import numpy as np
    import torch

    from sangnom_tpu_torch import Clip, bob, get_format
    from sangnom_tpu_torch.core.fields import double_weave, separate_fields
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded
    from sangnom_tpu_torch.parallel import fused_smooth as fs
    from sangnom_tpu_torch.parallel import width_sharded as ws

    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(7)
    dh = [rng.integers(0, 256, (120, h, w)).astype(np.uint8)
          for h, w in ((540, 1920), (270, 960), (270, 960))]
    bb = [rng.integers(0, 256, (60, h, w)).astype(np.uint8)
          for h, w in ((1080, 1920), (540, 960), (540, 960))]
    clip_dh = Clip.from_numpy(dh, fmt, device="cuda")
    clip_bob = Clip.from_numpy(bb, fmt, device="cuda", tff=True)
    woven = double_weave(separate_fields(clip_bob))
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    n = 4
    luma = clip_dh.planes[0].contiguous()
    Sc = 988  # the U+V plane's sharded width at 4 shards (parallel.sharding)
    uv = torch.cat([clip_dh.planes[1], clip_dh.planes[2]])
    uv = torch.cat([uv, uv[..., -1:].expand(-1, -1, Sc - 960)], dim=2).contiguous()
    a_y, a_c = aaf_as_pixel(aafs[0], fmt), aaf_as_pixel(aafs[1], fmt)
    N, bufH, S = luma.shape
    g = torch.Generator(device="cuda").manual_seed(3)
    raw = torch.randint(0, 256, (9 * N, bufH + 1, S), generator=g, device="cuda",
                        dtype=torch.int32)
    raw[:, [0, bufH]] = 0
    whole = hasattr(fs, "smooth_full_width")
    raw_sh = None if whole else ws._shards(raw, n).contiguous()

    def k5(r):
        if whole:
            return lambda: fs.smooth_full_width(raw, spec, n, r)
        return lambda: fs.smooth_sharded_chunked(raw_sh, spec, r)

    def sharded(d, s, c, smooth=None, **kw):
        mesh = default_mesh(d, s, devices=["cuda"] * (d * s))
        return lambda: sangnom2_sharded(c, mesh, space_axis="space", smooth=smooth,
                                        **kw).planes

    fns = {}
    for r in SWEEP:
        fns[f"K4 luma pass R{r}"] = lambda r=r: fs.deinterlace_fused_full(
            luma, 0, a_y, spec, n, S, r)
        fns[f"K4 U+V pass R{r}"] = lambda r=r: fs.deinterlace_fused_full(
            uv, 0, a_c, spec, n, 960, r)
        fns[f"K5 luma pass R{r}"] = k5(r)
    fns.update({
        "1x4 K4 dh": sharded(1, 4, clip_dh, order=1, dh=True),
        "1x4 K4 bob": sharded(1, 4, woven, order=0),
        "2x2 K4 dh": sharded(2, 2, clip_dh, order=1, dh=True),
        "2x2 K4 bob": sharded(2, 2, woven, order=0),
        "1x4 K5 dh": sharded(1, 4, clip_dh, "chunked", order=1, dh=True),
        "K1 bob": lambda: bob(clip_bob).planes,
    })

    def cuda_ms(fn, k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / k

    res = {}
    for name, fn in fns.items():
        out = fn()
        if name.startswith("K5") and not whole:
            out = ws._unshard(out)
        h = hashlib.sha256()
        for t in out if isinstance(out, (list, tuple)) else [out]:
            h.update(t.cpu().numpy().tobytes())
        del out
        k = reps if name in ("K1 bob",) or "pass" in name else max(2, reps // 3)
        if name == "1x4 K5 dh" and not whole:
            k = 1  # the plain-glue route takes about 0.1 s a call
        res[name] = {"ms": [cuda_ms(fn, k) for _ in range(3)], "sha256": h.hexdigest()}
        torch.cuda.empty_cache()
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
        for line in ab.ptxas_report(trees[tag], r"(shard_[a-z]+_kernel)I(\w+?)EEv"):
            print(f"[ptxas {tag}] {line}", flush=True)
    ms = ab.run_turns(
        ["other", "this"], a.rounds,
        lambda tag: ab.run_worker(__file__, trees[tag], ["--reps", str(a.reps)]),
        sha_key=lambda c: c.split(" R")[0])  # every R of a pass gives one output
    ab.report(ms, CASES, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
