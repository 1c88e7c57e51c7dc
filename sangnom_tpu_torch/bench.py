"""Headline benchmark of the PyTorch / CUDA port: 1080p bob+dh frames/sec/card.

    python -m sangnom_tpu_torch.bench [--headline-only] [--device cuda|cpu]

The port of the repository's root ``bench.py`` (the JAX bench): the same
workloads, drawn in the same order from ``np.random.default_rng(7)``, the
same parity gates, metric names, timing windows and JSON keys.

- Headline (``value``): TRUE BOB, 60 interlaced 1080p YUV420P8 frames
  through SeparateFields -> DoubleWeave -> SangNom2(order=0) (reference
  src/SangNom2.cpp:18-23; here ``core.fields.bob``, whose kernel reads the
  fields in place), alternating per-frame parity, 120 output frames a call.
- ``order1_dh_fps``: ``sangnom2(order=1, aa=48, aac=0, dh=True)`` on 120
  fields of 1920x540.
- ``configs``: the five ``BASELINE.json`` cases at 64 frames each.
- ``pool_compat_fps`` / ``pool_compat_carried_fps``: 32 frames of the dh
  workload with ``pool_compat=True`` at 1920 (stride-aligned) and 1912
  (the pool's pad columns carry state across frames).

Every workload is gated before it is timed: the headline, the bob and each
config bit-equal to the native oracle (``sangnom_tpu_torch.oracle``) on
their first frames, pool_compat bit-equal to the plain pool path
(``opt=0``) on 8 frames.  A failed headline or bob gate prints an error
line and exits 1 before any timing; a failed config or pool gate is
recorded in the JSON and exits 1 after it.

Timing: on the card each window of back-to-back calls is timed with CUDA
events on the current stream and ends in ``torch.cuda.synchronize()``, so a
window holds the host's issue of each call as well as the device work, as a
caller sees it.  On the CPU (``--device cpu``, the tests) ``perf_counter``
times the window.  The kernel library is built before any gate
(``build_s``) and every workload is warmed before its windows.  Without a
card the bench exits 2 unless ``--device cpu`` is given; on the card a
kernel that does not build or launch raises, it never falls back to the
plain path.

Baseline: the reference's own SSE2 path, single core, on this host
(``tools/sse2_baseline``).  With a reference tree (``SANGNOM_REF_DIR``) the
harness is rebuilt against it; otherwise the committed harness binary runs
as it is.  Only if that fails is the figure recorded on another host used,
and ``baseline_provenance`` says so.  ``vs_baseline`` is the card's bob fps
over the baseline.

The regression gate compares the run with the card's own committed history
(``results/cuda_bench_*.json``) of the same backend.

Prints ONE JSON line to stdout; diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from sangnom_tpu_torch import Clip, bob, double_weave, get_format, sangnom2, separate_fields
from sangnom_tpu_torch.oracle import sangnom2_frame_oracle
from sangnom_tpu_torch.utils.cost_model import card_line, utilization

REPO_ROOT = Path(__file__).resolve().parent.parent
SSE2_DIR = REPO_ROOT / "tools" / "sse2_baseline"
SSE2_BINARY = SSE2_DIR / "sse2_baseline"
# The SSE2 harness's best-of-runs on the TPU package's host (2026-08-20,
# one shared vCPU, uncontended): the fallback when no live run succeeds
# here.  It was taken on another host, so it is never a floor for a live
# run on this one.
SSE2_MEASURED_FPS_RECORDED = 119.7
HISTORY_GLOB = "results/cuda_bench_*.json"
METRIC = "1080p_bob_dh_fps_per_chip"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --- regression gate -------------------------------------------------------
# Compares the live numbers with the best of the committed history and flags
# any throughput metric more than REGRESSION_TOL below its best (default
# 10%, override with SANGNOM_BENCH_TOLERANCE as a fraction).  It flags and
# does not exit; parity failures exit nonzero.

try:
    REGRESSION_TOL = float(os.environ.get("SANGNOM_BENCH_TOLERANCE", "0.10"))
except ValueError:
    # the gate must never cost a bench run, not even to an env-var typo
    print("warning: ignoring malformed SANGNOM_BENCH_TOLERANCE "
          f"{os.environ['SANGNOM_BENCH_TOLERANCE']!r}; using 0.10",
          file=sys.stderr)
    REGRESSION_TOL = 0.10

#: throughput keys gated at the top level of the bench JSON
GATED_KEYS = ("value", "order1_dh_fps", "pool_compat_fps",
              "pool_compat_carried_fps")


def flatten_bench(rec: dict) -> dict:
    """Flat {metric: fps} map from one bench JSON (a record may wrap the
    line under "parsed"; a raw bench line is accepted as-is).  A record
    with "parsed": null, or no dict at all, gives {}."""
    if not isinstance(rec, dict):
        return {}
    if "parsed" in rec:
        rec = rec["parsed"]
        if not isinstance(rec, dict):
            return {}
    out = {}
    for k in GATED_KEYS:
        v = rec.get(k)
        if isinstance(v, (int, float)) and v > 0:
            out[k] = float(v)
    for name, cfg in (rec.get("configs") or {}).items():
        v = cfg.get("fps") if isinstance(cfg, dict) else None
        if isinstance(v, (int, float)) and v > 0 and cfg.get("parity") == "ok":
            out[f"configs.{name}"] = float(v)
    return out


def load_bench_history(root: Path) -> list[dict]:
    """Every ``results/cuda_bench_*.json`` record under ``root``, in name
    order; unreadable or non-JSON files are skipped."""
    hist = []
    for p in sorted(Path(root).glob(HISTORY_GLOB)):
        try:
            hist.append(json.loads(p.read_text()))
        except Exception as e:  # the gate must never crash the bench
            log(f"regression gate: skipping {p.name}: {e}")
    return hist


def check_regression(current: dict, history: list[dict],
                     tolerance: float = REGRESSION_TOL,
                     spreads: dict | None = None) -> dict:
    """Returns {"ok", "tolerance_pct", "best", "regressions"}: ``best`` maps
    each gated metric to its best-of-history fps, ``regressions`` lists the
    metrics whose current value is below best * (1 - tol_k).

    ``spreads`` maps a metric to this run's relative window-to-window
    spread (fraction); a metric's tolerance is max(tolerance, spread), and
    the applied tolerance is recorded per flagged metric.  Metrics with no
    history, or not measured this run, pass."""
    spreads = spreads or {}
    best: dict[str, float] = {}
    for rec in history:
        for k, v in flatten_bench(rec).items():
            best[k] = max(best.get(k, 0.0), v)
    cur = flatten_bench(current)
    regressions = []
    for k, floor_src in best.items():
        v = cur.get(k)
        if v is None:
            continue  # metric not measured this run (e.g. --headline-only)
        tol_k = max(tolerance, float(spreads.get(k, 0.0)))
        if v < floor_src * (1.0 - tol_k):
            regressions.append({
                "metric": k, "current": round(v, 1),
                "best": round(floor_src, 1),
                "drop_pct": round((1.0 - v / floor_src) * 100, 1),
                "tolerance_pct": round(tol_k * 100, 1),
            })
    return {
        "ok": not regressions,
        "tolerance_pct": round(tolerance * 100, 1),
        "best": {k: round(v, 1) for k, v in sorted(best.items())},
        "regressions": regressions,
    }


# --- sizes -----------------------------------------------------------------

#: The BASELINE.json config matrix: (name, format, width, height, filter kwargs).
CASES = (
    ("cfg1_640x480_GRAY8_order1", "GRAY8", 640, 480, (("order", 1),)),
    ("cfg2_640x480_YUV420P8_order2", "YUV420P8", 640, 480, (("order", 2),)),
    ("cfg4_1080i_YUV422P10_bob_dh", "YUV422P10", 1920, 540,
     (("order", 0), ("dh", True))),
    ("cfg5_1080p_GRAY16_aa128", "GRAY16", 1920, 1080,
     (("order", 1), ("aa", 128), ("aac", 64))),
    ("cfg5f_540p_YUV444PS", "YUV444PS", 960, 540, (("order", 2),)),
)


@dataclass(frozen=True)
class Sizes:
    """Every size the bench uses; ``FULL`` is the headline bench's."""

    width: int = 1920  # headline field width
    field_height: int = 540  # headline field height (bob frames: twice it)
    fields: int = 120  # dh fields a call = bob output frames a call
    calls: int = 10  # calls a headline window
    trials: int = 5  # headline windows
    cases: tuple = CASES
    cfg_frames: int = 64
    cfg_calls: int = 5
    cfg_windows: int = 4
    pool_frames: int = 32
    pool_width_unaligned: int = 1912
    pool_calls: int = 3
    pool_windows: int = 3
    sse2_frames: int = 30
    sse2_runs: int = 2


FULL = Sizes()
#: the sizes ``main`` runs
SIZES = FULL

BOB_GATE_FRAMES = 2  # interlaced frames -> 4 output frames against the oracle
POOL_GATE_FRAMES = 8  # pool frames held against opt=0


# --- timing ----------------------------------------------------------------

def _window_s(fn, calls: int, on_card: bool) -> float:
    """Seconds a call over one window of ``calls`` back-to-back calls: CUDA
    events on the current stream on the card, ``perf_counter`` on the CPU."""
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls


def _spread(times: list[float]) -> float:
    return (max(times) - min(times)) / max(times)


# --- the SSE2 baseline -----------------------------------------------------

def _run_sse2(frames: int, runs: int) -> float:
    best = 0.0
    for _ in range(runs):
        out = subprocess.run([str(SSE2_BINARY), str(frames)], check=True,
                             capture_output=True, text=True, timeout=600)
        best = max(best, float(json.loads(out.stdout)["value"]))
    return best


def measure_sse2_baseline(frames: int = 30, runs: int = 2) -> tuple[float, str, float]:
    """(fps, provenance, live_fps) of the reference SSE2 path on one core of
    this host, best of ``runs`` runs of ``frames`` frames.  ``live_fps`` is
    0.0 when no live run succeeded and the recorded figure stands in."""
    ref = os.environ.get("SANGNOM_REF_DIR")
    try:
        if ref and (Path(ref) / "SangNom2_SSE2.cpp").exists():
            subprocess.run(["make", "-s", f"REF_DIR={ref}"], cwd=SSE2_DIR, check=True,
                           capture_output=True, text=True, timeout=300)
            how = "measured live on this host (tools/sse2_baseline rebuilt from SANGNOM_REF_DIR)"
        else:
            how = ("measured live on this host (committed tools/sse2_baseline binary; "
                   "no reference tree)")
        best = _run_sse2(frames, runs)
        return best, how, best
    except Exception as e:  # no binary, not runnable here, build failure
        return SSE2_MEASURED_FPS_RECORDED, (
            "recorded 2026-08-20 on another host (the TPU package's shared vCPU); "
            f"live run failed: {e}"), 0.0


# --- the workloads ---------------------------------------------------------

def _failure(error: str) -> dict:
    return {"metric": METRIC, "value": 0.0, "unit": "frames/s",
            "vs_baseline": 0.0, "error": error}


def _backend_of(rec) -> str | None:
    """The "backend" of a history record (raw or wrapped under "parsed")."""
    if isinstance(rec, dict) and "parsed" in rec:
        rec = rec["parsed"]
    return rec.get("backend") if isinstance(rec, dict) else None


def _device_info(on_card: bool) -> dict:
    if not on_card:
        return {"name": "cpu", "power_limit": None}
    name, _, limit = card_line().rpartition(", ")
    return {"name": name, "power_limit": limit}


def _config_matrix(s: Sizes, rng, dev, on_card: bool) -> dict:
    """The BASELINE.json configs: parity gate and throughput for each.
    Returns {name: {"fps", "parity": "ok"|"FAIL", "spread_pct"}}.  Chroma
    planes draw from the same full-range generator as luma, and the one
    shared ``rng`` makes the matrix deterministic as a whole."""
    B = s.cfg_frames
    results = {}
    for name, fname, w, h, kw in s.cases:
        kw = dict(kw)
        fmt = get_format(fname)
        planes = []
        for i in range(fmt.num_planes):
            pw, ph = fmt.plane_dims(w, h, i)
            if fmt.is_float:
                planes.append(rng.random((B, ph, pw), np.float32))
            else:
                top = (1 << (8 * fmt.component_size)) - 1
                planes.append(rng.integers(0, top + 1, (B, ph, pw)).astype(fmt.np_dtype))
        clip = Clip.from_numpy(planes, fmt, device=dev)
        clip1 = Clip.from_numpy([p[:1] for p in planes], fmt, device=dev)
        out1 = sangnom2(clip1, opt=-1, **kw)
        want = sangnom2_frame_oracle([p[0] for p in planes], fmt,
                                     frame_parity=clip1.get_parity(0), **kw)
        parity_ok = all(np.array_equal(out1.planes[i][0].cpu().numpy(), want[i])
                        for i in range(fmt.num_planes))

        def call():
            return sangnom2(clip, opt=-1, **kw)

        call()  # warm: one call and one window-shaped pass
        _window_s(call, s.cfg_calls, on_card)
        times = [_window_s(call, s.cfg_calls, on_card) for _ in range(s.cfg_windows)]
        fps = B / min(times)
        spread = _spread(times)
        results[name] = {
            "fps": round(fps, 1), "parity": "ok" if parity_ok else "FAIL",
            "spread_pct": round(spread * 100, 1),
        }
        log(f"  {name}: {fps:8.0f} frames/s parity={results[name]['parity']}"
            f" (window spread {spread * 100:.0f}%)")
    return results


def _time_pool(planes_p: list, fmt, kwargs: dict, s: Sizes, dev, on_card: bool,
               label: str):
    """pool_compat frames/s of ``planes_p`` after its gate: the default route
    bit-equal to the plain pool path (``opt=0``) on the first 8 frames.
    Returns (fps, spread) or None when the gate fails."""
    clip_p = Clip.from_numpy(planes_p, fmt, device=dev)
    p8 = Clip.from_numpy([p[:POOL_GATE_FRAMES] for p in planes_p], fmt, device=dev)
    ref = sangnom2(p8, pool_compat=True, opt=0, **kwargs)
    got = sangnom2(p8, pool_compat=True, **kwargs)
    if not all(torch.equal(a, b) for a, b in zip(got.planes, ref.planes)):
        log(f"POOL-COMPAT PARITY FAILURE ({label})")
        return None
    del ref, got

    def call():
        return sangnom2(clip_p, pool_compat=True, **kwargs)

    call()  # warm
    times = [_window_s(call, s.pool_calls, on_card) for _ in range(s.pool_windows)]
    f = planes_p[0].shape[0] / min(times)
    log(f"pool_compat {label}: {f:.1f} frames/s "
        f"(sequential carried-state scan, best of {s.pool_windows} windows)")
    return f, _spread(times)


def run(device="cuda", sizes: Sizes = FULL, headline_only: bool = False) -> tuple[dict, int]:
    """Run the bench on ``device``; returns (the JSON record, exit code)."""
    s = sizes
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    backend = dev.type
    card = _device_info(on_card)
    log(f"device: {dev} ({card['name']}, power limit {card['power_limit']})")

    build_s = 0.0
    if on_card:
        from sangnom_tpu_torch.ops import deint_kernel

        t0 = time.perf_counter()
        deint_kernel._load()  # builds the kernel library unless it is current
        build_s = time.perf_counter() - t0
        log(f"kernel library: built or loaded in {build_s:.1f} s "
            f"({deint_kernel.BUILDS} nvcc build(s))")

    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(7)
    B, H, W = s.fields, s.field_height, s.width
    planes = [
        rng.integers(0, 256, (B, H, W)).astype(np.uint8),
        rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.uint8),
        rng.integers(0, 256, (B, H // 2, W // 2)).astype(np.uint8),
    ]
    clip = Clip.from_numpy(planes, fmt, device=dev)
    kwargs = dict(order=1, aa=48, aac=0, dh=True)

    # --- correctness gate: frame 0 bit-exact against the native oracle -----
    clip1 = Clip.from_numpy([p[:1] for p in planes], fmt, device=dev)
    out = sangnom2(clip1, opt=-1, **kwargs)
    want = sangnom2_frame_oracle([p[0] for p in planes], fmt, **kwargs)
    for i in range(3):
        if not np.array_equal(out.planes[i][0].cpu().numpy(), want[i]):
            log(f"BIT-EXACTNESS FAILURE plane {i}")
            return _failure("parity"), 1
    log("bit-exactness vs native oracle: OK (all planes)")

    # --- order=1 dh throughput ---------------------------------------------
    def dh_call():
        return sangnom2(clip, opt=-1, **kwargs)

    dh_call()  # warm: one call and one trial-shaped window, untimed
    _window_s(dh_call, s.calls, on_card)
    trials_o1 = [_window_s(dh_call, s.calls, on_card) for _ in range(s.trials)]
    dt_o1 = min(trials_o1)
    fps_o1 = B / dt_o1
    log(f"{backend} order=1 dh: {dt_o1 * 1e3:.3f} ms / {B} frames "
        f"-> {fps_o1:.0f} frames/s (best of {s.trials} windows of {s.calls} calls)")

    # --- TRUE BOB: the metric's literal workload ----------------------------
    B_in = B // 2  # interlaced frames -> B output frames
    bob_planes = [
        rng.integers(0, 256, (B_in, 2 * H, W)).astype(np.uint8),
        rng.integers(0, 256, (B_in, H, W // 2)).astype(np.uint8),
        rng.integers(0, 256, (B_in, H, W // 2)).astype(np.uint8),
    ]
    clip_bob = Clip.from_numpy(bob_planes, fmt, device=dev, tff=True)
    # parity gate: 2 input frames -> 4 output frames, each against the
    # oracle on the woven frame it is defined to equal
    clip2 = Clip.from_numpy([p[:BOB_GATE_FRAMES] for p in bob_planes], fmt,
                            device=dev, tff=True)
    out_bob = [p.cpu().numpy() for p in bob(clip2).planes]
    woven = double_weave(separate_fields(clip2))
    woven_np = woven.to_numpy()
    for n in range(2 * BOB_GATE_FRAMES):
        want = sangnom2_frame_oracle([p[n] for p in woven_np], fmt, order=0,
                                     frame_parity=woven.get_parity(n))
        for i in range(3):
            if not np.array_equal(out_bob[i][n], want[i]):
                log(f"BOB BIT-EXACTNESS FAILURE frame {n} plane {i}")
                return _failure("bob parity"), 1
    log("true-bob bit-exactness vs native oracle: OK (4 frames x 3 planes)")

    def bob_call():
        return bob(clip_bob)

    bob_call()  # warm, then one untimed trial-shaped window
    _window_s(bob_call, s.calls, on_card)
    trials = [_window_s(bob_call, s.calls, on_card) for _ in range(s.trials)]
    dt = min(trials)
    spread = (max(trials) - dt) / dt * 100
    fps = B / dt  # B output frames per bob() call
    log(f"{backend} TRUE BOB: {dt * 1e3:.3f} ms / {B} output frames -> {fps:.0f} "
        f"frames/s (best of {s.trials} windows of {s.calls} calls; spread {spread:.0f}%)")

    # --- roofline against the card's int32 peak -----------------------------
    util = utilization(fps_o1, fmt, W, H, dh=True)
    log(f"roofline: {util['ops_per_frame'] / 1e6:.0f}M ops/frame (the TPU kernel's "
        f"accounting) -> {util['achieved_ops_per_s'] / 1e12:.2f} Tops/s = "
        f"{util['utilization'] * 100:.0f}% of the card's int32 issue peak "
        f"({util['int32_peak_ops_per_s'] / 1e12:.2f} Tops/s), "
        f"{util['vs_measured_achievable'] * 100:.0f}% of the measured `mix` rate "
        f"({util['measured_achievable_ops_per_s'] / 1e12:.2f} Tops/s, "
        f"tools.calibrate_vpu)")

    # --- baseline: the reference's own SSE2 path, single core ---------------
    sse2_fps, provenance, sse2_live_fps = measure_sse2_baseline(s.sse2_frames, s.sse2_runs)
    log(f"reference SSE2 baseline: {sse2_fps:.1f} fps [{provenance}]")

    # --- the config matrix and pool_compat ----------------------------------
    configs = {}
    pool_fps = pool_carried_fps = None
    pool_parity_fail = False
    spreads = {"value": _spread(trials), "order1_dh_fps": _spread(trials_o1)}
    if not headline_only:
        log("config matrix (BASELINE.json):")
        configs = _config_matrix(s, rng, dev, on_card)
        for name, c in configs.items():
            spreads[f"configs.{name}"] = c["spread_pct"] / 100.0
        if any(c["parity"] != "ok" for c in configs.values()):
            log("CONFIG-MATRIX PARITY FAILURE")
        Bp, uw = s.pool_frames, s.pool_width_unaligned
        pool_fps = _time_pool([p[:Bp] for p in planes], fmt, kwargs, s, dev, on_card,
                              f"{W}x{2 * H} 4:2:0 stride-aligned")
        pool_carried_fps = _time_pool(
            [planes[0][:Bp, :, :uw], planes[1][:Bp, :, :uw // 2],
             planes[2][:Bp, :, :uw // 2]],
            fmt, kwargs, s, dev, on_card, f"{uw}x{2 * H} 4:2:0 unaligned")
        pool_parity_fail = pool_fps is None or pool_carried_fps is None
        if pool_fps is not None:
            pool_fps, spreads["pool_compat_fps"] = pool_fps
        if pool_carried_fps is not None:
            pool_carried_fps, spreads["pool_compat_carried_fps"] = pool_carried_fps

    result = {
        "metric": METRIC,
        "value": round(fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(fps / sse2_fps, 2),
        "order1_dh_fps": round(fps_o1, 1),
        "baseline_sse2_fps": round(sse2_fps, 1),
        "baseline_sse2_live_fps": round(sse2_live_fps, 1),
        "baseline_provenance": provenance,
        "trials_ms": [round(t * 1e3, 3) for t in trials],
        "order1_trials_ms": [round(t * 1e3, 3) for t in trials_o1],
        "pool_compat_fps": None if pool_fps is None else round(pool_fps, 1),
        "pool_compat_carried_fps": (
            None if pool_carried_fps is None else round(pool_carried_fps, 1)),
        "utilization_pct": round(util["utilization"] * 100, 1),
        "vs_measured_achievable_pct": round(util["vs_measured_achievable"] * 100, 1),
        "trial_spread_pct": round(spread, 1),
        "backend": backend,
        "device": card,
        "build_s": round(build_s, 1),
        "batch": B,
        "configs": configs,
    }
    # --- regression gate against this backend's committed history ----------
    history = [h for h in load_bench_history(REPO_ROOT) if _backend_of(h) == backend]
    gate = check_regression(result, history, spreads=spreads)
    result["regression"] = gate
    for r in gate["regressions"]:
        log(f"REGRESSION: {r['metric']} {r['current']} fps is {r['drop_pct']}% below "
            f"historical best {r['best']} fps (tolerance {r['tolerance_pct']}%)")
    failed = any(c["parity"] != "ok" for c in configs.values()) or pool_parity_fail
    return result, 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m sangnom_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--headline-only", action="store_true",
                   help="skip the config matrix and pool_compat")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    args = p.parse_args(argv)
    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        log(f"bench: invalid --device {args.device!r} ({e})")
        return 2
    if dev.type == "cuda" and not torch.cuda.is_available():
        log(f"bench: --device {args.device}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to run on the CPU")
        return 2
    result, rc = run(dev, SIZES, headline_only=args.headline_only)
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
