"""Randomized parity campaign on the CPU: the plain path (``opt=0``)
against the native oracle over hundreds of random configs, then a compat
arm (pool_compat x numerics, multi-frame clips).

    python -m sangnom_tpu_torch.tools.parity_campaign_cpu [n_random] [seed_base] [n_compat]

The draws are those of the TPU package's ``tools/parity_campaign_cpu.py``
(N 300, seed 77000, case c from ``default_rng(seed + c)``; the compat arm NC
60 from ``default_rng(seed + 11000 + c)``).  The compat arm's C-numerics
cases, pool_compat or not, are held against the oracle, which implements
the shared pool; its SSE2 cases have no anchor here (the oracle is the C
contract) and are counted as unanchored.  Any mismatch prints the config.
"""

from __future__ import annotations

import sys

import numpy as np

from sangnom_tpu_torch.core.formats import get_format

FMTS = ["GRAY8", "GRAY10", "GRAY12", "GRAY14", "GRAY16", "GRAYS",
        "YUV420P8", "YUV420P16", "YUV420PS", "YUV422P8", "YUV422P10",
        "YUV422PS", "YUV444P8", "YUV444P12", "YUV444PS",
        "YUVA420P8", "YUVA444P16"]
C_FMTS = ["GRAY8", "YUV420P8", "YUV420P16", "YUV422P8", "YUV411P8",
          "YUV444P8", "YUV420PS"]
N_RANDOM, SEED, N_COMPAT = 300, 77000, 60


def _plane(rng, fmt, w: int, h: int, i: int) -> np.ndarray:
    pw, ph = fmt.plane_dims(w, h, i)
    if fmt.is_float:
        return (rng.random((ph, pw), np.float32) * 2 - 0.5).astype(np.float32)
    top = (1 << (8 * fmt.component_size)) - 1
    return rng.integers(0, top + 1, (ph, pw)).astype(fmt.np_dtype)


def random_case(case: int, seed: int = SEED) -> dict:
    """Random case ``case``: format, geometry, filter arguments, field
    dominance and one frame of planes."""
    rng = np.random.default_rng(seed + case)
    fmt = get_format(FMTS[int(rng.integers(len(FMTS)))])
    w = int(rng.integers(1, 90)) * 2
    h = int(rng.integers(1, 24)) * 4
    kw = dict(order=int(rng.integers(0, 3)), aa=int(rng.integers(0, 129)),
              aac=int(rng.integers(0, 129)), dh=bool(rng.integers(0, 2)),
              luma=bool(rng.integers(0, 2)), chroma=bool(rng.integers(0, 2)))
    tff = bool(rng.integers(0, 2))
    planes = [_plane(rng, fmt, w, h, i) for i in range(fmt.num_planes)]
    return dict(fmt=fmt, w=w, h=h, kw=kw, tff=tff, planes=planes)


def compat_case(case: int, seed: int = SEED) -> dict:
    """Compat case ``case``: a 2-3 frame clip with per-frame parities,
    pool_compat and numerics drawn."""
    rng = np.random.default_rng(seed + 11000 + case)
    fmt = get_format(C_FMTS[int(rng.integers(len(C_FMTS)))])
    w = int(rng.integers(4, 17)) * 4
    h = int(rng.integers(2, 5)) * 4
    nfr = int(rng.integers(2, 4))
    kw = dict(order=int(rng.integers(0, 3)), aa=int(rng.integers(0, 129)),
              aac=int(rng.integers(0, 129)), dh=bool(rng.integers(0, 2)),
              luma=bool(rng.integers(0, 2)), chroma=bool(rng.integers(0, 2)))
    pool_compat = bool(rng.integers(0, 2))
    numerics = "sse2" if rng.integers(0, 2) and not fmt.is_float else "c"
    parities = [bool(rng.integers(0, 2)) for _ in range(nfr)]
    frames = [[_plane(rng, fmt, w, h, i) for i in range(fmt.num_planes)]
              for _ in range(nfr)]
    return dict(fmt=fmt, w=w, h=h, kw=kw, pool_compat=pool_compat,
                numerics=numerics, parities=parities, frames=frames)


def run_compat_case(d: dict):
    """The port's plain path on a compat case: the output clip's planes as
    numpy arrays [n, ph, pw]."""
    from sangnom_tpu_torch import Clip, sangnom2

    fmt, frames = d["fmt"], d["frames"]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    clip = Clip.from_numpy(planes, fmt, device="cpu", parity=np.asarray(d["parities"]))
    return sangnom2(clip, pool_compat=d["pool_compat"], numerics=d["numerics"], opt=0,
                    **d["kw"]).to_numpy()


def _mismatch(g: np.ndarray, wp: np.ndarray) -> str:
    d = g.astype(np.float64) - wp.astype(np.float64)
    return f"{np.count_nonzero(d)} px, max {np.abs(d).max()}"


def main(argv: list[str] | None = None) -> int:
    from sangnom_tpu_torch import Clip, sangnom2
    from sangnom_tpu_torch.oracle import sangnom2_clip_oracle, sangnom2_frame_oracle

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if len(argv) > 0 else N_RANDOM
    seed = int(argv[1]) if len(argv) > 1 else SEED
    nc = int(argv[2]) if len(argv) > 2 else N_COMPAT

    fails = 0
    for case in range(n):
        d = random_case(case, seed)
        fmt, kw = d["fmt"], d["kw"]
        clip = Clip.from_numpy([p[None] for p in d["planes"]], fmt, device="cpu",
                               tff=d["tff"])
        got = sangnom2(clip, opt=0, **kw).to_numpy()
        want = sangnom2_frame_oracle(d["planes"], fmt, frame_parity=d["tff"], **kw)
        for i, wp in enumerate(want):
            if not np.array_equal(got[i][0], wp):
                fails += 1
                print(f"MISMATCH case {case}: {fmt.name} {d['w']}x{d['h']} {kw} "
                      f"tff={d['tff']} plane {i}: {_mismatch(got[i][0], wp)}", flush=True)
        if case % 50 == 49:
            print(f"{case + 1}/{n} done, {fails} failures", flush=True)
    print(f"CAMPAIGN DONE: {n} configs, {fails} failures", flush=True)

    cfails = unanchored = 0
    for case in range(nc):
        d = compat_case(case, seed)
        fmt, kw = d["fmt"], d["kw"]
        got = run_compat_case(d)
        if d["numerics"] != "c":
            unanchored += 1
            continue
        want = sangnom2_clip_oracle(d["frames"], fmt, parities=d["parities"],
                                    pool_compat=d["pool_compat"], **kw)
        for f in range(len(d["frames"])):
            for i, wp in enumerate(want[f]):
                if not np.array_equal(got[i][f], wp):
                    cfails += 1
                    print(f"COMPAT MISMATCH case {case}: {fmt.name} {d['w']}x{d['h']} "
                          f"n={len(d['frames'])} {kw} pool={d['pool_compat']} "
                          f"parities={d['parities']} frame {f} plane {i}: "
                          f"{_mismatch(got[i][f], wp)}", flush=True)
        if case % 20 == 19:
            print(f"compat {case + 1}/{nc} done, {cfails} failures", flush=True)
    print(f"COMPAT CAMPAIGN DONE: {nc} configs, {cfails} failures, "
          f"{unanchored} unanchored (sse2)")
    return 1 if fails + cfails else 0


if __name__ == "__main__":
    sys.exit(main())
