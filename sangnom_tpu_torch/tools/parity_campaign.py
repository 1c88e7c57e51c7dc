"""Parity campaign on the card: the production path at API level against
the native oracle and the plain path, across format families, geometries
and the compat, bob and sharded routes.

    python -m sangnom_tpu_torch.tools.parity_campaign [--device cuda|cpu]
    python -m sangnom_tpu_torch.tools.parity_campaign --random N [seed]
    python -m sangnom_tpu_torch.tools.parity_campaign --compat N [seed]
    python -m sangnom_tpu_torch.tools.parity_campaign --bob N [seed]
    python -m sangnom_tpu_torch.tools.parity_campaign --sharded N [seed]

With no mode flag it runs the fixed 12-case set (``CASES``); a mode flag
draws N cases from its generator (default seed 20260817).  The generators
draw in the same order as the TPU package's ``tools/parity_campaign_tpu.py``,
and case k's planes come from ``default_rng(500 + k)``, so the case lines
equal that tool's line for line.  Modes:

- oracle (the fixed set, ``--random``): ``sangnom2(opt=1)`` against the
  native oracle on frames {0, n-1};
- compat: ``opt=1`` against ``opt=0`` on the whole clip, anchored on the
  oracle where ``numerics == "c"``; pool_compat cases run once more with
  ``pool_carry.POOL_FAST`` set, and say whether the frame-parallel route ran;
- bob: ``bob(opt=1)`` against SeparateFields -> DoubleWeave ->
  ``sangnom2(order=0, opt=0)``, anchored on the oracle;
- sharded: ``sangnom2_sharded`` on a 1x1 mesh (the case line), a 1x4 mesh
  of the card and ``cross_device.sangnom2_across`` over two slots of it,
  each against unsharded ``opt=0``, anchored on the oracle for C numerics.

``--device cpu`` runs the plain path (``opt=0``) in place of the kernels;
it exists for the CPU tests.  A case that raises is a failure and prints
its config and traceback.  The last line is ``CUDA CAMPAIGN DONE: N cases,
F failures`` (``CPU ...`` on the CPU); the exit code is 1 on any failure.
On the card the first line is the card's name and power limit, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from sangnom_tpu_torch.core.formats import get_format

DEFAULT_SEED = 20260817

CASES = [
    # (fmt, w, h, n, kwargs)
    ("GRAY8", 640, 480, 2, dict(order=1)),
    ("YUV420P8", 640, 480, 2, dict(order=2)),
    ("YUV420P8", 640, 480, 2, dict(order=1, dh=True)),
    ("YUV422P10", 1920, 540, 2, dict(order=0, dh=True)),  # 1080i bob fields
    ("GRAY16", 1920, 1080, 1, dict(order=1, aa=128, aac=64)),
    ("YUV444PS", 960, 540, 1, dict(order=2, aa=48, aac=16)),
    ("YUV420P8", 1920, 1080, 9, dict(order=1, aa=48, aac=48)),
    ("GRAY8", 1919, 1080, 1, dict(order=2)),  # odd width: a partial column group
    ("YUVA420P8", 640, 480, 1, dict(order=1, dh=True)),  # alpha + dh
    ("YUV411P8", 640, 480, 1, dict(order=1, aa=48, aac=48)),  # 4:1:1 chroma
    # 4K: the luma on the wide route (K4 over a cluster of 4-column blocks)
    ("YUV420P8", 3840, 2160, 2, dict(order=1, aa=48, aac=48)),
    ("GRAY16", 3840, 1080, 1, dict(order=2, dh=True)),
]

RANDOM_FORMATS = [
    "GRAY8", "GRAY10", "GRAY16", "YUV420P8", "YUV420P10", "YUV420P16",
    "YUV422P8", "YUV422P12", "YUV444P8", "YUV444P14", "YUV411P8",
    "YUVA420P8", "YUVA444P16", "GRAYS", "YUV444PS",
]


def random_cases(n_cases: int, seed: int):
    """Random format, geometry (mod 4, for 4:1:1), order, dh, aa, aac and
    plane masks."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        fname = RANDOM_FORMATS[rng.integers(len(RANDOM_FORMATS))]
        w = int(rng.integers(24, 260)) * 4
        h = int(rng.integers(4, 180)) * 4
        kw = dict(
            order=int(rng.integers(3)),
            dh=bool(rng.integers(2)),
            aa=int(rng.integers(129)),
            aac=int(rng.integers(129)),
            luma=bool(rng.integers(2)),
            chroma=bool(rng.integers(2)),
        )
        # without dh, a case whose processed planes are all masked off
        # copies its input: process luma instead
        has_chroma = get_format(fname).num_planes > 1
        if not kw["dh"] and not kw["luma"] and not (kw["chroma"] and has_chroma):
            kw["luma"] = True
        cases.append((fname, w, h, int(rng.integers(1, 4)), kw))
    return cases


def compat_cases(n_cases: int, seed: int):
    """Random cases over the compat axes (numerics="sse2", pool_compat);
    every case takes at least one of them."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        fname = RANDOM_FORMATS[rng.integers(len(RANDOM_FORMATS))]
        w = int(rng.integers(24, 200)) * 4
        h = int(rng.integers(4, 140)) * 4
        kw = dict(
            order=int(rng.integers(3)),
            dh=bool(rng.integers(2)),
            aa=int(rng.integers(129)),
            aac=int(rng.integers(129)),
            pool_compat=bool(rng.integers(2)),
        )
        if not get_format(fname).is_float:
            kw["numerics"] = "sse2" if rng.integers(2) else "c"
            if not kw["pool_compat"] and kw["numerics"] == "c":
                kw["numerics"] = "sse2"
        elif not kw["pool_compat"]:
            # float ignores numerics="sse2": take pool_compat instead
            kw["pool_compat"] = True
        cases.append((fname, w, h, int(rng.integers(1, 3)), kw))
    return cases


def bob_cases(n_cases: int, seed: int):
    """Random interlaced clips for the bob; the alpha formats are left out,
    as in the TPU campaign."""
    rng = np.random.default_rng(seed)
    fmts = [f for f in RANDOM_FORMATS if "A" not in f]
    cases = []
    for _ in range(n_cases):
        fname = fmts[rng.integers(len(fmts))]
        w = int(rng.integers(24, 200)) * 4
        h = int(rng.integers(6, 120)) * 4
        kw = dict(
            aa=int(rng.integers(129)),
            aac=int(rng.integers(129)),
            tff=bool(rng.integers(2)),
        )
        cases.append((fname, w, h, int(rng.integers(1, 4)), kw))
    return cases


def sharded_cases(n_cases: int, seed: int):
    """Random cases through ``sangnom2_sharded``, each with one ``smooth``
    arm and, for integer formats, C or SSE2 numerics."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        fname = RANDOM_FORMATS[rng.integers(len(RANDOM_FORMATS))]
        w = int(rng.integers(24, 200)) * 4
        h = int(rng.integers(4, 140)) * 4
        kw = dict(
            order=int(rng.integers(3)),
            dh=bool(rng.integers(2)),
            aa=int(rng.integers(129)),
            aac=int(rng.integers(129)),
            smooth=("fused", "chunked", "scan", "fused_noweave")[rng.integers(4)],
        )
        if not get_format(fname).is_float and rng.integers(2):
            kw["numerics"] = "sse2"
        cases.append((fname, w, h, int(rng.integers(1, 4)), kw))
    return cases


# flag -> (generator, mode, banner)
MODES = {
    "--random": (random_cases, "oracle", "full random draw vs oracle"),
    "--compat": (compat_cases, "compat", "opt=1 vs opt=0 on device"),
    "--bob": (bob_cases, "bob",
              "bob opt=1 vs explicit pipeline opt=0 + oracle anchor"),
    "--sharded": (sharded_cases, "sharded",
                  "sangnom2_sharded on 1x1 and 1x4 meshes and across 2 slots "
                  "vs unsharded opt=0 + oracle anchor"),
}
_PREFIX = {"oracle": "", "compat": "", "bob": "bob ", "sharded": "sharded "}


def case_line(k: int, total: int, case, mode: str) -> str:
    """A case's line without its verdict: ``[k/N] <prefix>FMT WxH n=.. {kw}``
    with ``k`` counted from 0."""
    fname, w, h, n, kw = case
    return f"[{k + 1}/{total}] {_PREFIX[mode]}{fname} {w}x{h} n={n} {kw}"


def synth_planes(k: int, case) -> tuple[list[np.ndarray], np.random.Generator]:
    """Case k's planes [n, ph, pw] from ``default_rng(500 + k)``: full-range
    integers, floats in [-0.5, 1.5).  Returns the generator too, for the
    sharded mode's per-frame parity draw that follows."""
    fname, w, h, n, _ = case
    fmt = get_format(fname)
    rng = np.random.default_rng(500 + k)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        if fmt.is_float:
            planes.append((rng.random((n, ph, pw), np.float32) * 2 - 0.5).astype(np.float32))
        else:
            top = (1 << (8 * fmt.component_size)) - 1
            planes.append(rng.integers(0, top + 1, (n, ph, pw)).astype(fmt.np_dtype))
    return planes, rng


def first_diff(got: np.ndarray, want: np.ndarray) -> str:
    """How two planes differ: the count and the first differing pixel."""
    if got.shape != want.shape:
        return f"shape {got.shape} != {want.shape}"
    bad = np.argwhere(got != want)
    at = tuple(int(x) for x in bad[0])
    return (f"{len(bad)} px differ, first at {at}: got {got[at].item()!r}, "
            f"want {want[at].item()!r}")


class _Case:
    """One case's comparisons: each mismatch prints a line with the case's
    config and counts one failure."""

    def __init__(self, config: str):
        self.config = config
        self.fails = 0

    def compare(self, what: str, got: np.ndarray, want: np.ndarray) -> None:
        if not np.array_equal(got, want):
            self.fails += 1
            print(f"{what} MISMATCH {self.config}: {first_diff(got, want)}", flush=True)

    def clips(self, what: str, got, want) -> None:
        """Every plane of two clips."""
        if got.num_planes != want.num_planes:
            self.fails += 1
            print(f"{what} MISMATCH {self.config}: {got.num_planes} planes, "
                  f"want {want.num_planes}", flush=True)
        for i, (g, w) in enumerate(zip(got.to_numpy(), want.to_numpy())):
            self.compare(f"{what} plane {i}", g, w)

    def oracle(self, what: str, got_np, frames, want_fn) -> None:
        """Frames ``frames`` of the numpy planes ``got_np`` against
        ``want_fn(frame)``, the oracle's planes of that frame."""
        for fr in sorted(frames):
            for i, wp in enumerate(want_fn(fr)):
                self.compare(f"{what} frame {fr} plane {i}", got_np[i][fr], wp)

    def route(self, name: str, fn) -> str:
        """An extra route's indented line: ``fn()`` runs its comparisons."""
        before = self.fails
        fn()
        return f"    {name}: {'OK' if self.fails == before else f'FAIL ({self.fails - before})'}"


def _run_oracle(c: _Case, planes, rng, fmt, n, kw, opt, device, stats) -> list[str]:
    from sangnom_tpu_torch import Clip, sangnom2
    from sangnom_tpu_torch.oracle import sangnom2_frame_oracle

    clip = Clip.from_numpy(planes, fmt, device=device)
    got = sangnom2(clip, opt=opt, **kw).to_numpy()
    c.oracle("ORACLE", got, {0, n - 1}, lambda fr: sangnom2_frame_oracle(
        [p[fr] for p in planes], fmt, frame_parity=clip.get_parity(fr), **kw))
    return []


def _run_compat(c: _Case, planes, rng, fmt, n, kw, opt, device, stats) -> list[str]:
    from sangnom_tpu_torch import Clip, sangnom2
    from sangnom_tpu_torch.ops import pool_carry, pool_kernel
    from sangnom_tpu_torch.oracle import sangnom2_clip_oracle

    clip = Clip.from_numpy(planes, fmt, device=device)
    got = sangnom2(clip, opt=opt, **kw)
    want = sangnom2(clip, opt=0, **kw)
    c.clips("OPT0", got, want)
    if kw.get("numerics", "c") == "c":
        # the oracle anchors a stage that both routes share
        okw = {k: v for k, v in kw.items() if k != "numerics"}
        want_o = sangnom2_clip_oracle(
            [[p[f] for p in planes] for f in range(n)], fmt,
            parities=[clip.get_parity(f) for f in range(n)], **okw)
        c.oracle("ORACLE", got.to_numpy(), {0, n - 1}, lambda fr: want_o[fr])
    if not kw["pool_compat"]:
        return []
    # the frame-parallel route runs where frames are provably independent
    # of the carried pool, on the kernel route; its prepare launches (one a
    # chunk and plane, against one a frame and plane in order) show it ran
    indep = pool_carry._frames_independent(planes[0].shape[2], planes[0].shape[1],
                                           fmt, kw["dh"], True)
    on_card = torch.device(device).type == "cuda"
    ran = on_card and opt != 0 and indep
    chunks = -(-n // max(1, pool_carry.POOL_FAST_BATCH)) if ran else n
    expect = min(fmt.num_planes, 3) * chunks if on_card else 0

    def fast_arm():
        before = pool_kernel.LAUNCHES["prepare"]
        saved = pool_carry.POOL_FAST
        pool_carry.POOL_FAST = True
        try:
            fast = sangnom2(clip, opt=opt, **kw)
        finally:
            pool_carry.POOL_FAST = saved
        prepared = pool_kernel.LAUNCHES["prepare"] - before
        c.clips("POOL_FAST", fast, want)
        if prepared != expect:
            c.fails += 1
            print(f"POOL_FAST LAUNCHES {c.config}: {prepared} prepare launches, "
                  f"expected {expect}", flush=True)

    line = c.route("POOL_FAST", fast_arm)
    stats["pool"] = stats.get("pool", 0) + 1
    stats["fast"] = stats.get("fast", 0) + int(ran)
    return [f"{line} (frames independent: {indep}; "
            f"{'fast route' if ran else 'sequential route'}, {expect} prepare launches)"]


def _run_bob(c: _Case, planes, rng, fmt, n, kw, opt, device, stats) -> list[str]:
    from sangnom_tpu_torch import Clip, sangnom2
    from sangnom_tpu_torch.core.fields import bob, double_weave, separate_fields
    from sangnom_tpu_torch.oracle import sangnom2_frame_oracle

    bkw = {k: v for k, v in kw.items() if k != "tff"}
    clip = Clip.from_numpy(planes, fmt, device=device, tff=kw["tff"])
    got = bob(clip, opt=opt, **bkw)
    woven = double_weave(separate_fields(clip))
    c.clips("BOB", got, sangnom2(woven, order=0, opt=0, **bkw))
    woven_np = woven.to_numpy()
    c.oracle("BOB ORACLE", got.to_numpy(), {0, 2 * n - 1}, lambda fr: sangnom2_frame_oracle(
        [p[fr] for p in woven_np], fmt, order=0, frame_parity=woven.get_parity(fr), **bkw))
    return []


def _run_sharded(c: _Case, planes, rng, fmt, n, kw, opt, device, stats) -> list[str]:
    from sangnom_tpu_torch import Clip, sangnom2
    from sangnom_tpu_torch.oracle import sangnom2_frame_oracle
    from sangnom_tpu_torch.parallel import cross_device, default_mesh, sangnom2_sharded

    parity = None
    if kw.get("order") == 0 and n > 1:
        # mixed per-frame parity: the per-frame weave offsets of the kernels
        parity = np.asarray(rng.integers(0, 2, n), dtype=bool)
    clip = Clip.from_numpy(planes, fmt, device=device, parity=parity)
    base_kw = {k: v for k, v in kw.items() if k != "smooth"}
    want = sangnom2(clip, opt=0, **base_kw)
    got = sangnom2_sharded(clip, default_mesh(1, 1, devices=[device]),
                           space_axis="space", opt=opt, **kw)
    c.clips("SHARDED", got, want)
    if kw.get("numerics", "c") == "c":
        okw = {k: v for k, v in base_kw.items() if k != "numerics"}
        c.oracle("SHARDED ORACLE", got.to_numpy(), {0, n - 1}, lambda fr: sangnom2_frame_oracle(
            [p[fr] for p in planes], fmt, frame_parity=clip.get_parity(fr), **okw))
    return [
        c.route("mesh 1x4", lambda: c.clips("MESH 1x4", sangnom2_sharded(
            clip, default_mesh(1, 4, devices=[device] * 4), space_axis="space",
            opt=opt, **kw), want)),
        c.route("across 2 slots", lambda: c.clips("ACROSS", cross_device.sangnom2_across(
            clip, [device] * 2, opt=opt, **kw), want)),
    ]


_RUNNERS = {"oracle": _run_oracle, "compat": _run_compat, "bob": _run_bob,
            "sharded": _run_sharded}


def run_cases(cases, mode: str, device: str = "cuda", stats: dict | None = None) -> int:
    """Run ``cases`` (case k's planes from ``default_rng(500 + k)``) in
    ``mode`` ("oracle", "compat", "bob" or "sharded") on ``device``; print
    a line a case and return the failures.  ``stats``, when given, gains
    "pool" (pool_compat cases of the compat mode) and "fast" (those that
    took the frame-parallel route)."""
    stats = {} if stats is None else stats
    opt = 1 if torch.device(device).type == "cuda" else 0
    fails = 0
    for k, case in enumerate(cases):
        fmt = get_format(case[0])
        n, kw = case[3], dict(case[4])
        c = _Case(f"{case[0]} {case[1]}x{case[2]} n={n} {kw}")
        extra: list[str] = []
        try:
            planes, rng = synth_planes(k, case)
            extra = _RUNNERS[mode](c, planes, rng, fmt, n, kw, opt, device, stats)
        except Exception:  # a raising case is a failure, with its config
            c.fails += 1
            print(f"ERROR {c.config}:\n{traceback.format_exc()}", flush=True)
        fails += c.fails
        verdict = "OK" if c.fails == 0 else f"FAIL ({c.fails})"
        print(f"{case_line(k, len(cases), case, mode)}: {verdict}", flush=True)
        for line in extra:
            print(line, flush=True)
    return fails


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    backend = torch.device(device).type
    if backend == "cuda":
        if not torch.cuda.is_available():
            print("parity_campaign: no CUDA device (pass --device cpu for the plain path)",
                  file=sys.stderr)
            return 2
        from sangnom_tpu_torch.utils.cost_model import card_line

        print(card_line(), flush=True)
    cases, mode = CASES, "oracle"
    for flag, (gen, gen_mode, banner) in MODES.items():
        if flag not in argv:
            continue
        i = argv.index(flag)
        try:
            n_cases = int(argv[i + 1])
            seed = int(argv[i + 2]) if len(argv) > i + 2 else DEFAULT_SEED
        except (IndexError, ValueError):
            print(f"usage: parity_campaign {flag} N [seed] [--device cuda|cpu]",
                  file=sys.stderr)
            return 2
        cases, mode = gen(n_cases, seed), gen_mode
        print(f"{flag[2:]} campaign: {n_cases} cases, seed {seed} ({banner})", flush=True)
        break
    stats: dict = {}
    t0 = time.perf_counter()
    fails = run_cases(cases, mode, device, stats)
    fast = (f"; POOL_FAST took the fast route in {stats.get('fast', 0)} of "
            f"{stats.get('pool', 0)} pool_compat cases" if mode == "compat" else "")
    print(f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{backend.upper()} CAMPAIGN DONE: {len(cases)} cases, {fails} failures{fast}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
