#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (sangnom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
checks each bit for bit against its plain PyTorch version on the card.
Drives the main path at full 1080 size: the 1080i YUV420P8 bob (60
interlaced frames -> 120) and the single-rate ``sangnom2(order=1, dh=True)``
on 120 fields of 1920x540.  Then the pool_compat path: the 1080i bob with
``pool_compat=True`` (16 interlaced frames -> 32) and 30 frames of 720x480
YUV420P8, through each pool kernel arm (K3, K6, and K7: the prepare kernel,
the K6 walk and the finalize kernel).  Then the
width-sharded path: ``parallel.sangnom2_sharded`` on meshes of the one card
(1x4 through K4 and through the K5 route, 2x2 through K4) on the 1080 dh
call and the woven 1080i bob, held bit-equal to the single-device kernel
path, one K4 launch (or one prepare, K5 and finalize launch) a plane pass
and no host-side halo exchange; each pass timed, with its blocks a SM,
clusters and waves.  Checks
the outputs against the plain path and the native oracle, and times kernels
and plain versions with CUDA events.  Last, the cost-model path: the probe
kernels K8-K10 (``csrc/probes.cu``) held bit-equal to their plain versions,
then the op-class calibration at full shape, the step-isolation arms and the
dynamic-row probe through their entry points, the measured rates and the
cost model's prediction of K1's row step against phase 5's time.  Phase 14,
last: the CLI (``sangnom_tpu_torch.cli.main``: ``--bob`` whole
and windowed, ``--dh``, ``--pool-compat`` whole and windowed, the
``script`` verb) and the AviSynth-model host at 1080 from y4m file to y4m
file, SHA-equal to phases 4 and 7's outputs, with their launch counts,
frames/s end to end, stage times and the card's idle share.  Phase 15:
``prewarm`` into a fresh directory and a fresh ``--aot`` process (no nvcc
build, hits only, phase 14's bytes).  Phase 16: the six examples
(``sangnom_tpu_torch/examples``) against the API's output.  Phase 17: the
frame-parallel pool path (``POOL_FAST``; the batched prepare, walk and
finalize kernels) against the sequential K7 route, its launch formula and
its ms per frame at 16 and 14 frames a chunk.  Phase 18: two gloo
processes on the card through ``parallel.sangnom2_multihost`` against
phase 4's dh output (the script re-runs itself as the workers, with
``--multihost-worker``).  Phase 19: width sharding across devices
(``parallel.cross_device``) with four slots that all name the card: K4 and
the K5 route on phase 4's inputs, bit-equal to its outputs, launches, halo
exchanges and PEER_BYTES against their formulas, timed at R 4/16/32/64 in
turns with the one-device cluster route; real meshes of two and four cards
when the machine has them.  Phase 20: the parity campaign
(``tools.parity_campaign``) at API level, the fixed 12-case set and the
first cases of the recorded random, compat, sharded and bob seeds, against
the native oracle and the plain path.  Phase 21: the streaming tools,
``stream_soak 240 32`` (whole against windowed CLI runs, byte identity,
peak RSS) and ``stream_attr`` at 1080.  Phase 22: the headline bench
(``python -m sangnom_tpu_torch.bench``) in a fresh process: the 1080i bob,
the order=1 dh call, the config matrix and pool_compat, every parity gate
ok, and its numbers beside the SSE2 baseline.  Phase 23: planes wider than
one block (past 8192 smoothed columns) through every route: the
15360x8640 4:2:0 bob, single-rate and dh calls at 8448-65600 columns (K4 on
k blocks of a cluster; 65600 on the chunk route), pool_compat at 8448 and
12288 (the walk split over a cluster; the K7 route and ``POOL_FAST``), a
1x2 sharded mesh at 20480 and four slots across at 40960, each bit-equal
to opt=0 with its launches on their formula, route and ms a call.  Each phase
prints one line or more; any
failure raises, so the script exits nonzero and never prints the final
``"ok"`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from sangnom_tpu_torch.utils.cost_model import (
    OPS_FINALIZE, OPS_PREPARE, OPS_SMOOTH, bound, card_line)

FMT = "YUV420P8"
N_IN = 60  # interlaced input frames of the bob -> 120 output frames
B = 120  # fields of the single-rate dh call
REPLACES = "sangnom_tpu/ops/pallas_kernel.py:463"
SOURCE = "sangnom_tpu_torch/csrc/deint.cu"
POOL_SOURCE = "sangnom_tpu_torch/csrc/pool.cu"
SHARD_SOURCE = "sangnom_tpu_torch/csrc/shard.cu"
N_POOL = 16  # interlaced 1080 frames of the pool_compat bob -> 32 frames
N_SD = 30  # 720x480 frames of the pool_compat single-rate calls
N_720 = 16  # 1280x720 frames of the pool_compat timing between those two sizes
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def deint_work(n_fields: int, bufH: int, w: int, S: int, elem: int = 1):
    """(bytes, ops) of one woven deint launch: kept rows in, woven plane
    out; every pair prepared, every row of S columns smoothed, every missing
    pixel finalized."""
    nbytes = n_fields * bufH * w * elem * 3  # read bufH rows, write 2*bufH
    ops = n_fields * (bufH - 1) * (w * (OPS_PREPARE + OPS_FINALIZE) + S * OPS_SMOOTH)
    return nbytes, ops


def pool_smooth_work(P: int, S: int):
    """(bytes, ops) of one pool smoothing pass: the pool read, rows 1..P-1
    written, 9 maps x S columns x P-1 rows smoothed."""
    return 9 * (2 * P) * S * 4, (P - 1) * S * OPS_SMOOTH


def pool_fused_work(P: int, S: int, bufH_p: int, w: int, elem: int = 1):
    """(bytes, ops) of one fused pool plane pass.  Bytes: body rows 1..P-1
    written; the old body read only where no kept pair prepares it (rows
    beyond R = bufH_p-1, columns from w); rows 0 and P read; the kept plane
    read and the interpolated rows written.  Ops: the smoothing plus the
    prepare and finalize of the R kept pairs."""
    R = bufH_p - 1
    body = (P - 1) * S
    nbytes = 9 * 4 * (body + (body - R * w) + 2 * S) + (2 * bufH_p - 1) * w * elem
    ops = body * OPS_SMOOTH + R * w * (OPS_PREPARE + OPS_FINALIZE)
    return nbytes, ops


def pool_prepare_work(bufH_p: int, w: int, elem: int = 1):
    """(bytes, ops) of one K7 prepare launch: the kept rows read, 9 int32
    maps of the R = bufH_p-1 pairs written."""
    R = bufH_p - 1
    return bufH_p * w * elem + 9 * 4 * R * w, R * w * OPS_PREPARE


def pool_finalize_work(bufH_p: int, w: int, elem: int = 1):
    """(bytes, ops) of one K7 finalize launch: the kept rows and 9 smoothed
    int32 maps of R rows read, R interpolated rows written."""
    R = bufH_p - 1
    return bufH_p * w * elem + 9 * 4 * R * w + R * w * elem, R * w * OPS_FINALIZE


def _rand_plane(rng, shape, fmt):
    """Full-range samples, out-of-nominal codes included for >8-bit formats."""
    if fmt.is_float:
        return (rng.random(shape, dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)


def phase_kernel_matrix(dk, get_format, KernelSpec, details):
    """Kernel vs plain on CUDA tensors over formats, numerics, offsets,
    interlaced input and widths; bit-equal required."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops.reference import interpolate_field_batch as plain_interp

    rng = np.random.default_rng(11)
    cases = 0
    formats = [("GRAY8", "c"), ("GRAY8", "sse2"), ("GRAY16", "c"),
               ("GRAY16", "sse2"), ("YUV420P10", "c"), ("YUV420P10", "sse2"),
               ("GRAYS", "c")]
    # (frames, kept rows, width, stride or None for the next multiple of 32):
    # 75 frames give 150 fields; 3840 is past one block of the field kernel
    # (K4 over 4 blocks of a cluster); stride 1023 gives S = 1023, a partial
    # last column group; width 5 is below the 7-tap span
    shapes = [(3, 9, 61, None), (3, 9, 1920, None), (75, 6, 61, None),
              (2, 6, 3840, None), (3, 9, 1023, 1023), (3, 9, 5, 5)]
    for fmt_name, numerics in formats:
        fmt = get_format(fmt_name)
        spec = KernelSpec.from_format(fmt, sse2=numerics == "sse2")
        aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
        for n, bufH, w, stride in shapes:
            stride = stride or -(-w // 32) * 32
            for tff in (None, True, False):
                n_fields = n if tff is None else 2 * n
                shape = (n, bufH, w) if tff is None else (n, 2 * bufH, w)
                src = torch.from_numpy(_rand_plane(rng, shape, fmt)).cuda()
                pf = torch.from_numpy(rng.integers(0, 2, n_fields).astype(np.int32)).cuda()
                for off in (0, 1, pf):
                    got = dk.deinterlace_field_batch_fused(src, off, aaf, spec, stride, tff)
                    want = dk.deinterlace_field_batch_plain(src, off, aaf, spec, stride, tff)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"kernel != plain: {fmt_name} {numerics} shape={shape} "
                            f"tff={tff} offset={'pf' if off is pf else off} "
                            f"max_abs={max_abs(got, want)}")
                    cases += 1
                if tff is None:  # the no-weave mode
                    got = dk.interpolate_field_batch(src, aaf, spec, stride)
                    want = plain_interp(src, aaf, spec, stride)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"no-weave kernel != plain: {fmt_name} {numerics} shape={shape}")
                    cases += 1
    details["matrix_cases"] = cases
    return cases


def _on_split(plane_pass, kept, pool, aaf, spec):
    """A split-carry plane pass on a pool: (rows, the pool after it)."""
    from sangnom_tpu_torch.ops import pool_carry as pc

    carry = pc._pool_split(pool)
    out = plane_pass(kept, carry, aaf, spec)
    return out, pc._pool_join(carry)


def phase_pool_matrix(get_format, KernelSpec, details):
    """K3, K6 and K7 vs their plain twins on CUDA tensors: formats and
    numerics x pool strides 64/736/1920 x plane shapes (luma covering the
    pool, unaligned luma, chroma with R < P-1 and w < S, a plane narrower
    than the 7-tap span, a degenerate plane), on pools holding stale
    content from two plain passes; the interpolated rows and the whole pool
    bit-equal.  K7 also on kept rows read in place (the odd rows of a
    frame), and its prepare and finalize kernels each against their twins."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk

    rng = np.random.default_rng(13)
    formats = [("GRAY8", "c"), ("GRAY8", "sse2"), ("GRAY16", "c"),
               ("GRAY16", "sse2"), ("YUV420P10", "c"), ("YUV420P10", "sse2"),
               ("GRAYS", "c")]
    P = 24
    cases = 0
    for fmt_name, numerics in formats:
        fmt = get_format(fmt_name)
        spec = KernelSpec.from_format(fmt, sse2=numerics == "sse2")
        aaf_y, aaf_c = (aaf_as_pixel(scaled_aa_thresholds(a, 0, fmt)[0], fmt)
                        for a in (48, 40))
        for S in (64, 736, 1920):
            pool = torch.zeros((9, P + 1, S), dtype=spec.acc_dtype, device=DEVICE)
            for rows, w in ((P, S - 5), (P // 2, S // 2 - 3)):  # stale content
                kept = torch.from_numpy(_rand_plane(rng, (rows, w), fmt)).to(DEVICE)
                pc.interp_field_pool(kept, pool, aaf_y, spec)
            if not bool(pool[:, 1:P].any()):
                raise AssertionError(f"stale pool is zero: {fmt_name} S={S}")
            for rows, w in ((P, S), (P, S - 16), (P // 2 - 1, S // 2 - 8), (7, 5),
                            (1, S // 2)):
                frame = torch.from_numpy(_rand_plane(rng, (2 * rows, w), fmt)).to(DEVICE)
                kept, strided = frame[0::2].contiguous(), frame[0::2]
                aaf = aaf_y if rows == P else aaf_c
                want_pool = pool.clone()
                want = pc.interp_field_pool(kept, want_pool, aaf, spec)
                arms = (
                    ("K3", lambda p: (pc.interp_field_pool_k3(kept, p, aaf, spec), p)),
                    ("K6", lambda p: _on_split(pc.interp_field_pool_split3, kept, p, aaf, spec)),
                    ("K7", lambda p: _on_split(pc.interp_field_pool_fused, kept, p, aaf, spec)),
                    ("K7 strided", lambda p: _on_split(pc.interp_field_pool_fused, strided, p,
                                                       aaf, spec)),
                )
                for name, run in arms:
                    before = dict(pk.LAUNCHES)
                    got, got_pool = run(pool.clone())
                    torch.cuda.synchronize()
                    if pk.LAUNCHES == before:
                        raise AssertionError(f"{name} did not launch")
                    if not (torch.equal(got, want) and torch.equal(got_pool, want_pool)):
                        raise AssertionError(
                            f"{name} != plain: {fmt_name} {numerics} S={S} kept "
                            f"{rows}x{w}: rows max_abs {max_abs(got, want)}, pool "
                            f"max_abs {max_abs(got_pool, want_pool)}")
                    cases += 1
                # K3 alone on the prepared pool, against its twin
                a, b = want_pool.clone(), want_pool.clone()
                pk.smooth_pool_(a, spec)
                pk.smooth_pool_plain_(b, spec)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"K3 alone != twin: {fmt_name} {numerics} S={S}")
                cases += 1
                if rows >= 2:  # K7's prepare and finalize kernels alone
                    body = pc._pool_split(pool)[1]
                    a, b = body.clone(), body.clone()
                    pk.prepare_pool_(strided, a, spec)
                    pk.prepare_pool_plain_(strided, b, spec)
                    got = pk.finalize_pool(strided, body, aaf, spec)
                    want = pk.finalize_pool_plain(strided, body, aaf, spec)
                    torch.cuda.synchronize()
                    if not (torch.equal(a, b) and torch.equal(got, want)):
                        raise AssertionError(f"K7 prepare or finalize != twin: {fmt_name} "
                                             f"{numerics} S={S} kept {rows}x{w}")
                    cases += 2
                pool = want_pool
    details["pool_matrix_cases"] = cases
    return cases


def pool_inputs():
    """The pool_compat inputs, seed 8: 16 interlaced 1080 YUV420P8 frames,
    then 30 frames of 720x480 YUV420P8."""
    rng = np.random.default_rng(8)
    hd = [rng.integers(0, 256, (N_POOL, h, w)).astype(np.uint8)
          for h, w in ((1080, 1920), (540, 960), (540, 960))]
    sd = [rng.integers(0, 256, (N_SD, h, w)).astype(np.uint8)
          for h, w in ((480, 720), (240, 360), (240, 360))]
    return hd, sd


POOL_ARMS = {"K3": (False, False), "K6": (True, False), "K7": (False, True)}  # flags


def default_pool_arm(pc) -> str:
    """The arm the module's flags pick for CUDA tensors."""
    return "K7" if pc.POOL_FUSED else "K6" if pc.POOL_SPLIT3 else "K3"


def phase_pool_main_path(fmt, clip_hd, clip_sd, details):
    """The pool_compat path through the entry points, once per kernel arm
    (K3, K6, K7), each with the launch counts set to 0 just before and read
    just after, and held to their formula (one K3 or K6 launch a plane pass;
    three for K7: prepare, the K6 walk, finalize); outputs and final pools
    bit-equal to opt=0, chunked streams equal to the whole clip, the first 2
    frames equal to the native oracle with a carried pool.  The module's
    flags are restored after each arm.  Returns (launches per arm and
    kernel, the bob's final pool)."""
    from sangnom_tpu_torch import Clip, bob, sangnom2
    from sangnom_tpu_torch.core.fields import double_weave, separate_fields
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream as stream
    from sangnom_tpu_torch.oracle import sangnom2_clip_oracle

    woven = double_weave(separate_fields(clip_hd))
    calls = {  # name -> (main-path call, the same as a stream: clip, kwargs)
        "bob": (lambda: bob(clip_hd, pool_compat=True), woven, dict(order=0)),
        "sd": (lambda: sangnom2(clip_sd, order=1, pool_compat=True), clip_sd,
               dict(order=1)),
        "sd_noluma": (lambda: sangnom2(clip_sd, order=1, luma=False, pool_compat=True),
                      clip_sd, dict(order=1, luma=False)),
    }
    n_hd, n_sd = clip_hd.num_frames, clip_sd.num_frames
    passes = 2 * n_hd * 3 + n_sd * 3 + n_sd * 2  # plane passes of the three calls
    formula = {"K3": {"smooth": passes}, "K6": {"split3": passes},
               "K7": {"prepare": passes, "split3": passes, "finalize": passes}}
    ref = {}
    for name, (_, c, kw) in calls.items():
        ref[name] = stream(c, None, opt=0, **kw)
    launches, outs = {}, {}
    defaults = pc.POOL_SPLIT3, pc.POOL_FUSED  # restored after each arm
    for arm, flags in POOL_ARMS.items():
        pc.POOL_SPLIT3, pc.POOL_FUSED = flags
        try:
            torch.cuda.synchronize()
            pk.reset_launches()
            outs = {name: call() for name, (call, _, _) in calls.items()}
            torch.cuda.synchronize()
            launches[arm] = dict(pk.LAUNCHES)
            for name, (_, c, kw) in calls.items():
                out, pool = stream(c, None, **kw)
                want, want_pool = ref[name]
                for i, (g, s_, r) in enumerate(zip(outs[name].planes, out.planes, want.planes)):
                    if not (torch.equal(g, r) and torch.equal(s_, r)):
                        raise AssertionError(f"{arm} {name} plane {i} != opt=0, "
                                             f"max_abs {max_abs(g, r)}")
                if not torch.equal(pool, want_pool):
                    raise AssertionError(f"{arm} {name}: final pool != opt=0")
        finally:
            pc.POOL_SPLIT3, pc.POOL_FUSED = defaults
        want_counts = {k: formula[arm].get(k, 0) for k in launches[arm]}
        if launches[arm] != want_counts:
            raise AssertionError(f"{arm}: launches {launches[arm]}, formula {want_counts} "
                                 f"for {passes} plane passes")
    # chunked streams == the whole clip (the default arm)
    for name, (_, c, kw) in calls.items():
        k = c.num_frames // 2 - 1
        a, pool = stream(c[0:k], None, **kw)
        b, pool = stream(c[k:], pool, **kw)
        want, want_pool = ref[name]
        joined = Clip.concat(a, b)
        if not all(torch.equal(g, r) for g, r in zip(joined.planes, want.planes)):
            raise AssertionError(f"{name}: chunked stream != whole clip")
        if not torch.equal(pool, want_pool):
            raise AssertionError(f"{name}: chunked stream's pool != whole clip's")
    # the first 2 frames against the native oracle with a carried pool
    for name, (_, c, kw) in calls.items():
        frames = [[p[n].cpu().numpy() for p in c.planes] for n in range(2)]
        want = sangnom2_clip_oracle(frames, fmt, parities=list(c.parity_array()[:2]),
                                    pool_compat=True, **kw)
        got = outs[name]
        for n in range(2):
            for i in range(3):
                if not np.array_equal(got.planes[i][n].cpu().numpy(), want[n][i]):
                    raise AssertionError(f"{name} frame {n} plane {i} != native oracle")
    got = [tuple(p.shape) for p in outs["bob"].planes]
    if got != [(2 * n, h, w) for n, h, w in (p.shape for p in clip_hd.planes)]:
        raise AssertionError(f"bob shapes {got}")
    details["pool_main_path_launches"] = launches
    return launches, ref["bob"][1]


def phase_pool_timing(fmt, clip_hd, clip_sd, hd_pool, card, details):
    """ms per output frame of the pool_compat calls per kernel arm, in
    turns, the arms' outputs equal (1080i bob, 720p and 720x480); ms per
    launch of each pool kernel and its twin at the 1080 luma and chroma
    passes (kept rows read in place, as the bob reads them); the plain path
    on a 2-frame prefix; profiles of the bob through K3 and of each call
    through the default arm."""
    from sangnom_tpu_torch import Clip, bob, sangnom2
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    rng = np.random.default_rng(9)  # 720p, between the two checked sizes
    clip_720 = Clip.from_numpy([rng.integers(0, 256, (N_720, h, w)).astype(np.uint8)
                                for h, w in ((720, 1280), (360, 640), (360, 640))],
                               fmt, device=DEVICE)
    calls = {
        "bob1080": (lambda: bob(clip_hd, pool_compat=True), 2 * clip_hd.num_frames),
        "hd720": (lambda: sangnom2(clip_720, order=1, pool_compat=True), N_720),
        "sd480": (lambda: sangnom2(clip_sd, order=1, pool_compat=True), clip_sd.num_frames),
    }
    e2e: dict = {}
    first: dict = {}  # workload -> the first arm's output, which every arm must equal
    defaults = pc.POOL_SPLIT3, pc.POOL_FUSED  # restored after each arm
    default_arm = default_pool_arm(pc)
    try:
        for rnd in (list(POOL_ARMS), list(POOL_ARMS)[::-1]):
            for arm in rnd:
                pc.POOL_SPLIT3, pc.POOL_FUSED = POOL_ARMS[arm]
                for wl, (fn, frames) in calls.items():
                    out = fn()  # warm-up
                    want = first.setdefault(wl, out)
                    if not all(torch.equal(g, r) for g, r in zip(out.planes, want.planes)):
                        raise AssertionError(f"{wl}: arm {arm} != the first arm's output")
                    e2e.setdefault(f"{wl}/{arm}", []).append(cuda_ms(fn, 2) / frames)
    finally:
        pc.POOL_SPLIT3, pc.POOL_FUSED = defaults
    del first
    plain = {
        "bob1080": cuda_ms(lambda: bob(clip_hd[0:1], pool_compat=True, opt=0), 1) / 2,
        "sd480": cuda_ms(lambda: sangnom2(clip_sd[0:2], order=1, pool_compat=True,
                                          opt=0), 1) / 2,
    }
    for k, ts in e2e.items():
        log(f"[8 pool timing] {k}: {min(ts):.4f} ms/output frame -> "
            f"{1e3 / min(ts):.1f} frames/s (windows {', '.join(f'{t:.4f}' for t in ts)}) | {card}")
    for wl in calls:
        best = min(POOL_ARMS, key=lambda arm: min(e2e[f"{wl}/{arm}"]))
        log(f"[8 pool timing] {wl}: fastest arm {best}; default arm {default_arm}")
    for k, t in plain.items():
        log(f"[8 pool timing] {k}/plain (opt=0, 2-frame prefix): {t:.3f} ms/output frame | {card}")
    details["pool_e2e_ms_per_frame"] = e2e
    details["pool_plain_ms_per_frame"] = plain
    details["pool_default_arm"] = default_arm

    # each kernel alone at the 1080 passes, on the bob's stale final pool
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    P, S = hd_pool.shape[1] - 1, hd_pool.shape[2]
    field = clip_hd.planes
    passes = {
        "luma": (field[0][0, 0::2], aaf_as_pixel(aafs[0], fmt)),
        "chroma": (field[1][0, 0::2], aaf_as_pixel(aafs[1], fmt)),
    }
    per: dict = {}
    for pname, (kept, aaf) in passes.items():
        bufH_p, w = kept.shape
        prepared = hd_pool.clone()
        pc._prepare(kept, prepared[:, 1:bufH_p, :w], spec)
        carry = pc._pool_split(prepared)
        body = pc._pool_split(hd_pool)[1]
        kernels = {
            "K3": (lambda p=prepared.clone(): pk.smooth_pool_(p, spec),
                   lambda p=prepared.clone(): pk.smooth_pool_plain_(p, spec),
                   lambda: _k3_err(pk, prepared, spec), pool_smooth_work(P, S)),
            "K6": (lambda c=tuple(x.clone() for x in carry): pk.smooth_split3_(*c, spec),
                   lambda c=tuple(x.clone() for x in carry): pk.smooth_split3_plain_(*c, spec),
                   lambda: _k6_err(pk, carry, spec), pool_smooth_work(P, S)),
            "K7": (lambda c=tuple(x.clone() for x in pc._pool_split(hd_pool)):
                   pk.interp_fused(kept, *c, aaf, spec),
                   lambda c=tuple(x.clone() for x in pc._pool_split(hd_pool)):
                   pk.interp_fused_plain(kept, *c, aaf, spec),
                   lambda: _k7_err(pk, pc, hd_pool, kept, aaf, spec),
                   pool_fused_work(P, S, bufH_p, w)),
            "prepare": (lambda b=body.clone(): pk.prepare_pool_(kept, b, spec),
                        lambda b=body.clone(): pk.prepare_pool_plain_(kept, b, spec),
                        lambda: _prepare_err(pk, body, kept, spec),
                        pool_prepare_work(bufH_p, w)),
            "finalize": (lambda: pk.finalize_pool(kept, body, aaf, spec),
                         lambda: pk.finalize_pool_plain(kept, body, aaf, spec),
                         lambda: max_abs(pk.finalize_pool(kept, body, aaf, spec),
                                         pk.finalize_pool_plain(kept, body, aaf, spec)),
                         pool_finalize_work(bufH_p, w)),
        }
        for kname, (kern, twin, err, work) in kernels.items():
            kern()  # warm-up
            k_ms = [cuda_ms(kern, 5) for _ in range(2)]
            p_ms = cuda_ms(twin, 1)
            b_ms, b_by = bound(*work)
            per[f"{kname}/{pname}"] = dict(ms=min(k_ms), windows=k_ms, plain_ms=p_ms,
                                           max_abs_err=err(), bound_ms=b_ms, bound_by=b_by)
            log(f"[8 pool timing] {kname} at the 1080 {pname} pass (pool 9x{P + 1}x{S}, "
                f"kept {bufH_p}x{w}): {min(k_ms):.4f} ms/launch (windows "
                f"{', '.join(f'{t:.4f}' for t in k_ms)}), twin {p_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}) | {card}")
    details["pool_kernel_ms"] = per
    profiles = {}  # the K3 bob, then each call through the default arm
    for wl, arm in dict.fromkeys([("bob1080", "K3")] + [(wl, default_arm) for wl in calls]):
        fn, frames = calls[wl]
        pc.POOL_SPLIT3, pc.POOL_FUSED = POOL_ARMS[arm]
        try:
            profiles[f"{wl}/{arm}"] = profile_call(
                fn, min(e2e[f"{wl}/{arm}"]) * frames,
                f"{wl}/{arm}" + (" (default)" if arm == default_arm else ""), card)
        finally:
            pc.POOL_SPLIT3, pc.POOL_FUSED = defaults
    details["pool_profile"] = profiles
    return per


def profile_call(fn, wall_ms: float, what: str, card: str,
                 tag: str = "8 pool profile") -> dict:
    """Device time of one call of ``fn`` by torch.profiler, against
    ``wall_ms``, its time by CUDA events without the profiler: the device's
    busy and idle share, and the kernels that take the most device time.
    Also the host time of a call: from its start until it returns, before
    the device is waited for (best of 3)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host_ms = min(host)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: the port's own spans (utils.profiling.span), where they
    # are on, also appear on the device timeline, spanning their kernels
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("sangnom/")]
    busy = sum(r[2] for r in rows)
    if not busy:
        log(f"[{tag}] {what}: the profiler traced no device time; "
            f"busy share not measured; host {host_ms:.3f} ms per call")
        return {"host_ms": host_ms}
    rows.sort(key=lambda r: -r[2])
    top = [(k[:60], n, round(ms, 4)) for k, n, ms in rows[:6]]
    log(f"[{tag}] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"per call (idle share {1 - busy / wall_ms:.3f}), host {host_ms:.3f} ms per "
        f"call, {sum(r[1] for r in rows)} kernel launches; top (name, launches, ms): "
        f"{top} | {card}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "host_ms": host_ms,
            "launches": sum(r[1] for r in rows), "top": top, "all": rows}


def _k3_err(pk, pool, spec) -> float:
    a, b = pool.clone(), pool.clone()
    pk.smooth_pool_(a, spec)
    pk.smooth_pool_plain_(b, spec)
    return max_abs(a, b)


def _k6_err(pk, carry, spec) -> float:
    a, b = (tuple(x.clone() for x in carry) for _ in range(2))
    pk.smooth_split3_(*a, spec)
    pk.smooth_split3_plain_(*b, spec)
    return max(max_abs(x, y) for x, y in zip(a, b))


def _prepare_err(pk, body, kept, spec) -> float:
    a, b = body.clone(), body.clone()
    pk.prepare_pool_(kept, a, spec)
    pk.prepare_pool_plain_(kept, b, spec)
    return max_abs(a, b)


def _k7_err(pk, pc, pool, kept, aaf, spec) -> float:
    a, b = pc._pool_split(pool), pc._pool_split(pool)
    ra = pk.interp_fused(kept, *a, aaf, spec)
    rb = pk.interp_fused_plain(kept, *b, aaf, spec)
    return max([max_abs(ra, rb)] + [max_abs(x, y) for x, y in zip(a, b)])


def phase_shard_matrix(get_format, KernelSpec, details):
    """The sharded kernels vs their plain versions on CUDA tensors: formats
    and numerics x shard counts 1/2/4/8 on the cluster route and 12 on the
    chunk route (thin shards, 4- and 1-column blocks, and a chroma-like
    plane whose true width is short of the padded one) x chunk_rows 1/5/16;
    K4 with no weave and weave offsets 0/1/per frame, K5 on the whole plane,
    the chunked route's prepare and finalize kernels alone and the route;
    bit-equal required, and each kernel's launches equal to its plan."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.parallel import fused_smooth as fs
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.parallel import width_sharded as ws

    rng = np.random.default_rng(17)
    formats = [("GRAY8", "c"), ("GRAY8", "sse2"), ("GRAY16", "c"),
               ("GRAY16", "sse2"), ("YUV420P10", "c"), ("YUV420P10", "sse2"),
               ("GRAYS", "c")]
    # K4: (shards, padded width, true width); K5: (shards, padded width)
    k4_geoms = [(1, 1920, 1920), (2, 1920, 1917), (4, 988, 960), (8, 1920, 1920),
                (8, 72, 70), (12, 1920, 1916)]
    k5_geoms = [(1, 480), (2, 988), (4, 1920), (8, 64), (12, 1920)]
    route_geoms = [(4, 988, 960), (1, 1920, 1920)]
    limit = 227 * 1024
    cases = {"K4": 0, "K5": 0, "prepare": 0, "finalize": 0, "route": 0}
    for fmt_name, numerics in formats:
        fmt = get_format(fmt_name)
        spec = KernelSpec.from_format(fmt, sse2=numerics == "sse2")
        aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
        for n, S, w in k4_geoms:
            kept = _rand_plane(rng, (3, 17, w), fmt)
            kept = np.concatenate([kept, np.repeat(kept[:, :, -1:], S - w, axis=2)], axis=2)
            kept = torch.from_numpy(np.ascontiguousarray(kept)).to(DEVICE)
            pf = torch.from_numpy(rng.integers(0, 2, 3).astype(np.int32)).to(DEVICE)
            pw = w if w < S else None
            for chunk_rows in (1, 5, 16):
                plan = sk.full_plan(n, S // n, 17, kept.element_size(), limit, chunk_rows)
                for off in (None, 0, 1, pf):
                    before = sk.LAUNCHES["full"]
                    if off is None:
                        got = fs.interpolate_fused_full(kept, aaf, spec, n, pw, chunk_rows)
                        torch.cuda.synchronize()
                        launched = sk.LAUNCHES["full"] - before
                        want = fs.interpolate_fused_full_plain(kept, aaf, spec, n, pw, chunk_rows)
                    else:
                        got = fs.deinterlace_fused_full(kept, off, aaf, spec, n, pw, chunk_rows)
                        torch.cuda.synchronize()
                        launched = sk.LAUNCHES["full"] - before
                        want = fs.deinterlace_fused_full_plain(kept, off, aaf, spec, n, pw,
                                                               chunk_rows)
                    if launched != plan.launches or not torch.equal(got, want):
                        raise AssertionError(
                            f"K4 != plain: {fmt_name} {numerics} shards={n} S={S} w={w} "
                            f"chunk_rows={chunk_rows} weave={'pf' if off is pf else off} "
                            f"launches {launched} (plan {plan.launches}) "
                            f"max_abs={max_abs(got, want)}")
                    cases["K4"] += 1
        for n, S in k5_geoms:
            raw = (torch.from_numpy(rng.random((27, 18, S), dtype=np.float32) * 300)
                   if spec.is_float else torch.from_numpy(
                       rng.integers(0, spec.mask + 1, (27, 18, S)).astype(np.int32)))
            raw[:, [0, 17]] = 0
            raw = raw.to(DEVICE)
            for chunk_rows in (1, 5, 16):
                plan = sk.smooth_plan(n, S // n, 17, limit, chunk_rows)
                before = sk.LAUNCHES["smooth"]
                got = fs.smooth_full_width(raw, spec, n, chunk_rows)
                torch.cuda.synchronize()
                launched = sk.LAUNCHES["smooth"] - before
                want = ws._unshard(fs.smooth_sharded_chunked_plain(
                    ws._shards(raw, n), spec, chunk_rows))
                if launched != plan.launches or not torch.equal(got, want):
                    raise AssertionError(
                        f"K5 != plain: {fmt_name} {numerics} shards={n} S={S} "
                        f"chunk_rows={chunk_rows} launches {launched} (plan "
                        f"{plan.launches}) max_abs={max_abs(got, want)}")
                cases["K5"] += 1
        for n, S, w in route_geoms:
            kept = _rand_plane(rng, (3, 17, w), fmt)
            kept = np.concatenate([kept, np.repeat(kept[:, :, -1:], S - w, axis=2)], axis=2)
            kept = torch.from_numpy(np.ascontiguousarray(kept)).to(DEVICE)
            pw = w if w < S else None
            raw = sk.prepare(kept, spec, w)
            sm = fs.smooth_full_width(raw.view(27, 18, S), spec, n).view(9, 3, 16, S)
            checks = (
                ("prepare", raw, ws.prepare_chunked_plain(kept, spec, n, pw)),
                ("finalize", sk.finalize(kept, sm, aaf, spec),
                 ws.finalize_chunked_plain(kept, sm, aaf, spec, n)),
                ("route", fs.interpolate_chunked(kept, aaf, spec, n, pw),
                 fs.interpolate_chunked_plain(kept, aaf, spec, n, pw)))
            torch.cuda.synchronize()
            for key, got, want in checks:
                if not torch.equal(got, want):
                    raise AssertionError(f"chunked route {key} != plain: {fmt_name} "
                                         f"{numerics} shards={n} S={S} w={w} "
                                         f"max_abs={max_abs(got, want)}")
                cases[key] += 1
    details["shard_matrix_cases"] = cases
    return cases


def _plane_passes(clip, dh: bool, n_space: int):
    """(rows of the kept field, columns per shard) of each plane pass of a
    sharded call on a YUV420 clip: luma, then the fused U+V batch."""
    from sangnom_tpu_torch.core.geometry import buffer_stride_elems
    from sangnom_tpu_torch.parallel.sharding import _sharded_pad_width

    fmt = clip.format
    stride = buffer_stride_elems(clip.width, fmt.component_size)
    out = []
    for p in clip.planes[:2]:
        _, h, w = p.shape
        s_eff = stride if w >= stride else _sharded_pad_width(w, h, stride, n_space, fmt, dh)
        out.append((h if dh else h // 2, s_eff // n_space))
    return out


def shard_expected(clip, dh: bool, n_data: int, n_space: int, arm: str) -> dict:
    """Kernel launches of one sharded call, from the plans: per data row and
    plane pass (luma, fused U+V), K4 one launch on the cluster route; the K5
    route one prepare, one K5 and one finalize launch.  No host-side halo
    exchange."""
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    want = {k: 0 for k in sk.LAUNCHES}
    for bufH, w_loc in _plane_passes(clip, dh, n_space):
        if arm == "K4":
            want["full"] += n_data * sk.full_plan(n_space, w_loc, bufH, 1, 227 * 1024).launches
        else:
            want["smooth"] += n_data * sk.smooth_plan(n_space, w_loc, bufH, 227 * 1024).launches
            want["prepare"] += n_data
            want["finalize"] += n_data
    return want


def phase_sharded_main_path(clip_dh, woven, out_dh, out_bob, details):
    """sangnom2_sharded at full 1080 size on meshes of the one card: 1x4
    through K4 (default) and through the K5 route (smooth="chunked"), and
    2x2 through K4, each on the dh call and the woven bob; each output
    bit-equal to the single-device kernel path (phase 4), launches equal to
    their formula (data rows x plane passes) and no host-side halo
    exchange; the scan arm (opt=0) on 4-frame prefixes too.  Returns the
    1x4 runs' launches, {arm: {kernel: launches}}."""
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.parallel import width_sharded as ws

    calls = {"dh": (clip_dh, dict(order=1, dh=True), out_dh),
             "bob": (woven, dict(order=0), out_bob)}
    runs = [("K4", 1, 4, None), ("K5", 1, 4, "chunked"), ("K4", 2, 2, None)]
    launches = {}
    for arm, n_data, n_space, smooth in runs:
        mesh = default_mesh(n_data, n_space, devices=[DEVICE] * (n_data * n_space))
        torch.cuda.synchronize()
        sk.reset_launches()
        ws.reset_exchanges()
        outs = {name: sangnom2_sharded(c, mesh, space_axis="space", smooth=smooth, **kw)
                for name, (c, kw, _) in calls.items()}
        torch.cuda.synchronize()
        got = dict(sk.LAUNCHES)
        exch = dict(ws.HALO_EXCHANGES)
        want = {k: 0 for k in sk.LAUNCHES}
        for name, (c, kw, _) in calls.items():
            for k, v in shard_expected(c, kw.get("dh", False), n_data, n_space, arm).items():
                want[k] += v
        if got != want or any(exch.values()):
            raise AssertionError(f"{arm} {n_data}x{n_space}: launches {got}, exchanges "
                                 f"{exch}, expected {want} and no exchange")
        for name, (_, _, ref) in calls.items():
            for i, (g, r) in enumerate(zip(outs[name].planes, ref.planes)):
                if not torch.equal(g, r):
                    raise AssertionError(f"{arm} {n_data}x{n_space} {name} plane {i} != the "
                                         f"single-device kernel path, max_abs {max_abs(g, r)}")
        del outs
        if n_data == 1:
            launches[arm] = got
        details[f"shard_main_{arm}_{n_data}x{n_space}"] = {"launches": got, "exchanges": exch}
        log(f"[10 sharded main path] {arm} on a {n_data}x{n_space} mesh of {DEVICE}: dh and "
            f"bob bit-equal to phase 4; launches {got} (formula: data rows x plane "
            f"passes, {want}), host-side halo exchanges {exch}")
    mesh = default_mesh(1, 4, devices=[DEVICE] * 4)
    ws.reset_exchanges()
    for name, (c, kw, ref) in calls.items():
        got = sangnom2_sharded(c[0:4], mesh, space_axis="space", opt=0, **kw)
        for i, (g, r) in enumerate(zip(got.planes, ref.planes)):
            if not torch.equal(g, r[0:4]):
                raise AssertionError(f"scan arm {name} plane {i} != phase 4")
    torch.cuda.synchronize()
    rows = sum(bufH - 1 for c, kw, _ in calls.values()
               for bufH, _ in _plane_passes(c, kw.get("dh", False), 4))
    if ws.HALO_EXCHANGES != {"kept": 4, "carry": 0, "row": rows}:
        raise AssertionError(f"scan arm exchanges {ws.HALO_EXCHANGES}, expected {rows} rows")
    log(f"[10 sharded main path] scan arm (opt=0), 1x4, 4-frame prefixes of dh and bob: "
        f"bit-equal to phase 4; exchanges {dict(ws.HALO_EXCHANGES)}")
    return launches


def k4_work(N: int, bufH: int, S: int, elem: int = 1):
    """(bytes, ops) of one woven K4 plane pass: the kept rows read once, the
    woven plane written; every pair prepared, every row of S columns
    smoothed, every missing pixel finalized (the halo's repeated columns
    are the kernel's choice, not the function's work)."""
    return N * bufH * S * elem * 3, N * (bufH - 1) * S * (OPS_PREPARE + OPS_SMOOTH + OPS_FINALIZE)


def k5_work(C: int, bufH: int, S: int):
    """(bytes, ops) of one K5 plane pass: raw rows 1..bufH read, the bufH-1
    smoothed rows written (int32); the smoothing of one map a row."""
    return 4 * C * (2 * bufH - 1) * S, C * (bufH - 1) * S * (OPS_SMOOTH // 9)


def chunked_prepare_work(N: int, bufH: int, S: int, elem: int = 1):
    """(bytes, ops) of the chunked route's prepare: kept rows in, 9 int32
    maps of rows 0..bufH out."""
    return N * bufH * S * elem + 36 * N * (bufH + 1) * S, N * (bufH - 1) * S * OPS_PREPARE


def chunked_finalize_work(N: int, bufH: int, S: int, elem: int = 1):
    """(bytes, ops) of the chunked route's finalize: kept rows and 9 int32
    smoothed maps in, the interpolated rows out."""
    R = bufH - 1
    return N * bufH * S * elem + 36 * N * R * S + N * R * S * elem, N * R * S * OPS_FINALIZE


def _timed(fn, plain, reps: int) -> dict:
    """Best ms of ``fn`` over two windows of ``reps`` calls; the plain twin
    timed by CUDA events over the one call that gives the reference, and
    their max_abs_err."""
    got = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    err = max_abs(got, want)
    del got, want
    return {"ms": min(cuda_ms(fn, reps) for _ in range(2)), "plain_ms": start.elapsed_time(end),
            "max_abs_err": err}


def phase_shard_timing(clip_dh, woven, card, details):
    """ms per call of the sharded dh and bob at space 1/2/4 through K4 and
    the K5 route, in turns with the single-device K1 call; a profile of the
    1x4 K4 calls and of the 1x4 K5 dh call; ms per plane pass of K4 (1080
    dh luma and U+V passes on 4 shards) and of the K5 route's three kernels
    (luma pass), their plain versions' and their bounds; the blocks a SM,
    clusters and waves of each pass.  Returns the per-pass numbers."""
    from sangnom_tpu_torch import sangnom2
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded
    from sangnom_tpu_torch.parallel import fused_smooth as fs
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.parallel import width_sharded as ws
    from sangnom_tpu_torch.parallel.sharding import _sharded_pad_width

    calls = {"dh": (clip_dh, dict(order=1, dh=True)), "bob": (woven, dict(order=0))}
    arms = {"K1": (None, None)}
    for n in (1, 2, 4):
        arms[f"K4/space{n}"] = (n, None)
        arms[f"K5/space{n}"] = (n, "chunked")
    reps = {"K1": 5, "K4": 5, "K5": 2}

    def fn(arm, wl):
        c, kw = calls[wl]
        n, smooth = arms[arm]
        if n is None:
            return lambda: sangnom2(c, **kw)
        mesh = default_mesh(1, n, devices=[DEVICE] * n)
        return lambda: sangnom2_sharded(c, mesh, space_axis="space", smooth=smooth, **kw)

    e2e: dict = {}
    for wl in calls:
        fns = {arm: fn(arm, wl) for arm in arms}
        for f in fns.values():
            f()  # warm-up
        for rnd in (list(arms), list(arms)[::-1]):
            for arm in rnd:
                e2e.setdefault(f"{wl}/{arm}", []).append(
                    cuda_ms(fns[arm], reps[arm.split("/")[0]]))
    for k, ts in e2e.items():
        log(f"[11 shard timing] {k}: {min(ts):.3f} ms/call -> {120 / min(ts) * 1e3:.1f} "
            f"output frames/s (windows {', '.join(f'{t:.3f}' for t in ts)}) | {card}")
    details["shard_e2e_ms"] = e2e
    # The K5 route's per-pass kernels are its own; every other kernel of its
    # call (padding, the U+V batch, the trim) is the sharded call's, as in
    # the K4 call: no torch kernel over the plane belongs to the route.
    own = ("shard_prepare_kernel", "shard_smooth_kernel", "shard_finalize_kernel",
           "shard_full_kernel")
    # a call's launches of those kernels (two plane passes, one each), which
    # a complete trace holds: the profiler at times drops a U+V pass's
    # launches, and a trace that did is taken again (at most three times)
    route = {"K4/space4": {"shard_full_kernel": 2},
             "K5/space4": {o: 2 for o in own[:3]}}
    profiles = {}
    for wl, arm in (("dh", "K4/space4"), ("bob", "K4/space4"), ("dh", "K5/space4")):
        for _ in range(3):
            prof = profile_call(fn(arm, wl), min(e2e[f"{wl}/{arm}"]), f"{wl}/{arm}", card,
                                "11 shard profile")
            traced = {o: sum(n for k, n, _ in prof.get("all", ()) if o in k)
                      for o in route[arm]}
            if "top" not in prof or traced == route[arm]:
                break
            log(f"[11 shard profile] {wl}/{arm}: the trace holds {traced} of the call's "
                f"{route[arm]} launches; profiling it again")
        profiles[f"{wl}/{arm}"] = prof
    details["shard_profiles"] = profiles
    if "top" in profiles["dh/K5/space4"]:
        others = {}
        for key in ("dh/K4/space4", "dh/K5/space4"):
            others[key] = sorted((k, n) for k, n, _ in profiles[key]["all"]
                                 if not any(o in k for o in own))
        # the route's launches in one call by its wrappers' counts, which are
        # exact: the profiler's trace has dropped a U+V pass's launch
        before = dict(sk.LAUNCHES)
        fn("K5/space4", "dh")()
        torch.cuda.synchronize()
        mine = {o: sk.LAUNCHES[k] - before[k]
                for o in own for k in [o.removeprefix("shard_").removesuffix("_kernel")]}
        log(f"[11 shard profile] dh/K5/space4 route kernels (name: launches): {mine}; "
            f"other kernels equal to the K4 call's: {others['dh/K4/space4'] == others['dh/K5/space4']}")
        # two plane passes (luma, U+V): one prepare, K5 and finalize each
        if others["dh/K4/space4"] != others["dh/K5/space4"] or list(mine.values()) != [2, 2, 2, 0]:
            raise AssertionError(f"the K5 route's call launches torch kernels of its own: "
                                 f"{mine} / {others}")

    # each pass alone: the 1080 dh call's luma and U+V passes on 4 shards
    fmt = clip_dh.format
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    n = 4
    luma = clip_dh.planes[0].contiguous()
    N, bufH, S = luma.shape
    Sc = _sharded_pad_width(960, 270, S, n, fmt, True)
    uv = torch.cat([clip_dh.planes[1], clip_dh.planes[2]])
    uv = torch.cat([uv, uv[..., -1:].expand(-1, -1, Sc - uv.shape[2])], dim=2).contiguous()
    passes = {"luma": (luma, aaf_as_pixel(aafs[0], fmt), S),
              "U+V": (uv, aaf_as_pixel(aafs[1], fmt), 960)}
    limit = dk._max_smem_bytes(dk._load(), torch.device(DEVICE))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res: dict = {}
    for name, (kept, aaf, w) in passes.items():
        Nk, bH, Sk = kept.shape
        m = _timed(lambda: sk.full_pass(kept, 0, aaf, spec, n, w),
                   lambda: fs.deinterlace_fused_full_plain(kept, 0, aaf, spec, n, w), 10)
        m["bound_ms"], m["bound_by"] = bound(*k4_work(Nk, bH, Sk))
        plan = sk.full_plan(n, Sk // n, bH, 1, limit)
        occ = sk.occupancy("full", spec, plan, n, torch.device(DEVICE))
        m["occupancy"] = {**occ, "blocks": Nk * n, "plan": plan._asdict(),
                          "waves": Nk * n / max(1, occ["clusters"] * n)}
        res[f"K4/{name}"] = m
        log(f"[11 shard timing] K4 per {name} pass ({n} shards x {Nk} fields x {bH} rows, "
            f"R {plan.R}, halo {plan.H}, {plan.threads} threads x {plan.cols} columns, route "
            f"{plan.route}): {m['ms']:.4f} ms ({m['ms'] / (bH - 1) * 1e3:.3f} us a row step), "
            f"plain {m['plain_ms']:.3f} ms, bound {m['bound_ms']:.4f} ms ({m['bound_by']}), "
            f"max_abs_err {m['max_abs_err']}; {occ['registers']} registers, "
            f"{occ['spill_bytes']} spill bytes, {occ['blocks_per_sm']} blocks a SM, "
            f"{occ['clusters']} clusters at once, {Nk * n} blocks = "
            f"{m['occupancy']['waves']:.2f} waves | {card}")
        raw = sk.prepare(kept, spec, w)
        C = 9 * Nk
        rawf = raw.view(C, bH + 1, Sk)
        sm = sk.smooth_pass(rawf, spec, n)
        stages = {
            "prepare": (lambda: sk.prepare(kept, spec, w),
                        lambda: ws.prepare_chunked_plain(kept, spec, n, w if w < Sk else None),
                        chunked_prepare_work(Nk, bH, Sk)),
            "K5": (lambda: sk.smooth_pass(rawf, spec, n),
                   lambda: ws._unshard(fs.smooth_sharded_chunked_plain(
                       ws._shards(rawf, n), spec)), k5_work(C, bH, Sk)),
            "finalize": (lambda: sk.finalize(kept, sm.view(9, Nk, bH - 1, Sk), aaf, spec),
                         lambda: ws.finalize_chunked_plain(kept, sm.view(9, Nk, bH - 1, Sk),
                                                           aaf, spec, n),
                         chunked_finalize_work(Nk, bH, Sk)),
        }
        for key, (kf, pf, work) in stages.items():
            mm = _timed(kf, pf, 3)
            mm["bound_ms"], mm["bound_by"] = bound(*work)
            if key == "K5":
                p5 = sk.smooth_plan(n, Sk // n, bH, limit)
                o5 = sk.occupancy("smooth", spec, p5, n, torch.device(DEVICE))
                mm["occupancy"] = {**o5, "blocks": C * n, "plan": p5._asdict(),
                                   "waves": C * n / max(1, o5["clusters"] * n)}
            res[f"{key}/{name}"] = mm
            occ_s = "" if key != "K5" else (
                f"; {o5['registers']} registers, {o5['spill_bytes']} spill bytes, "
                f"{o5['blocks_per_sm']} blocks a SM, {o5['clusters']} clusters at once, "
                f"{C * n} blocks = {mm['occupancy']['waves']:.2f} waves")
            log(f"[11 shard timing] {key} per {name} pass ({n} shards, {Nk} fields x {bH} "
                f"rows x {Sk}): {mm['ms']:.4f} ms, plain {mm['plain_ms']:.3f} ms, bound "
                f"{mm['bound_ms']:.4f} ms ({mm['bound_by']}), max_abs_err "
                f"{mm['max_abs_err']}{occ_s} | {card}")
        del raw, rawf, sm
        torch.cuda.empty_cache()
    details["shard_pass_ms"] = res
    details["sm_count"] = n_sm
    return res


PROBE_SOURCE = "sangnom_tpu_torch/csrc/probes.cu"
def probe_src():
    """The probes' [120, 2048] int32 input, seed 0 (the tools' own)."""
    return torch.from_numpy(np.random.default_rng(0).integers(0, 255, (120, 2048))).to(
        DEVICE, torch.int32)


def plan_line(plan) -> str:
    """A K8-K10 launch plan (``tools.probe_kernel.Plan``) in one phrase."""
    return (f"C {plan.cols}" + (f" x {plan.rows} rows" if plan.rows > 1 else "")
            + f", {plan.threads} threads x {plan.blocks} blocks, route "
            f"{plan.route}, {plan.exchanges} exchanges and {plan.barriers} barriers an "
            f"iteration, {plan.smem_bytes} shared bytes")


def phase_probe_matrix(details):
    """K8, K9 and K10 vs their plain versions on CUDA tensors: every K8 arm
    at full [120, 2048], 4 steps, at the differential's long chain; K9's
    default arms (bigslab@1 must raise), every other arm once, ramt130@2 (the
    whole-line route), ramt2047@2 (a shuffle) and bigslab_iota@1; K10 at
    the probe's shape, at 540 x 1920 over 542 steps and on rows that are not
    16-byte aligned (60 x 1000 over 30 steps, 5 x 17 over 9), u8 and i32.  Prints
    each K8 arm's and K9 default arm's launch plan.  Returns
    {kernel: (cases, max_abs_err)} ("K8mm": the mm arms); any difference
    raises."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv
    from sangnom_tpu_torch.tools import isolate_step as iso
    from sangnom_tpu_torch.tools import probe_kernel as prk
    from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn

    src = probe_src()
    res = {"K8": [0, 0.0], "K8mm": [0, 0.0], "K9": [0, 0.0], "K10": [0, 0.0]}

    def check(key, got, want, what):
        torch.cuda.synchronize()
        err = max_abs(got, want)
        res[key][1] = max(res[key][1], err)
        if err != 0.0:
            raise AssertionError(f"{key} {what}: kernel != plain, max_abs {err}")
        res[key][0] += 1

    for kind in cv.OPS_PER_ITER:
        log(f"[12 plan] K8 {kind} at [120, 2048]: "
            f"{plan_line(prk.line_plan(kind, 2048))}")
        k = cv.chain_lengths(kind)[1]
        got = cv.run(src, kind, k, steps=4)
        if kind in cv.TRANSPOSED and got[:, :, 120:].any():
            raise AssertionError(f"K8 {kind}: columns 120..127 not zero")
        check("K8mm" if kind in cv.MM_KINDS else "K8", got,
              cv.run_plain(src, kind, k, steps=4), f"{kind} k={k}")
    arms = list(iso.DEFAULT_ARMS) + [f"{k}@1" for k in iso.KINDS if k != "bigslab"]
    for arm in arms + ["ramt130@2", "ramt2047@2", "bigslab_iota@1"]:
        kind, _, k = arm.partition("@")
        if kind == "bigslab":
            for fn in (iso.run, iso.run_plain):
                try:
                    fn(src, kind, int(k))
                except ValueError:
                    continue
                raise AssertionError(f"K9 bigslab@1 did not raise in {fn.__name__}")
            continue
        if arm in iso.DEFAULT_ARMS:
            log(f"[12 plan] K9 {arm}: {plan_line(prk.isolate_plan(kind))}")
        check("K9", iso.run(src, kind, int(k)), iso.run_plain(src, kind, int(k)), arm)
    for dtype in (np.uint8, np.int32):
        for H, S, steps in ((64, 256, 70), (540, 1920, 542), (60, 1000, 30), (5, 17, 9)):
            kept = torch.from_numpy(dyn.probe_input(dtype, H, S)).to(DEVICE)
            check("K10", dyn.dynrow(kept, steps), dyn.dynrow_plain(kept, steps),
                  f"{np.dtype(dtype).name} {H}x{S} steps {steps}")
    details["probe_matrix"] = res
    return res


def phase_cost_model_path(card, details):
    """The cost-model path through its entry points, launch counts set to 0
    just before and read just after: the op-class calibration at full shape
    (all 30 arms, 512 steps, differential, best of 3; K8), the step-isolation tool's
    default arms (K9) and the dynamic-row probe (K10).  Returns (rates,
    launches per kernel)."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv
    from sangnom_tpu_torch.tools import isolate_step as iso
    from sangnom_tpu_torch.tools import probe_kernel as prk
    from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn
    from sangnom_tpu_torch.utils.cost_model import PEAK_INT32_S

    src = probe_src()
    torch.cuda.synchronize()
    prk.reset_launches()
    rates = cv.calibrate(src, tuple(cv.OPS_PER_ITER), reps=3,
                         log=lambda line: log(f"[13 calibration]{line} | {card}"))
    if iso.main([]) != 0 or dyn.main() != 0:
        raise AssertionError("a probe tool failed")
    torch.cuda.synchronize()
    launches = dict(prk.LAUNCHES)
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe kernel did not launch on the cost-model path: {launches}")
    if min(rates.values()) <= 0.0:
        raise AssertionError(f"a calibration arm measured no rate: {rates}")
    details["calibration_rates"] = rates
    details["calibration_share_of_int32_peak"] = {k: v / PEAK_INT32_S for k, v in rates.items()}
    log(f"[13 cost-model path] calibration of {len(rates)} arms, isolate_step and "
        f"probe_pool_dynrow: launches {launches}")
    return rates, launches


def predicted_k1_step(rates, luma_ms: float, card: str, details) -> dict:
    """K1's luma launch (120 fields x 1920 columns, 539 row steps) against
    the cost model's step prediction, from this run's rates and from the
    stored ``MEASURED_OP_RATES``."""
    from sangnom_tpu_torch.utils import cost_model as cm

    elems = 120 * 1920
    here = sum(n * elems / rates[c] for c, n in cm.STEP_OP_CLASSES.items())
    stored = cm.predicted_step_time_s(120, 1920)
    measured = luma_ms * 1e-3 / 539
    out = {"measured_us": measured * 1e6, "predicted_us": here * 1e6,
           "predicted_stored_us": stored * 1e6}
    log(f"[13 K1 step] luma step measured {measured * 1e6:.3f} us (phase 5 luma launch "
        f"{luma_ms:.4f} ms / 539 steps); predicted from this run's rates "
        f"{here * 1e6:.3f} us ({here / measured:.3f} of measured), from the stored "
        f"rates {stored * 1e6:.3f} us | {card}")
    details["k1_step"] = out
    return out


def shuffled(cols: int, *reach: int) -> float:
    """Values a column takes from other lanes in a chain iteration, with C =
    ``cols`` columns a thread, for rolls (and b's tap windows) that reach
    ``reach`` columns: a roll by s renames registers for C - |s| of a
    thread's C elements and shuffles the other |s|, so a column pays |s| / C
    shuffles, not an operation.  A shuffle takes one issue slot as an add
    does; the shuffle unit's own rate, a quarter of the issue rate, would
    bind only past a quarter of the operations, which no probe reaches."""
    return sum(reach) / cols


def mm_library_ms(kind: str, r: int, iters: int) -> float:
    """ms of ``iters`` iterations' products of an mm arm by one PyTorch call
    each, a yardstick the port never calls: z [r, 128] @ m [128, 128] as
    torch.addmm in float32 with TF32 off (mmf32, + wv), torch._int_mm
    (mmint8) or a bf16 torch.mm (mmbf16, mmroll); one call timed over 200
    back-to-back calls, times ``iters``."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv

    z, m = cv.mm_seed(r, DEVICE), cv.mm_perm(DEVICE)
    if kind == "mmf32":
        zf, mf, wv = z.float(), m.float(), z.float()
        fn = lambda: torch.addmm(wv, zf, mf)  # noqa: E731
    elif kind == "mmint8":
        z8, m8 = cv.wrap8(z).to(torch.int8), m.to(torch.int8)
        fn = lambda: torch._int_mm(z8, m8)  # noqa: E731
    else:
        zb, mb = z.to(torch.bfloat16), m.to(torch.bfloat16)
        fn = lambda: torch.mm(zb, mb)  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fn()
        return min(cuda_ms(fn, 200) for _ in range(2)) * iters
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def probe_timing(card, details) -> dict:
    """ms of one launch of each probe kernel and of its plain version on the
    same inputs, with its bound: K8 for one arm of each of its line and step
    kernels at [120, 2048] over 32 steps, mix (line_kernel, the
    kernel-shaped blend) at k 96, stepv (step_kernel) at k 12, and the four
    mm arms at k 96 with one PyTorch call of each iteration's product as a
    yardstick (``mm_library_ms``); K9's unroll@12 (8 steps); K10 at 540 x
    1920 u8 over 542 steps, its kernel's device time by the profiler
    (``probe_ab.device_ms``).  Each case prints its launch plan.
    Their operation bounds count what the work needs: the adds, masks and
    shifts of each chain, and for each roll only the shuffles of the plan's
    C (``shuffled``); the mm arms' FLOPs of a dense 128 x 128 product an
    iteration over the rate of the unit they run on."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv
    from sangnom_tpu_torch.tools import isolate_step as iso
    from sangnom_tpu_torch.tools import probe_kernel as prk
    from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn
    from sangnom_tpu_torch.tools.probe_ab import device_ms
    from sangnom_tpu_torch.utils.cost_model import PEAK_BF16_S, PEAK_FP32_S, PEAK_INT8_S

    src = probe_src()
    G, W = src.shape
    kept = torch.from_numpy(dyn.probe_input(np.uint8, 540, 1920)).to(DEVICE)
    out_bytes = lambda steps: steps * G * 128 * 4  # noqa: E731
    io = G * W * 4 + out_bytes(32)
    # a slab's rolls by 1, 2 and 3 on 5 slabs, and b's window of 3 columns
    # each side (6 shifted adds share it)
    slab_and_taps = (1, 2, 3) * 5 + (3, 3)
    c_mix, c_stepv = prk.line_plan("mix", W).cols, prk.line_plan("stepv", W).cols
    c_k9 = prk.isolate_plan("unroll").cols
    cases = {
        "K8": (lambda: cv.run(src, "mix", 96, steps=32),
               lambda: cv.run_plain(src, "mix", 96, steps=32),
               # 7 counted ops an iteration, one of them the roll by 1
               (io, 96 * 32 * G * W * (cv.OPS_PER_ITER["mix"] - 1 + shuffled(c_mix, 1))),
               "mix arm, [120, 2048] i32, k 96, 32 steps", prk.line_plan("mix", W)),
        # stepv: an add after each of 3 rolls, a sub, shift and mask on each of
        # 5 slabs, 6 shifted adds and a mask on b, an iteration a column
        "K8 stepv": (lambda: cv.run(src, "stepv", 12, steps=32),
                     lambda: cv.run_plain(src, "stepv", 12, steps=32),
                     (io, 12 * 32 * G * W * (5 * 6 + 7 + shuffled(c_stepv, *slab_and_taps))),
                     "stepv arm, [120, 2048] i32, k 12, 32 steps", prk.line_plan("stepv", W)),
    }
    # the mm arms: z [G*W/128, 128] @ m [128, 128] an iteration, 2 operations
    # a multiply-add, over the peak of the unit the arm runs on
    mm_iters = 96 * 32
    mm_ops = mm_iters * 2 * (G * W // 128) * 128 * 128
    for kind, peak, unit in (("mmbf16", PEAK_BF16_S, "bf16 tensor-core FLOPs over 989 TFLOP/s"),
                             ("mmf32", PEAK_FP32_S, "FP32 FMA FLOPs over 66.9 TFLOP/s"),
                             ("mmint8", PEAK_INT8_S, "int8 tensor-core ops over 1979 TOP/s"),
                             ("mmroll", PEAK_BF16_S, "bf16 tensor-core FLOPs over 989 TFLOP/s")):
        cases[f"K8 {kind}"] = (lambda kind=kind: cv.run(src, kind, 96, steps=32),
                               lambda kind=kind: cv.run_plain(src, kind, 96, steps=32),
                               (io, mm_ops, peak),
                               f"{kind} arm, [120, 2048] i32, k 96, 32 steps, {unit}",
                               prk.line_plan(kind, W))
    # unroll: an add after each of 3 rolls on 5 slabs and 6 shifted adds on
    # b an iteration
    cases["K9"] = (lambda: iso.run(src, "unroll", 12), lambda: iso.run_plain(src, "unroll", 12),
                   (G * W * 4 + out_bytes(8),
                    12 * 8 * G * W * (5 * 3 + 6 + shuffled(c_k9, *slab_and_taps))),
                   "unroll@12, [120, 2048] i32, 8 steps", prk.isolate_plan("unroll"))
    cases["K10"] = (lambda: dyn.dynrow(kept, 542), lambda: dyn.dynrow_plain(kept, 542),
                    (540 * 1920 + 542 * 1920 * 4, 542 * 1920 * 5),
                    "540 x 1920 u8, 542 steps", prk.dynrow_plan(540, 1920, 542, True))
    res = {}
    for key, (kern, plain, work, what, plan) in cases.items():
        kern()
        plain()
        k_ms = min(cuda_ms(kern, 5) for _ in range(2))
        p_ms = cuda_ms(plain, 1)
        b_ms, b_by = bound(*work)
        res[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        lib = ""
        if key == "K10":  # a few microseconds on the card: take its device time
            res[key].update(ms=device_ms(kern, "dynrow_kernel"), call_ms=k_ms)
            lib = (f"; the call by CUDA events {k_ms:.4f} ms (the host's issue time), the "
                   f"kernel's device time by the profiler")
            k_ms = res[key]["ms"]
        if key.startswith("K8 mm"):
            lib_ms = mm_library_ms(key[3:], G * W // 128, mm_iters)
            res[key]["library_ms"] = lib_ms
            lib = (f"; an iteration {k_ms / mm_iters * 1e3:.4f} us, one PyTorch call of its "
                   f"product {lib_ms / mm_iters * 1e3:.4f} us ({lib_ms:.4f} ms for {mm_iters})")
        log(f"[13 probe timing] {key} ({what}): {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / k_ms:.3f} of it{lib}"
            + f"; plan {plan_line(plan)}"
            + f" | {card}")
    details["probe_kernel_ms"] = res
    return res


CLI_WINDOW = 8  # --window of the windowed CLI runs; the hosts' batch
POOL_WINDOW = 4  # --window of the windowed pool_compat CLI run
BOB_RECIPE = "AssumeTFF()\nSeparateFields()\nDoubleWeave()\nSangNom2(order=0)\n"


def _file_sha(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _y4m_sha(clip, fps) -> str:
    """SHA-256 of ``write_y4m(clip, fps=fps)``, the bytes a CLI run must
    write."""
    from sangnom_tpu_torch.io import write_y4m

    buf = io.BytesIO()
    write_y4m(buf, clip, fps=fps)
    return hashlib.sha256(buf.getbuffer()).hexdigest()


def check_launches(what: str, got: dict, want: dict, at_least: bool = False) -> None:
    """Raise unless the launch counts equal their formula (with ``at_least``:
    reach it in every kernel)."""
    if (any(got.get(k, 0) < v for k, v in want.items()) if at_least else got != want):
        raise AssertionError(f"{what}: launches {got}, formula {want}")


def _launch_counts(dk, pk) -> dict:
    return {"deint": dk.LAUNCHES, **{k: v for k, v in pk.LAUNCHES.items() if v}}


def _profile_run(fn) -> dict:
    """One run of ``fn`` under torch.profiler: its wall time and the device
    time of its kernels and of its copies, so the card's idle share over
    the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("sangnom/")]
    copies = sum(ms for k, ms in rows if k.startswith(("Memcpy", "Memset")))
    kernels = sum(ms for k, ms in rows) - copies
    return {"wall_ms": wall_ms, "kernel_ms": kernels, "copy_ms": copies}


def phase_cli_hosts(tmp, fmt, bob_planes, dh_planes, pool_planes, out_bob, out_dh,
                    api_bob_ms: float, card: str, details: dict) -> dict:
    """Phase 14: the CLI and the hosts at 1080, from a y4m file to a y4m
    file.  Writes phase 4's interlaced input (tff, 30000:1001), its fields
    and phase 7's pool clip as y4m files; runs ``cli.main`` in-process:
    ``--bob`` whole, windowed without and with the writer and reader
    threads, and through the plain path; ``--order 1 --dh --window``;
    ``--pool-compat --order 1`` whole and windowed; and the ``script`` verb
    on the canonical bob recipe.  Each output file is SHA-equal to
    ``write_y4m`` of phase 4's output (or of the API's pool_compat call on
    phase 7's clip), and each run's kernel launches equal their formula (2
    K1 launches a filter call, luma and fused U+V; 3 K7 launches a plane
    pass).  Then the AviSynth-model host serves the fields through
    ``env.invoke("SangNom2", src, order=1, dh=True)`` to 4 threads in
    shuffled order, every frame equal to phase 4's dh output.  Times each
    run's wall and frames/s, and for the windowed bob the read+parse,
    upload, download and write stages alone and the card's idle share over
    the run."""
    from sangnom_tpu_torch import Clip, cli, sangnom2
    from sangnom_tpu_torch.hosts.avisynth import (ArraySource, ScriptEnvironment,
                                                  avisynth_plugin_init)
    from sangnom_tpu_torch.io import iter_y4m, write_y4m
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk

    t_phase = time.perf_counter()
    n_in, n_fields, n_pool = bob_planes[0].shape[0], dh_planes[0].shape[0], pool_planes[0].shape[0]
    paths = {"bob": tmp / "bob.y4m", "fields": tmp / "fields.y4m", "pool": tmp / "pool.y4m"}
    for key, planes, ilace in (("bob", bob_planes, "t"), ("fields", dh_planes, "p"),
                               ("pool", pool_planes, "t")):
        write_y4m(str(paths[key]), Clip.from_numpy(planes, fmt, device="cpu"),
                  fps=(30000, 1001), interlace=ilace)
    pool_api = sangnom2(Clip.from_numpy(pool_planes, fmt, device=DEVICE, tff=True),
                        order=1, pool_compat=True)
    want = {"bob": _y4m_sha(out_bob, (60000, 1001)), "dh": _y4m_sha(out_dh, (30000, 1001)),
            "pool": _y4m_sha(pool_api, (30000, 1001))}
    del pool_api
    sizes = {k: p.stat().st_size for k, p in paths.items()}
    dims = {k: f"{p[0].shape[2]}x{p[0].shape[1]}"
            for k, p in (("bob", bob_planes), ("fields", dh_planes), ("pool", pool_planes))}
    log(f"[14 inputs] y4m files: {n_in} x {dims['bob']} tff ({sizes['bob']} bytes), "
        f"{n_fields} fields {dims['fields']} ({sizes['fields']} bytes), {n_pool} x "
        f"{dims['pool']} ({sizes['pool']} bytes); expected output SHA-256s from phase 4 "
        f"and the API")

    arm = default_pool_arm(pc)
    passes = n_pool * 3
    pool_formula = {"K3": {"smooth": passes}, "K6": {"split3": passes},
                    "K7": {"prepare": passes, "split3": passes, "finalize": passes}}[arm]
    bob_win = ["--bob", "--window", str(CLI_WINDOW)]
    windows_bob = -(-n_in // CLI_WINDOW)
    runs = [  # (name, input, flags, expected output, launches formula)
        ("bob", "bob", ["--bob"], "bob", {"deint": 2}),
        ("bob-window", "bob", bob_win + ["--no-overlap-write"], "bob",
         {"deint": 2 * windows_bob}),
        ("bob-window-overlap", "bob", bob_win + ["--overlap-write"], "bob",
         {"deint": 2 * windows_bob}),
        ("bob-window-overlap", "bob", bob_win + ["--overlap-write"], "bob",
         {"deint": 2 * windows_bob}),
        ("bob-window", "bob", bob_win + ["--no-overlap-write"], "bob",
         {"deint": 2 * windows_bob}),
        ("bob-plain", "bob", ["--bob", "--opt", "0"], "bob", {"deint": 0}),
        ("dh-window", "fields", ["--order", "1", "--dh", "--window", str(CLI_WINDOW)], "dh",
         {"deint": 2 * -(-n_fields // CLI_WINDOW)}),
        ("pool", "pool", ["--pool-compat", "--order", "1"], "pool",
         {"deint": 0, **pool_formula}),
        ("pool-window", "pool", ["--pool-compat", "--order", "1", "--window",
                                 str(POOL_WINDOW)], "pool", {"deint": 0, **pool_formula}),
        ("script", "bob", None, "bob", {"deint": 2 * -(-2 * n_in // CLI_WINDOW)}),
    ]
    recipe = tmp / "bob.avs"
    recipe.write_text(BOB_RECIPE)
    frames_in = {"bob": n_in, "fields": n_fields, "pool": n_pool}
    frames_out = {"bob": 2 * n_in, "dh": n_fields, "pool": n_pool}
    walls: dict = {}
    for name, src, flags, key, formula in runs:
        out = tmp / "out.y4m"
        argv = (["script", str(recipe), str(paths[src]), str(out)] if flags is None
                else [str(paths[src]), str(out), *flags])
        torch.cuda.synchronize()
        dk.LAUNCHES = 0
        pk.reset_launches()
        t = time.perf_counter()
        rc = cli.main(argv + ["--device", DEVICE])
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"CLI run {name} exited {rc}")
        launches = _launch_counts(dk, pk)
        if _file_sha(out) != want[key]:
            raise AssertionError(f"CLI run {name}: output != write_y4m of the {key} output")
        out.unlink()
        check_launches(f"CLI run {name}", launches, formula)
        walls.setdefault(name, []).append(wall)
        log(f"[14 cli] {name} ({' '.join(argv[2:] if flags is not None else ['script', 'bob.avs'])}): "
            f"{wall * 1e3:.1f} ms wall, {frames_in[src] / wall:.2f} input frames/s, "
            f"{frames_out[key] / wall:.2f} output frames/s end to end; SHA-equal to the "
            f"{key} output; launches {launches} = formula | {card}")

    # the AviSynth-model host: 4 threads, shuffled, windows of CLI_WINDOW
    env = ScriptEnvironment(device=DEVICE)
    avisynth_plugin_init(env)
    flt = env.invoke("SangNom2", ArraySource(dh_planes, fmt), order=1, dh=True,
                     batch=CLI_WINDOW)
    want_np = out_dh.to_numpy()
    order = np.random.default_rng(14).permutation(n_fields)
    bad: list = []

    def serve(ns):
        for n in ns:
            got = flt.get_frame(int(n), env).planes
            if not all(np.array_equal(g, w[n]) for g, w in zip(got, want_np)):
                bad.append(int(n))

    torch.cuda.synchronize()
    dk.LAUNCHES = 0
    t = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        for fut in [ex.submit(serve, order[i::4]) for i in range(4)]:
            fut.result(timeout=600)
    host_wall = time.perf_counter() - t
    if bad:
        raise AssertionError(f"AviSynth host: frames {sorted(bad)[:8]} != phase 4's dh output")
    check_launches("AviSynth host", {"deint": dk.LAUNCHES},
                   {"deint": 2 * -(-n_fields // CLI_WINDOW)}, at_least=True)
    log(f"[14 avisynth host] SangNom2(order=1, dh=True) on {n_fields} fields, windows of "
        f"{CLI_WINDOW}, 4 threads in shuffled order: every frame equal to phase 4's dh "
        f"output; {dk.LAUNCHES} K1 launches (2 a window computed; evicted windows "
        f"recompute); {host_wall * 1e3:.1f} ms, {n_fields / host_wall:.2f} frames/s | {card}")
    del want_np

    # the windowed bob's stages alone, per input frame
    t = time.perf_counter()
    windows = list(iter_y4m(str(paths["bob"]), CLI_WINDOW, device="cpu"))
    read_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    for w in windows:
        [p.to(DEVICE) for p in w.planes]
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t) * 1e3
    del windows
    t = time.perf_counter()
    out_host = Clip([p.cpu() for p in out_bob.planes], out_bob.format, props=out_bob.props)
    download_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    write_y4m(str(tmp / "write.y4m"), out_host, fps=(60000, 1001))
    write_ms = (time.perf_counter() - t) * 1e3
    (tmp / "write.y4m").unlink()
    del out_host
    log(f"[14 stages] windowed bob alone, per input frame (of {n_in}): read+parse "
        f"(iter_y4m, window {CLI_WINDOW}) {read_ms / n_in:.3f} ms, upload "
        f"{upload_ms / n_in:.3f} ms, download of the 2 output frames {download_ms / n_in:.3f} "
        f"ms, write_y4m of them {write_ms / n_in:.3f} ms; the API call (phase 5) "
        f"{api_bob_ms / n_in:.3f} ms | {card}")
    prof = {}
    for name, extra in (("bob-window", ["--no-overlap-write"]),
                        ("bob-window-overlap", ["--overlap-write"])):
        out = tmp / "out.y4m"
        prof[name] = p = _profile_run(lambda: cli.main(
            [str(paths["bob"]), str(out), *bob_win, *extra, "--device", DEVICE]))
        out.unlink()
        busy = p["kernel_ms"] + p["copy_ms"]
        log(f"[14 profile] {name}: wall {p['wall_ms']:.1f} ms under the profiler; device "
            f"kernels {p['kernel_ms']:.3f} ms, copies {p['copy_ms']:.3f} ms; idle share "
            f"{1 - busy / p['wall_ms']:.4f} (kernels only: "
            f"{1 - p['kernel_ms'] / p['wall_ms']:.4f}) | {card}")
    best = {k: min(v) for k, v in walls.items()}
    log(f"[14 summary] output frames/s end to end: CLI --bob whole {2 * n_in / best['bob']:.1f}, "
        f"--window {CLI_WINDOW} {2 * n_in / best['bob-window']:.1f}, with --overlap-write "
        f"{2 * n_in / best['bob-window-overlap']:.1f}, script verb "
        f"{2 * n_in / best['script']:.1f}; the API call (phase 5) "
        f"{2 * n_in / api_bob_ms * 1e3:.1f} | {card}")
    res = {"wall_s": walls, "stage_ms": {"read": read_ms, "upload": upload_ms,
                                         "download": download_ms, "write": write_ms},
           "profile": prof, "host_wall_s": host_wall, "api_bob_ms": api_bob_ms,
           "seconds": time.perf_counter() - t_phase}
    details["cli_hosts"] = res
    return paths, want


# --- phases 15-18 ------------------------------------------------------------

AOT_RUN = ("import sys; from sangnom_tpu_torch import cli; "
           "from sangnom_tpu_torch.ops import deint_kernel as dk; "
           "rc = cli.main(sys.argv[1:]); "
           "print('BUILDS', dk.BUILDS, 'LIB', dk.LIB_PATH, flush=True); sys.exit(rc)")


def _subprocess(argv: list, what: str, timeout: int = 600):
    """Run ``argv`` from the repository root; raise unless it exits 0.
    Returns (wall seconds, stdout, stderr)."""
    t = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=timeout,
                       cwd=Path(__file__).resolve().parent)
    wall = time.perf_counter() - t
    if r.returncode != 0:
        raise AssertionError(f"{what} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-4000:]}")
    return wall, r.stdout, r.stderr


def phase_prewarm(tmp, paths, want, n_in, card, details):
    """Phase 15: ``prewarm`` into a fresh directory in a subprocess (the cold
    cost, nvcc included), then the main verb with ``--bob --window`` and
    ``--aot DIR`` in a fresh subprocess on phase 14's 1080i y4m: it must
    build nothing, load the library from DIR, count only hits, and write the
    bytes of phase 14's windowed bob.  The trailing window of 60 frames at 8
    (4 frames) is prewarmed by a second ``prewarm --frames 4`` into the same
    directory (no nvcc).  A fresh process with no --aot on the checkout's
    built library is timed beside them."""
    adir = tmp / "aot"
    pre = [sys.executable, "-m", "sangnom_tpu_torch", "prewarm", "--aot", str(adir),
           "--size", "1920x1080", "--format", FMT, "--bob", "--device", DEVICE]
    cold, _, err = _subprocess(pre + ["--window", str(CLI_WINDOW)], "prewarm")
    log(f"[15 prewarm] prewarm --bob --window {CLI_WINDOW} into a fresh directory: "
        f"{cold:.2f} s wall (nvcc included) | {err.strip().splitlines()} | {card}")
    tail = n_in % CLI_WINDOW
    tail_s = 0.0
    if tail:
        tail_s, _, err = _subprocess(pre + ["--frames", str(tail)], "prewarm tail")
        if "kernel library built" in err:
            raise AssertionError("the second prewarm rebuilt the library")
    walls = {}
    for name, extra in (("--aot", ["--aot", str(adir)]), ("no --aot", [])):
        out = tmp / "aot_out.y4m"
        wall, so, se = _subprocess(
            [sys.executable, "-c", AOT_RUN, str(paths["bob"]), str(out), "--bob",
             "--window", str(CLI_WINDOW), "--device", DEVICE, *extra], f"main verb {name}")
        walls[name] = wall
        if _file_sha(out) != want["bob"]:
            raise AssertionError(f"main verb {name}: output != phase 14's windowed bob")
        out.unlink()
        builds = so.split("BUILDS ")[1].split()[0]
        lib = so.split(" LIB ")[1].strip()
        note = next((ln for ln in se.splitlines() if ln.startswith("aot:")), "")
        if name == "--aot":
            hits = -(-n_in // CLI_WINDOW)
            if builds != "0" or (DEVICE == "cuda" and Path(lib).parent != adir):
                raise AssertionError(f"--aot run: {builds} builds, library {lib}")
            if note != f"aot: {hits} dispatch(es) served from artifacts, 0 miss(es)":
                raise AssertionError(f"--aot run: {note!r}")
        log(f"[15 prewarm] fresh process, main verb --bob --window {CLI_WINDOW} {name}: "
            f"{wall:.2f} s wall, {builds} nvcc builds, library {lib}; {note or 'no aot note'}; "
            f"SHA-equal to phase 14's windowed bob | {card}")
    details["prewarm"] = {"prewarm_s": cold, "prewarm_tail_s": tail_s, "run_s": walls}


def phase_examples(tmp, paths, card, details):
    """Phase 16: the six examples with ``--device cuda`` (in-process); the
    five file examples on phase 14's 1080i y4m, ``sharded_batch`` on its own
    8 x 1920x540 batch; each output file byte-equal to ``write_y4m`` of the
    port's API output for the same call."""
    import importlib

    from sangnom_tpu_torch import Clip, bob, sangnom2
    from sangnom_tpu_torch.io import read_y4m, write_y4m
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded

    def sha(clip, **kw):
        buf = io.BytesIO()
        write_y4m(buf, clip, **kw)
        return hashlib.sha256(buf.getbuffer()).hexdigest()

    clip = read_y4m(str(paths["bob"]), device=DEVICE)
    fps = clip.props["y4m_fps"]
    host = Clip([p.cpu() for p in sangnom2(clip, order=1, aa=48, dh=True).planes],
                clip.format)  # what the host example writes: no props
    want = {
        "deinterlace_file": sha(sangnom2(clip, order=1, aa=48)),
        "antialias_2x": sha(sangnom2(clip, dh=True, aa=48, aac=0)),
        "bob_double_rate": sha(bob(clip), fps=(fps[0] * 2, fps[1])),
        "reference_compat": sha(sangnom2(clip, order=1, aa=48, pool_compat=True,
                                         numerics="sse2")),
        "avisynth_host": sha(host),
    }
    del host
    rng = np.random.default_rng(0)
    sb = Clip.from_numpy([rng.integers(0, 256, (8, h, w)).astype(np.uint8)
                          for h, w in ((540, 1920), (270, 960), (270, 960))],
                         FMT, device=DEVICE)
    mesh = default_mesh() if DEVICE == "cuda" else default_mesh(devices=[DEVICE])
    want["sharded_batch"] = sha(sangnom2_sharded(sb, mesh, order=1, dh=True))
    del sb, clip
    res = {}
    for name, w in want.items():
        mod = importlib.import_module(f"sangnom_tpu_torch.examples.{name}")
        out = tmp / f"example_{name}.y4m"
        argv = (["--device", DEVICE, "--out", str(out)] if name == "sharded_batch"
                else [str(paths["bob"]), str(out), "--device", DEVICE])
        t = time.perf_counter()
        mod.main(argv)
        torch.cuda.synchronize()
        res[name] = time.perf_counter() - t
        if _file_sha(out) != w:
            raise AssertionError(f"example {name}: output != the API output's y4m")
        out.unlink()
    log(f"[16 examples] {', '.join(f'{k} {v:.2f} s' for k, v in res.items())} "
        f"(--device {DEVICE}, wall with file I/O); each output byte-equal to the "
        f"API's | {card}")
    details["examples_s"] = res


def pool_fast_inputs(fmt):
    """The fast path's extra clip: 40 frames of 1920x1080, seed 10."""
    from sangnom_tpu_torch import Clip

    rng = np.random.default_rng(10)
    return Clip.from_numpy([rng.integers(0, 256, (40, h, w)).astype(np.uint8)
                            for h, w in ((1080, 1920), (540, 960), (540, 960))],
                           fmt, device=DEVICE)


def phase_pool_fast(fmt, clip_hd, clip_sd, card, details):
    """Phase 17: the frame-parallel pool path (``POOL_FAST``) on pool
    bob1080 (32 woven frames: chunks of 16), a 40-frame 1080 clip (16, 16,
    8) and pool hd720, each bit-equal to the sequential K7 route, frames and
    final pool, in 3 x planes x ceil(N / K) launches (planes x chunks of
    each kernel); pool sd480 (720 in stride 736) stays on the loop.  The
    batched prepare, walk and finalize against their plain twins at the
    1080 luma pass of K = 16 frames, timed with their bounds; ms per output
    frame of the fast path at K = 16 and 14 against the sequential route,
    in turns, with the idle share.  The flags are restored after."""
    from sangnom_tpu_torch import Clip, bob, sangnom2
    from sangnom_tpu_torch.core.fields import double_weave, separate_fields
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream as stream

    rng = np.random.default_rng(9)  # phase 8's hd720 clip
    clip_720 = Clip.from_numpy([rng.integers(0, 256, (N_720, h, w)).astype(np.uint8)
                                for h, w in ((720, 1280), (360, 640), (360, 640))],
                               fmt, device=DEVICE)
    clip_40 = pool_fast_inputs(fmt)
    woven = double_weave(separate_fields(clip_hd))
    cases = {  # name -> (clip, stream kwargs, main-path call)
        "bob1080": (woven, dict(order=0), lambda: bob(clip_hd, pool_compat=True)),
        "1080x40": (clip_40, dict(order=1), lambda: sangnom2(clip_40, order=1,
                                                             pool_compat=True)),
        "hd720": (clip_720, dict(order=1), lambda: sangnom2(clip_720, order=1,
                                                            pool_compat=True)),
        "sd480": (clip_sd, dict(order=1), lambda: sangnom2(clip_sd, order=1,
                                                           pool_compat=True)),
    }
    defaults = pc.POOL_FAST, pc.POOL_FAST_BATCH
    seq = {name: stream(c, None, **kw) for name, (c, kw, _) in cases.items()}
    launches = {}
    try:
        pc.POOL_FAST, pc.POOL_FAST_BATCH = True, 16
        torch.cuda.synchronize()
        pk.reset_launches()
        for name, (c, kw, call) in cases.items():
            before = dict(pk.LAUNCHES)
            out = call()
            torch.cuda.synchronize()
            got = {k: pk.LAUNCHES[k] - before[k] for k in before}
            got = {k: v for k, v in got.items() if v}
            want_out, want_pool = seq[name]
            for i, (g, r) in enumerate(zip(out.planes, want_out.planes)):
                if not torch.equal(g, r):
                    raise AssertionError(f"pool fast {name} plane {i} != the sequential "
                                         f"route, max_abs {max_abs(g, r)}")
            _, pool = stream(c, None, **kw)
            if not torch.equal(pool, want_pool):
                raise AssertionError(f"pool fast {name}: final pool != the sequential one")
            n = c.num_frames
            if name == "sd480":
                formula = {k: 3 * n for k in ("prepare", "split3", "finalize")}
            else:
                formula = {k: 3 * -(-n // 16) for k in ("prepare", "split3", "finalize")}
            check_launches(f"pool fast {name}", got, formula)
            launches[name] = got
            log(f"[17 pool fast] {name} ({n} frames, POOL_FAST_BATCH 16): frames and "
                f"final pool bit-equal to the sequential K7 route; launches {got} = "
                f"{'3 x planes x frames (sequential loop)' if name == 'sd480' else '3 x planes x ceil(N / 16)'}")

        # the batched kernels alone at the 1080 luma pass of 16 and 14 frames;
        # the kernels line reads K = 16, the default chunk
        spec = KernelSpec.from_format(fmt)
        aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
        per = {}
        for k_req in (16, 14):
            K = min(k_req, woven.num_frames)
            kept = woven.planes[0][:K, 0::2]  # strided, as the fast path reads it
            bufH_p, w = kept.shape[1:]
            P, S = bufH_p, w  # a stride-aligned luma plane fills its pool
            zeros = torch.zeros((K, 9, S), dtype=torch.int32, device=DEVICE)
            body0 = torch.zeros((K, 9, P - 1, S), dtype=torch.int32, device=DEVICE)
            prepared = pk.prepare_batch_plain_(kept, body0.clone(), spec)
            smoothed = pk.smooth_batch_plain_(zeros, prepared.clone(), zeros, spec)
            stages = {
                "prepare_batch": (
                    lambda b=body0.clone(), kept=kept: pk.prepare_batch_(kept, b, spec),
                    lambda b=body0.clone(), kept=kept: pk.prepare_batch_plain_(kept, b, spec),
                    lambda kept=kept, body0=body0, prepared=prepared: max_abs(
                        pk.prepare_batch_(kept, body0.clone(), spec), prepared),
                    tuple(K * x for x in pool_prepare_work(bufH_p, w))),
                "walk_batch": (
                    lambda b=prepared.clone(), z=zeros: pk.smooth_batch_(z, b, z, spec),
                    lambda b=prepared.clone(), z=zeros: pk.smooth_batch_plain_(z, b, z, spec),
                    lambda z=zeros, prepared=prepared, smoothed=smoothed: max_abs(
                        pk.smooth_batch_(z, prepared.clone(), z, spec), smoothed),
                    tuple(K * x for x in pool_smooth_work(P, S))),
                "finalize_batch": (
                    lambda kept=kept, sm=smoothed: pk.finalize_batch(kept, sm, aaf, spec),
                    lambda kept=kept, sm=smoothed: pk.finalize_batch_plain(kept, sm, aaf, spec),
                    lambda kept=kept, sm=smoothed: max_abs(
                        pk.finalize_batch(kept, sm, aaf, spec),
                        pk.finalize_batch_plain(kept, sm, aaf, spec)),
                    tuple(K * x for x in pool_finalize_work(bufH_p, w))),
            }
            for sname, (kern, twin, err, work) in stages.items():
                kern()
                k_ms = [cuda_ms(kern, 5) for _ in range(2)]
                p_ms = cuda_ms(twin, 1)
                b_ms, b_by = bound(*work)
                key = sname if k_req == 16 else f"{sname}/K{k_req}"
                per[key] = dict(ms=min(k_ms), windows=k_ms, plain_ms=p_ms, max_abs_err=err(),
                                bound_ms=b_ms, bound_by=b_by, frames=K)
                log(f"[17 pool fast] {sname} at the {2 * P}-line luma pass of {K} frames: "
                    f"{min(k_ms):.4f} ms/launch ({min(k_ms) / K:.4f} a frame; windows "
                    f"{', '.join(f'{t:.4f}' for t in k_ms)}), twin {p_ms:.3f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}), max_abs_err {per[key]['max_abs_err']} | {card}")
            del stages, zeros, body0, prepared, smoothed
        threads, per_sm = pk.walk_occupancy(spec, S)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for k in (16, 14):
            log(f"[17 pool fast] walk at K = {k}: {9 * k} blocks of {threads} threads, "
                f"{per_sm} resident a SM on {sms} SMs -> {-(-9 * k // (per_sm * sms))} "
                f"wave(s)")
        if any(v["max_abs_err"] != 0.0 for v in per.values()):
            raise AssertionError(f"a batched pool kernel disagrees with its twin: {per}")

        # ms per output frame, in turns: sequential, K = 16, K = 14
        arms = {"sequential": (False, 16), "fast K=16": (True, 16), "fast K=14": (True, 14)}
        timed = {name: cases[name] for name in ("bob1080", "1080x40", "hd720")}
        e2e: dict = {}
        for rnd in (list(arms), list(arms)[::-1]):
            for arm in rnd:
                pc.POOL_FAST, pc.POOL_FAST_BATCH = arms[arm]
                for wl, (c, _, call) in timed.items():
                    frames = c.num_frames
                    call()
                    e2e.setdefault(f"{wl}/{arm}", []).append(cuda_ms(call, 2) / frames)
        for k, ts in e2e.items():
            log(f"[17 pool fast] {k}: {min(ts):.4f} ms/output frame (windows "
                f"{', '.join(f'{t:.4f}' for t in ts)}) | {card}")
        prof = {}
        for arm in ("sequential", "fast K=16", "fast K=14"):
            pc.POOL_FAST, pc.POOL_FAST_BATCH = arms[arm]
            c, _, call = timed["bob1080"]
            prof[arm] = profile_call(call, min(e2e[f"bob1080/{arm}"]) * c.num_frames,
                                     f"bob1080 {arm}", card, tag="17 pool fast profile")
    finally:
        pc.POOL_FAST, pc.POOL_FAST_BATCH = defaults
    details["pool_fast"] = {"launches": launches, "kernels": per, "e2e_ms_per_frame": e2e,
                            "waves": {k: -(-9 * k // (per_sm * sms)) for k in (16, 14)},
                            "blocks_per_sm": per_sm,
                            "profile": {k: {kk: vv for kk, vv in v.items() if kk != "all"}
                                        for k, v in prof.items()}}
    return per


def multihost_worker(rank: int, world: int, port: int, space: int,
                     device: str = "cuda:0") -> None:
    """One process of phase 18 (``chip_smoke.py --multihost-worker``): its
    half of phase 4's 120 dh fields on ``device`` through
    ``sangnom2_multihost`` over a gloo group; prints each output plane's
    SHA-256 and the collectives the call ran."""
    from sangnom_tpu_torch import Clip, get_format
    from sangnom_tpu_torch.parallel import multihost as mh

    mh.initialize_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=300)
    dh_planes, _ = main_path_inputs()
    lo, hi = rank * B // world, (rank + 1) * B // world
    clip = Clip.from_numpy([p[lo:hi] for p in dh_planes], get_format(FMT), device=device)
    del dh_planes
    mesh = mh.multihost_mesh(space=space, local_devices=[device] * space)
    c0 = mh.COLLECTIVES
    out = mh.sangnom2_multihost(clip, mesh, order=1, dh=True,
                                space_axis="space" if space > 1 else None)
    shas = [hashlib.sha256(p.cpu().numpy().tobytes()).hexdigest() for p in out.planes]
    print(f"MH {rank} {lo} {hi} {mh.COLLECTIVES - c0} {' '.join(shas)}", flush=True)
    mh.dist.destroy_process_group()


def phase_multihost(out_dh, card, details):
    """Phase 18: two processes with gloo, each filtering its half of phase
    4's 120 dh fields on cuda:0 through ``sangnom2_multihost``, with
    ``space`` 1 (K1) and 2 (K4, a 1x2 row on the one card); their joined
    outputs must equal phase 4's ``out_dh``, with one collective a call."""
    import socket

    res = {}
    for space in (1, 2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--multihost-worker", str(r), "2", str(port), str(space),
                                   "cuda:0" if DEVICE == "cuda" else DEVICE],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for r, (p, (so, se)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"multihost worker {r} (space {space}) exited "
                                     f"{p.returncode}:\n{so[-2000:]}\n{se[-4000:]}")
            line = next(ln for ln in so.splitlines() if ln.startswith("MH "))
            _, rank, lo, hi, coll, *shas = line.split()
            lo, hi = int(lo), int(hi)
            want = [hashlib.sha256(p[lo:hi].cpu().numpy().tobytes()).hexdigest()
                    for p in out_dh.planes]
            if shas != want:
                raise AssertionError(f"multihost space {space} process {rank}: fields "
                                     f"{lo}-{hi} != phase 4's dh output")
            if coll != "1":
                raise AssertionError(f"multihost space {space} process {rank}: {coll} "
                                     f"collectives in the call")
        res[space] = wall
        log(f"[18 multihost] space {space}: 2 gloo processes on one card, fields "
            f"0-{B // 2 - 1} and {B // 2}-{B - 1}, joined output equal to phase 4's dh "
            f"output, 1 collective a call in each; {wall:.2f} s wall (2 process starts "
            f"included) | {card}")
    details["multihost_s"] = res


def cross_expected(clip, dh: bool, n: int, smooth: str, chunk_rows=None):
    """(launches, halo exchanges, PEER_BYTES) of one u8 call through the
    route across ``n`` slots (parallel.cross_device), per plane pass (luma,
    fused U+V): K4 ceil((bufH-1) / R) one-shard launches a slot and a carry
    exchange between chunks; the K5 route a prepare, as many K5 chunks and a
    finalize a slot; the scan a row exchange a row.  Each exchange moves
    2(n-1) halos; the scatter and the gather move slots 1..n-1's own
    columns, the gather the woven rows (K4, K5) or the interpolated ones."""
    from sangnom_tpu_torch.parallel import cross_device as cd
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    launches = {k: 0 for k in sk.LAUNCHES}
    exch = {"kept": 0, "carry": 0, "row": 0}
    peer = {k: 0 for k in cd.PEER_BYTES}
    for k, (bufH, W) in enumerate(_plane_passes(clip, dh, n)):
        N = clip.num_frames * (2 if k else 1)  # U and V in one pass
        steps = bufH - 1
        exch["kept"] += 1
        peer["scatter"] += (n - 1) * N * bufH * W
        if smooth == "scan":
            exch["row"] += steps
            peer["kept"] += 2 * (n - 1) * 3 * N * bufH
            peer["row"] += steps * 2 * (n - 1) * 3 * 9 * N * 4
            peer["gather"] += (n - 1) * N * steps * W
            continue
        R, halo = (cd.k4_geometry if smooth == "fused" else cd.k5_geometry)(W, steps, chunk_rows)
        chunks = -(-steps // R)
        if smooth == "fused":
            launches["full"] += n * chunks
        else:
            launches["smooth"] += n * chunks
            launches["prepare"] += n
            launches["finalize"] += n
        exch["carry"] += chunks - 1
        peer["kept"] += 2 * (n - 1) * halo * N * bufH
        peer["carry"] += (chunks - 1) * 2 * (n - 1) * halo * 9 * N * 4
        peer["gather"] += (n - 1) * N * 2 * bufH * W
    return launches, exch, peer


SLOT_SWEEP = (4, 16, 32, 64)  # chunk_rows of phase 19's sweep


def phase_cross_device(clip_dh, woven, out_dh, out_bob, card, details):
    """Phase 19: the route across devices (``parallel.cross_device``) with
    four slots that all name the card, on phase 4's 1080 dh call and woven
    bob: K4 and the K5 route, each output bit-equal to phase 4's, launches,
    halo exchanges and PEER_BYTES equal to their formulas; the scan arm on
    4-frame prefixes; each call timed at R in SLOT_SWEEP in turns with the
    one-device cluster route; the 1080 dh luma and U+V passes against their
    plain steps.  With two cards or more, sangnom2_sharded on real meshes
    of them too.  Returns {"launches": {arm: counts}, "pass": {arm: ms}}."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.parallel import cross_device as cd
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.parallel import width_sharded as ws
    from sangnom_tpu_torch.parallel.sharding import _sharded_pad_width

    n = 4
    slots = [DEVICE] * n
    calls = {"dh": (clip_dh, dict(order=1, dh=True), out_dh),
             "bob": (woven, dict(order=0), out_bob)}

    def same(outs, what, prefix=None):
        for name, (_, _, ref) in calls.items():
            for i, (g, r) in enumerate(zip(outs[name].planes, ref.planes)):
                r = r if prefix is None else r[:prefix]
                if not torch.equal(g, r):
                    raise AssertionError(f"{what} {name} plane {i} != phase 4, max_abs "
                                         f"{max_abs(g, r)}")

    res: dict = {"launches": {}, "pass": {}}
    for arm, smooth in (("K4", "fused"), ("K5", "chunked")):
        torch.cuda.synchronize()
        sk.reset_launches()
        ws.reset_exchanges()
        cd.reset_peer_bytes()
        outs = {name: cd.sangnom2_across(c, slots, smooth=smooth, **kw)
                for name, (c, kw, _) in calls.items()}
        torch.cuda.synchronize()
        got = (dict(sk.LAUNCHES), dict(ws.HALO_EXCHANGES), dict(cd.PEER_BYTES))
        want = [{k: 0 for k in d} for d in got]
        for c, kw, _ in calls.values():
            for total, part in zip(want, cross_expected(c, kw.get("dh", False), n, smooth)):
                for k, v in part.items():
                    total[k] += v
        if list(got) != want:
            raise AssertionError(f"{arm} across {n} slots: (launches, exchanges, peer "
                                 f"bytes) {got}, formula {want}")
        same(outs, f"{arm} across {n} slots")
        del outs
        res["launches"][arm] = got[0]
        details[f"cross_{arm}_1x{n}"] = {"launches": got[0], "exchanges": got[1],
                                         "peer_bytes": got[2]}
        R = sk.SLOT_ROWS if arm == "K4" else sk.SLOT_ROWS_K5
        log(f"[19 cross-device] {arm} through {n} slots of {DEVICE} (default R {R}): dh "
            f"and bob bit-equal to phase 4; launches {got[0]}, halo "
            f"exchanges {got[1]}, PEER_BYTES {got[2]} ({sum(got[2].values()) / 2e6:.1f} "
            "MB a call), each equal to its formula")
    ws.reset_exchanges()
    cd.reset_peer_bytes()
    outs = {name: cd.sangnom2_across(c[0:4], slots, smooth="scan", **kw)
            for name, (c, kw, _) in calls.items()}
    torch.cuda.synchronize()
    same(outs, "scan across slots", prefix=4)
    want = [{k: 0 for k in d} for d in (ws.HALO_EXCHANGES, cd.PEER_BYTES)]
    for c, kw, _ in calls.values():
        for total, part in zip(want, cross_expected(c[0:4], kw.get("dh", False), n,
                                                    "scan")[1:]):
            for k, v in part.items():
                total[k] += v
    if [dict(ws.HALO_EXCHANGES), dict(cd.PEER_BYTES)] != want:
        raise AssertionError(f"scan across slots: {ws.HALO_EXCHANGES} {cd.PEER_BYTES}, "
                             f"formula {want}")
    log(f"[19 cross-device] scan arm through {n} slots, 4-frame prefixes of dh and bob: "
        f"bit-equal to phase 4; exchanges {dict(ws.HALO_EXCHANGES)}, PEER_BYTES "
        f"{dict(cd.PEER_BYTES)}")
    del outs

    # each call at R in SLOT_SWEEP, in turns with the one-device cluster route
    mesh = default_mesh(1, n, devices=slots)
    arms: dict = {}
    for arm, smooth in (("K4", "fused"), ("K5", "chunked")):
        arms[f"{arm}/cluster"] = (smooth, None)
        for R in SLOT_SWEEP:
            arms[f"{arm}/slots/R{R}"] = (smooth, R)
    sweep: dict = {}
    for wl, (c, kw, _) in calls.items():
        fns = {}
        for key, (smooth, R) in arms.items():
            if R is None:
                fns[key] = lambda c=c, kw=kw, s=smooth: sangnom2_sharded(
                    c, mesh, space_axis="space", smooth=s, **kw)
            else:
                fns[key] = lambda c=c, kw=kw, s=smooth, R=R: cd.sangnom2_across(
                    c, slots, chunk_rows=R, smooth=s, **kw)
        for f in fns.values():
            f()  # warm-up
        for rnd in (list(arms), list(arms)[::-1]):
            for key in rnd:
                sweep.setdefault(f"{wl}/{key}", []).append(cuda_ms(fns[key], 2))
        torch.cuda.empty_cache()
    for key, ts in sweep.items():
        log(f"[19 cross-device timing] {key}: {min(ts):.3f} ms/call (windows "
            f"{', '.join(f'{t:.3f}' for t in ts)}) | {card}")
    details["cross_sweep_ms"] = sweep
    for arm in ("K4", "K5"):
        best = {R: min(sweep[f"dh/{arm}/slots/R{R}"]) + min(sweep[f"bob/{arm}/slots/R{R}"])
                for R in SLOT_SWEEP}
        log(f"[19 cross-device timing] {arm} through slots, dh + bob ms by R: "
            f"{ {R: round(t, 3) for R, t in best.items()} }; fastest R {min(best, key=best.get)} "
            f"(default {sk.SLOT_ROWS if arm == 'K4' else sk.SLOT_ROWS_K5}) | {card}")

    # the 1080 dh passes alone: the route against its plain steps
    fmt = clip_dh.format
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    luma = clip_dh.planes[0].contiguous()
    S = luma.shape[2]
    _, hc, wc = clip_dh.planes[1].shape
    Sc = _sharded_pad_width(wc, hc, S, n, fmt, True)
    uv = torch.cat([clip_dh.planes[1], clip_dh.planes[2]])
    uv = torch.cat([uv, uv[..., -1:].expand(-1, -1, Sc - wc)], dim=2).contiguous()
    passes = {"luma": (luma, aaf_as_pixel(aafs[0], fmt), S),
              "U+V": (uv, aaf_as_pixel(aafs[1], fmt), wc)}
    for arm, route in (("K4", cd.fused_pass), ("K5", cd.chunked_pass)):
        for name, (kept, aaf, w) in passes.items():
            Nk, bH, Sk = kept.shape
            m = _timed(lambda: route(kept, 0, aaf, spec, slots, w),
                            lambda: route(kept, 0, aaf, spec, slots, w, plain=True), 3)
            m["bound_ms"], m["bound_by"] = bound(*k4_work(Nk, bH, Sk))
            res["pass"][f"{arm}/{name}"] = m
            log(f"[19 cross-device timing] {arm} through {n} slots per {name} pass ({Nk} "
                f"fields x {bH} rows x {Sk}, default R): {m['ms']:.4f} ms, plain "
                f"steps {m['plain_ms']:.3f} ms, bound {m['bound_ms']:.4f} ms "
                f"({m['bound_by']}), max_abs_err {m['max_abs_err']} | {card}")
    del luma, uv
    torch.cuda.empty_cache()
    details["cross_pass_ms"] = res["pass"]

    # real meshes of several cards
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[19 cross-device] cross-device peer copies not run: {count} device")
        return res
    for space in (2, 4):
        if space > count:
            break
        peers = [torch.cuda.can_device_access_peer(0, i) for i in range(1, space)]
        cd.reset_peer_bytes()
        t0 = time.perf_counter()
        outs = {name: sangnom2_sharded(c, default_mesh(1, space), space_axis="space", **kw)
                for name, (c, kw, _) in calls.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same(outs, f"a 1x{space} mesh of {space} cards")
        del outs
        log(f"[19 cross-device] default_mesh(1, {space}) over {space} cards (peer access "
            f"from cuda:0 {peers}): dh and bob bit-equal to phase 4; PEER_BYTES "
            f"{dict(cd.PEER_BYTES)}; {wall:.3f} s wall for both calls | {card}")
    return res


# phase 20's slice of the campaigns: (name, mode flag or None for the fixed
# set, cases, seed); the generators draw in order, so these are the first
# lines of results/tpu_campaign_*_r05.txt and the whole fixed set
CAMPAIGN_SLICE = (("fixed", None, 12, None), ("random", "--random", 8, 551),
                  ("compat", "--compat", 6, 552), ("sharded", "--sharded", 4, 553),
                  ("bob", "--bob", 4, 554))
# the kernels each mode must launch: (counter, key or None for deint's int)
CAMPAIGN_KERNELS = {"oracle": (("deint", None),),
                    "compat": (("deint", None), ("pool", "prepare"), ("pool", "split3"),
                               ("pool", "finalize")),
                    "bob": (("deint", None),),
                    "sharded": (("shard", "full"), ("shard", "smooth"))}


def phase_campaign(card, details):
    """Phase 20: the parity campaign (``tools.parity_campaign.run_cases``)
    at API level on the card: the fixed 12-case set (4K, width 1919, alpha
    with dh, 4:1:1, float) and the first cases of the recorded seeds,
    random (oracle), compat (opt=1 against opt=0 and the oracle, the
    POOL_FAST arm), sharded (1x1 and 1x4 meshes, two slots across devices)
    and bob.  Raises on any failure.  Each mode's counts are set to 0 just
    before it and read just after; each must launch its kernels."""
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.tools import parity_campaign as pc

    res = {}
    for name, flag, n, seed in CAMPAIGN_SLICE:
        if flag is None:
            cases, mode = pc.CASES[:n], "oracle"
        else:
            gen, mode, _ = pc.MODES[flag]
            cases = gen(n, seed)
        stats: dict = {}
        torch.cuda.synchronize()
        dk.LAUNCHES = 0
        pk.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        fails = pc.run_cases(cases, mode, DEVICE, stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"deint": dk.LAUNCHES, "pool": dict(pk.LAUNCHES), "shard": dict(sk.LAUNCHES)}
        if fails:
            raise AssertionError(f"campaign {name}: {fails} failures")
        for counter, key in CAMPAIGN_KERNELS[mode]:
            got = counts[counter] if key is None else counts[counter][key]
            if DEVICE == "cuda" and got == 0:
                raise AssertionError(f"campaign {name}: no {counter} {key or ''} launch")
        fast = (f"; POOL_FAST took the fast route in {stats.get('fast', 0)} of "
                f"{stats.get('pool', 0)} pool_compat cases" if mode == "compat" else "")
        log(f"[20 campaign] {name} ({len(cases)} cases{f', seed {seed}' if seed else ''}): "
            f"0 failures in {wall:.1f} s; launches {counts}{fast} | {card}")
        res[name] = {"cases": len(cases), "wall_s": wall, "launches": counts, **stats}
    details["campaign"] = res
    return res


def phase_stream_tools(card, details):
    """Phase 21: the streaming tools on the card.  ``stream_soak 240 32``:
    240 frames of 640x480 through the CLI whole and with ``--window 32`` in
    child processes, byte-identical, with both peak RSS values; then
    ``stream_attr`` at 1920x1080, 48 frames, window 24 in process (the
    deint counts set to 0 just before and read just after), its JSON."""
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.tools import stream_attr, stream_soak

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = stream_soak.main(["240", "32", "plain", "640x480", "--device", DEVICE])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines or not lines[-1].startswith("byte-identical: True"):
        raise AssertionError(f"stream_soak 240 32 exited {rc}:\n{buf.getvalue()[-2000:]}")
    rss = {ln.split(":")[0]: int(ln.split("PEAK_RSS_MB=")[1].split()[0])
           for ln in lines if "PEAK_RSS_MB=" in ln}
    log(f"[21 stream tools] stream_soak 240 32 (640x480 --order 1): whole and "
        f"--window 32 byte-identical, peak RSS {rss} MB, {wall:.1f} s | {' / '.join(lines)} "
        f"| {card}")
    torch.cuda.synchronize()
    dk.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        attr = stream_attr.main(["48", "1920x1080", "24", "--device", DEVICE])
    torch.cuda.synchronize()
    if DEVICE == "cuda" and dk.LAUNCHES == 0:
        raise AssertionError("stream_attr launched no deint kernel")
    log(f"[21 stream tools] stream_attr 48 1920x1080 24: {json.dumps(attr)} "
        f"({dk.LAUNCHES} deint launches, {time.perf_counter() - t0:.1f} s) | {card}")
    details["stream_tools"] = {"soak_rss_mb": rss, "soak_s": wall, "attr": attr}


def phase_bench(card, details):
    """Phase 22: ``python -m sangnom_tpu_torch.bench`` in a fresh process.
    Raises unless it exits 0 with a JSON last line whose bob and dh rates
    are positive, whose five configs all read parity "ok", whose two
    pool_compat rates are present and which carries a regression object."""
    wall, out, err = _subprocess([sys.executable, "-m", "sangnom_tpu_torch.bench"],
                                 "the bench", timeout=900)
    res = json.loads(out.strip().splitlines()[-1])
    cfgs = res.get("configs") or {}
    problems = [k for k in ("value", "order1_dh_fps") if not res.get(k, 0) > 0]
    problems += [f"configs.{n}" for n, c in cfgs.items() if c.get("parity") != "ok"]
    if len(cfgs) != 5:
        problems.append(f"{len(cfgs)} configs")
    problems += [k for k in ("pool_compat_fps", "pool_compat_carried_fps") if res.get(k) is None]
    if not isinstance(res.get("regression"), dict):
        problems.append("regression")
    if problems:
        raise AssertionError(f"the bench: {problems}\n{out[-2000:]}\n{err[-4000:]}")
    for line in err.strip().splitlines():
        log(f"[22 bench stderr] {line}")
    cfg_fps = ", ".join(f"{n.split('_')[0]} {c['fps']}" for n, c in cfgs.items())
    log(f"[22 bench] {res['metric']} {res['value']} frames/s (bob, windows "
        f"{res['trials_ms']} ms), order1_dh_fps {res['order1_dh_fps']} (windows "
        f"{res['order1_trials_ms']} ms), pool_compat {res['pool_compat_fps']} / carried "
        f"{res['pool_compat_carried_fps']}, configs {cfg_fps} (all parity ok); "
        f"vs_baseline {res['vs_baseline']} over SSE2 {res['baseline_sse2_fps']} fps "
        f"[{res['baseline_provenance']}]; regression ok {res['regression']['ok']}; "
        f"build_s {res['build_s']}; {wall:.1f} s wall | {res['device']['name']}, "
        f"{res['device']['power_limit']} | {card}")
    details["bench"] = res
    return res


# --- phase 23: planes wider than one block ------------------------------------

# phase 23's calls: (format, width, height, frames, mode, filter kw) through
# the main path; (format, width, height, frames, POOL_FAST) through
# pool_compat; (width, height) of the 1x2 sharded call and of the call across
# four slots
WIDE_MAIN = (
    ("YUV420P8", 15360, 8640, 2, "bob", {}),
    ("GRAY8", 8448, 64, 4, "single", dict(order=1)),
    ("GRAY8", 8448, 64, 4, "single", dict(order=2)),
    ("GRAY16", 10240, 256, 4, "dh", dict(order=1, dh=True)),
    ("YUV444PS", 8448, 128, 2, "single", dict(order=2)),
    ("GRAY8", 65600, 32, 2, "single", dict(order=1)),  # past 8 blocks: the chunk route
)
WIDE_POOL = (("YUV420P8", 8448, 540, 4, False), ("YUV420P8", 8448, 540, 4, True),
             ("GRAY8", 12288, 270, 3, False))
WIDE_SHARDED = (20480, 64)
WIDE_ACROSS = (40960, 32)


def _wide_clip(fname, w, h, n, seed, **kw):
    from sangnom_tpu_torch import Clip, get_format

    fmt = get_format(fname)
    rng = np.random.default_rng(seed)
    planes = [_rand_plane(rng, (n,) + fmt.plane_dims(w, h, i)[::-1], fmt)
              for i in range(min(fmt.num_planes, 3))]
    return Clip.from_numpy(planes, fmt, device=DEVICE, **kw)


def wide_passes(clip, mode: str):
    """(name, fields, kept rows, width) of each plane pass of a call on
    ``clip``: luma, then U and V in one batch (``mode``: "bob", "dh" or
    "single")."""
    n = clip.num_frames * (2 if mode == "bob" else 1)
    planes = [("luma", clip.planes[0], n)]
    if len(clip.planes) >= 3:
        planes.append(("U+V", clip.planes[1], 2 * n))
    return [(name, fields, p.shape[1] if mode == "dh" else p.shape[1] // 2, p.shape[2])
            for name, p, fields in planes]


def _k4_scratch(fp, n_fields: int, elem: int) -> int:
    """Device bytes the wide route's K4 launch allocates beside its output:
    the global route's rows and raw slices, the chunk route's carried rows."""
    plan, k = fp.plan, fp.k
    nbytes = 0
    if plan.route == "global":
        nbytes += n_fields * k * 9 * (plan.pitch_b * 4 + plan.pitch_p * elem)
    if not plan.cluster:
        nbytes += 2 * n_fields * 9 * fp.width * 4
    return nbytes


def wide_expected(clip, mode: str, stride: int, spec) -> tuple:
    """(launches {"deint", "full"} on the routes' formulas, route text,
    (bytes, ops) of the call) for the filter on ``clip``: a pass past one
    block is K4 over its plan's k blocks (one launch on the cluster route,
    a launch a chunk of R rows on the chunk route), the others K1."""
    from sangnom_tpu_torch.core.geometry import width_tiers
    from sangnom_tpu_torch.ops import deint_kernel as dk

    want = {"deint": 0, "full": 0}
    text, nbytes, ops = [], 0, 0
    elem = clip.planes[0].element_size()
    for name, n_fields, bufH, w in wide_passes(clip, mode):
        fp = dk._card_plan(w, bufH, stride, spec, torch.device(DEVICE))
        S = width_tiers(w, bufH, stride, spec)[2]
        b_, o_ = deint_work(n_fields, bufH, w, S, elem)
        nbytes, ops = nbytes + b_, ops + o_
        if fp.k == 1:
            want["deint"] += 1
            text.append(f"{name} {w}x{bufH} (S {S}): K1, {fp.plan.route}")
            continue
        want["full"] += fp.plan.launches
        route = "cluster" if fp.plan.cluster else f"chunk, {fp.plan.launches} launches"
        text.append(f"{name} {w}x{bufH} (S {S}): K4 k={fp.k} x {fp.W_loc} columns "
                    f"(padded {fp.width}), {route}, {fp.plan.route}, "
                    f"{fp.plan.smem_bytes} B shared, scratch {_k4_scratch(fp, n_fields, elem)} B")
    return want, "; ".join(text), (nbytes, ops)


def _colrows(clip, mode: str) -> int:
    """Interpolated pixels of a call: fields x (kept rows - 1) x width."""
    return sum(n * (bufH - 1) * w for _, n, bufH, w in wide_passes(clip, mode))


def _counts(dk, pk, sk) -> dict:
    return {"deint": dk.LAUNCHES, **{f"pool {k}": v for k, v in pk.LAUNCHES.items()},
            **{f"shard {k}": v for k, v in sk.LAUNCHES.items()}}


def _reset(dk, pk, sk, ws=None):
    dk.LAUNCHES = 0
    pk.reset_launches()
    sk.reset_launches()
    if ws is not None:
        ws.reset_exchanges()


# K4's (k, R) sweep (`wide_k_sweep`), on the cluster route: the maa pass's
# 24 luma fields of 3840 columns, whose readings set deint_kernel.wide_plan's
# rule (WIDE_BLOCK, WIDE_ROWS), and the 15360 bob's luma pass
WIDE_SWEEP_3840 = [(k, r) for k in (2, 3, 4) for r in (2, 4, 8)] + [(4, 16), (8, 4), (8, 8)]
WIDE_SWEEP_BOB = [(2, 4), (4, 4), (8, 2), (8, 4), (8, 8), (8, 16)]


def wide_k_sweep(name: str, fields, spec, pairs, card: str) -> dict:
    """K4's woven pass (``shard_kernel.full_pass``, offset 0, the cluster
    route) over ``fields`` [N, bufH, S] at each (k, R) of ``pairs`` whose
    cluster the card schedules, in turns (ascending, then descending),
    outputs equal across (k, R): ms a pass (3 passes a window, best of 2),
    each plan's build, registers and spill bytes; and the (k, R) that
    ``deint_kernel.wide_plan`` takes for the shape."""
    from sangnom_tpu_torch.core.formats import get_format
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    dev = torch.device(DEVICE)
    N, bufH, S = fields.shape
    fmt = get_format("GRAY8")  # the passes are 8-bit
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    limit = dk._max_smem_bytes(dk._load(), dev)
    cases = []
    for k, r in pairs:
        if S % k:
            continue
        plan = sk.full_plan(k, S // k, bufH, fields.element_size(), limit, r)
        occ = sk.occupancy("full", spec, plan, k, dev)
        if occ["clusters"] > 0:
            cases.append(((k, r), plan, occ))

    def run(k, r):
        return sk.full_pass(fields, 0, aaf, spec, k, S, r)

    ref = run(*cases[0][0])
    times = {kr: [] for kr, _, _ in cases}
    for order in (cases, cases[::-1]):
        for (k, r), _, _ in order:
            got = run(k, r)
            if not torch.equal(got, ref):
                raise AssertionError(f"[23 wide] {name} at k={k} R={r} != "
                                     f"k={cases[0][0][0]} R={cases[0][0][1]}")
            del got
            times[k, r].append(cuda_ms(lambda k=k, r=r: run(k, r), 3))
    del ref
    fp = dk._card_plan(S, bufH, S, spec, dev)
    out = {f"k{k} R{r}": {"ms": min(times[k, r]), "windows": times[k, r], "cols": plan.cols,
                          "threads": plan.threads, "route": plan.route, **occ}
           for (k, r), plan, occ in cases}
    out["plan"] = {"k": fp.k, "R": fp.plan.R, "cluster": fp.plan.cluster}
    log(f"[23 wide] {name} ({N}x{bufH}x{S}) through K4 in turns, outputs equal: " + "; ".join(
        f"{kr} ({v['cols']} columns x {v['threads']} threads, {v['route']}, "
        f"{v['registers']} registers, {v['spill_bytes']} spill bytes) {v['ms']:.3f} ms "
        f"({v['ms'] / (bufH - 1) * 1e3:.3f} us a row step)"
        for kr, v in out.items() if kr != "plan")
        + f" | wide_plan: k={fp.k} R={fp.plan.R} | {card}")
    torch.cuda.empty_cache()
    return out


def phase_wide(card: str, bob_ms: float, details) -> dict:
    """Phase 23: planes wider than one block (more than 8192 smoothed
    columns) through the public calls: the 15360x8640 4:2:0 bob, single-rate
    and dh calls at 8448-65600 columns (65600: the chunk route past 8
    blocks), pool_compat at 8448 (the K7 route and POOL_FAST) and 12288,
    ``sangnom2_sharded`` on a 1x2 mesh of the card at 20480 and the route
    across devices with four slots of the card at 40960.  Each call's
    output bit-equal to opt=0, its launches on their formulas, its route,
    its ms a call (CUDA events, best of 2) against its bound and the 1080
    bob's ns a column-row; each count set to 0 just before a call and read
    just after."""
    from sangnom_tpu_torch import bob, get_format, sangnom2
    from sangnom_tpu_torch.core.fields import _split_plane
    from sangnom_tpu_torch.core.geometry import (
        aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds, width_tiers)
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.parallel import cross_device as cd
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.parallel import width_sharded as ws
    from sangnom_tpu_torch.parallel.sharding import _sharded_pad_width, _sub_split

    t_phase = time.perf_counter()
    bob_colrows = N_IN * 2 * (539 * 1920 + 2 * 269 * 960)
    bob_ns = bob_ms * 1e6 / bob_colrows
    res, total = {}, {}

    def equal(name, got, want):
        for i, (g, r) in enumerate(zip(got, want)):
            if g.shape != r.shape or not torch.equal(g, r):
                raise AssertionError(f"[23 wide] {name} plane {i} != opt=0, max_abs "
                                     f"{max_abs(g, r) if g.shape == r.shape else 'shape'}")

    def drive(name, call, want_counts, plain_planes, route, work, colrows):
        torch.cuda.synchronize()
        _reset(dk, pk, sk, ws)
        out = call()
        torch.cuda.synchronize()
        got = {k: v for k, v in _counts(dk, pk, sk).items() if v}
        check_launches(f"[23 wide] {name}", got, {k: v for k, v in want_counts.items() if v})
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        equal(name, out.planes, plain_planes() if callable(plain_planes) else plain_planes)
        del out
        ms = min(cuda_ms(call, 1) for _ in range(2))
        b_ms, b_by = bound(*work)
        ns = ms * 1e6 / colrows
        log(f"[23 wide] {name}: bit-equal to opt=0; launches {got} on their formula; "
            f"{ms:.3f} ms a call (best of 2), bound {b_ms:.4f} ms ({b_by}), "
            f"{ns:.4f} ns a column-row against the 1080 bob's {bob_ns:.4f} | route: "
            f"{route} | {card}")
        res[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "launches": got,
                     "ns_colrow": ns, "route": route}
        torch.cuda.empty_cache()

    # the main-path calls: the bob, single-rate and dh, K4 past one block
    k4_pass = None
    for seed, (fname, w, h, n, mode, kw) in enumerate(WIDE_MAIN, 230):
        name = f"{'bob ' if mode == 'bob' else ''}{fname} {w}x{h} x{n} {kw or ''}"
        clip = _wide_clip(fname, w, h, n, seed, tff=True)
        spec = KernelSpec.from_format(clip.format)
        stride = buffer_stride_elems(w, clip.format.component_size)
        want, route, work = wide_expected(clip, mode, stride, spec)
        if mode == "bob":
            call = lambda c=clip: bob(c)  # noqa: E731

            def plain(c=clip):  # one input frame at a time bounds the plain path's memory
                outs = [bob(c[j:j + 1], opt=0).planes for j in range(c.num_frames)]
                return [torch.cat([o[i] for o in outs]) for i in range(3)]
        else:
            call = lambda c=clip, kw=kw: sangnom2(c, **kw)  # noqa: E731
            plain = lambda c=clip, kw=kw: sangnom2(c, opt=0, **kw).planes  # noqa: E731
        drive(name, call, {"deint": want["deint"], "shard full": want["full"]}, plain,
              route, work, _colrows(clip, mode))
        if fname == "GRAY16":
            k4_pass = (clip.planes[0], spec, stride, clip.format)
        if mode == "bob":
            luma = _split_plane(clip.planes[0], True).contiguous()
            res["bob luma k sweep"] = wide_k_sweep("bob luma pass", luma, spec,
                                                   WIDE_SWEEP_BOB, card)
            del luma
        del clip
    g = torch.Generator(device=DEVICE).manual_seed(3840)
    maa = torch.randint(0, 256, (24, 1080, 3840), generator=g, device=DEVICE,
                        dtype=torch.int32).to(torch.uint8)
    res["maa luma k sweep"] = wide_k_sweep("maa luma pass", maa, KernelSpec.from_format(
        get_format("GRAY8")), WIDE_SWEEP_3840, card)
    del maa

    # the K4 pass of the dh case alone, against its plain twin (not counted)
    kept, spec, stride, fmt = k4_pass
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    k4 = _timed(lambda: dk.deinterlace_field_batch_fused(kept, 0, aaf, spec, stride),
                lambda: dk.deinterlace_field_batch_plain(kept, 0, aaf, spec, stride), 2)
    N, bufH, w = kept.shape
    k4["bound_ms"], k4["bound_by"] = bound(*deint_work(N, bufH, w,
                                                       width_tiers(w, bufH, stride, spec)[2], 2))
    log(f"[23 wide] K4 wide pass GRAY16 {N}x{bufH}x{w} alone: {k4['ms']:.3f} ms, plain "
        f"{k4['plain_ms']:.3f} ms, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), "
        f"max_abs_err {k4['max_abs_err']} | {card}")
    del kept, k4_pass

    # pool_compat: the K7 route (its walk split over a cluster) and POOL_FAST
    walk = None
    defaults = pc.POOL_FAST, pc.POOL_FAST_BATCH
    try:
        for fname, w, h, n, fast in WIDE_POOL:
            name = f"pool_compat {fname} {w}x{h} x{n} order=1{' POOL_FAST' if fast else ''}"
            clip = _wide_clip(fname, w, h, n, w + h + n)
            spec = KernelSpec.from_format(clip.format)
            stride = buffer_stride_elems(w, clip.format.component_size)
            P = h // 2
            plan = pk.card_walk_plan(spec, stride, P - 1, torch.device(DEVICE))
            planes = min(clip.format.num_planes, 3)
            passes = planes * (1 if fast else n)
            want = {"pool prepare": passes, "pool split3": passes * plan.launches,
                    "pool finalize": passes}
            route = (f"walk k={plan.k} x {plan.W_loc} columns, H {plan.H}, R {plan.R}, "
                     f"{'cluster' if plan.cluster else 'chunk'}, {plan.cols} columns x "
                     f"{plan.threads} threads, {plan.smem_bytes} B shared, scratch "
                     f"{0 if plan.cluster else 9 * (P - 1) * stride * 4} B")
            work = [0, 0]
            for i in range(planes):
                pw, ph = clip.format.plane_dims(w, h, i)
                b_, o_ = pool_fused_work(P, stride, ph // 2, pw)
                work = [work[0] + n * b_, work[1] + n * o_]
            pc.POOL_FAST, pc.POOL_FAST_BATCH = fast, 16
            want_planes = sangnom2(clip, order=1, pool_compat=True, opt=0).planes
            drive(name, lambda c=clip: sangnom2(c, order=1, pool_compat=True), want,
                  want_planes, route, work, _colrows(clip, "single"))
            if walk is None:
                from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream

                _, pool = sangnom2_pool_stream(clip, None, order=1)  # a stale pool
                walk = (pool, spec)
            del clip, want_planes
    finally:
        pc.POOL_FAST, pc.POOL_FAST_BATCH = defaults

    # the wide walk alone on the luma pass's pool, against its plain twin
    pool, spec = walk
    P, S = pool.shape[1] - 1, pool.shape[2]
    row0, body, tail = (x.contiguous() for x in (pool[:, 0], pool[:, 1:P], pool[:, P]))
    pw = _timed(lambda: pk.smooth_split3_(row0, body.clone(), tail, spec),
                lambda: pk.smooth_split3_plain_(row0, body.clone(), tail, spec), 5)
    pw["bound_ms"], pw["bound_by"] = bound(*pool_smooth_work(P, S))
    occ = pk.walk_clusters(spec, S, P - 1, DEVICE)
    log(f"[23 wide] pool wide walk alone, [9, {P + 1}, {S}]: {pw['ms']:.3f} ms "
        f"({pw['ms'] / (P - 1) * 1e3:.3f} us a row step), plain {pw['plain_ms']:.3f} ms, "
        f"bound {pw['bound_ms']:.4f} ms ({pw['bound_by']}), max_abs_err "
        f"{pw['max_abs_err']}; build {occ} | {card}")
    del pool, walk, row0, body, tail

    # sharded past one block: a 1x2 mesh of the card, then four slots across
    w_sh, h_sh = WIDE_SHARDED
    clip = _wide_clip("YUV420P8", w_sh, h_sh, 2, 2048)
    spec = KernelSpec.from_format(clip.format)
    stride = w_sh
    mesh = default_mesh(1, 2, devices=[DEVICE] * 2)
    rows = [list(mesh.devices[0])]
    k = _sub_split(stride, 2, "fused", rows, False, None)
    n = 2 * k
    passes = wide_passes(clip, "single")
    route, work = [], [0, 0]
    limit = dk._max_smem_bytes(dk._load(), torch.device(DEVICE))
    for pname, nf, bufH, w in passes:
        S_eff = _sharded_pad_width(w, 2 * bufH, stride, n, clip.format, False)
        plan = sk.full_plan(n, S_eff // n, bufH, 1, limit)
        route.append(f"{pname} {S_eff} columns over {n} blocks of {S_eff // n}, "
                     f"{'cluster' if plan.cluster else 'chunk'}, {plan.route}")
        b_, o_ = deint_work(nf, bufH, w, S_eff)
        work = [work[0] + b_, work[1] + o_]
    want_planes = sangnom2(clip, order=1, opt=0).planes
    drive(f"sharded 1x2 YUV420P8 {w_sh}x{h_sh} x2 (K4)",
          lambda: sangnom2_sharded(clip, mesh, space_axis="space", order=1),
          {"shard full": len(passes)}, want_planes,
          f"each shard of {w_sh // 2} split into {k}: " + "; ".join(route), work,
          _colrows(clip, "single"))
    del clip, want_planes

    w_ac, h_ac = WIDE_ACROSS
    clip = _wide_clip("GRAY8", w_ac, h_ac, 2, 4096)
    stride = w_ac
    slots = [DEVICE] * 4
    k = _sub_split(stride, 4, "fused", [slots], True, None)
    n = 4 * k
    _, _, bufH, w = wide_passes(clip, "single")[0]
    R, halo = cd.k4_geometry(w // n, bufH - 1)
    chunks = -(-(bufH - 1) // R)
    want_planes = sangnom2(clip, order=1, opt=0).planes
    drive(f"across 4 slots of the card, GRAY8 {w_ac}x{h_ac} x2",
          lambda: cd.sangnom2_across(clip, slots, order=1),
          {"shard full": n * chunks}, want_planes,
          f"each slot of {w_ac // 4} split into {k}: {n} slots of {w // n} columns, halo "
          f"{halo}, R {R}, {chunks} chunk(s) a slot",
          deint_work(2, bufH, w, w), _colrows(clip, "single"))
    del clip, want_planes
    torch.cuda.empty_cache()

    seconds = time.perf_counter() - t_phase
    log(f"[23 wide] launches on the phase's calls {total}; done in {seconds:.1f} s | {card}")
    out = {"cases": res, "k4": k4, "walk": pw, "walk_build": occ, "launches": total,
           "seconds": seconds}
    details["wide"] = out
    return out


def main_path_inputs():
    """The bench's 1080 inputs, seed 7: 120 dh fields first, then 60
    interlaced frames."""
    rng = np.random.default_rng(7)
    dh_planes = [
        rng.integers(0, 256, (B, 540, 1920)).astype(np.uint8),
        rng.integers(0, 256, (B, 270, 960)).astype(np.uint8),
        rng.integers(0, 256, (B, 270, 960)).astype(np.uint8),
    ]
    bob_planes = [
        rng.integers(0, 256, (N_IN, 1080, 1920)).astype(np.uint8),
        rng.integers(0, 256, (N_IN, 540, 960)).astype(np.uint8),
        rng.integers(0, 256, (N_IN, 540, 960)).astype(np.uint8),
    ]
    return dh_planes, bob_planes


def main() -> int:
    details: dict = {}
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1 device] {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    details["card"] = card

    from sangnom_tpu_torch import Clip, bob, get_format, sangnom2
    from sangnom_tpu_torch.core.fields import double_weave, separate_fields
    from sangnom_tpu_torch.core.geometry import (
        aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds, width_tiers)
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.oracle import sangnom2_frame_oracle

    # 2. build
    t0 = time.perf_counter()
    compile_s = dk.build()
    dk._load()
    log(f"[2 build] kernel library built from {SOURCE}, {POOL_SOURCE}, {SHARD_SOURCE} "
        f"and {PROBE_SOURCE} "
        f"(one nvcc each, in parallel) in {compile_s:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
    details["build_s"] = compile_s

    # 3. kernel vs plain on the card
    t0 = time.perf_counter()
    cases = phase_kernel_matrix(dk, get_format, KernelSpec, details)
    log(f"[3 kernel vs plain] {cases} cases bit-equal on the card "
        f"(u8/u16/10-bit/f32, c/sse2, offsets 0/1/per-frame, interlaced "
        f"none/tff/bff, widths 61/1920/3840 (K4 over 4 blocks)/1023 unpadded/5, "
        f"150 fields) in {time.perf_counter() - t0:.1f} s")

    # 4. main path at full size
    fmt = get_format(FMT)
    dh_planes, bob_planes = main_path_inputs()
    clip_bob = Clip.from_numpy(bob_planes, fmt, device="cuda", tff=True)
    clip_dh = Clip.from_numpy(dh_planes, fmt, device="cuda")
    torch.cuda.synchronize()
    dk.LAUNCHES = 0
    out_bob = bob(clip_bob)
    out_dh = sangnom2(clip_dh, order=1, dh=True)
    torch.cuda.synchronize()
    launches = dk.LAUNCHES
    if launches < 4:  # luma + fused U/V, for each of the two calls
        raise AssertionError(f"main path launched the kernel {launches} times")
    ref_bob = bob(clip_bob, opt=0)
    ref_dh = sangnom2(clip_dh, order=1, dh=True, opt=0)
    for name, got, want, shapes in (
        ("bob", out_bob, ref_bob, [(120, 1080, 1920), (120, 540, 960), (120, 540, 960)]),
        ("dh", out_dh, ref_dh, [(120, 1080, 1920), (120, 540, 960), (120, 540, 960)]),
    ):
        for i, (g, r) in enumerate(zip(got.planes, want.planes)):
            if tuple(g.shape) != shapes[i] or g.dtype != torch.uint8:
                raise AssertionError(f"{name} plane {i}: {tuple(g.shape)} {g.dtype}")
            if not torch.equal(g, r):
                raise AssertionError(f"{name} plane {i}: kernel path != plain path, "
                                     f"max_abs {max_abs(g, r)}")
    del ref_bob, ref_dh
    # the first 2 interlaced frames -> 4 output frames, against the oracle on
    # the woven frames they are defined to equal
    woven = double_weave(separate_fields(clip_bob[0:2]))
    woven_np = woven.to_numpy()
    bob_np = [p[:4].cpu().numpy() for p in out_bob.planes]
    for n in range(4):
        want = sangnom2_frame_oracle([p[n] for p in woven_np], fmt, order=0,
                                     frame_parity=woven.get_parity(n))
        for i in range(3):
            if not np.array_equal(bob_np[i][n], want[i]):
                raise AssertionError(f"bob frame {n} plane {i} != native oracle")
    dh_np = [p[0].cpu().numpy() for p in out_dh.planes]
    want = sangnom2_frame_oracle([p[0] for p in dh_planes], fmt, order=1, dh=True)
    for i in range(3):
        if not np.array_equal(dh_np[i], want[i]):
            raise AssertionError(f"dh frame 0 plane {i} != native oracle")
    log(f"[4 main path] bob 60x1920x1080 YUV420P8 -> 120 frames and sangnom2"
        f"(order=1, dh=True) on 120 fields 1920x540: {launches} kernel launches, "
        f"bit-equal to opt=0 on the card; bob frames 0-3 and dh frame 0 "
        f"bit-equal to the native oracle")
    details["main_path_launches"] = launches

    # 5. timing: kernel (opt=-1 on CUDA) and plain (opt=0), in turns
    calls = {
        ("bob", "kernel"): lambda: bob(clip_bob),
        ("bob", "plain"): lambda: bob(clip_bob, opt=0),
        ("dh", "kernel"): lambda: sangnom2(clip_dh, order=1, dh=True),
        ("dh", "plain"): lambda: sangnom2(clip_dh, order=1, dh=True, opt=0),
    }
    reps = {"kernel": 10, "plain": 2}
    times: dict = {k: [] for k in calls}
    for k, fn in calls.items():
        fn()  # warm-up
    for arm_order in (("plain", "kernel"), ("kernel", "plain")):
        for wl in ("bob", "dh"):
            for arm in arm_order:
                times[(wl, arm)].append(cuda_ms(calls[(wl, arm)], reps[arm]))
    for (wl, arm), ts in times.items():
        best = min(ts)
        log(f"[5 timing] {wl} {arm}: {best:.3f} ms/call -> {120 / best * 1e3:.1f} "
            f"output frames/s (windows {', '.join(f'{t:.3f}' for t in ts)} ms) | {card}")
    details["e2e_ms"] = {f"{wl}/{arm}": ts for (wl, arm), ts in times.items()}

    # the kernel alone at the main path's shapes, and its plain twin
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    stride = buffer_stride_elems(1920, fmt.component_size)
    pf = torch.tensor([0, 1] * N_IN, dtype=torch.int32, device="cuda")
    uv = torch.cat([clip_bob.planes[1], clip_bob.planes[2]])
    launches_bob = [
        (clip_bob.planes[0], pf, aaf_as_pixel(aafs[0], fmt), True),
        (uv, pf.repeat(2), aaf_as_pixel(aafs[1], fmt), True),
    ]
    err = 0.0
    for src, off, aaf, tff in launches_bob:
        got = dk.deinterlace_field_batch_fused(src, off, aaf, spec, stride, tff)
        want = dk.deinterlace_field_batch_plain(src, off, aaf, spec, stride, tff)
        err = max(err, max_abs(got, want))
    del got, want
    if err != 0.0:
        raise AssertionError(f"kernel at main-path shapes: max_abs_err {err}")

    def run(fn):
        return lambda: [fn(s, o, a, spec, stride, t) for s, o, a, t in launches_bob]

    kernel, plain = dk.deinterlace_field_batch_fused, dk.deinterlace_field_batch_plain
    per_launch = [cuda_ms(lambda a=a: kernel(a[0], a[1], a[2], spec, stride, a[3]), 10)
                  for a in launches_bob]
    smem_limit = dk._max_smem_bytes(dk._load(), torch.device(DEVICE))
    plans = [dk.launch_plan(s.shape[2], width_tiers(s.shape[2], s.shape[1] // 2, stride, spec)[2],
                            s.element_size(), smem_limit) for s, _, _, _ in launches_bob]
    steps = [src.shape[1] // 2 - 1 for src, _, _, _ in launches_bob]  # 539, 269
    log(f"[5 timing] deint kernel per bob launch: luma {per_launch[0]:.3f} ms "
        f"({per_launch[0] / steps[0] * 1e3:.3f} us a row step), U/V "
        f"{per_launch[1]:.3f} ms ({per_launch[1] / steps[1] * 1e3:.3f} us a row step) "
        f"| {card}")
    for name, plan in zip(("luma", "U/V"), plans):
        log(f"[5 plan] bob {name} launch: route {plan.route}, {plan.smem_bytes} bytes "
            f"of shared memory, {plan.threads} threads x {plan.cols} columns")
    details["kernel_ms_per_launch"] = per_launch
    details["row_step_us"] = [t / n * 1e3 for t, n in zip(per_launch, steps)]
    details["plans"] = [p._asdict() for p in plans]
    k_ms, p_ms = [], []
    for arm in ("plain", "kernel", "kernel", "plain"):  # in turns
        if arm == "kernel":
            k_ms.append(cuda_ms(run(kernel), reps["kernel"]))
        else:
            p_ms.append(cuda_ms(run(plain), reps["plain"]))
    log(f"[5 timing] deint kernel alone, bob launches (luma 120x540x1920 + U/V "
        f"240x270x960, per-frame offsets, interlaced): {min(k_ms):.3f} ms; plain "
        f"twin {min(p_ms):.3f} ms | {card}")
    details["kernel_ms"] = {"kernel": k_ms, "plain": p_ms}

    # the no-weave mode (not on the main path) at the dh luma shape
    kept = clip_dh.planes[0]
    nw_k = cuda_ms(lambda: dk.interpolate_field_batch(kept, aaf_as_pixel(aafs[0], fmt), spec, stride), 10)
    from sangnom_tpu_torch.ops.reference import interpolate_field_batch as plain_interp
    nw_p = cuda_ms(lambda: plain_interp(kept, aaf_as_pixel(aafs[0], fmt), spec, stride), 2)
    nw_bound = bound(kept.shape[0] * (2 * kept.shape[1] - 1) * kept.shape[2],
                     kept.shape[0] * (kept.shape[1] - 1) * kept.shape[2]
                     * (OPS_PREPARE + OPS_FINALIZE + OPS_SMOOTH))
    log(f"[5 timing] no-weave mode (120x540x1920 luma): kernel {nw_k:.3f} ms, "
        f"plain {nw_p:.3f} ms, bound {nw_bound[0]:.4f} ms ({nw_bound[1]}) | {card}")
    details["no_weave_ms"] = {"kernel": nw_k, "plain": nw_p, "bound": nw_bound}

    # 6. the pool kernels vs their twins on the card
    t0 = time.perf_counter()
    cases = phase_pool_matrix(get_format, KernelSpec, details)
    log(f"[6 pool kernels vs plain] {cases} cases bit-equal on the card, rows "
        f"and whole pool (K3, K6, K7 on contiguous and strided kept rows; "
        f"u8/u16/10-bit/f32, c/sse2, strides 64/736/1920, luma/unaligned/"
        f"chroma/5-wide/degenerate planes on stale pools; K3, K7 prepare and "
        f"K7 finalize alone) in {time.perf_counter() - t0:.1f} s")

    # 7. the pool_compat main path, once per kernel arm
    t0 = time.perf_counter()
    hd, sd = pool_inputs()
    clip_hd = Clip.from_numpy(hd, fmt, device=DEVICE, tff=True)
    clip_sd = Clip.from_numpy(sd, fmt, device=DEVICE)
    pool_launches, hd_pool = phase_pool_main_path(fmt, clip_hd, clip_sd, details)
    log(f"[7 pool main path] bob(pool_compat=True) {N_POOL}x1920x1080 -> "
        f"{2 * N_POOL} frames, sangnom2(order=1, pool_compat=True) on {N_SD} "
        f"frames 720x480 (stride 736) with luma on and off: launches per arm "
        f"{pool_launches}; outputs and final pools bit-equal to opt=0, chunked "
        f"streams equal to the whole clips, frames 0-1 equal to the native "
        f"oracle, in {time.perf_counter() - t0:.1f} s")

    # 8. pool timing
    pool_ms = phase_pool_timing(fmt, clip_hd, clip_sd, hd_pool, card, details)
    del clip_hd, clip_sd, hd_pool, sd

    # 9. the width-sharded kernels vs their plain versions on the card
    t0 = time.perf_counter()
    cases = phase_shard_matrix(get_format, KernelSpec, details)
    log(f"[9 shard kernels vs plain] {cases} cases bit-equal on the card (u8/u16/"
        f"10-bit/f32, c/sse2, shards 1/2/4/8 on the cluster route and 12 on the chunk "
        f"route, thin and chroma-width shards, chunk_rows 1/5/16, K4 no weave and weave "
        f"0/1/per-frame, K5 on the whole plane, the chunked route's prepare and "
        f"finalize kernels and the route; launches equal to each plan) in "
        f"{time.perf_counter() - t0:.1f} s")

    # 10. the sharded main path at full width, then 11. its timing
    t0 = time.perf_counter()
    woven = double_weave(separate_fields(clip_bob))
    shard_launches = phase_sharded_main_path(clip_dh, woven, out_dh, out_bob, details)
    log(f"[10 sharded main path] done in {time.perf_counter() - t0:.1f} s")
    shard_ms = phase_shard_timing(clip_dh, woven, card, details)
    del clip_bob  # clip_dh, woven and phase 4's outputs stay for phase 19

    # 12. the probe kernels vs their plain versions, 13. the cost-model path
    t0 = time.perf_counter()
    probe_res = phase_probe_matrix(details)
    log(f"[12 probe kernels vs plain] K8 {probe_res['K8'][0]} line and step arms and "
        f"{probe_res['K8mm'][0]} mm arms, K9 "
        f"{probe_res['K9'][0]} arms (bigslab@1 raises in both), K10 "
        f"{probe_res['K10'][0]} cases bit-equal on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rates, probe_launches = phase_cost_model_path(card, details)
    predicted_k1_step(rates, per_launch[0], card, details)
    probe_ms = probe_timing(card, details)
    log(f"[13 cost-model path] done in {time.perf_counter() - t0:.1f} s")

    # 14. the CLI and the hosts at 1080, from y4m file to y4m file, on phases
    # 4 and 7's inputs and outputs; last, so that its host threads and
    # profiler sessions run after every earlier phase's measurements
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sangnom_cli_") as tmp:
        paths, want = phase_cli_hosts(Path(tmp), fmt, bob_planes, dh_planes, hd, out_bob,
                                      out_dh, min(times[("bob", "kernel")]), card, details)
        log(f"[14 CLI and hosts] done in {time.perf_counter() - t0:.1f} s")
        del hd

        # 15. prewarm and --aot, in fresh processes, on phase 14's files
        t0 = time.perf_counter()
        phase_prewarm(Path(tmp), paths, want, N_IN, card, details)
        log(f"[15 prewarm] done in {time.perf_counter() - t0:.1f} s")

        # 16. the examples on the card
        t0 = time.perf_counter()
        phase_examples(Path(tmp), paths, card, details)
        log(f"[16 examples] done in {time.perf_counter() - t0:.1f} s")

    # 17. the frame-parallel pool path, each count set to 0 just before its
    # main-path run and read just after (inside the phase)
    t0 = time.perf_counter()
    hd, sd = pool_inputs()
    pool_fast_ms = phase_pool_fast(
        fmt, Clip.from_numpy(hd, fmt, device=DEVICE, tff=True),
        Clip.from_numpy(sd, fmt, device=DEVICE), card, details)
    del hd, sd
    log(f"[17 pool fast] done in {time.perf_counter() - t0:.1f} s")

    # 18. multi-process frame sharding: two gloo processes on the one card
    t0 = time.perf_counter()
    phase_multihost(out_dh, card, details)
    log(f"[18 multihost] done in {time.perf_counter() - t0:.1f} s")

    # 19. width sharding across devices: four slots of the card through the
    # route's per-slot launches, copies and gathers, against phase 4
    t0 = time.perf_counter()
    cross = phase_cross_device(clip_dh, woven, out_dh, out_bob, card, details)
    del clip_dh, woven, out_dh, out_bob
    log(f"[19 cross-device] done in {time.perf_counter() - t0:.1f} s")

    # 20. the parity campaign at API level, bounded: the fixed set and the
    # first cases of the recorded seeds
    t0 = time.perf_counter()
    phase_campaign(card, details)
    log(f"[20 campaign] done in {time.perf_counter() - t0:.1f} s")

    # 21. the streaming tools: the soak (child processes) and stream_attr
    t0 = time.perf_counter()
    phase_stream_tools(card, details)
    log(f"[21 stream tools] done in {time.perf_counter() - t0:.1f} s")

    # 22. the headline bench, in a fresh process
    t0 = time.perf_counter()
    phase_bench(card, details)
    log(f"[22 bench] done in {time.perf_counter() - t0:.1f} s")

    # 23. planes wider than one block, through every route
    wide = phase_wide(card, min(times[("bob", "kernel")]), details)
    log(f"[23 wide planes] done in {wide['seconds']:.1f} s")

    log("[details] " + json.dumps(details))
    dk_bytes, dk_ops = 0, 0
    for src, _, _, _ in launches_bob:
        n_fields, bufH, w = 2 * src.shape[0], src.shape[1] // 2, src.shape[2]
        b_, o_ = deint_work(n_fields, bufH, w, width_tiers(w, bufH, stride, spec)[2])
        dk_bytes, dk_ops = dk_bytes + b_, dk_ops + o_
    dk_bound, dk_by = bound(dk_bytes, dk_ops)
    kernels = [{
        "name": "deint_kernel (K1 weave; K2 no-weave mode)",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": min(k_ms),
        "plain_ms": min(p_ms),
        "bound_ms": dk_bound,
        "bound_by": dk_by,
        "library_ms": None,
    }]
    for key, name, replaces, arm, count in (
        ("K3", "pool_smooth_kernel (K3)", "sangnom_tpu/ops/pool_carry.py:63", "K3", "smooth"),
        ("K6", "pool_smooth_kernel, split3 entry (K6; the walk of a K7 pass)",
         "sangnom_tpu/ops/pool_carry.py:268", "K6", "split3"),
        ("prepare", "pool_prepare_kernel (K7 pass, 1 of 3)",
         "sangnom_tpu/ops/pool_carry.py:178", "K7", "prepare"),
        ("finalize", "pool_finalize_kernel (K7 pass, 3 of 3)",
         "sangnom_tpu/ops/pool_carry.py:178", "K7", "finalize"),
        ("K7", "K7 pass: pool_prepare_kernel, pool_smooth_kernel (split3 entry), "
         "pool_finalize_kernel", "sangnom_tpu/ops/pool_carry.py:178", "K7", "prepare"),
    ):
        m = pool_ms[f"{key}/luma"]
        kernels.append({
            "name": name, "route": "cuda", "source": POOL_SOURCE,
            "replaces": replaces,
            "launches": pool_launches[arm][count],
            "max_abs_err": max(m["max_abs_err"], pool_ms[f"{key}/chroma"]["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    fast = details["pool_fast"]["launches"]
    for key, name, replaces, lkey in (
        ("prepare_batch", "pool_prepare_kernel, frame-batched (POOL_FAST pass, 1 of 3)",
         "sangnom_tpu/ops/pool_carry.py:770", "prepare"),
        ("walk_batch", "pool_smooth_kernel over 9K maps (POOL_FAST pass, 2 of 3; K3's "
         "walk with K frames folded in)", "sangnom_tpu/ops/pool_carry.py:557", "split3"),
        ("finalize_batch", "pool_finalize_kernel, frame-batched (POOL_FAST pass, 3 of 3)",
         "sangnom_tpu/ops/pool_carry.py:770", "finalize"),
    ):
        m = pool_fast_ms[key]
        kernels.append({
            "name": name, "route": "cuda", "source": POOL_SOURCE, "replaces": replaces,
            "launches": sum(fast[wl][lkey] for wl in ("bob1080", "1080x40", "hd720")),
            "max_abs_err": max(m["max_abs_err"], pool_fast_ms[f"{key}/K14"]["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": None,
        })
    for key, name, replaces, lkey in (
        ("K4", "shard_full_kernel (K4)", "sangnom_tpu/parallel/fused_smooth.py:480", "full"),
        ("K5", "shard_smooth_kernel (K5)", "sangnom_tpu/parallel/fused_smooth.py:116", "smooth"),
        ("prepare", "shard_prepare_kernel (K5 route, 1 of 3)",
         "sangnom_tpu/parallel/fused_smooth.py:116", "prepare"),
        ("finalize", "shard_finalize_kernel (K5 route, 3 of 3)",
         "sangnom_tpu/parallel/fused_smooth.py:116", "finalize"),
    ):
        m = shard_ms[f"{key}/luma"]
        kernels.append({
            "name": name, "route": "cuda", "source": SHARD_SOURCE, "replaces": replaces,
            "launches": shard_launches["K4" if key == "K4" else "K5"][lkey],
            "max_abs_err": max(m["max_abs_err"], shard_ms[f"{key}/U+V"]["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    for arm, name, lkey in (
        ("K4", "shard_full_kernel (K4), one-shard chunk launches a slot (width sharding "
         "across devices; timed: the 1080 dh luma pass through 4 slots)", "full"),
        ("K5", "shard_prepare_kernel, shard_smooth_kernel (K5) one-shard chunks, "
         "shard_finalize_kernel, a slot (width sharding across devices; timed: the 1080 "
         "dh luma pass through 4 slots)", "smooth"),
    ):
        m = cross["pass"][f"{arm}/luma"]
        kernels.append({
            "name": name, "route": "cuda", "source": SHARD_SOURCE,
            "replaces": ("sangnom_tpu/parallel/fused_smooth.py:480" if arm == "K4"
                         else "sangnom_tpu/parallel/fused_smooth.py:116"),
            "launches": cross["launches"][arm][lkey],
            "max_abs_err": max(m["max_abs_err"], cross["pass"][f"{arm}/U+V"]["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    for key, ekey, name, replaces, lkey in (
        ("K8", "K8", "line_kernel, step_kernel (K8 line and step arms; timed: mix)",
         "tools/calibrate_vpu.py:351", "calibrate"),
        ("K8 mmbf16", "K8mm", "mm_kernel, mmf32_kernel (K8 mm arms; timed: mmbf16)",
         "tools/calibrate_vpu.py:230", "mm"),
        ("K9", "K9", "isolate_kernel (K9)", "tools/archive/isolate_step.py:126", "isolate"),
        ("K10", "K10", "dynrow_kernel (K10)", "tools/archive/probe_pool_dynrow.py:26", "dynrow"),
    ):
        m = probe_ms[key]
        kernels.append({
            "name": name, "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
            "launches": probe_launches[lkey], "max_abs_err": probe_res[ekey][1],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    for name, replaces, m, lkey in (
        ("shard_full_kernel (K4) as the wide main path: a field past one block over "
         "k blocks of a cluster (timed: the GRAY16 10240x256 dh pass)",
         "sangnom_tpu/ops/pallas_kernel.py:463", wide["k4"], "shard full"),
        ("pool_smooth_kernel's cluster mode (WIDE): the pool walk (K3/K6, K7's walk, "
         "the batched walk) split over a cluster past one block (timed: the 8448 luma "
         "pass's walk)",
         "sangnom_tpu/ops/pool_carry.py:268", wide["walk"], "pool split3"),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": SHARD_SOURCE if lkey == "shard full" else POOL_SOURCE,
            "replaces": replaces, "launches": wide["launches"].get(lkey, 0),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": None,
        })
    if any(k["max_abs_err"] != 0.0 for k in kernels):
        raise AssertionError(f"a kernel disagrees with its twin: {kernels}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        multihost_worker(*map(int, sys.argv[2:6]), *sys.argv[6:7])
        sys.exit(0)
    sys.exit(main())
