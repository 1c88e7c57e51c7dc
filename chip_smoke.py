#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (sangnom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
checks each bit for bit against its plain PyTorch version on the card.
Drives the main path at full 1080 size: the 1080i YUV420P8 bob (60
interlaced frames -> 120) and the single-rate ``sangnom2(order=1, dh=True)``
on 120 fields of 1920x540.  Then the pool_compat path: the 1080i bob with
``pool_compat=True`` (16 interlaced frames -> 32) and 30 frames of 720x480
YUV420P8, through each pool kernel (K3, and the K6 / K7 options).  Then the
width-sharded path: ``parallel.sangnom2_sharded`` on meshes of the one card
(1x4 through K4 and through K5, 2x2 through K4) on the 1080 dh call and the
woven 1080i bob, held bit-equal to the single-device kernel path.  Checks
the outputs against the plain path and the native oracle, and times kernels
and plain versions with CUDA events.  Last, the cost-model path: the probe
kernels K8-K10 (``csrc/probes.cu``) held bit-equal to their plain versions,
then the op-class calibration at full shape, the step-isolation arms and the
dynamic-row probe through their entry points, the measured rates and the
cost model's prediction of K1's row step against phase 5's time.  Each phase prints one line; any
failure raises, so the script exits nonzero and never prints the final
``"ok"`` line.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

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
    shapes = [(3, 9, 61), (3, 9, 1920), (75, 6, 61)]  # 75 frames: 150 fields
    for fmt_name, numerics in formats:
        fmt = get_format(fmt_name)
        spec = KernelSpec.from_format(fmt, sse2=numerics == "sse2")
        aaf = aaf_as_pixel(scaled_aa_thresholds(48, 48, fmt)[0], fmt)
        for n, bufH, w in shapes:
            stride = -(-w // 32) * 32
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
    pool, unaligned luma, chroma with R < P-1 and w < S, a degenerate
    plane), on pools holding stale content from two plain passes; the
    interpolated rows and the whole pool bit-equal."""
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
            for rows, w in ((P, S), (P, S - 16), (P // 2 - 1, S // 2 - 8), (1, S // 2)):
                kept = torch.from_numpy(_rand_plane(rng, (rows, w), fmt)).to(DEVICE)
                aaf = aaf_y if rows == P else aaf_c
                want_pool = pool.clone()
                want = pc.interp_field_pool(kept, want_pool, aaf, spec)
                arms = (
                    ("K3", lambda p: (pc.interp_field_pool_k3(kept, p, aaf, spec), p)),
                    ("K6", lambda p: _on_split(pc.interp_field_pool_split3, kept, p, aaf, spec)),
                    ("K7", lambda p: _on_split(pc.interp_field_pool_fused, kept, p, aaf, spec)),
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


def phase_pool_main_path(fmt, clip_hd, clip_sd, details):
    """The pool_compat path through the entry points, once per kernel arm
    (K3 default, K6, K7), each with the launch counts set to 0 just before
    and read just after; outputs and final pools bit-equal to opt=0,
    chunked streams equal to the whole clip, the first 2 frames equal to
    the native oracle with a carried pool.  Returns (launches per kernel,
    the K3 bob's final pool)."""
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
    ref = {}
    for name, (_, c, kw) in calls.items():
        ref[name] = stream(c, None, opt=0, **kw)
    launches, outs = {}, {}
    for arm, key, flags in (("K3", "smooth", (False, False)),
                            ("K6", "split3", (True, False)),
                            ("K7", "fused", (False, True))):
        pc.POOL_SPLIT3, pc.POOL_FUSED = flags
        try:
            torch.cuda.synchronize()
            pk.reset_launches()
            outs = {name: call() for name, (call, _, _) in calls.items()}
            torch.cuda.synchronize()
            launches[key] = pk.LAUNCHES[key]
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
            pc.POOL_SPLIT3 = pc.POOL_FUSED = False
        if launches[key] != passes:
            raise AssertionError(f"{arm}: {launches[key]} launches, {passes} passes")
    # chunked streams == the whole clip (K3)
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
    turns, the arms' outputs equal (1080i bob, 720p and 720x480: where K3
    and K7 cross over); ms per launch of each pool kernel and its twin at the 1080 luma
    and chroma passes; the plain path on a 2-frame prefix."""
    from sangnom_tpu_torch import Clip, bob, sangnom2
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops import pool_carry as pc
    from sangnom_tpu_torch.ops import pool_kernel as pk
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    arms = {"K3": (False, False), "K6": (True, False), "K7": (False, True)}
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
    first: dict = {}  # workload -> K3's output, which every arm must equal
    try:
        for rnd in (list(arms), list(arms)[::-1]):
            for arm in rnd:
                pc.POOL_SPLIT3, pc.POOL_FUSED = arms[arm]
                for wl, (fn, frames) in calls.items():
                    out = fn()  # warm-up
                    want = first.setdefault(wl, out)
                    if not all(torch.equal(g, r) for g, r in zip(out.planes, want.planes)):
                        raise AssertionError(f"{wl}: arm {arm} != the first arm's output")
                    e2e.setdefault(f"{wl}/{arm}", []).append(cuda_ms(fn, 2) / frames)
    finally:
        pc.POOL_SPLIT3 = pc.POOL_FUSED = False
    del first
    plain = {
        "bob1080": cuda_ms(lambda: bob(clip_hd[0:1], pool_compat=True, opt=0), 1) / 2,
        "sd480": cuda_ms(lambda: sangnom2(clip_sd[0:2], order=1, pool_compat=True,
                                          opt=0), 1) / 2,
    }
    for k, ts in e2e.items():
        log(f"[8 pool timing] {k}: {min(ts):.4f} ms/output frame -> "
            f"{1e3 / min(ts):.1f} frames/s (windows {', '.join(f'{t:.4f}' for t in ts)}) | {card}")
    for k, t in plain.items():
        log(f"[8 pool timing] {k}/plain (opt=0, 2-frame prefix): {t:.3f} ms/output frame | {card}")
    details["pool_e2e_ms_per_frame"] = e2e
    details["pool_plain_ms_per_frame"] = plain

    # each kernel alone at the 1080 passes, on the bob's stale final pool
    spec = KernelSpec.from_format(fmt)
    aafs = scaled_aa_thresholds(48, 0, fmt)
    P, S = hd_pool.shape[1] - 1, hd_pool.shape[2]
    field = clip_hd.planes
    passes = {
        "luma": (field[0][0, 0::2].contiguous(), aaf_as_pixel(aafs[0], fmt)),
        "chroma": (field[1][0, 0::2].contiguous(), aaf_as_pixel(aafs[1], fmt)),
    }
    per: dict = {}
    for pname, (kept, aaf) in passes.items():
        bufH_p, w = kept.shape
        prepared = hd_pool.clone()
        pc._prepare(kept, prepared[:, 1:bufH_p, :w], spec)
        carry = pc._pool_split(prepared)
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
                f"{b_ms:.4f} ms ({b_by}), {P - 1} serial row steps | {card}")
    details["pool_kernel_ms"] = per
    details["pool_profile"] = profile_call(lambda: bob(clip_hd, pool_compat=True),
                                           min(e2e["bob1080/K3"]) * 2 * clip_hd.num_frames,
                                           "bob1080/K3", card)
    return per


def profile_call(fn, wall_ms: float, what: str, card: str,
                 tag: str = "8 pool profile") -> dict:
    """Device time of one call of ``fn`` by torch.profiler, against
    ``wall_ms``, its time by CUDA events without the profiler: the device's
    busy and idle share, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: the port's own named ranges (utils.profiling.stage_scope)
    # also appear on the device timeline, spanning their kernels
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("sangnom/")]
    busy = sum(r[2] for r in rows)
    if not busy:
        log(f"[{tag}] {what}: the profiler traced no device time; "
            f"busy share not measured")
        return {}
    rows.sort(key=lambda r: -r[2])
    top = [(k[:60], n, round(ms, 4)) for k, n, ms in rows[:6]]
    log(f"[{tag}] {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"per call (idle share {1 - busy / wall_ms:.3f}), {sum(r[1] for r in rows)} "
        f"kernel launches; top (name, launches, ms): {top} | {card}")
    return {"busy_ms": busy, "wall_ms": wall_ms, "launches": sum(r[1] for r in rows),
            "top": top}


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


def _k7_err(pk, pc, pool, kept, aaf, spec) -> float:
    a, b = pc._pool_split(pool), pc._pool_split(pool)
    ra = pk.interp_fused(kept, *a, aaf, spec)
    rb = pk.interp_fused_plain(kept, *b, aaf, spec)
    return max([max_abs(ra, rb)] + [max_abs(x, y) for x, y in zip(a, b)])


def phase_shard_matrix(get_format, KernelSpec, details):
    """K4 and K5 vs their plain versions on CUDA tensors: formats and
    numerics x shard counts 1/2/4/8 (thin shards, and a chroma-like plane
    whose true width is short of the padded one) x chunk_rows 1/5/16, K4 with
    no weave and weave offsets 0/1/per frame; bit-equal required."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.parallel import fused_smooth as fs
    from sangnom_tpu_torch.parallel import shard_kernel as sk

    rng = np.random.default_rng(17)
    formats = [("GRAY8", "c"), ("GRAY8", "sse2"), ("GRAY16", "c"),
               ("GRAY16", "sse2"), ("YUV420P10", "c"), ("YUV420P10", "sse2"),
               ("GRAYS", "c")]
    # K4: (shards, padded width, true width); K5: (shards, padded width)
    k4_geoms = [(1, 1920, 1920), (2, 1920, 1917), (4, 988, 960), (8, 1920, 1920),
                (8, 72, 70)]
    k5_geoms = [(1, 480), (2, 988), (4, 1920), (8, 64)]
    cases = {"K4": 0, "K5": 0}
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
                for off in (None, 0, 1, pf):
                    before = sk.LAUNCHES["full"]
                    if off is None:
                        got = fs.interpolate_fused_full(kept, aaf, spec, n, pw, chunk_rows)
                        want = fs.interpolate_fused_full_plain(kept, aaf, spec, n, pw, chunk_rows)
                    else:
                        got = fs.deinterlace_fused_full(kept, off, aaf, spec, n, pw, chunk_rows)
                        want = fs.deinterlace_fused_full_plain(kept, off, aaf, spec, n, pw,
                                                               chunk_rows)
                    torch.cuda.synchronize()
                    if sk.LAUNCHES["full"] == before or not torch.equal(got, want):
                        raise AssertionError(
                            f"K4 != plain: {fmt_name} {numerics} shards={n} S={S} w={w} "
                            f"chunk_rows={chunk_rows} weave={'pf' if off is pf else off} "
                            f"max_abs={max_abs(got, want)}")
                    cases["K4"] += 1
        for n, S in k5_geoms:
            raw = (torch.from_numpy(rng.random((n, 27, 18, S // n), dtype=np.float32) * 300)
                   if spec.is_float else torch.from_numpy(
                       rng.integers(0, spec.mask + 1, (n, 27, 18, S // n)).astype(np.int32)))
            raw[:, :, [0, 17]] = 0
            raw = raw.to(DEVICE)
            for chunk_rows in (1, 5, 16):
                before = sk.LAUNCHES["smooth"]
                got = fs.smooth_sharded_chunked(raw, spec, chunk_rows)
                want = fs.smooth_sharded_chunked_plain(raw, spec, chunk_rows)
                torch.cuda.synchronize()
                if sk.LAUNCHES["smooth"] == before or not torch.equal(got, want):
                    raise AssertionError(
                        f"K5 != plain: {fmt_name} {numerics} shards={n} S={S} "
                        f"chunk_rows={chunk_rows} max_abs={max_abs(got, want)}")
                cases["K5"] += 1
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
    """Kernel launches and halo exchanges of one sharded call, from the chunk
    geometry: per data row and plane pass, K4 one kept exchange and
    ceil(bufH / R) chunks (the weave's n_tot = bufH); K5 two whole-plane
    exchanges (kept rows, raw maps) and ceil((bufH-1) / R) chunks."""
    from sangnom_tpu_torch.parallel import fused_smooth as fs

    want = {"launches": 0, "kept": 0, "carry": 0}
    for bufH, w_loc in _plane_passes(clip, dh, n_space):
        if arm == "K4":
            R, _ = fs.chunk_geometry_k4(w_loc, bufH)
            chunks, kept = -(-bufH // R), 1
        else:
            R, _ = fs.chunk_geometry_k5(w_loc, bufH - 1)
            chunks, kept = -(-(bufH - 1) // R), 2
        want["launches"] += n_data * chunks
        want["kept"] += n_data * kept
        want["carry"] += n_data * chunks
    return want


def phase_sharded_main_path(clip_dh, woven, out_dh, out_bob, details):
    """sangnom2_sharded at full 1080 size on meshes of the one card: 1x4
    through K4 (default) and through K5 (smooth="chunked"), and 2x2 through
    K4, each on the dh call and the woven bob; each output bit-equal to the
    single-device kernel path (phase 4), launches and halo exchanges equal
    to their formulas; the scan arm (opt=0) on 4-frame prefixes too.
    Returns {arm: launches of its 1x4 run}."""
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
        key = "full" if arm == "K4" else "smooth"
        want = {"launches": 0, "kept": 0, "carry": 0}
        for name, (c, kw, _) in calls.items():
            for k, v in shard_expected(c, kw.get("dh", False), n_data, n_space, arm).items():
                want[k] += v
        if (got[key], exch["kept"], exch["carry"], exch["row"]) != (
                want["launches"], want["kept"], want["carry"], 0) or sum(got.values()) != got[key]:
            raise AssertionError(f"{arm} {n_data}x{n_space}: launches {got}, exchanges "
                                 f"{exch}, expected {want}")
        for name, (_, _, ref) in calls.items():
            for i, (g, r) in enumerate(zip(outs[name].planes, ref.planes)):
                if not torch.equal(g, r):
                    raise AssertionError(f"{arm} {n_data}x{n_space} {name} plane {i} != the "
                                         f"single-device kernel path, max_abs {max_abs(g, r)}")
        del outs
        if n_data == 1:
            launches[arm] = got[key]
        details[f"shard_main_{arm}_{n_data}x{n_space}"] = {"launches": got, "exchanges": exch}
        log(f"[10 sharded main path] {arm} on a {n_data}x{n_space} mesh of {DEVICE}: dh and "
            f"bob bit-equal to phase 4; {got[key]} launches, exchanges {exch} (formula "
            f"{want})")
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


def k4_work(n: int, N: int, steps: int, W_loc: int, HALO: int, S: int, elem: int = 1):
    """(bytes, ops) of one woven K4 chunk launch: the kept rows it reads
    (steps + 2 of W_ext columns), the woven rows it writes (2 * steps of the
    plane width S), the carry row in (9 maps x W_ext) and out (9 x W_loc);
    prepare and smoothing over every W_ext column, finalize over W_loc."""
    W_ext = W_loc + 2 * HALO
    nbytes = (n * N * (steps + 2) * W_ext * elem + N * 2 * steps * S * elem
              + n * N * 9 * (W_ext + W_loc) * 4)
    ops = n * N * steps * (W_ext * (OPS_PREPARE + OPS_SMOOTH) + W_loc * OPS_FINALIZE)
    return nbytes, ops


def k5_work(n: int, C: int, steps: int, W_loc: int, HK: int):
    """(bytes, ops) of one K5 chunk launch: raw rows read (steps + 1 of W_ext
    columns), the carry row in, the smoothed rows out (W_loc columns); the
    smoothing of one map over every W_ext column."""
    W_ext = W_loc + 2 * HK
    nbytes = 4 * n * C * ((steps + 1) * W_ext + W_ext + steps * W_loc)
    ops = n * C * steps * W_ext * (OPS_SMOOTH // 9)
    return nbytes, ops


def phase_shard_timing(clip_dh, woven, card, details):
    """ms per call of the sharded dh and bob at space 1/2/4 through K4 and
    K5, in turns with the single-device K1 call; ms per launch of K4 and K5
    at the 1080 luma chunk shape (4 shards, 16 rows), their plain versions'
    and their bounds.  Returns the per-launch numbers."""
    from sangnom_tpu_torch import sangnom2
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded
    from sangnom_tpu_torch.parallel import fused_smooth as fs
    from sangnom_tpu_torch.parallel import shard_kernel as sk
    from sangnom_tpu_torch.parallel.width_sharded import _exchange_halo, _shards

    calls = {"dh": (clip_dh, dict(order=1, dh=True)), "bob": (woven, dict(order=0))}
    arms = {"K1": (None, None)}
    for n in (1, 2, 4):
        arms[f"K4/space{n}"] = (n, None)
        arms[f"K5/space{n}"] = (n, "chunked")
    reps = {"K1": 5, "K4": 3, "K5": 1}

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
    for wl in calls:
        details[f"shard_profile_{wl}"] = profile_call(
            fn("K4/space4", wl), min(e2e[f"{wl}/K4/space4"]), f"{wl}/K4/space4", card,
            "11 shard profile")

    # each kernel alone at the 1080 dh luma chunk shape: 4 shards, R = 16
    fmt = clip_dh.format
    spec = KernelSpec.from_format(fmt)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    kept = clip_dh.planes[0]
    N, bufH, S = kept.shape
    n = 4
    W_loc = S // n
    R, HALO = fs.chunk_geometry_k4(W_loc, bufH)
    keptx = _exchange_halo(_shards(kept, n), HALO, "kept")
    smx = torch.zeros((n, N, 9, W_loc + 2 * HALO), dtype=spec.acc_dtype, device=DEVICE)
    out_k = torch.empty((N, 2 * bufH, S), dtype=kept.dtype, device=DEVICE)
    out_p = torch.empty_like(out_k)
    sm_k = sk.full_chunk(keptx, smx, out_k, 0, 0, R, HALO, S, aaf, spec)
    sm_p = fs._full_chunk_plain(keptx, smx, out_p, 0, 0, R, HALO, S, aaf, spec)
    torch.cuda.synchronize()
    k4_err = max(max_abs(out_k[:, :2 * R], out_p[:, :2 * R]), max_abs(sm_k, sm_p))
    k4 = dict(
        ms=min(cuda_ms(lambda: sk.full_chunk(keptx, smx, out_k, 0, 0, R, HALO, S, aaf, spec), 10)
               for _ in range(2)),
        plain_ms=cuda_ms(lambda: fs._full_chunk_plain(keptx, smx, out_p, 0, 0, R, HALO, S,
                                                      aaf, spec), 1),
        max_abs_err=k4_err)
    k4["bound_ms"], k4["bound_by"] = bound(*k4_work(n, N, R, W_loc, HALO, S))
    del keptx, smx, out_k, out_p

    C = 9 * N
    R5, HK = fs.chunk_geometry_k5(W_loc, bufH - 1)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    raw = torch.randint(0, 256, (n, C, bufH + 1, W_loc), generator=g, device=DEVICE,
                        dtype=torch.int32)
    raw[:, :, [0, bufH]] = 0
    rawx = _exchange_halo(raw, HK, "kept")
    del raw
    smx5 = torch.randint(0, 256, (n, C, W_loc + 2 * HK), generator=g, device=DEVICE,
                         dtype=torch.int32)
    o_k = torch.empty((n, C, bufH - 1, W_loc), dtype=torch.int32, device=DEVICE)
    o_p = torch.empty_like(o_k)
    sk.smooth_chunk(smx5, rawx, o_k, 0, R5, HK, spec)
    fs._smooth_chunk_plain(smx5, rawx, o_p, 0, R5, HK, spec)
    torch.cuda.synchronize()
    k5 = dict(
        ms=min(cuda_ms(lambda: sk.smooth_chunk(smx5, rawx, o_k, 0, R5, HK, spec), 10)
               for _ in range(2)),
        plain_ms=cuda_ms(lambda: fs._smooth_chunk_plain(smx5, rawx, o_p, 0, R5, HK, spec), 1),
        max_abs_err=max_abs(o_k[:, :, :R5], o_p[:, :, :R5]))
    k5["bound_ms"], k5["bound_by"] = bound(*k5_work(n, C, R5, W_loc, HK))
    del rawx, smx5, o_k, o_p
    for name, m, shape in (
            ("K4", k4, f"weave, {n} shards x {N} fields, W_loc {W_loc} + 2x{HALO} halo, "
                       f"{R} rows"),
            ("K5", k5, f"{n} shards x {C} map rows, W_loc {W_loc} + 2x{HK} halo, {R5} rows")):
        log(f"[11 shard timing] {name} per launch at the 1080 dh luma chunk ({shape}): "
            f"{m['ms']:.4f} ms, plain {m['plain_ms']:.3f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}), max_abs_err {m['max_abs_err']} | {card}")
    details["shard_kernel_ms"] = {"K4": k4, "K5": k5}
    return {"K4": k4, "K5": k5}


PROBE_SOURCE = "sangnom_tpu_torch/csrc/probes.cu"
def probe_src():
    """The probes' [120, 2048] int32 input, seed 0 (the tools' own)."""
    return torch.from_numpy(np.random.default_rng(0).integers(0, 255, (120, 2048))).to(
        DEVICE, torch.int32)


def phase_probe_matrix(details):
    """K8, K9 and K10 vs their plain versions on CUDA tensors: every K8 arm
    at full [120, 2048], 4 steps, at the differential's long chain; K9's
    default arms (bigslab@1 must raise) and every other arm once; K10 at the
    probe's shape and at 540 x 1920 over 542 steps, u8 and i32.  Returns
    {kernel: (cases, max_abs_err)}; any difference raises."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv
    from sangnom_tpu_torch.tools import isolate_step as iso
    from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn

    src = probe_src()
    res = {"K8": [0, 0.0], "K9": [0, 0.0], "K10": [0, 0.0]}

    def check(key, got, want, what):
        torch.cuda.synchronize()
        err = max_abs(got, want)
        res[key][1] = max(res[key][1], err)
        if err != 0.0:
            raise AssertionError(f"{key} {what}: kernel != plain, max_abs {err}")
        res[key][0] += 1

    for kind in cv.OPS_PER_ITER:
        k = cv.chain_lengths(kind)[1]
        got = cv.run(src, kind, k, steps=4)
        want = cv.run_plain(src, kind, k, steps=4)
        if kind in cv.TRANSPOSED and got[:, :, 120:].any():
            raise AssertionError(f"K8 {kind}: columns 120..127 not zero")
        check("K8", got, want, f"{kind} k={k}")
    arms = list(iso.DEFAULT_ARMS) + [f"{k}@1" for k in iso.KINDS if k != "bigslab"]
    for arm in arms + ["ramt130@2", "bigslab_iota@1"]:
        kind, _, k = arm.partition("@")
        if kind == "bigslab":
            for fn in (iso.run, iso.run_plain):
                try:
                    fn(src, kind, int(k))
                except ValueError:
                    continue
                raise AssertionError(f"K9 bigslab@1 did not raise in {fn.__name__}")
            continue
        check("K9", iso.run(src, kind, int(k)), iso.run_plain(src, kind, int(k)), arm)
    for dtype in (np.uint8, np.int32):
        for H, S, steps in ((64, 256, 70), (540, 1920, 542)):
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


def probe_timing(card, details) -> dict:
    """ms of one launch of each probe kernel and of its plain version on the
    same inputs, with its bound: K8's mix arm (the kernel-shaped blend) at
    [120, 2048], k 96, 32 steps; K9's unroll@12 (8 steps); K10 at 540 x 1920
    u8 over 542 steps."""
    from sangnom_tpu_torch.tools import calibrate_vpu as cv
    from sangnom_tpu_torch.tools import isolate_step as iso
    from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn

    src = probe_src()
    G, W = src.shape
    kept = torch.from_numpy(dyn.probe_input(np.uint8, 540, 1920)).to(DEVICE)
    out_bytes = lambda steps: steps * G * 128 * 4  # noqa: E731
    cases = {
        "K8": (lambda: cv.run(src, "mix", 96, steps=32),
               lambda: cv.run_plain(src, "mix", 96, steps=32),
               (G * W * 4 + out_bytes(32), 96 * 32 * G * W * cv.OPS_PER_ITER["mix"]),
               "mix arm, [120, 2048] i32, k 96, 32 steps"),
        # unroll: 3 roll+add pairs on 5 slabs and 6 shifted adds on b an iteration
        "K9": (lambda: iso.run(src, "unroll", 12), lambda: iso.run_plain(src, "unroll", 12),
               (G * W * 4 + out_bytes(8), 12 * 8 * G * W * (5 * 6 + 12)),
               "unroll@12, [120, 2048] i32, 8 steps"),
        "K10": (lambda: dyn.dynrow(kept, 542), lambda: dyn.dynrow_plain(kept, 542),
                (540 * 1920 + 542 * 1920 * 4, 542 * 1920 * 5),
                "540 x 1920 u8, 542 steps"),
    }
    res = {}
    for key, (kern, plain, work, what) in cases.items():
        kern()
        plain()
        k_ms = min(cuda_ms(kern, 5) for _ in range(2))
        p_ms = cuda_ms(plain, 1)
        b_ms, b_by = bound(*work)
        res[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[13 probe timing] {key} ({what}): {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) | {card}")
    details["probe_kernel_ms"] = res
    return res


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
        f"none/tff/bff, widths 61/1920, 150 fields) in {time.perf_counter() - t0:.1f} s")

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
    log(f"[5 timing] deint kernel per bob launch: luma {per_launch[0]:.3f} ms, "
        f"U/V {per_launch[1]:.3f} ms | {card}")
    details["kernel_ms_per_launch"] = per_launch
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
        f"and whole pool (K3, K6, K7; u8/u16/10-bit/f32, c/sse2, strides "
        f"64/736/1920, luma/unaligned/chroma/degenerate planes on stale "
        f"pools; K3 alone) in {time.perf_counter() - t0:.1f} s")

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
    del clip_hd, clip_sd, hd_pool

    # 9. the width-sharded kernels vs their plain versions on the card
    t0 = time.perf_counter()
    cases = phase_shard_matrix(get_format, KernelSpec, details)
    log(f"[9 shard kernels vs plain] {cases} cases bit-equal on the card (u8/u16/"
        f"10-bit/f32, c/sse2, shards 1/2/4/8 with thin and chroma-width shards, "
        f"chunk_rows 1/5/16, K4 no weave and weave 0/1/per-frame) in "
        f"{time.perf_counter() - t0:.1f} s")

    # 10. the sharded main path at full width, then 11. its timing
    t0 = time.perf_counter()
    woven = double_weave(separate_fields(clip_bob))
    shard_launches = phase_sharded_main_path(clip_dh, woven, out_dh, out_bob, details)
    log(f"[10 sharded main path] done in {time.perf_counter() - t0:.1f} s")
    del out_dh, out_bob
    shard_ms = phase_shard_timing(clip_dh, woven, card, details)
    del clip_dh, clip_bob, woven

    # 12. the probe kernels vs their plain versions, 13. the cost-model path
    t0 = time.perf_counter()
    probe_res = phase_probe_matrix(details)
    log(f"[12 probe kernels vs plain] K8 {probe_res['K8'][0]} arms, K9 "
        f"{probe_res['K9'][0]} arms (bigslab@1 raises in both), K10 "
        f"{probe_res['K10'][0]} cases bit-equal on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rates, probe_launches = phase_cost_model_path(card, details)
    predicted_k1_step(rates, per_launch[0], card, details)
    probe_ms = probe_timing(card, details)
    log(f"[13 cost-model path] done in {time.perf_counter() - t0:.1f} s")

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
    for key, name, replaces in (
        ("K3", "pool_smooth_kernel (K3)", "sangnom_tpu/ops/pool_carry.py:63"),
        ("K6", "pool_smooth_kernel, split3 entry (K6)", "sangnom_tpu/ops/pool_carry.py:268"),
        ("K7", "pool_fused_kernel (K7)", "sangnom_tpu/ops/pool_carry.py:178"),
    ):
        m = pool_ms[f"{key}/luma"]
        kernels.append({
            "name": name, "route": "cuda", "source": POOL_SOURCE,
            "replaces": replaces,
            "launches": pool_launches[{"K3": "smooth", "K6": "split3", "K7": "fused"}[key]],
            "max_abs_err": max(m["max_abs_err"], pool_ms[f"{key}/chroma"]["max_abs_err"]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    for key, name, replaces in (
        ("K4", "shard_full_kernel (K4)", "sangnom_tpu/parallel/fused_smooth.py:480"),
        ("K5", "shard_smooth_kernel (K5)", "sangnom_tpu/parallel/fused_smooth.py:116"),
    ):
        m = shard_ms[key]
        kernels.append({
            "name": name, "route": "cuda", "source": SHARD_SOURCE, "replaces": replaces,
            "launches": shard_launches[key], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    for key, name, replaces, lkey in (
        ("K8", "calibrate kernels (K8: line, mm and step arms)",
         "tools/calibrate_vpu.py:351", "calibrate"),
        ("K9", "isolate_kernel (K9)", "tools/archive/isolate_step.py:126", "isolate"),
        ("K10", "dynrow_kernel (K10)", "tools/archive/probe_pool_dynrow.py:26", "dynrow"),
    ):
        m = probe_ms[key]
        kernels.append({
            "name": name, "route": "cuda", "source": PROBE_SOURCE, "replaces": replaces,
            "launches": probe_launches[lkey], "max_abs_err": probe_res[key][1],
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        })
    if any(k["max_abs_err"] != 0.0 for k in kernels):
        raise AssertionError(f"a kernel disagrees with its twin: {kernels}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
