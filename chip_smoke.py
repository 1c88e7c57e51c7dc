#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (sangnom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernel from csrc/, checks it bit for bit against its plain
PyTorch version on the card, drives the main path at full 1080 size (the
1080i YUV420P8 bob, 60 interlaced frames -> 120, and the single-rate
``sangnom2(order=1, dh=True)`` on 120 fields of 1920x540), checks the output
against the plain path and the native oracle, and times kernel and plain
version with CUDA events.  Each phase prints one line; any failure raises,
so the script exits nonzero and never prints the final ``"ok"`` line.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FMT = "YUV420P8"
N_IN = 60  # interlaced input frames of the bob -> 120 output frames
B = 120  # fields of the single-rate dh call
REPLACES = "sangnom_tpu/ops/pallas_kernel.py:463"
SOURCE = "sangnom_tpu_torch/csrc/deint.cu"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
                if fmt.is_float:
                    host = (rng.random(shape, dtype=np.float32) * 1.5 - 0.25)
                else:
                    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
                    host = rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)
                src = torch.from_numpy(np.ascontiguousarray(host)).cuda()
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
        aaf_as_pixel, buffer_stride_elems, scaled_aa_thresholds)
    from sangnom_tpu_torch.ops import deint_kernel as dk
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.oracle import sangnom2_frame_oracle

    # 2. build
    t0 = time.perf_counter()
    compile_s = dk.build()
    dk._load()
    log(f"[2 build] kernel library built from {SOURCE} in {compile_s:.1f} s "
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
    log(f"[5 timing] no-weave mode (120x540x1920 luma): kernel {nw_k:.3f} ms, "
        f"plain {nw_p:.3f} ms | {card}")
    details["no_weave_ms"] = {"kernel": nw_k, "plain": nw_p}

    log("[5 details] " + json.dumps(details))
    log(json.dumps({"kernels": [{
        "name": "deint_kernel (K1 weave; K2 no-weave mode)",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": min(k_ms),
        "plain_ms": min(p_ms),
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
