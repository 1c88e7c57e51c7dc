"""Closed loop of calls of one public entry of the program, one caller.

Traffic parameters: ``frames`` (input frames a call), ``clips`` (distinct
seed-made clips on the device, called in turn), ``kwargs`` (added to the
configuration's filter arguments), ``sample_calls`` (calls of the window
whose outputs are judged, drawn from the seed).

Set-up makes the clips and calls the entry twice on each, then the window
calls it back to back, each call ending in a synchronize, until
``seconds`` have passed.  A call's time runs from its start to the end of
its synchronize; its issue time to its return, before the synchronize.
With ``trace``, a profiler covers a stretch of the window's calls; the
calls outside it are also kept apart (``quiet_call_s``, ``issue_s``), so
that a per-layer reading of a traced run leaves the profiler's cost out.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import harness, inputs, reference, trace

# The traced stretch starts this far into the window and lasts at most
# TRACE_SECONDS (or half the window).
TRACE_FROM = 0.25
TRACE_SECONDS = 2.0


def entry_of(cell: harness.Cell):
    """(entry name, the call on a clip, its keyword arguments) of the cell."""
    import sangnom_tpu_torch as snt

    name = cell.config["filter"]["entry"]
    fn = getattr(snt, name)
    kwargs = {**cell.config["filter"]["kwargs"], **cell.traffic.get("kwargs", {})}
    return name, lambda clip: fn(clip, **kwargs), kwargs


def run(cell: harness.Cell, call=None) -> harness.Outcome:
    """One run; ``call`` replaces the entry (the tests break it there)."""
    import sangnom_tpu_torch as snt

    t_imported = time.perf_counter()
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tff = cfg["field_order"] == "tff"
    gen = inputs.generator(cell.seed, dev)
    sources = [inputs.frames(cfg, tr["frames"], gen, dev) for _ in range(tr["clips"])]
    sync()
    t_inputs = time.perf_counter()
    clips = [snt.Clip(p, cfg["format"], tff=tff) for p in sources]
    name, entry, kwargs = entry_of(cell)
    call = call or entry
    for _ in range(2):
        for c in clips:
            frames_out = call(c).num_frames
            sync()
    if cell.trace:  # the profiler's own first start, outside the window
        prof = trace.profiler()
        call(clips[0])
        sync()
        prof.stop()
    setup_s = time.perf_counter() - cell.t0

    rng = random.Random(cell.seed)
    k = tr["sample_calls"]
    samples: list = []  # (clip index, output) by reservoir sampling
    call_s, quiet_call_s, issue_s = [], [], []
    prof, stopped, n_traced = None, False, 0
    start = time.perf_counter()
    t_from, t_to = start + TRACE_FROM * cell.seconds, None
    i = 0
    while True:
        ci = i % len(clips)
        if cell.trace and prof is None and time.perf_counter() >= t_from:
            prof = trace.profiler()
            t_to = time.perf_counter() + min(TRACE_SECONDS, cell.seconds / 2)
        traced = prof is not None and not stopped
        if traced:
            with trace.mark("call"):
                t0 = time.perf_counter()
                out = call(clips[ci])
            with trace.mark("sync"):
                sync()
            n_traced += 1
        else:
            t0 = time.perf_counter()
            out = call(clips[ci])
            issue_s.append(time.perf_counter() - t0)
            sync()
        t2 = time.perf_counter()
        call_s.append(t2 - t0)
        if not traced:
            quiet_call_s.append(t2 - t0)
        if len(samples) < k:
            samples.append((ci, out))
        elif (j := rng.randrange(i + 1)) < k:
            samples[j] = (ci, out)
        del out
        i += 1
        if prof is not None and not stopped and (t2 >= t_to or t2 >= start + cell.seconds):
            prof.stop()
            stopped = True
        if t2 >= start + cell.seconds:
            break
    window_s = t2 - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    # where set-up went: imports; the device's context and the inputs; the
    # warm calls, which load the kernel library (and build it, in a
    # checkout's first run)
    parts = {"imports": t_imported - cell.t0, "context_inputs": t_inputs - t_imported,
             "warm_calls": setup_s - (t_inputs - cell.t0)}
    obs = {"setup_s": setup_s, "setup_parts": parts, "window_s": window_s,
           "frames": frames_out * len(call_s),
           "call_s": call_s, "quiet_call_s": quiet_call_s, "issue_s": issue_s,
           "work": harness.work(tr["work"]).call_work(cfg, tr)}
    red = trace.reduce(trace.events(prof)) if prof is not None else None
    if red:
        red["calls"] = n_traced
        red["frames"] = n_traced * frames_out
        obs["trace"] = red

    del clips
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    px = parity = failed = 0
    refs: dict = {}
    bits = cfg["bits"]
    for ci, got in samples:
        if ci not in refs:
            refs[ci] = reference.run(name, sources[ci], bits, tff, kwargs)
        want_planes, want_parity = refs[ci]
        bad = mismatches(got.planes, want_planes)
        pbad = sum(a != b for a, b in zip(got.parity_array().tolist(), want_parity))
        pbad += abs(got.num_frames - len(want_parity))
        px, parity, failed = px + bad, parity + pbad, failed + bool(bad or pbad)
    checks = [("px_mismatch", px, 0), ("parity_mismatch", parity, 0),
              ("calls_unjudged", k - len(samples), 0)]
    return harness.Outcome(obs=obs, checks=checks, attempted=len(call_s),
                           failed=failed, memory_peak_bytes=peak, kind=kind)


def mismatches(got, want) -> int:
    """Samples that differ over all planes; a plane of the wrong shape or
    dtype counts all its samples.  Compared in int32: the card has no
    uint16 comparison."""
    bad = abs(len(got) - len(want))
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            bad += b.numel()
        else:
            bad += int((a.to(b.device, torch.int32) != b.to(torch.int32)).sum())
    return bad
