"""Profiling helpers: named scopes for the pipeline stages and a trace
context.

Usage:
    with profile_trace("/tmp/sangnom-trace"):   # a Chrome trace file
        out = sangnom2(clip)

`stage_scope` is applied inside the ops, so kernels and the surrounding
tensor glue are attributable in the profiler's trace.
"""

from __future__ import annotations

import contextlib
import os

import torch


def stage_scope(name: str):
    """A named range for one pipeline stage (shows up in torch.profiler)."""
    return torch.profiler.record_function(f"sangnom/{name}")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the context (the
    CPU, and the card's kernels where the process has one); on exit, write
    it into ``log_dir`` as a Chrome trace (``trace-<pid>.json``, readable by
    Perfetto or chrome://tracing).  Yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
