"""Named scopes for the pipeline stages.

Usage:
    with torch.profiler.profile(...) as prof:
        out = sangnom2(clip)

`stage_scope` is applied inside the ops, so kernels and the surrounding
tensor glue are attributable in the profiler's trace.
"""

from __future__ import annotations

import torch


def stage_scope(name: str):
    """A named range for one pipeline stage (shows up in torch.profiler)."""
    return torch.profiler.record_function(f"sangnom/{name}")
