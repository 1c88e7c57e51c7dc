"""Faults planted under the timed path, for the tests that see `correct`
come out false: a filter step that returns its input unchanged, half of a
call's frames left unfiltered, one output sample altered where it is made."""

from __future__ import annotations

import torch

import sangnom_tpu_torch as snt

FAULTS = ("unchanged", "half", "altered")


def unfiltered(clip, entry: str):
    """What the entry returns with its filter step skipped."""
    if entry == "bob":
        return snt.double_weave(snt.separate_fields(clip))
    return clip


def broken(fn, entry: str, fault: str):
    """``fn`` (the entry) with ``fault`` planted."""

    def call(clip, **kwargs):
        if fault == "unchanged":
            return unfiltered(clip, entry)
        out = fn(clip, **kwargs)
        if fault == "half":
            raw = unfiltered(clip, entry)
            h = out.num_frames // 2
            return out.with_planes([torch.cat([a[:h], b[h:]]) for a, b in zip(out.planes, raw.planes)])
        planes = [p.clone() for p in out.planes]
        last = planes[0][-1, -1, -1]
        last.copy_(last.to(torch.int32) ^ 1)  # in int32: the card has no uint16 xor
        return out.with_planes(planes)

    return call
