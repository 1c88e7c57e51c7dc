"""The plain reference the benchmark judges the program by.

`run` maps a cell's entry and keyword arguments to the reference's
function; it imports neither JAX nor anything of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import sangnom


def run(entry: str, planes, bits: int, tff: bool, kwargs: dict):
    """The reference's (planes, per-frame parity) for ``entry(clip,
    **kwargs)`` on a clip of ``planes`` ([N, h, w] tensors of the storage
    dtype) whose samples have ``bits`` bits and whose field order is
    ``tff``.  It works in int32 and returns planes of the input's dtype."""
    out, parity = _run(entry, [p.to(torch.int32) for p in planes], bits, tff, kwargs)
    return [o.to(p.dtype) for o, p in zip(out, planes)], parity


def _run(entry: str, planes, bits: int, tff: bool, kwargs: dict):
    if not 8 <= bits <= 16:
        raise ValueError(f"reference: integer samples of 8-16 bits only, not {bits}")
    kw = dict(kwargs)
    aa, aac = kw.pop("aa", 48), kw.pop("aac", 0)
    pool = kw.pop("pool_compat", False)
    if entry == "bob":
        if kw:
            raise ValueError(f"reference bob: unsupported arguments {sorted(kw)}")
        fn = sangnom.bob_pool if pool else sangnom.bob
        return fn(planes, bits, tff, aa, aac)
    if entry == "sangnom2":
        order = kw.pop("order", 1)
        if kw or order not in (1, 2):
            raise ValueError(f"reference sangnom2: unsupported arguments {kwargs}")
        n = planes[0].shape[0]
        offsets = [order - 1] * n
        fn = sangnom.sangnom2_pool if pool else sangnom.sangnom2
        return fn(planes, bits, offsets, aa, aac), [tff] * n
    raise ValueError(f"reference: no entry {entry!r}")
