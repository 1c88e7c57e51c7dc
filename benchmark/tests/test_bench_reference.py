"""The benchmark's reference against the port's plain path (opt=0), bit
for bit, at small sizes: the bob, order 1 and 2, the shared pool, aligned
and unaligned widths, both field orders.  (The test may import the port;
the reference does not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sangnom_tpu_torch as snt
from benchmark import reference

CASES = [("bob", {}), ("bob", {"pool_compat": True}), ("sangnom2", {"order": 1}),
         ("sangnom2", {"order": 2}), ("sangnom2", {"order": 1, "pool_compat": True})]
SIZES = [(3, 16, 64), (2, 24, 60), (2, 20, 1912 // 8), (1, 12, 40)]


def _planes(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (n, h // s, w // s), dtype=np.uint8))
            for s in (1, 2, 2)]


@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("entry,kwargs", CASES, ids=lambda c: str(c))
def test_reference_matches_plain_path(entry, kwargs, size, tff):
    n, h, w = size
    planes = _planes(sum(size), n, h, w)
    args = {"aa": 48, "aac": 0, **kwargs}
    got = getattr(snt, entry)(snt.Clip(planes, "YUV420P8", tff=tff), opt=0, **args)
    want, parity = reference.run(entry, planes, 8, tff, args)
    assert len(got.planes) == len(want)
    for a, b in zip(got.planes, want):
        assert torch.equal(a, b)
    assert got.parity_array().tolist() == parity


@pytest.mark.parametrize("aa,aac", [(0, 0), (48, 48), (128, 7)])
def test_reference_thresholds(aa, aac):
    planes = _planes(aa + aac, 2, 16, 64)
    got = snt.bob(snt.Clip(planes, "YUV420P8"), aa=aa, aac=aac, opt=0)
    want, _ = reference.run("bob", planes, 8, True, {"aa": aa, "aac": aac})
    assert all(torch.equal(a, b) for a, b in zip(got.planes, want))


def test_reference_rejects_what_it_does_not_compute():
    planes = _planes(0, 1, 8, 32)
    with pytest.raises(ValueError):
        reference.run("sangnom2", planes, 8, True, {"order": 0})
    with pytest.raises(ValueError):
        reference.run("bob", planes, 8, True, {"dh": True})
