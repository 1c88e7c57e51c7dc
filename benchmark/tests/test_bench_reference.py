"""The benchmark's reference against the port's plain path (opt=0), bit
for bit, at small sizes: the bob, order 1 and 2, the shared pool, aligned
and unaligned widths, both field orders; beyond 8 bits against the native
oracle too.  (The test may import the port; the reference does not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import sangnom_tpu_torch as snt
from benchmark import reference
from sangnom_tpu_torch import oracle

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


# --- samples deeper than 8 bits -------------------------------------------

DEEP_FORMATS = ["YUV420P10", "YUV422P10", "YUV422P12", "YUV420P16"]
DEEP_WIDTHS = [64, 60]  # a whole stride, and one that leaves padding columns


def _deep_planes(fmt, seed, n, h, w):
    """[n, h, w] uint16 planes of ``fmt``, uniform over its depth."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 1 << fmt.bits, (n, *reversed(fmt.plane_dims(w, h, i))),
                                          dtype=np.uint16))
            for i in range(3)]


def _oracle(entry, clip, aa, aac, order=0, pool_compat=False):
    """The native oracle (the plugin's C path in C++) over ``clip``; the bob
    as the port's SeparateFields -> DoubleWeave, then order 0."""
    if entry == "bob":
        clip = snt.double_weave(snt.separate_fields(clip))
    frames = [[p[f].numpy() for p in clip.planes] for f in range(clip.num_frames)]
    out = oracle.sangnom2_clip_oracle(frames, clip.format, order, aa, aac,
                                      parities=clip.parity_array().tolist(),
                                      pool_compat=pool_compat)
    return [torch.from_numpy(np.stack([fr[i] for fr in out])) for i in range(3)]


# At (0, 0) every pixel whose least error is above 0 takes the vertical
# average, which never wraps: those cases hold the dtype path, not the wrap.
@pytest.mark.parametrize("aa,aac", [(0, 0), (48, 48), (128, 7)])
@pytest.mark.parametrize("w", DEEP_WIDTHS)
@pytest.mark.parametrize("entry,kwargs", CASES, ids=lambda c: str(c))
@pytest.mark.parametrize("name", DEEP_FORMATS)
def test_reference_matches_oracle_and_plain_path_deeper_than_8_bits(name, entry, kwargs, w, aa, aac):
    """At 9-16 bits the C path wraps its predictors, averages and smoothing
    at 16 bits, the pixel type, not at the depth: the reference agrees with
    the oracle and with the port's plain path in every sample."""
    fmt = snt.get_format(name)
    planes = _deep_planes(fmt, [fmt.bits, w, aa, aac], 2, 24, w)
    clip = snt.Clip(planes, fmt)
    args = {"aa": aa, "aac": aac, **kwargs}
    want, parity = reference.run(entry, planes, fmt.bits, True, args)
    plain = getattr(snt, entry)(clip, opt=0, **args)
    order = kwargs.get("order", 0)
    native = _oracle(entry, clip, aa, aac, order, kwargs.get("pool_compat", False))
    assert [p.dtype for p in want] == [torch.uint16] * 3
    for a, b, c in zip(want, plain.planes, native):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert plain.parity_array().tolist() == parity


def test_storage_mask_is_the_pixel_types():
    from benchmark.reference import sangnom

    assert [sangnom.storage_mask(b) for b in (8, 10, 12, 14, 16)] == [0xFF] + [0xFFFF] * 4
    assert [sangnom.decay_rows(m) for m in (0xFF, 0xFFFF)] == [7, 14]
    with pytest.raises(ValueError):
        reference.run("bob", _planes(0, 1, 8, 32), 32, True, {})
