"""Inputs made from the seed: uniform random samples, a plane at a time in
one call each.  The filter has no branch whose work depends on the samples
(every pixel takes the same prepare, smoothing and select), so uniform
noise times it as any content would, and it reaches every select
direction and the wrap of the predictors."""

from __future__ import annotations

import torch

from benchmark.work import planes_of


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def frames(config: dict, n: int, gen: torch.Generator, device) -> list[torch.Tensor]:
    """[n, h, w] planes of ``n`` frames of the configuration, uniform in
    [0, 2^bits) and in the storage dtype: uint8 at 8 bits, uint16 at 9-16
    (drawn in int32, which torch's uint16 cannot be drawn in)."""
    bits = config["bits"]
    if not 8 <= bits <= 16:
        raise ValueError(f"inputs: integer samples of 8-16 bits only, not {bits}")
    draw, store = (torch.uint8, torch.uint8) if bits == 8 else (torch.int32, torch.uint16)
    return [torch.randint(0, 1 << bits, (n, h, w), generator=gen, device=device,
                          dtype=draw).to(store)
            for w, h in planes_of(config)]
