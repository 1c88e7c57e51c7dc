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
    """[n, h, w] planes of ``n`` frames of the configuration (8-bit samples)."""
    top = 1 << config["bits"]
    return [torch.randint(0, top, (n, h, w), generator=gen, device=device,
                          dtype=torch.uint8)
            for w, h in planes_of(config)]
