"""Tiny cells for the benchmark's own tests: each traffic mix under
`benchmark/workloads/` with its frames cut to a size the CPU runs in a
second."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness

TINY = {"width": 64, "height": 32}
CELLS = sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json"))


def tiny_cell(name: str, seconds: float = 0.5, trace: bool = False,
              device: str = "cpu", seed: int = 2**31 + 17, **size) -> harness.Cell:
    config, traffic = harness.cell_files(name)
    config = dict(config, **(size or TINY))
    traffic = dict(traffic)
    if "frames" in traffic:
        traffic["frames"] = 3
    if traffic["driver"] == "cli_stream":
        traffic.update(warmup_frames=16, distinct_frames=4, sample_every=4)
    return harness.Cell(name=name, config=config, traffic=traffic, seed=seed,
                        seconds=seconds, trace=trace, t0=time.perf_counter(),
                        device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return "cuda"
