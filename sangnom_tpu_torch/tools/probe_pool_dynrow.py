"""Dynamic-row probe: three clamped rows of a whole kept plane per step.

    python -m sangnom_tpu_torch.tools.probe_pool_dynrow

The fused pool walk reads kept rows (t, t+1, t+2) at step t, clamped at the
last row.  ``dynrow`` computes, for t in 0..steps-1,

    out[t, 0] = 3*kept[min(t, H-1)] + 5*kept[min(t+1, H-1)] + 7*kept[min(t+2, H-1)]

in int32 from a u8 or i32 plane [H, S].  On a CUDA tensor it launches
``csrc/probes.cu::dynrow_kernel``, parallel over output rows and 16-byte
column groups: a thread computes its clamped row indices, loads the rows it
needs and writes a few output rows (``probe_kernel.dynrow_plan``;
``probe_kernel.LAUNCHES["dynrow"]``); on a CPU tensor it runs
``dynrow_plain``, clamped gathers.  ``steps > H`` is the point of the
probe: the clamp repeats the last row.
"""

from __future__ import annotations

import numpy as np
import torch

from sangnom_tpu_torch.tools import probe_kernel


def dynrow_plain(kept: torch.Tensor, steps: int) -> torch.Tensor:
    """[H, S] u8/i32 -> [steps, 1, S] int32, by clamped row gathers."""
    H = kept.shape[0]
    k = kept.to(torch.int32)
    t = torch.arange(steps, device=kept.device)
    rows = [k[torch.clamp(t + d, max=H - 1)] for d in range(3)]
    return (rows[0] * 3 + rows[1] * 5 + rows[2] * 7)[:, None, :]


def dynrow(kept: torch.Tensor, steps: int) -> torch.Tensor:
    """[H, S] u8/i32 -> [steps, 1, S] int32: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if kept.device.type == "cpu":
        return dynrow_plain(kept, steps)
    return probe_kernel.dynrow(kept, steps)


def probe_input(dtype, H: int = 64, S: int = 256) -> np.ndarray:
    """The probe's plane: seed 0, values 0..199."""
    return np.random.default_rng(0).integers(0, 200, (H, S)).astype(dtype)


def run(dtype, H: int = 64, S: int = 256, steps: int = 70,
        device: str = "cuda") -> bool:
    """Run the probe on ``device`` and hold it against the numpy formula;
    prints one line and returns whether they agree."""
    kept = probe_input(dtype, H, S)
    got = dynrow(torch.from_numpy(kept).to(device), steps)[:, 0].cpu().numpy()
    k = kept.astype(np.int64)
    want = np.stack([
        k[min(t, H - 1)] * 3 + k[min(t + 1, H - 1)] * 5 + k[min(t + 2, H - 1)] * 7
        for t in range(steps)
    ])
    ok = np.array_equal(got, want)
    print(f"{np.dtype(dtype).name}: {'OK' if ok else 'MISMATCH'}")
    return ok


def main() -> int:
    print(f"device: {torch.cuda.get_device_name(0)}")
    ok = all([run(dt) for dt in (np.int32, np.uint8)])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
