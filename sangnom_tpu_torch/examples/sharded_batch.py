"""Shard a frame batch over a device mesh.

The mesh is built from ``--device``: ``cuda`` takes every card (frames
over 'data'), ``cuda:N`` or ``cpu`` one device.  The 'data' axis spreads
frames across devices with zero communication; the optional 'space' axis
splits plane width with halo exchange (parallel.sangnom2_sharded).

    python -m sangnom_tpu_torch.examples.sharded_batch [--out out.y4m]
"""

import argparse

import numpy as np
import torch

from sangnom_tpu_torch import Clip
from sangnom_tpu_torch.io import write_y4m
from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the output as y4m")
    args = p.parse_args(argv)
    if args.device == "cuda":
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = [args.device]
    mesh = default_mesh(devices=devices)
    print(f"mesh: {mesh.shape} over {len(devices)} device(s)")

    rng = np.random.default_rng(0)
    planes = [
        rng.integers(0, 256, (8, 540, 1920)).astype(np.uint8),
        rng.integers(0, 256, (8, 270, 960)).astype(np.uint8),
        rng.integers(0, 256, (8, 270, 960)).astype(np.uint8),
    ]
    clip = Clip.from_numpy(planes, "YUV420P8", device=devices[0])
    out = sangnom2_sharded(clip, mesh, order=1, dh=True)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    print(f"deinterlaced {out.num_frames} frames -> {out.width}x{out.height}")
    if args.out:
        write_y4m(args.out, out)
    return out


if __name__ == "__main__":
    main()
