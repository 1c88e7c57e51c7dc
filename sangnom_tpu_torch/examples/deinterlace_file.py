"""Deinterlace a .y4m file — the simplest end-to-end use.

    python -m sangnom_tpu_torch.examples.deinterlace_file in.y4m out.y4m
"""

import argparse

from sangnom_tpu_torch import sangnom2
from sangnom_tpu_torch.io import read_y4m, write_y4m


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    clip = read_y4m(args.input, device=args.device)
    out = sangnom2(clip, order=1, aa=48)  # keep top field, default strength
    write_y4m(args.output, out)
    print(f"{clip.num_frames} frames {clip.width}x{clip.height} done")


if __name__ == "__main__":
    main()
