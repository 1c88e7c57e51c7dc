"""Classic SangNom2 anti-aliasing recipe: supersample vertically with
dh=True, then downscale externally (or keep the doubled height).

The dh mode treats every source line as a kept field line and synthesizes
the in-between lines edge-directedly — the standard AA building block
(reference README.md:33-37).

    python -m sangnom_tpu_torch.examples.antialias_2x in.y4m out2x.y4m
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
    out = sangnom2(clip, dh=True, aa=48, aac=0)
    write_y4m(args.output, out)
    print(f"AA-supersampled to {out.width}x{out.height}")


if __name__ == "__main__":
    main()
