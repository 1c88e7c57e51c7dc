"""Reproduce a LIVE reference build bit-for-bit: the two compat axes.

The AviSynth reference has two behaviors this framework deliberately
cleans up by default (docs/PARITY.md):

  * its shared buffer pool carries stale smoothed data across plane/frame
    passes (observable on subsampled chroma)        -> pool_compat=True
  * its SSE2 path computes DIFFERENT numerics than its C path at integer
    extremes (the contract silently rides CPU dispatch) -> numerics="sse2"

Composing both replicates exactly what a stock reference build (opt=-1 on
an SSE2 machine) produces.

    python -m sangnom_tpu_torch.examples.reference_compat in.y4m out.y4m
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

    # exactly what AviSynth's SangNom2(order=1) emits on an SSE2 host
    out = sangnom2(clip, order=1, aa=48, pool_compat=True, numerics="sse2")

    # the framework's default: same filter, zero-defined scratch, C numerics,
    # frame-parallel (pool_compat forces sequential frames)
    clean = sangnom2(clip, order=1, aa=48)

    write_y4m(args.output, out)
    ndiff = sum(int((a != b).sum()) for a, b in zip(out.planes, clean.planes))
    print(f"wrote {out.width}x{out.height}; "
          f"{ndiff} samples differ between compat and default contracts")


if __name__ == "__main__":
    main()
