"""Double-rate bob deinterlace of interlaced content: every field becomes a
full frame (2N output frames), fields sequenced by stream dominance.

    python -m sangnom_tpu_torch.examples.bob_double_rate interlaced.y4m progressive2x.y4m
"""

import argparse

from sangnom_tpu_torch import bob
from sangnom_tpu_torch.io import read_y4m, write_y4m


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    clip = read_y4m(args.input, device=args.device)
    out = bob(clip)  # SeparateFields -> DoubleWeave -> SangNom2(order=0)
    fps = clip.props.get("y4m_fps", (25, 1))
    write_y4m(args.output, out, fps=(fps[0] * 2, fps[1]))
    print(f"{clip.num_frames} -> {out.num_frames} frames (double rate)")


if __name__ == "__main__":
    main()
