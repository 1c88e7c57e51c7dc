"""A stand-in for the CLI's process that filters nothing: it reads the y4m
stream on standard input and writes each input frame's bytes as the
output frames the filter would make (two for --bob), under the header the
filter would write.  It measures what the stream cell's feeder and drainer
sustain alone, and, as a program whose step returns its input unchanged,
it is a fault the stream cell has to catch.

    python3 benchmark/tests/copy_child.py --result-fd W -- - - [--bob] [...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--result-fd", type=int, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("cli", nargs=argparse.REMAINDER)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    rate = 2 if "--bob" in args.cli else 1
    fin, fout = sys.stdin.fileno(), sys.stdout.fileno()
    line = b""
    while not line.endswith(b"\n"):
        line += os.read(fin, 1)
    head = line.decode().split()
    size = {t[0]: t[1:] for t in head[1:]}
    w, h = int(size["W"]), int(size["H"])
    num, den = size["F"].split(":")
    os.write(fout, f"YUV4MPEG2 W{w} H{h} F{int(num) * rate}:{den} Ip A{size['A']} "
             f"C{size['C']}\n".encode())
    rec = memoryview(bytearray(6 + w * h * 3 // 2))
    frames = 0
    while True:
        have = 0
        while have < len(rec):
            k = os.readv(fin, [rec[have:]])
            if not k:
                break
            have += k
        if have < len(rec):
            break
        for _ in range(rate):
            out = rec
            while out:
                out = out[os.write(fout, out):]
        frames += 1
    with open(args.result_fd, "w") as f:
        json.dump({"rc": 0, "memory_peak_bytes": 0, "kind": "copy", "trace": None,
                   "banned": []}, f)
    print(f"copy child: {frames} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
