"""Streaming soak: a long clip through the CLI whole and with ``--window``,
byte-identical output, and the peak RSS of each run.

    python -m sangnom_tpu_torch.tools.stream_soak [frames] [window] [bob|plain] [WxH] [--device cuda|cpu]

Writes a synthetic YUV420P8 y4m (seed 42; 640x480 unless WxH is given),
runs ``python -m sangnom_tpu_torch`` on it whole and with ``--window W``
(``--order 1``, or ``--bob`` when the third argument is ``bob``), each in a
child process that reports its peak RSS, and compares the two outputs in
chunks.  Defaults: 480 frames, window 32, the card.  Exits 1 if a run fails
or the outputs differ.
"""

from __future__ import annotations

import filecmp
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# runs the CLI as a grandchild, so the peak RSS is the CLI's alone
_RSS_WRAPPER = ("import resource, subprocess, sys; rc = subprocess.call(sys.argv[1:]); "
                "ru = resource.getrusage(resource.RUSAGE_CHILDREN); "
                "print(f'PEAK_RSS_MB={ru.ru_maxrss / 1024:.0f}'); sys.exit(rc)")


def main(argv: list[str] | None = None) -> int:
    from sangnom_tpu_torch.core.clip import Clip
    from sangnom_tpu_torch.io import write_y4m

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    frames = int(argv[0]) if len(argv) > 0 else 480
    window = int(argv[1]) if len(argv) > 1 else 32
    use_bob = len(argv) > 2 and argv[2] == "bob"
    w, h = (int(x) for x in (argv[3] if len(argv) > 3 else "640x480").split("x"))

    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    rng = np.random.default_rng(42)
    with tempfile.TemporaryDirectory(prefix="sangnom_soak_") as tmp:
        src = os.path.join(tmp, "in.y4m")
        planes = [rng.integers(0, 256, (frames, ph, pw)).astype(np.uint8)
                  for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        write_y4m(src, Clip.from_numpy(planes, "YUV420P8", device="cpu"))
        del planes
        outs = {}
        for name, extra in (("whole", []), ("windowed", ["--window", str(window)])):
            dst = os.path.join(tmp, f"{name}.y4m")
            outs[name] = dst
            mode = ["--bob"] if use_bob else ["--order", "1"]
            cmd = [sys.executable, "-m", "sangnom_tpu_torch", src, dst, "--aa", "48",
                   "--device", device] + mode + extra
            r = subprocess.run([sys.executable, "-c", _RSS_WRAPPER] + cmd,
                               capture_output=True, text=True, env=env, timeout=7200)
            if r.returncode != 0:
                print(f"{name} run exited {r.returncode}:\n{r.stderr[-2000:]}")
                return 1
            rss = [ln for ln in r.stdout.splitlines() if "PEAK_RSS" in ln]
            note = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ""
            print(f"{name}: {rss[0] if rss else '?'}  ({note})", flush=True)
        # chunked compare: the soak proves bounded memory, so it does not
        # hold both outputs in RAM to check them
        same = filecmp.cmp(outs["whole"], outs["windowed"], shallow=False)
        size = os.path.getsize(outs["whole"])
    print(f"byte-identical: {same}  ({size / 1e6:.0f} MB output)")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
