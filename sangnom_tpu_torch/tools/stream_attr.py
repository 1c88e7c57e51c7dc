"""Stage attribution of the CLI's windowed pipeline, in process.

    python -m sangnom_tpu_torch.tools.stream_attr [frames] [WxH] [window] [--device cuda|cpu]

Times each host stage of the windowed ``--dh`` pipeline alone: read and
parse with the upload (``iter_y4m``), parse alone, the filter on the device,
the fetch to the host and y4m serialization; each stage ends with
``torch.cuda.synchronize()`` on the card.  Then it runs ``cli.main`` on the
same stream with ``--no-overlap-write`` and with ``--overlap-write`` and
asserts that the two outputs are byte-identical.  The stage rates bound what
a pipelined host can reach (the slowest stage, fetch and serialize sharing
the writer thread); the end-to-end arms say what it does reach.  Prints one
JSON line: frames, geometry, window, device and the eight rates in frames/s.
Defaults: 96 frames, 1920x1080 YUV420P8, window 24, the card.
"""

from __future__ import annotations

import io
import json
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class _Std:
    """A stand-in for sys.stdin / sys.stdout: the CLI reads ``.buffer``."""

    def __init__(self, buf):
        self.buffer = buf


def main(argv: list[str] | None = None) -> dict:
    from sangnom_tpu_torch import Clip, cli, get_format, sangnom2
    from sangnom_tpu_torch.io import iter_y4m, write_y4m, write_y4m_frames
    from sangnom_tpu_torch.io.y4m import _parse_header, _read_frame_block

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    frames = int(argv[0]) if len(argv) > 0 else 96
    W, H = (int(x) for x in (argv[1] if len(argv) > 1 else "1920x1080").split("x"))
    window = int(argv[2]) if len(argv) > 2 else 24
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(11)
    planes = [rng.integers(0, 256, (frames, ph, pw)).astype(np.uint8)
              for ph, pw in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    src = io.BytesIO()
    write_y4m(src, Clip.from_numpy(planes, fmt, device="cpu"), fps=(30, 1))
    stream = src.getvalue()
    del planes, src
    log(f"stream: {frames} frames {W}x{H} = {len(stream) / 2**20:.0f} MiB on {device}")

    kwargs = dict(order=1, aa=48, dh=True)
    res = {"frames": frames, "geometry": f"{W}x{H}", "window": window,
           "device": torch.cuda.get_device_name(0) if on_card else "cpu"}

    t0 = time.perf_counter()
    ws = list(iter_y4m(io.BytesIO(stream), window, device=device))
    sync()
    res["read_upload_fps"] = frames / (time.perf_counter() - t0)
    log(f"read+parse+upload: {res['read_upload_fps']:.0f} fps")

    fh = io.BytesIO(stream)
    t0 = time.perf_counter()
    parsed = _read_frame_block(fh, _parse_header(fh), None)
    res["read_parse_only_fps"] = parsed[0].shape[0] / (time.perf_counter() - t0)
    del parsed
    log(f"read+parse only:   {res['read_parse_only_fps']:.0f} fps")

    outs = [sangnom2(w, **kwargs) for w in ws]  # warm-up (the kernel build included)
    sync()
    t0 = time.perf_counter()
    outs = [sangnom2(w, **kwargs) for w in ws]
    sync()
    res["device_fps"] = frames / (time.perf_counter() - t0)
    log(f"device compute:    {res['device_fps']:.0f} fps")

    t0 = time.perf_counter()
    fetched = [[p.cpu().numpy() for p in o.planes] for o in outs]
    res["fetch_fps"] = frames / (time.perf_counter() - t0)
    log(f"device fetch:      {res['fetch_fps']:.0f} fps")

    null = io.BytesIO()
    hostclips = [Clip.from_numpy(f, outs[0].format, device="cpu") for f in fetched]
    del outs, fetched, ws
    t0 = time.perf_counter()
    for hc in hostclips:
        write_y4m_frames(null, hc)
    res["serialize_fps"] = frames / (time.perf_counter() - t0)
    del hostclips, null
    log(f"y4m serialize:     {res['serialize_fps']:.0f} fps")

    res["pipeline_bound_fps"] = min(
        res["read_upload_fps"], res["device_fps"],
        1.0 / (1.0 / res["fetch_fps"] + 1.0 / res["serialize_fps"]))
    log(f"=> pipelined bound (slowest stage, fetch+serialize on one thread): "
        f"{res['pipeline_bound_fps']:.0f} fps")

    outs_bytes = {}
    old_in, old_out = sys.stdin, sys.stdout
    for tag, flag in (("serial", "--no-overlap-write"), ("overlap", "--overlap-write")):
        dst = io.BytesIO()
        sys.stdin, sys.stdout = _Std(io.BytesIO(stream)), _Std(dst)
        try:
            t0 = time.perf_counter()
            rc = cli.main(["-", "-", "--dh", "--window", str(window), flag,
                           "--device", device])
            dt = time.perf_counter() - t0
        finally:
            sys.stdin, sys.stdout = old_in, old_out
        if rc != 0:
            raise RuntimeError(f"cli.main {flag} exited {rc}")
        outs_bytes[tag] = dst.getvalue()
        res[f"e2e_{tag}_fps"] = frames / dt
        log(f"end-to-end {tag}: {res[f'e2e_{tag}_fps']:.0f} fps")
    if outs_bytes["serial"] != outs_bytes["overlap"]:
        raise AssertionError("overlap output is not byte-identical to the serial output")
    log("byte-identity serial == overlap: OK")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
