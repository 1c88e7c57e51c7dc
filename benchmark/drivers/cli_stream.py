"""The program's CLI in a process of its own, fed a y4m stream on standard
input and drained of its standard output, nothing on disk.

Traffic parameters: ``distinct_frames`` (seed-made interlaced frames, held
in memory and fed in a cycle), ``cli_args`` (after ``- -``),
``warmup_frames`` (output frames before the window opens),
``sample_every`` (on average one output frame in this many is kept and
judged, drawn from the seed; the last frame always is).

A feeder thread writes the header and then whole frame records; a drainer
thread reads whole output records and opens the window at
``warmup_frames``, closes it ``seconds`` later, and reads the CLI
process's CPU time at both ends.  Then the feeder stops after its current
frame, closes the CLI's standard input, and the rest of the stream is
drained; every output frame is counted and its marker checked.
"""

from __future__ import annotations

import fcntl
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import harness, inputs, reference

# The traced stretch: from this share of the window, at most TRACE_SECONDS.
TRACE_FROM = 0.25
TRACE_SECONDS = 2.0
PIPE_BYTES = 1 << 20
# Seconds the CLI may take to deliver its warm-up frames (a first run in a
# checkout builds the kernel library), and to close the window once open.
SETUP_LIMIT = 600
WINDOW_SLACK = 60


def _cpu_s(pid: int) -> float:
    """User plus system CPU seconds of process ``pid``, all its threads."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _widen(fd: int) -> None:
    """A 1 MiB pipe buffer (the default 64 KiB wakes each side 50 times a
    frame); kept at the default where the system refuses."""
    try:
        fcntl.fcntl(fd, 1031, PIPE_BYTES)  # F_SETPIPE_SZ
    except OSError:
        pass


def _fill(f, mv: memoryview) -> int:
    """Bytes of the stream ``f`` read into ``mv``: all of it, or fewer at
    its end."""
    have = 0
    while have < len(mv):
        k = f.readinto(mv[have:])
        if not k:
            break
        have += k
    return have


def header(config: dict, rate: int = 1, interlace: str | None = None) -> bytes:
    num, den = config["fps"]
    il = interlace or ("t" if config["field_order"] == "tff" else "b")
    return (f"YUV4MPEG2 W{config['width']} H{config['height']} F{num * rate}:{den} "
            f"I{il} A1:1 C{config['y4m_colorspace']}\n").encode()


def rate_of(config: dict) -> int:
    """Output frames an input frame gives: two for the bob."""
    return 2 if config["filter"]["entry"] == "bob" else 1


def run(cell: harness.Cell, child_argv: list[str] | None = None) -> harness.Outcome:
    """One run; ``child_argv`` replaces the CLI's command (the tests break
    the program there)."""
    cfg, tr = cell.config, cell.traffic
    n = tr["distinct_frames"]
    src = inputs.frames(cfg, n, inputs.generator(cell.seed, "cpu"), "cpu")
    records = [b"FRAME\n" + b"".join(p[i].numpy().tobytes() for p in src) for i in range(n)]
    frame_bytes = len(records[0]) - 6

    res_r, res_w = os.pipe()
    argv = child_argv or [sys.executable, "-m", "benchmark.drivers.cli_child"]
    argv = [*argv, "--result-fd", str(res_w), "--trace", str(int(cell.trace)), "--",
            "-", "-", *tr["cli_args"], "--device", cell.device]
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            pass_fds=(res_w,))
    os.close(res_w)
    _widen(proc.stdin.fileno())
    _widen(proc.stdout.fileno())

    stop = threading.Event()
    fed = [0]
    result: dict = {}

    def feed():
        try:
            proc.stdin.write(header(cfg))
            while not stop.is_set():
                proc.stdin.write(records[fed[0] % n])
                fed[0] += 1
        except BrokenPipeError:
            pass
        finally:
            try:
                proc.stdin.close()
            except BrokenPipeError:
                pass

    rng = random.Random(cell.seed)
    win = {"open": None, "close": None}
    closed = threading.Event()
    got: dict = {"header": b"", "frames": 0, "bad_markers": 0, "samples": {}, "last": None}

    def drain():
        got["header"] = proc.stdout.readline()
        mv = memoryview(bytearray(6 + frame_bytes))
        sent = ""
        while True:
            have = _fill(proc.stdout, mv)
            if have < len(mv):
                if have:
                    got["truncated"] = have
                break
            k = got["frames"]
            now = time.perf_counter()
            got["frames"] = k + 1
            got["bad_markers"] += mv[:6] != b"FRAME\n"
            if rng.random() * tr["sample_every"] < 1:
                got["samples"][k] = bytes(mv[6:])
            if win["open"] is None and k + 1 >= tr["warmup_frames"]:
                win["open"] = (now, k + 1, _cpu_s(proc.pid))
            elif win["open"] and win["close"] is None:
                t_open = win["open"][0]
                if cell.trace and not sent and now >= t_open + TRACE_FROM * cell.seconds:
                    os.kill(proc.pid, signal.SIGUSR1)
                    sent, t_stop = "S", now + min(TRACE_SECONDS, cell.seconds / 2)
                elif sent == "S" and now >= t_stop:
                    os.kill(proc.pid, signal.SIGUSR2)
                    sent = "E"
                if now >= t_open + cell.seconds:
                    if sent == "S":
                        os.kill(proc.pid, signal.SIGUSR2)
                        sent = "E"
                    win["close"] = (now, k + 1, _cpu_s(proc.pid))
                    closed.set()
        if got["frames"] and "truncated" not in got:
            got["last"] = (got["frames"] - 1, bytes(mv[6:]))

    def collect():
        with open(res_r, "rb") as f:
            data = f.read()
        if data:
            result.update(json.loads(data))

    threads = [threading.Thread(target=f, name=f"bench-{f.__name__}", daemon=True)
               for f in (feed, drain, collect)]
    for t in threads:
        t.start()
    t_start = time.perf_counter()
    while not closed.wait(0.2):
        late = (win["open"][0] + cell.seconds + WINDOW_SLACK if win["open"]
                else t_start + SETUP_LIMIT)
        if proc.poll() is not None or time.perf_counter() > late:
            break
    stop.set()
    threads[0].join(WINDOW_SLACK)
    try:
        rc = proc.wait(WINDOW_SLACK)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    for t in threads[1:]:
        t.join(WINDOW_SLACK)
    if win["close"] is None:
        raise RuntimeError(f"the CLI delivered {got['frames']} frames and no full window "
                           f"(exit code {rc})")

    (t_open, k_open, cpu_open), (t_close, k_close, cpu_close) = win["open"], win["close"]
    obs = {"setup_s": t_open - cell.t0, "window_s": t_close - t_open,
           "stream_frames": k_close - k_open, "cpu_s": cpu_close - cpu_open}
    if result.get("trace"):
        obs["trace"] = result["trace"]

    # the reference over the distinct frames; output k is of input k // rate
    entry, rate = cfg["filter"]["entry"], rate_of(cfg)
    want, _ = reference.run(entry, [p.to(cell.device) for p in src], cfg["bits"],
                            cfg["field_order"] == "tff", cfg["filter"]["kwargs"])
    want = [np.concatenate([p[j].cpu().numpy().ravel() for p in want]) for j in range(rate * n)]
    judged = dict(got["samples"])
    if got["last"] is not None:
        judged[got["last"][0]] = got["last"][1]
    px = failed = 0
    for k, data in judged.items():
        bad = int(np.count_nonzero(np.frombuffer(data, np.uint8) != want[(k // rate) % n * rate + k % rate]))
        px, failed = px + bad, failed + bool(bad)
    missing = abs(got["frames"] - rate * fed[0]) + int("truncated" in got)
    checks = [
        ("header_mismatch", int(got["header"] != header(cfg, rate, "p")), 0),
        ("frames_missing", missing, 0),
        ("marker_errors", got["bad_markers"], 0),
        ("px_mismatch", px, 0),
        ("cli_exit_code", abs(rc), 0),
        ("child_banned_modules", len(result.get("banned", [])) if result else 1, 0),
    ]
    return harness.Outcome(obs=obs, checks=checks, attempted=got["frames"],
                           failed=failed + missing, memory_peak_bytes=result.get("memory_peak_bytes", 0),
                           kind=result.get("kind", "unknown"))
