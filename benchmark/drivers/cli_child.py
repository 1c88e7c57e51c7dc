"""The program's CLI in this process, as a user runs it, plus what the
benchmark reads from inside: a profiler started and stopped on the parent's
word, the card's peak memory, and the modules loaded.

    python3 -m benchmark.drivers.cli_child --result-fd W [--trace 1] -- <CLI arguments>

With ``--trace 1`` a profiler runs from before the CLI starts until it
returns, and SIGUSR1 and SIGUSR2 mark the traced stretch's start and end
(host ranges, recorded on the main thread, the one that calls the filter).
Once the CLI returns, one JSON object goes to fd W.  File descriptor 1 is
pointed at standard error so that nothing but the CLI's stream reaches the
parent's pipe.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import signal


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.drivers.cli_child")
    p.add_argument("--result-fd", type=int, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("cli", nargs=argparse.REMAINDER)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    cli_args = args.cli[1:] if args.cli[:1] == ["--"] else args.cli

    stream = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = io.TextIOWrapper(open(stream, "wb"), write_through=True)

    import torch

    from benchmark import harness, trace
    from sangnom_tpu_torch import cli

    # Started before the CLI makes its threads and stopped after they end:
    # the signals only mark the stretch, as host ranges on the main thread.
    prof = trace.profiler() if args.trace else None

    def mark(signum, frame):
        with trace.mark("stretch"):
            pass

    signal.signal(signal.SIGUSR1, mark)
    signal.signal(signal.SIGUSR2, mark)
    rc = cli.main(cli_args)
    sys.stdout.flush()
    sys.stdout.close()
    if prof is not None:
        prof.stop()
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    result = {
        "rc": rc,
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "trace": trace.reduce(trace.events(prof)) if prof is not None else None,
        "banned": harness.banned_modules(),
    }
    with open(args.result_fd, "w") as f:
        json.dump(result, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
