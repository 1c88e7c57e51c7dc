"""Command-line host: deinterlace .y4m streams standalone, on a CUDA device.

The reference runs inside an AviSynth host; this CLI is the framework's own
minimal host runtime, exposing the exact script-function surface over files:

    python -m sangnom_tpu_torch input.y4m output.y4m --order 1 --aa 48 --dh
    python -m sangnom_tpu_torch in.y4m out.y4m --legacy --order 2   # SangNom()
    python -m sangnom_tpu_torch in.y4m out.y4m --bob --device cpu
    python -m sangnom_tpu_torch script recipe.avs in.y4m out.y4m
    python -m sangnom_tpu_torch prewarm --aot DIR --size 1920x1080 \
        --format YUV420P8 --bob --window 8
    python -m sangnom_tpu_torch in.y4m out.y4m --bob --window 8 --aot DIR

Reads/writes YUV4MPEG2 on files or stdin/stdout ("-").  The filter runs on
``--device`` (default "cuda"); without a card the CLI exits 2 unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import itertools
import math
import os
import sys
import time

import numpy as np
import torch

from sangnom_tpu_torch import __version__, sangnom, sangnom2
from sangnom_tpu_torch.io import iter_y4m, read_y4m, write_y4m, write_y4m_frames
from sangnom_tpu_torch.utils.profiling import (
    FILTER, WAIT_INPUT, WAIT_OUTPUT, WAIT_WRITER, span)

# Output frames the script verb fetches and writes at a time (the AviSynth
# model filter's default batch, so each write follows one filter window).
SCRIPT_WINDOW = 8


def _add_device_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the filter runs on (default cuda; "
                   "there is no fallback: without a CUDA device the run "
                   "fails unless --device cpu is given)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="directory the CUDA kernel library is built into and "
                   "loaded from (default: sangnom_tpu_torch/_build/); a "
                   "resident process cannot switch it after the first load. "
                   "With --aot, a library prewarmed into the --aot directory "
                   "wins; this directory serves only when that one holds "
                   "no library of the current sources")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sangnom-tpu-torch",
        description="SangNom2 edge-directed deinterlacer / anti-aliaser "
        "(PyTorch and CUDA). Parameter names, defaults and semantics match "
        "the AviSynth plugin.",
    )
    p.add_argument("input", help=".y4m input path, or - for stdin")
    p.add_argument("output", help=".y4m output path, or - for stdout")
    p.add_argument("--order", type=int, default=1,
                   help="0: per-frame parity (bob), 1: keep top, 2: keep "
                   "bottom (default 1)")
    p.add_argument("--aa", type=int, default=48, help="luma AA strength 0..128")
    p.add_argument("--aac", type=int, default=0, help="chroma AA strength 0..128")
    p.add_argument("--threads", type=int, default=0,
                   help="accepted and ignored (reference compatibility)")
    p.add_argument("--dh", action="store_true", help="double height")
    p.add_argument("--no-luma", dest="luma", action="store_false")
    p.add_argument("--no-chroma", dest="chroma", action="store_false")
    p.add_argument("--opt", type=int, default=-1,
                   help="-1 auto, 0 plain PyTorch path, 1 CUDA kernel")
    p.add_argument("--pool-compat", action="store_true",
                   help="reproduce the reference's shared-buffer-pool "
                   "stale-data semantics bit-for-bit (frames become "
                   "sequential)")
    p.add_argument("--numerics", choices=("c", "sse2"), default="c",
                   help="numeric contract: the reference's C path "
                   "(default) or its diverging SSE2 path")
    p.add_argument("--legacy", action="store_true",
                   help="use the legacy SangNom() surface (order remap; "
                   "aa/opt only)")
    p.add_argument("--bob", action="store_true",
                   help="double-rate deinterlace: SeparateFields -> "
                   "DoubleWeave -> SangNom2(order=0); doubles the frame "
                   "count and framerate")
    p.add_argument("--tff", dest="tff", action="store_true", default=None,
                   help="force top-field-first (default: stream flag)")
    p.add_argument("--bff", dest="tff", action="store_false",
                   help="force bottom-field-first")
    p.add_argument("--frames", type=int, default=None,
                   help="process at most N frames")
    p.add_argument("--window", type=int, default=None,
                   help="stream in windows of N frames (bounded memory for "
                   "long inputs; default: whole clip at once)")
    p.add_argument("--overlap-write", action="store_true", default=None,
                   help="with --window: pipeline the host stages across "
                   "threads — a reader thread (parse+upload), the main "
                   "thread (filter launches), and a writer thread (device "
                   "fetch + y4m serialization) — so end-to-end throughput "
                   "approaches min(reader, writer, device) instead of "
                   "their serial sum (byte-identical output; single "
                   "reader/writer preserve order).  DEFAULT ON when "
                   "--window is given and the host has >1 CPU.")
    p.add_argument("--no-overlap-write", dest="overlap_write",
                   action="store_false",
                   help="force the single-threaded windowed loop")
    p.add_argument("--fps", default=None,
                   help="output framerate N:D (default: input stream's, "
                   "doubled under --bob)")
    p.add_argument("--aot", default=None, metavar="DIR",
                   help="directory prewarmed by the 'prewarm' verb: the CUDA "
                   "kernel library loads from it with no nvcc build, and "
                   "dispatches whose artifact is present count as served "
                   "from it (same bits either way)")
    _add_device_options(p)
    p.add_argument("--version", action="version",
                   version=f"sangnom-tpu-torch {__version__}")
    return p


def _setup_device(args) -> None:
    """Check ``--device`` and apply ``--cache-dir`` before any kernel loads.
    Raises ValueError for a device this machine cannot serve."""
    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        raise ValueError(f"invalid --device {args.device!r} ({e})") from None
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            f"--device {args.device}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to "
            "run on the CPU")
    if args.cache_dir:
        from sangnom_tpu_torch.ops import cuda_library

        cuda_library.set_build_dir(args.cache_dir)


def _parse_fps(text: str) -> tuple[int, int]:
    num, den = (int(x) for x in text.split(":"))
    if den <= 0 or num <= 0:
        raise ValueError(f"invalid --fps {text!r}")
    return num, den


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "prewarm":
        return _prewarm_main(argv[1:])
    if argv and argv[0] == "script":
        return _script_main(argv[1:])

    args = build_parser().parse_args(argv)
    # configure UNCONDITIONALLY (None disables), before any kernel loads:
    # the artifact directory is process-global, and an in-process host
    # calling main() repeatedly must not leak one run's --aot directory (or
    # its hit/miss stats) into a later run that did not ask for it
    from sangnom_tpu_torch import aot

    aot.configure(args.aot or None)
    src = sys.stdin.buffer if args.input == "-" else args.input
    dst = sys.stdout.buffer if args.output == "-" else args.output

    from sangnom_tpu_torch.api import SangNomError

    t0 = time.perf_counter()
    try:
        _setup_device(args)
        if args.legacy and args.bob:
            # --bob would silently run the SangNom2 surface and drop
            # --legacy; SangNom2-only knobs (--dh/--aac/--no-chroma) are
            # instead IGNORED under --legacy, matching the legacy
            # surface's documented parameter set
            raise ValueError(
                "--legacy cannot be combined with --bob (bob runs the "
                "SangNom2 surface; use --legacy --order 0 for per-frame "
                "parity)"
            )
        fps = None if args.fps is None else _parse_fps(args.fps)
        if args.overlap_write and args.window is None:
            raise ValueError("--overlap-write requires --window")
        if args.overlap_write is None:
            # default: overlap when the host can actually run the stages in
            # parallel (a 1-vCPU host would only pay thread switching)
            args.overlap_write = (
                args.window is not None and (os.cpu_count() or 1) > 1
            )
        if args.window is not None:
            return _run_windowed(src, dst, args, fps, t0)
        clip = read_y4m(src, max_frames=args.frames, device=args.device)
        out = _filter_one(_override_tff(clip, args), args)
        if fps is None:
            fps = clip.props.get("y4m_fps", (25, 1))
            if args.bob:
                # double-rate output; an EXPLICIT --fps is already the
                # output rate (its documented meaning) and stays as-is
                fps = (fps[0] * 2, fps[1])
        write_y4m(dst, out, fps=fps,
                  interlace=_out_interlace(args, clip.num_planes, clip.props))
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    _aot_note(args)
    print(
        f"{clip.num_frames} frames {clip.width}x{clip.height} -> "
        f"{out.width}x{out.height} in {dt:.2f}s "
        f"({clip.num_frames / dt:.1f} fps end-to-end)",
        file=sys.stderr,
    )
    return 0


def _aot_note(args) -> None:
    if not getattr(args, "aot", None):
        return
    from sangnom_tpu_torch import aot

    h, m = aot.STATS["hits"], aot.STATS["misses"]
    print(f"aot: {h} dispatch(es) served from artifacts, {m} miss(es)",
          file=sys.stderr)


def _out_interlace(args, num_planes: int, props: dict) -> str:
    """Output-stream interlace tag.  The filter produces progressive output
    ('p') whenever it actually processes a plane; a pure pass-through run
    (no --dh/--bob and every existing plane masked off — chroma flags are
    moot on GRAY clips) forwards the input stream's tag instead of
    restamping interlaced content.  Single policy for the whole-clip and
    windowed writers."""
    processes = (
        args.bob or args.dh or args.luma or (args.chroma and num_planes >= 3)
    )
    if processes:
        return "p"
    return props.get("y4m_interlace", "p")


def _override_tff(clip, args):
    if args.tff is None:
        return clip
    # force field dominance over the stream's interlace flag
    # (applies to every mode, not just --bob)
    from sangnom_tpu_torch import Clip

    return Clip(clip.planes, clip.format, parity=None, tff=args.tff,
                props=clip.props)


def _filter_one(clip, args):
    compat = dict(pool_compat=args.pool_compat, numerics=args.numerics)
    if args.bob:
        from sangnom_tpu_torch import bob as bob_fn

        return bob_fn(clip, aa=args.aa, aac=args.aac, luma=args.luma,
                      chroma=args.chroma, opt=args.opt, tff=args.tff,
                      **compat)
    if args.legacy:
        return sangnom(clip, order=args.order, aa=args.aa, opt=args.opt,
                       **compat)
    return sangnom2(
        clip, order=args.order, aa=args.aa, aac=args.aac,
        threads=args.threads, dh=args.dh, luma=args.luma,
        chroma=args.chroma, opt=args.opt, **compat,
    )


def _prefetch_windows(it, depth: int = 2):
    """Run a window iterator on its own READER thread with a bounded
    handoff queue: the y4m parse + device upload of window k+1 overlap the
    main thread's launches and the writer thread's fetch/serialize of
    window k.  The iterator uploads to the device it was given, so this
    thread names its device explicitly.  Order is preserved (single reader,
    FIFO queue) so output stays byte-identical; reader exceptions re-raise
    on the consuming thread.  The bounded queue keeps at most ``depth``
    parsed windows in flight (same memory ceiling as the serial loop's
    lookahead)."""
    import queue as _queue
    import threading

    q = _queue.Queue(maxsize=depth)
    err: list = []
    done = object()
    stop = threading.Event()

    def _put(x) -> bool:
        # bounded put that gives up when the consumer is gone — without
        # this, an error in the windowed loop would leave the reader
        # thread blocked in q.put forever, pinning its parsed+uploaded
        # windows and the input stream (an in-process host calling
        # cli.main() repeatedly would accumulate them)
        while not stop.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def _loop():
        try:
            for x in it:
                if not _put(x):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            err.append(e)
        finally:
            _put(done)

    threading.Thread(target=_loop, name="sangnom-reader",
                     daemon=True).start()
    try:
        for k in itertools.count():
            with span(WAIT_INPUT, call=k):
                x = q.get()
            if x is done:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()


def _run_windowed(src, dst, args, fps, t0) -> int:
    """Streaming mode: process in --window sized batches, write
    incrementally.  The filter has no temporal taps so windows are exact;
    the bob pipeline pairs each frame's trailing field with the NEXT
    frame's leading field, so windows are processed with one frame of
    lookahead and the overlap outputs dropped."""
    from sangnom_tpu_torch import Clip
    from sangnom_tpu_torch.api import SangNomError

    if args.pool_compat and args.bob:
        # bob windows overlap by one lookahead frame; processing it twice
        # would corrupt the carried pool state vs whole-clip output
        print("error: --pool-compat with --bob requires whole-clip "
              "processing (drop --window)", file=sys.stderr)
        return 2

    # opened lazily at the first emit so a failed run never truncates a
    # pre-existing output file (matching whole-clip mode's behavior)
    state = {"fh": None, "close": False, "out": 0, "in": 0, "shape": None}

    pool_state = {"p": None}

    def fone(w):
        if not args.pool_compat:
            return _filter_one(w, args)
        # pool-compat streaming: the pool is cross-frame state and must
        # survive window boundaries for byte-identity with whole-clip mode
        from sangnom_tpu_torch.api import _LEGACY_ORDER_REMAP, _validate
        from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream

        if args.legacy:
            # the legacy surface has NO dh/luma/chroma parameters — mirror
            # sangnom()'s fixed defaults so windowed output stays
            # byte-identical to whole-clip legacy mode
            _validate("SangNom", w, args.order, args.aa, 0, args.opt)
            order = (_LEGACY_ORDER_REMAP[args.order]
                     if args.order != 1 else 1)
            aac, dh, luma, chroma = 0, False, True, True
        else:
            order, aac = args.order, args.aac
            dh, luma, chroma = args.dh, args.luma, args.chroma
        out, pool_state["p"] = sangnom2_pool_stream(
            w, pool_state["p"], order=order, aa=args.aa, aac=aac,
            dh=dh, luma=luma, chroma=chroma,
            numerics=args.numerics, opt=args.opt,
        )
        return out

    def emit(out_clip, in_props, k):
        f = fps
        if f is None:
            f = in_props.get("y4m_fps", (25, 1))
            if args.bob:
                # explicit --fps is the OUTPUT rate; only the
                # input-derived rate doubles under --bob
                f = (f[0] * 2, f[1])
        if state["fh"] is None:
            if isinstance(dst, (str, bytes)):
                state["fh"], state["close"] = open(dst, "wb"), True
            else:
                state["fh"] = dst
            ilace = _out_interlace(args, out_clip.num_planes, in_props)
            write_y4m(state["fh"], out_clip, fps=f, interlace=ilace, window=k)
        else:
            write_y4m_frames(state["fh"], out_clip, window=k)
        state["out"] += out_clip.num_frames
        state["shape"] = (out_clip.width, out_clip.height)

    # --overlap-write: a single writer THREAD runs emit(), so window k's
    # device-to-host copy (which waits for the device with the GIL
    # released) and y4m serialization overlap window k+1's launches on the
    # main thread.  FIFO queue + one writer preserves emission order
    # exactly — output stays byte-identical.  Bounded queue keeps the same
    # backpressure as serial emission; writer exceptions are re-raised on
    # the main thread (the writer then drains so the producer never blocks
    # on a dead consumer).
    emit_err: list = []
    wq = wthread = None
    if args.overlap_write:
        import queue as _queue
        import threading

        wq = _queue.Queue(maxsize=2)

        def _writer_loop():
            drain = False
            for k in itertools.count():
                with span(WAIT_OUTPUT, call=k):
                    item = wq.get()
                if item is None:
                    return
                if drain:
                    continue
                try:
                    emit(*item)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    emit_err.append(e)
                    drain = True

        wthread = threading.Thread(
            target=_writer_loop, name="sangnom-writer", daemon=True
        )
        wthread.start()

    def submit(out_clip, in_props, k):
        if wq is None:
            emit(out_clip, in_props, k)
            return
        if emit_err:
            raise emit_err[0]
        with span(WAIT_WRITER, call=k):
            wq.put((out_clip, in_props, k))

    def filtered(clip, k, frames):
        with span(FILTER, call=k, window=k, frames=frames):
            return fone(clip)

    pending = None
    inflight = None  # one-window software pipeline (see below)
    windows = iter_y4m(src, args.window, max_frames=args.frames,
                       device=args.device)
    if args.overlap_write:
        # third pipeline stage: parse+upload on a reader thread
        windows = _prefetch_windows(windows)
    try:
        for k, w in enumerate(windows):
            w = _override_tff(w, args)
            state["in"] += w.num_frames
            if args.bob:
                if pending is not None:
                    feed = Clip.concat(pending, w[0:1])  # 1-frame lookahead
                    out = filtered(feed, k - 1, pending.num_frames)
                    submit(out[0 : 2 * pending.num_frames], pending.props, k - 1)
                pending = w
            else:
                # CUDA launches are asynchronous: launch window k, then let
                # the NEXT window's host-side y4m parse overlap the device
                # compute, and only then fetch/emit window k.  Same emission
                # order (byte-identical output), one extra window in flight.
                out = filtered(w, k, w.num_frames)
                if inflight is not None:
                    submit(*inflight)
                inflight = (out, w.props, k)
        if args.bob and pending is not None:
            # final window (k, the last one's index): the degenerate last
            # pairing, as unwindowed
            submit(filtered(pending, k, pending.num_frames), pending.props, k)
        if inflight is not None:
            submit(*inflight)
        if wthread is not None:
            wq.put(None)
            wthread.join()
            wthread = None
            if emit_err:
                raise emit_err[0]
        if state["in"] == 0:
            raise ValueError("y4m stream contains no frames")
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if wthread is not None:
            # exception path: stop the writer before closing its file
            wq.put(None)
            wthread.join()
        if state["close"] and state["fh"] is not None:
            state["fh"].close()
    dt = time.perf_counter() - t0
    _aot_note(args)
    w_, h_ = state["shape"]
    print(
        f"{state['in']} frames -> {state['out']} frames {w_}x{h_} in "
        f"{dt:.2f}s ({state['in'] / dt:.1f} fps end-to-end, "
        f"window={args.window})",
        file=sys.stderr,
    )
    return 0


def _prewarm_main(argv: list[str]) -> int:
    """``sangnom-tpu-torch prewarm``: build the CUDA kernel library into an
    artifact directory and write one artifact for each dispatch of a
    (format, geometry, params) combo, so later CLI runs with ``--aot DIR``
    start with no nvcc build — the analogue of the reference's AOT-.so
    zero-warmup property (reference src/SangNom2.cpp:312-329)."""
    p = argparse.ArgumentParser(
        prog="sangnom-tpu-torch prewarm",
        description="Prewarm an artifact directory for a format/geometry/"
        "parameter combo: the CUDA kernel library and one artifact a "
        "dispatch. Run with the SAME filter flags you will pass to the main "
        "CLI, plus the clip geometry; then give the main CLI --aot DIR.",
    )
    p.add_argument("--aot", required=True, metavar="DIR",
                   help="artifact directory (created if missing)")
    p.add_argument("--format", required=True, dest="fmt",
                   help="video format name, e.g. YUV420P8, GRAY16, YUV444PS")
    p.add_argument("--size", required=True, metavar="WxH",
                   help="input frame geometry, e.g. 1920x1080")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--window", type=int,
                   help="frames per dispatch for windowed runs (--window N "
                   "on the main CLI; --bob additionally prewarms the N+1 "
                   "lookahead feed). The trailing partial window of a clip "
                   "whose length is not a multiple counts a miss.")
    g.add_argument("--frames", type=int,
                   help="frames per dispatch for whole-clip runs (the exact "
                   "clip length)")
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--aa", type=int, default=48)
    p.add_argument("--aac", type=int, default=0)
    p.add_argument("--dh", action="store_true")
    p.add_argument("--no-luma", dest="luma", action="store_false")
    p.add_argument("--no-chroma", dest="chroma", action="store_false")
    p.add_argument("--opt", type=int, default=-1)
    p.add_argument("--numerics", choices=("c", "sse2"), default="c")
    p.add_argument("--legacy", action="store_true")
    p.add_argument("--bob", action="store_true")
    p.add_argument("--tff", dest="tff", action="store_true", default=True,
                   help="field dominance of --bob dispatches (default tff; "
                   "must match the stream/flags at run time)")
    p.add_argument("--bff", dest="tff", action="store_false")
    p.add_argument("--no-warm-call", dest="warm_call", action="store_false",
                   help="write the artifacts only; skip the call of each "
                   "dispatch on zeros that loads the library and launches "
                   "its kernels at this geometry")
    _add_device_options(p)
    args = p.parse_args(argv)

    from sangnom_tpu_torch import aot
    from sangnom_tpu_torch.api import (_LEGACY_ORDER_REMAP, SangNomError,
                                       _validate, _validate_geometry,
                                       _validate_numerics)
    from sangnom_tpu_torch.core.formats import get_format
    from sangnom_tpu_torch.ops import cuda_library

    t0 = time.perf_counter()
    try:
        _setup_device(args)
        # the warm calls load the library from the directory being prewarmed
        aot.configure(args.aot)
        if args.legacy and args.bob:
            raise ValueError("--legacy cannot be combined with --bob")
        try:
            w, h = (int(x) for x in args.size.lower().split("x"))
        except ValueError:
            raise ValueError(f"invalid --size {args.size!r} (want WxH)")
        fmt = get_format(args.fmt)
        on_cuda = torch.device(args.device).type == "cuda"
        _validate("SangNom2", None, args.order, args.aa, args.aac, args.opt,
                  opt1_ok=on_cuda)
        _validate_numerics("SangNom2", args.numerics)
        _validate_geometry("SangNom2", fmt, h)

        def shapes(n):
            return tuple(
                ((n,) + tuple(reversed(fmt.plane_dims(w, h, i))),
                 str(fmt.np_dtype))
                for i in range(fmt.num_planes)
            )

        jobs = []  # (kind, n_frames, statics)
        n0 = args.window if args.window is not None else args.frames
        if n0 <= 0:
            raise ValueError("--window/--frames must be positive")
        if args.bob:
            statics = aot.bob_statics(args.aa, args.aac, args.tff,
                                      args.opt, args.numerics)
            jobs.append(("bob", n0, statics))
            if args.window is not None:
                # windowed bob feeds window+1 frames (1-frame lookahead)
                jobs.append(("bob", n0 + 1, statics))
        else:
            order = args.order
            if args.legacy:
                # the legacy surface: order remap, fixed aac/dh/luma/chroma
                order = _LEGACY_ORDER_REMAP[order] if order != 1 else 1
                statics = aot.filter_statics(order, args.aa, 0, False,
                                             True, True, args.opt,
                                             args.numerics)
            else:
                statics = aot.filter_statics(order, args.aa, args.aac,
                                             args.dh, args.luma,
                                             args.chroma, args.opt,
                                             args.numerics)
            jobs.append(("filter", n0, statics))

        for kind, n, statics in jobs:
            tj = time.perf_counter()
            builds = cuda_library.BUILDS
            path = aot.save_program(args.aot, kind, fmt, shapes(n), statics,
                                    device=args.device)
            dt_save = time.perf_counter() - tj
            if cuda_library.BUILDS > builds:
                print(f"  {cuda_library.library_name()}: kernel library "
                      f"built in {dt_save:.1f}s", file=sys.stderr)
            note = ""
            if args.warm_call:
                note = f", warm-called {aot.warm_call(path):.1f}s"
            print(
                f"  {path.name}: {path.stat().st_size} bytes "
                f"({kind}, {n} frames, saved {dt_save:.1f}s{note})",
                file=sys.stderr,
            )
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        aot.configure(None)
    print(
        f"prewarmed {len(jobs)} program(s) for {args.fmt} {w}x{h} into "
        f"{args.aot} in {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    return 0


def _script_main(argv: list[str]) -> int:
    """``sangnom-tpu-torch script``: run an AviSynth recipe file over a y4m
    stream through the script host (hosts/avs_script.py) — existing .avs
    lines drive the filter unmodified.  The source clip stays on the host
    (the chain's built-ins are host row shuffles); the filter's windows go
    to ``--device``.  The output header comes from the result's VideoInfo,
    then frames are fetched and appended SCRIPT_WINDOW at a time, so the
    output clip is never held whole.  The output frame rate scales with the
    recipe's frame-count ratio (e.g. the double-rate bob recipe doubles it)
    unless --fps pins it."""
    p = argparse.ArgumentParser(
        prog="sangnom-tpu-torch script",
        description="Evaluate an AviSynth script file (the plugin's usage "
        "subset: SangNom2/SangNom, AssumeTFF/BFF, SeparateFields, "
        "DoubleWeave, Weave, SelectEven/Odd, Trim, implicit last, "
        "chaining) over a y4m input.",
    )
    p.add_argument("recipe", help=".avs script file ('-' for stdin is NOT "
                   "supported here: stdin carries the video)")
    p.add_argument("input", help="input .y4m ('-' for stdin)")
    p.add_argument("output", help="output .y4m ('-' for stdout)")
    p.add_argument("--frames", type=int, default=None,
                   help="process at most N input frames")
    p.add_argument("--fps", default=None, metavar="N:D",
                   help="force the OUTPUT frame rate")
    p.add_argument("--tff", dest="tff", action="store_true", default=None,
                   help="override the stream's field dominance")
    p.add_argument("--bff", dest="tff", action="store_false")
    _add_device_options(p)
    args = p.parse_args(argv)

    from sangnom_tpu_torch import Clip
    from sangnom_tpu_torch.api import SangNomError
    from sangnom_tpu_torch.hosts.avisynth import (ArraySource,
                                                  ScriptEnvironment,
                                                  avisynth_plugin_init)
    from sangnom_tpu_torch.hosts.avs_script import eval_script

    t0 = time.perf_counter()
    fh = None
    close = False
    try:
        _setup_device(args)
        with open(args.recipe, "r", encoding="utf-8") as rf:
            text = rf.read()
        src_stream = sys.stdin.buffer if args.input == "-" else args.input
        clip = read_y4m(src_stream, max_frames=args.frames, device="cpu")
        tff = clip.tff if args.tff is None else args.tff
        src = ArraySource([pl.numpy() for pl in clip.planes], clip.format,
                          parity=tff)
        env = ScriptEnvironment(device=args.device)
        avisynth_plugin_init(env)
        result = eval_script(env, text, last=src)
        if not hasattr(result, "get_video_info"):
            raise SangNomError(
                f"script result is not a clip (got {type(result).__name__})")
        vi = result.get_video_info()
        if args.fps is not None:
            fps = _parse_fps(args.fps)
        else:
            num, den = clip.props.get("y4m_fps", (25, 1))
            # scale by the recipe's frame-count ratio (bob 2x, SelectEven
            # 0.5x, ...) and reduce
            num, den = num * vi.num_frames, den * clip.num_frames
            g = math.gcd(num, den)
            fps = (num // g, den // g)
        for start in range(0, vi.num_frames, SCRIPT_WINDOW):
            frames = [result.get_frame(n, env) for n in
                      range(start, min(start + SCRIPT_WINDOW, vi.num_frames))]
            window = Clip.from_numpy(
                [np.stack([fr.planes[i] for fr in frames])
                 for i in range(vi.num_components())],
                vi.format, device="cpu", props=clip.props)
            if fh is None:
                # opened at the first window so a failed script never
                # truncates a pre-existing output file
                if args.output == "-":
                    fh = sys.stdout.buffer
                else:
                    fh, close = open(args.output, "wb"), True
                write_y4m(fh, window, fps=fps)
            else:
                write_y4m_frames(fh, window)
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if close:
            fh.close()
    print(
        f"script {args.recipe}: {clip.num_frames} frames "
        f"{clip.width}x{clip.height} -> {vi.num_frames} frames "
        f"{vi.width}x{vi.height} in {time.perf_counter() - t0:.2f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
