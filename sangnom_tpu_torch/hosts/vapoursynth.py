"""VapourSynth host adapter.

Exposes `SangNom2` / `SangNom` as VapourSynth filter callables — the same
two functions the reference registers into its host
(AvisynthPluginInit3, reference src/SangNom2.cpp:474-484) — built on this
framework's `register_plugin_functions` registry surface.  VapourSynth is
a natural host: the reference plugin itself is a port of the VapourSynth
`vapoursynth-sangnom` plugin (reference README.md:5).

Integration model: VapourSynth serves frames on demand through a filter
graph, so the adapter wraps the filter as a dimension-aware
`std.ModifyFrame` node over a `std.BlankClip` of the OUTPUT geometry (the
standard VapourSynth recipe for Python filters that change frame size).
Because the frame server requests one frame at a time while the device
wants batches, the adapter processes frames in fixed windows of ``batch``
frames on ``device`` ("cuda" unless the caller asks for another) and caches
the most recent windows: sequential playback hits the device once per
window at full batch efficiency.

THREADING MODEL (why this cannot exhaust the host worker pool):

1. Every source frame a selector needs is a host-prefetched DEPENDENCY.
   The node's ``clips`` list carries ``batch`` window-gather clips
   (``std.SelectEvery`` over an end-padded source) whose frame ``n`` is
   source frame ``(n // batch) * batch + j`` — so when the host invokes
   the selector for frame ``n``, it has already fetched the ENTIRE window
   of ``n`` through its own scheduler.  The selector never issues a
   nested ``src.get_frame`` — the classic stateful-Python-filter deadlock
   (every worker inside a selector waiting for a fetch that needs a free
   worker) is structurally impossible, not merely unlikely.
2. Concurrent requests that miss the cache dedupe through per-window
   single-flight events.  The computing thread needs only the device (its
   inputs were prefetched), so waiters always make progress; no lock is
   held across the computation, and cache hits for other windows are
   never blocked by an in-flight window.  A waiter that wakes to find its
   window evicted recomputes from its OWN prefetched frames — it never
   re-enters the host.
3. ``pool_compat=True`` chains windows through the carried pool state in
   clip order (byte-identical to whole-clip processing, exactly like the
   CLI's --window streaming).  Sequential playback — the only access
   pattern under which the mode's semantics are meaningful — advances the
   chain using prefetched frames only, so points 1-2 apply unchanged and
   that path is structurally safe.  Random access (a seek past or behind
   the chain) needs source windows the host did not prefetch; those
   fetches run on the adapter's own dedicated prefetch thread, NEVER on
   a VapourSynth worker — the same external-request mechanism an output
   loop (e.g. vspipe's get_frame) uses.  Honest residual condition: an
   external request still needs the host to have at least one worker not
   currently blocked inside THIS filter's selectors to produce the
   frame; if a seek storm occupies every worker, the fetch cannot
   complete.  The adapter therefore bounds the wait
   (``SANGNOM_FETCH_TIMEOUT`` seconds, default 120; the older name
   ``SANGNOM_VS_FETCH_TIMEOUT`` is an alias) and raises a
   diagnostic error telling the caller to serialize the seek instead of
   hanging the process — a hang is structurally impossible, a loud
   failure under a pathological pattern is not.

Host-side cost of the prefetch design: each source frame is requested
``batch`` times by the graph (once per output frame of its window); the
source node's frame cache makes the repeats cache hits.  Keep ``batch``
moderate (the default 8 balances device batching against request fan-out).

The module imports without VapourSynth installed (everything host-facing
resolves lazily); `tests/test_torch_vapoursynth_host.py` drives it against a
mock implementing the exact host surface used here — including a
multithreaded stress harness with out-of-order parallel requests and a
nested-fetch detector — and the same code path runs unchanged against a
real `vapoursynth` module.

Usage (inside a .vpy script):

    import vapoursynth as vs
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2
    clip = vs.core.ffms2.Source("in.mkv")
    clip = SangNom2(clip, order=1, aa=48, dh=True, device="cuda")
    clip.set_output()
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sangnom_tpu_torch.api import SangNomError
from sangnom_tpu_torch.core.formats import get_format

# The runner and the framework's host-agnostic function table live in the
# shared hosts.window module (the AviSynth-model adapter reuses them); the
# THREADING MODEL above is the authoritative statement of the runner's
# concurrency contract under VapourSynth's bounded worker pool.
from sangnom_tpu_torch.hosts.window import _PLUGIN_ID, WindowRunner as _WindowRunner  # noqa: E402,F401


def _vs():
    import vapoursynth

    return vapoursynth


def _format_name_from_vs(fmt) -> str:
    """Map a VapourSynth format object to this framework's format name.

    Uses the documented VS attributes (color_family, bits_per_sample,
    sample_type, subsampling_w/h).  RGB and half-float formats raise the
    same fail-fast validation error the factory surface would."""
    vs = _vs()

    def check_bits(bits, is_float):
        if is_float and bits != 32:
            raise SangNomError("SangNom2: only 32-bit float is supported.")
        if not is_float and bits not in (8, 10, 12, 14, 16):
            # VS also has 9/11/13-bit formats; the registry (and the
            # reference's y4m-adjacent ecosystem) carries the even depths
            raise SangNomError(
                f"SangNom2: unsupported bit depth {bits} "
                f"(supported: 8/10/12/14/16-bit integer, 32-bit float).")

    if fmt.color_family == vs.GRAY:
        check_bits(fmt.bits_per_sample, fmt.sample_type == vs.FLOAT)
        if fmt.sample_type == vs.FLOAT:
            return "GRAYS"
        return f"GRAY{fmt.bits_per_sample}" if fmt.bits_per_sample > 8 else "GRAY8"
    if fmt.color_family != vs.YUV:
        raise SangNomError("SangNom2: clip must be in Y/YUV planar format.")
    sub = {(1, 1): "420", (1, 0): "422", (0, 0): "444",
           (2, 0): "411"}.get((fmt.subsampling_w, fmt.subsampling_h))
    if sub is None:
        raise SangNomError(
            f"SangNom2: unsupported subsampling "
            f"{fmt.subsampling_w}x{fmt.subsampling_h}.")
    check_bits(fmt.bits_per_sample, fmt.sample_type == vs.FLOAT)
    if fmt.sample_type == vs.FLOAT:
        return f"YUV{sub}PS"
    return f"YUV{sub}P{fmt.bits_per_sample}"


def _frame_planes(frame, num_planes) -> list[np.ndarray]:
    """Read a VS frame's planes as numpy copies ([h, w] each).  VS frames
    expose plane buffers through the array interface (`frame[i]`)."""
    return [np.asarray(frame[i]).copy() for i in range(num_planes)]


def _frame_parity(frame, n: int, tff: bool) -> bool:
    """Per-frame parity for order=0, from VS frame props when present:
    `_Field` (set by std.SeparateFields: 1 = top) wins, else `_FieldBased`
    (2 = tff, 1 = bff), else the adapter-level tff default — the analogue
    of the host GetParity(n) the reference consults
    (reference src/SangNom2.cpp:338)."""
    props = getattr(frame, "props", {}) or {}
    if "_Field" in props:
        return bool(props["_Field"])
    if "_FieldBased" in props and props["_FieldBased"] in (1, 2):
        return props["_FieldBased"] == 2
    return tff


def _window_dep_clips(core, src, batch: int) -> list:
    """``batch`` window-gather dependency clips: clip ``j``'s frame ``n``
    is source frame ``(n // batch) * batch + j`` (end-padded with the last
    frame so the trailing partial window still gathers).  Listing these in
    ``clips`` makes the host prefetch every source frame of ``n``'s window
    before the selector runs — the core of the no-nested-fetch design."""
    if batch == 1:
        return [src]
    n = src.num_frames
    pad = (-n) % batch
    padded = src
    if pad:
        last = core.std.Trim(src, first=n - 1, last=n - 1)
        padded = core.std.Splice(clips=[src, core.std.Loop(last, pad)])
    return [
        core.std.SelectEvery(padded, cycle=batch, offsets=[j] * batch)
        for j in range(batch)
    ]


def _wrap(src, params: dict, batch: int, tff: bool | None, legacy: bool,
          device):
    vs = _vs()
    core = vs.core
    fmt_name = _format_name_from_vs(src.format)
    fmt = get_format(fmt_name)
    dh = bool(params.get("dh", False)) and not legacy
    out_h = src.height * 2 if dh else src.height
    batch = max(1, batch)
    tff_default = True if tff is None else tff

    def host_fetch(k):
        # pool-mode random access only; runs on the runner's own thread
        fr = src.get_frame(k)
        return {
            "planes": _frame_planes(fr, fmt.num_planes),
            "parity": _frame_parity(fr, k, tff_default),
        }

    runner = _WindowRunner(
        src.num_frames, fmt_name, dict(params, _legacy=legacy),
        tff=tff_default, batch=batch, host_fetch=host_fetch, device=device,
    )

    # OUTPUT-geometry carrier clip: ModifyFrame requires the selector's
    # returned frame to match the clip it modifies, so dimension-changing
    # Python filters modify a blank clip of the output size (the standard
    # VapourSynth recipe) while reading the real source from `clips`.
    blank = core.std.BlankClip(
        clip=src, width=src.width, height=out_h, length=src.num_frames
    )
    win_clips = _window_dep_clips(core, src, batch)

    def selector(n, f):
        # f: [blank frame, window frame 0, ..., window frame batch-1] per
        # the clips list below — the host prefetched n's ENTIRE source
        # window, so no nested get_frame ever runs on this worker
        fout = f[0].copy()
        start = (n // batch) * batch
        end = min(start + batch, src.num_frames)

        def window_frames_fn():
            # deferred: the batch full-frame plane copies run only when
            # the runner actually misses its window cache
            return [
                {
                    "planes": _frame_planes(f[1 + j], fmt.num_planes),
                    "parity": _frame_parity(f[1 + j], start + j,
                                            runner.tff),
                }
                for j in range(end - start)
            ]

        src_frame = f[1 + (n - start)]

        outs = runner.get(n, window_frames_fn)
        for i, plane in enumerate(outs):
            np.asarray(fout[i])[...] = plane
        # propagate the SOURCE frame's props (colorimetry, range,
        # timecodes — the v8 NewVideoFrameP analogue, reference
        # src/SangNom2.cpp:344); the filter emits progressive content, so
        # field-ness props are rewritten rather than forwarded
        fprops = getattr(fout, "props", None)
        if fprops is not None:
            for k, v in (getattr(src_frame, "props", {}) or {}).items():
                fprops[k] = v
            fprops["_FieldBased"] = 0
            try:
                del fprops["_Field"]
            except KeyError:
                pass
        return fout

    return core.std.ModifyFrame(clip=blank, clips=[blank] + win_clips,
                                selector=selector)


def SangNom2(clip, order: int = 1, aa: int = 48, aac: int = 0,
             threads: int = 0, dh: bool = False, luma: bool = True,
             chroma: bool = True, opt: int = -1, batch: int = 8,
             tff: bool | None = None,
             device: torch.device | str = "cuda", **compat) -> Any:
    """The SangNom2 surface as a VapourSynth filter (parameters, defaults
    and validation exactly as the registered script function; ``batch``,
    ``tff`` and ``device`` are host-integration knobs: window size, the
    order=0 parity default when the stream carries no field props, and the
    torch device the windows run on)."""
    params = dict(order=order, aa=aa, aac=aac, threads=threads, dh=dh,
                  luma=luma, chroma=chroma, opt=opt, **compat)
    return _wrap(clip, params, batch, tff, legacy=False, device=device)


def SangNom(clip, order: int = 1, aa: int = 48, opt: int = -1,
            batch: int = 8, tff: bool | None = None,
            device: torch.device | str = "cuda", **compat) -> Any:
    """The legacy SangNom surface as a VapourSynth filter."""
    params = dict(order=order, aa=aa, opt=opt, **compat)
    return _wrap(clip, params, batch, tff, legacy=True, device=device)


def register(namespace=None):
    """Attach the filter callables onto ``namespace`` (any object or dict) —
    the adapter-level analogue of AvisynthPluginInit3 (reference
    src/SangNom2.cpp:476-484).  Returns the plugin identifier."""
    fns = {"SangNom2": SangNom2, "SangNom": SangNom}
    if namespace is None:
        return _PLUGIN_ID
    for name, fn in fns.items():
        if isinstance(namespace, dict):
            namespace[name] = fn
        else:
            setattr(namespace, name, fn)
    return _PLUGIN_ID
