"""Host-agnostic windowed frame-batch runner shared by the host adapters.

Frame-serving hosts (VapourSynth, AviSynth) request one frame at a time
while the device wants batches; `WindowRunner` bridges the two by processing
frames in fixed windows of ``batch`` frames with a small window cache, so
sequential playback hits the device once per window at full batch
efficiency.

The concurrency contract (single-flight per window, no lock held across
device computation, ordered pool-chain turn-taking) is documented in detail
in `hosts/vapoursynth.py`'s THREADING MODEL docstring — VapourSynth's
bounded worker pool is the host where the contract is load-bearing.  The
AviSynth-model adapter (`hosts/avisynth.py`) reuses the runner unchanged:
there the host call model already permits nested child fetches inside
GetFrame (the reference itself calls child->GetFrame from GetFrame,
reference src/SangNom2.cpp:343), so every guarantee here is strictly
stronger than that host requires.

How frames arrive is the HOST ADAPTER's job, through two callables:

* ``window_frames_fn`` (per `get` call) builds the frame dicts
  (``{"planes": [np arrays], "parity": bool}``) for EVERY source frame of
  the requested frame's window, from whatever fetch mechanism the host
  offers (prefetched dependency frames under VapourSynth, nested child
  GetFrame under AviSynth).  It is a callable so the batch of full-frame
  plane copies runs only on a cache miss.
* ``host_fetch`` (constructor) serves a single source frame by index for
  pool-compat random access — the one path whose inputs the current
  request cannot supply.

A window goes to ``device`` ("cuda" unless the adapter asks for another) as
one upload a plane, and comes back as one host copy a plane.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from sangnom_tpu_torch.api import SangNomError, register_plugin_functions
from sangnom_tpu_torch.core.clip import Clip
from sangnom_tpu_torch.core.formats import get_format
from sangnom_tpu_torch.utils.profiling import HOST_FETCH, WINDOW, WINDOW_WAIT, count, span

# The framework's own host-agnostic function table (the analogue of the
# host's function registry the reference fills at plugin load).
_REGISTRY: dict = {}
_PLUGIN_ID = register_plugin_functions(_REGISTRY)

# Seconds a pool_compat random-access fetch may wait for the host.  The
# VapourSynth-era name stays an alias of the host-neutral one.
FETCH_TIMEOUT_ENV = ("SANGNOM_FETCH_TIMEOUT", "SANGNOM_VS_FETCH_TIMEOUT")
FETCH_TIMEOUT_DEFAULT = 120.0


def fetch_timeout() -> float:
    """The pool_compat random-access fetch timeout: the first of
    `FETCH_TIMEOUT_ENV` that is set, else `FETCH_TIMEOUT_DEFAULT`."""
    for name in FETCH_TIMEOUT_ENV:
        value = os.environ.get(name)
        if value is not None:
            return float(value)
    return FETCH_TIMEOUT_DEFAULT


class WindowRunner:
    """Batches frame requests into device-sized windows with a tiny cache.

    Thread-safe for a frame server's parallel requests: ``get`` receives
    a callable that can supply the request's whole source window (so the
    runner itself never talks to the host), concurrent missers of one
    window dedupe through single-flight events, and no lock is held
    across device computation.  ``pool_compat`` windows chain through the
    carried pool state in clip order under ``_chain``; random-access
    gap/restart fetches run on the runner's dedicated prefetch thread
    via ``host_fetch`` — never on a host worker thread.
    """

    def __init__(self, num_frames: int, fmt_name: str, params: dict,
                 tff: bool, batch: int, host_fetch=None,
                 cache_windows: int = 2,
                 device: torch.device | str = "cuda"):
        self.num_frames = num_frames
        self.fmt = get_format(fmt_name)
        self.params = params
        self.tff = tff
        self.batch = max(1, batch)
        self.cache_windows = max(1, cache_windows)
        self.device = device
        self.legacy = bool(params.get("_legacy", False))
        self.pool_compat = bool(params.get("pool_compat", False))
        self._host_fetch = host_fetch  # k -> frame dict, host-served
        self._cache: dict[int, list[np.ndarray]] = {}  # window start -> planes
        self._order: list[int] = []
        self._lock = threading.Lock()
        self._inflight: dict[int, threading.Event] = {}
        # pool_compat chain state (guarded by _cond's lock): windows run
        # strictly in clip order, one computing thread at a time, with
        # ORDERED turn-taking across the active requests (lowest window
        # first) so parallel sequential lookahead consumes only
        # host-prefetched frames — see _get_pool
        self._cond = threading.Condition()
        self._chain_busy = False
        self._active: dict[int, int] = {}  # window start -> requester count
        self._pool_state = None
        self._pool_next = 0  # next window start the pool chain will compute

    def _to_clip(self, frames):
        planes = [
            np.stack([fr["planes"][i] for fr in frames])
            for i in range(self.fmt.num_planes)
        ]
        parity = np.asarray([fr["parity"] for fr in frames], bool)
        return Clip.from_numpy(planes, self.fmt, device=self.device,
                               parity=parity)

    def _run_window(self, frames: list) -> list[np.ndarray]:
        clip = self._to_clip(frames)
        params = {k: v for k, v in self.params.items() if k != "_legacy"}
        if self.pool_compat:
            # the pool is genuine cross-frame state: thread it through the
            # windows exactly as the CLI's --window mode does
            from sangnom_tpu_torch.api import _LEGACY_ORDER_REMAP, _validate
            from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream

            kw = {k: params[k] for k in
                  ("order", "aa", "aac", "dh", "luma", "chroma",
                   "numerics", "opt") if k in params}
            if self.legacy:
                # the legacy surface has no dh/luma/chroma knobs; mirror
                # sangnom()'s fixed defaults (same policy as the CLI)
                _validate("SangNom", clip, kw.get("order", 1),
                          kw.get("aa", 48), 0, kw.get("opt", -1))
                order = kw.get("order", 1)
                kw = dict(order=_LEGACY_ORDER_REMAP[order]
                          if order != 1 else 1,
                          aa=kw.get("aa", 48), opt=kw.get("opt", -1),
                          numerics=kw.get("numerics", "c"))
            out, self._pool_state = sangnom2_pool_stream(
                clip, self._pool_state, **kw)
        else:
            fn = _REGISTRY["SangNom" if self.legacy else "SangNom2"]
            out = fn(clip, **params)
        return [p.cpu().numpy() for p in out.planes]

    def _store(self, start: int, outs) -> None:
        if start in self._cache:
            return
        self._cache[start] = outs
        self._order.append(start)
        while len(self._order) > self.cache_windows:
            self._cache.pop(self._order.pop(0), None)

    def _slice(self, start: int, n: int) -> list[np.ndarray]:
        return [p[n - start] for p in self._cache[start]]

    def _fetch_off_worker(self, start: int) -> list:
        """Source frames of the window at ``start``, fetched through the
        host on a fresh daemon thread (pool-mode random access only — the
        one path whose inputs the current request did not supply).  The
        fetch consumes no host worker itself, but PRODUCING the frame may
        need one free worker upstream (vapoursynth.py docstring point 3),
        so the wait is bounded (`fetch_timeout`): a pathological seek storm
        fails loudly instead of hanging the host.  A per-fetch daemon
        thread (not a shared executor) means a timed-out fetch can never
        wedge later fetches behind its abandoned blocked call, and an
        abandoned thread never blocks interpreter exit."""
        if self._host_fetch is None:
            raise SangNomError(
                "SangNom2: pool_compat random access needs a host fetch "
                "path (internal error: adapter wired without one).")
        end = min(start + self.batch, self.num_frames)
        box: list = []
        done = threading.Event()

        def fetch_range():
            try:
                box.append([self._host_fetch(k) for k in range(start, end)])
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box.append(e)
            finally:
                done.set()

        threading.Thread(target=fetch_range, name="sangnom-prefetch",
                         daemon=True).start()
        timeout = fetch_timeout()
        with span(HOST_FETCH, start=start, frames=end - start):
            fetched = done.wait(timeout)
        if not fetched:
            raise SangNomError(
                "SangNom2: pool_compat random-access fetch timed out "
                f"after {timeout:.0f}s — the host could not serve the "
                "filter's own frame request (every host worker is likely "
                "blocked inside this filter). Request frames in clip "
                f"order instead of seeking, or raise {FETCH_TIMEOUT_ENV[0]}."
            )
        if isinstance(box[0], BaseException):
            raise box[0]
        return box[0]

    def get(self, n: int, window_frames_fn) -> list[np.ndarray]:
        """Output planes of frame ``n`` ([h, w] numpy per plane).
        ``window_frames_fn()`` builds {"planes": [...], "parity": bool}
        for EVERY source frame of ``n``'s window, in order.  It is a
        CALLABLE so the plane copies (batch full-frame memcpys) happen
        only on a cache miss — cache hits (batch-1 of every batch
        sequential requests) skip them entirely."""
        start = (n // self.batch) * self.batch
        with span(WINDOW, call=start, start=start,
                  frames=min(self.batch, self.num_frames - start)):
            if self.pool_compat:
                return self._get_pool(n, start, window_frames_fn)
            return self._get_plain(n, start, window_frames_fn)

    def _hit(self, start: int, n: int) -> list[np.ndarray]:
        """Frame ``n`` of the cached window at ``start``, counted as a hit
        (the caller holds ``_lock``)."""
        count("window_hits")
        return self._slice(start, n)

    def _run_miss(self, frames: list) -> list[np.ndarray]:
        count("window_misses")
        return self._run_window(frames)

    def _get_plain(self, n: int, start: int, window_frames_fn):
        with self._lock:
            if start in self._cache:
                return self._hit(start, n)
            ev = self._inflight.get(start)
            if ev is None:
                ev = self._inflight[start] = threading.Event()
                owner = True
            else:
                owner = False
        if not owner:
            # the owner depends only on the device, never on the host —
            # waiting here cannot deadlock the worker pool
            with span(WINDOW_WAIT):
                ev.wait()
            with self._lock:
                if start in self._cache:
                    return self._hit(start, n)
            # evicted between set() and our wake: recompute from our own
            # prefetched frames (never re-enter the host)
            outs = self._run_miss(window_frames_fn())
            return [p[n - start] for p in outs]
        try:
            outs = self._run_miss(window_frames_fn())  # no lock held
            with self._lock:
                self._store(start, outs)
        finally:
            with self._lock:
                self._inflight.pop(start, None)
                ev.set()  # waiters recompute if the store above failed
        return [p[n - start] for p in outs]

    def _get_pool(self, n: int, start: int, window_frames_fn):
        """Pool windows run strictly in clip order, one computing thread
        at a time, with ORDERED turn-taking: among the requests currently
        inside this method, the lowest window goes first.  Under parallel
        sequential lookahead (a frame server pipelining requests for
        frames k, k+1, ...) every window's own requester is active when
        its turn comes, so the chain advances on host-prefetched frames
        ONLY — a later-window selector that happens to run first WAITS
        for its predecessors instead of re-entering the host.  Off-worker
        fetches happen only when the chain's next window has no active
        requester at all — a genuine seek."""
        with self._lock:
            if start in self._cache:
                return self._hit(start, n)
        with self._cond:
            self._active[start] = self._active.get(start, 0) + 1
            self._cond.notify_all()  # min(active) may have changed
        try:
            return self._get_pool_turns(n, start, window_frames_fn)
        finally:
            with self._cond:
                self._active[start] -= 1
                if not self._active[start]:
                    del self._active[start]
                self._cond.notify_all()

    def _get_pool_turns(self, n: int, start: int, window_frames_fn):
        restart = False
        with self._cond:
            while True:
                with self._lock:
                    if start in self._cache:
                        return self._hit(start, n)
                if not self._chain_busy:
                    if start == self._pool_next:
                        break  # my turn: advance on my prefetched frames
                    if start == min(self._active):
                        # lowest active request, and it is not the chain's
                        # next window: either behind (evicted — replay
                        # 0..start) or a genuine forward seek (gap-fill);
                        # both consume host fetches only for windows no
                        # active request can supply.  Deferring to
                        # min(active) in BOTH cases keeps liveness (the
                        # minimum is always eligible once the chain
                        # idles) and minimizes fetches: each lower window
                        # is served by its own requester's prefetched
                        # frames first.
                        restart = start < self._pool_next
                        break
                # chain busy, or an earlier active request will take the
                # turn first: wait (bounded re-check; progress guaranteed
                # — min(active) is always eligible once the chain idles)
                with span(WINDOW_WAIT):
                    self._cond.wait(timeout=0.5)
            self._chain_busy = True
            if restart:
                self._pool_state, self._pool_next = None, 0
        try:
            s = self._pool_next
            while s <= start:
                frames = (window_frames_fn() if s == start
                          else self._fetch_off_worker(s))
                outs = self._run_miss(frames)  # threads _pool_state
                with self._lock:
                    self._store(s, outs)
                with self._cond:
                    self._pool_next = s = s + self.batch
        finally:
            with self._cond:
                self._chain_busy = False
                self._cond.notify_all()
        with self._lock:
            return self._slice(start, n)
