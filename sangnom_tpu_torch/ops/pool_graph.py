"""A whole pool-compat call replayed as one CUDA graph.

A sequential pool-compat call on the card issues three launches a plane
pass (K7: prepare, the K6 walk, finalize), 144 for the 8-frame 1080i bob,
and the Python around them: slicing, the weave's copies, checks and spans.
The card waits on that issue (PERF.md §5).  The same kernels on the same
data in the same order can be recorded once and replayed with one launch,
so the output is the eager call's, bit for bit.

`engages` says where a call takes the graph: CUDA planes, the kernel route
(``opt != 0``) and frames in order (not ``POOL_FAST``'s batched path),
whether the call starts from a fresh pool or from a caller's carried pool
(the CLI's and the hosts' windows).  Everything else runs eagerly.

`call_key` holds everything that can change what a call does: the device
and the caller's current stream (two streams never share the static
buffers), whether the pool is fresh (made inside the graph) or the
caller's (copied into a static pool first), the format, each plane's shape
and dtype, the per-frame offsets and the filter's arguments, and the
kernel-route arm flags read at the call.  `GraphCache.run` runs a key's
first call eagerly (it loads the library and fills the plan caches),
captures on its second and replays on every later one: the caller's planes
(and pool) are copied into the graph's static inputs on the caller's
stream, the graph replays there, and the outputs are cloned, so a later
replay never overwrites what a caller holds; a caller's pool is updated in
place, as the eager call updates it.  A capture that raises, or whose graph
alone is larger than its device's memory bound, leaves its key eager.  A
device holds at most ``GRAPHS_PER_DEVICE`` keys, and its graphs together
at most ``GRAPH_MEMORY_SHARE`` of its memory (each graph's static inputs
and its private memory pool, read after the capture); the least recently
used go first.

The kernel wrappers count their launches (``pool_kernel.LAUNCHES``) when
they issue them: on an eager call, and on a capture, whose launches the
capturing call's own replay runs once.  A later replay issues no wrapper
launch and adds nothing there; its work shows as its kernels in a device
trace, and its calls in ``pool_graph_replays``.  (A graph captured and then
found too large to keep never runs, yet its launches were counted.)

Counters (``utils.profiling.count``, while spans are on):
``pool_graph_captures``, ``pool_graph_replays`` (calls served by a replay,
the capturing call not counted) and ``pool_graph_eager_fallbacks`` (calls
run eagerly because their key's capture failed or its graph was too
large to keep).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from sangnom_tpu_torch.utils.logging import get_logger
from sangnom_tpu_torch.utils.profiling import count

# Keys a device holds, and the share of its memory its graphs may hold
# together: 2.5 GB of an 80 GB card, where the graph of a 16-frame 1080i
# bob (32 frames out) holds 315539456 bytes, its inputs and private pool.
GRAPHS_PER_DEVICE = 4
GRAPH_MEMORY_SHARE = 1 / 32


def engages(device: torch.device, opt: int, batched: bool) -> bool:
    """Whether a pool-compat call replays as a graph: CUDA planes, the
    kernel route, frames in order."""
    return device.type == "cuda" and opt != 0 and not batched


def call_key(planes, stream: int, fresh: bool, fmt_name: str, offsets, order: int,
             aa: int, aac: int, dh: bool, luma: bool, chroma: bool, numerics: str,
             opt: int, arms: tuple) -> tuple:
    """The key of a call: its device first (the cache's bounds are a
    device's), then the caller's stream, whether the pool is fresh, the
    format, each plane's shape and dtype, the per-frame offsets as bytes,
    the filter's arguments and the arm flags (``POOL_FUSED``,
    ``POOL_SPLIT3``)."""
    return (planes[0].device, stream, fresh, fmt_name,
            tuple((tuple(p.shape), p.dtype) for p in planes), bytes(offsets),
            order, aa, aac, dh, luma, chroma, numerics, opt, tuple(arms))


def device_budget(device: torch.device) -> int:
    """The bytes a device's graphs may hold together."""
    return int(torch.cuda.get_device_properties(device).total_memory * GRAPH_MEMORY_SHARE)


class _Graph:
    """A key's captured call: the graph, its static planes and pool (None
    for a fresh pool), its outputs and final pool, and the device bytes it
    holds."""

    def __init__(self, graph, inputs, pool_in, outs, pool, nbytes: int):
        self.graph, self.inputs, self.pool_in = graph, inputs, pool_in
        self.outs, self.pool, self.nbytes = outs, pool, nbytes

    def replay(self, planes, pool0):
        for s, p in zip(self.inputs, planes):
            s.copy_(p)
        if pool0 is not None:
            self.pool_in.copy_(pool0)
        self.graph.replay()  # on the current stream of the capture's device
        outs = tuple(o.clone() for o in self.outs)
        if pool0 is None:
            return outs, self.pool.clone()
        return outs, pool0.copy_(self.pool)


_SEEN = "seen"  # a key's first call ran eagerly; the next one captures
_EAGER = "eager"  # its capture failed or its graph was too large: eager for good


class GraphCache:
    """Keys to their state (`_SEEN`, then a `_Graph` or `_EAGER`), at most
    ``bound`` a device and graphs of at most ``budget(device)`` bytes a
    device, least recently used dropped first."""

    def __init__(self, bound: int = GRAPHS_PER_DEVICE, budget=device_budget):
        self.bound, self.budget = bound, budget
        self.entries: OrderedDict = OrderedDict()
        self.lock = threading.RLock()

    def lookup(self, key):
        """A key's state, marked most recently used (None: not held)."""
        with self.lock:
            state = self.entries.get(key)
            if state is not None:
                self.entries.move_to_end(key)
            return state

    def insert(self, key, state) -> list:
        """Hold ``state`` for ``key``; returns the keys dropped, least
        recently used first, to keep the key's device within its bounds."""
        with self.lock:
            self.entries[key] = state
            self.entries.move_to_end(key)
            same = [k for k in self.entries if k[0] == key[0]]
            dropped = same[: max(0, len(same) - self.bound)]
            graphs = [k for k in same if k not in dropped
                      and isinstance(self.entries[k], _Graph)]
            held = sum(self.entries[k].nbytes for k in graphs)
            if held:
                budget = self.budget(key[0])
                for k in graphs:
                    if held <= budget or k == key:
                        break
                    held -= self.entries[k].nbytes
                    dropped.append(k)
            for k in dropped:
                if isinstance(self.entries.pop(k), _Graph) and k[0].type == "cuda":
                    # no replay of the dropped graph may still be running
                    # when its memory goes back to the allocator
                    torch.cuda.synchronize(k[0])
            return dropped

    def clear(self) -> None:
        """Drop every key, and the graphs' memory with them."""
        with self.lock:
            devices = {k[0] for k, v in self.entries.items()
                       if isinstance(v, _Graph) and k[0].type == "cuda"}
            for d in devices:
                torch.cuda.synchronize(d)
            self.entries.clear()

    def run(self, key, planes, pool0, body):
        """The call ``body(planes, pool0) -> (outs, pool)`` for ``key``:
        eager on the key's first call, captured on its second, replayed
        after."""
        with self.lock:
            state = self.lookup(key)
            if isinstance(state, _Graph):
                count("pool_graph_replays")
                return state.replay(planes, pool0)
            if state is _SEEN:
                try:
                    graph = _capture(planes, pool0, body, key[0])
                except Exception:
                    get_logger().exception("pool_compat: CUDA graph capture failed; "
                                           "this call signature stays eager")
                    state = _EAGER
                else:
                    if graph.nbytes <= self.budget(key[0]):
                        count("pool_graph_captures")
                        self.insert(key, graph)
                        return graph.replay(planes, pool0)
                    get_logger().info(
                        "pool_compat: a graph of %d bytes exceeds the device's %d; "
                        "this call signature stays eager", graph.nbytes,
                        self.budget(key[0]))
                    del graph
                    state = _EAGER
            self.insert(key, _SEEN if state is None else state)
        if state is _EAGER:
            count("pool_graph_eager_fallbacks")
        return body(planes, pool0)


def _capture(planes, pool0, body, device) -> _Graph:
    """Record ``body`` on static copies of ``planes`` (and of ``pool0``)
    into a CUDA graph, on a side stream of ``device``; the graph's bytes
    are its static inputs' and its private pool's segments."""
    inputs = [torch.empty(p.shape, dtype=p.dtype, device=p.device) for p in planes]
    pool_in = None if pool0 is None else torch.empty_like(pool0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, stream=torch.cuda.Stream(device), capture_error_mode="thread_local"):
        outs, pool = body(inputs, pool_in)
    static = inputs if pool_in is None else [*inputs, pool_in]
    held = sum(t.numel() * t.element_size() for t in static)
    held += sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s["segment_pool_id"]) == tuple(graph.pool()))
    return _Graph(graph, inputs, pool_in, tuple(outs), pool, held)


CACHE = GraphCache()
