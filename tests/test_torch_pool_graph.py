"""A whole pool-compat call replayed as one CUDA graph
(sangnom_tpu_torch.ops.pool_graph).

On the CPU: where a call takes the graph (`pool_graph.engages`), the key
that tells two calls apart (`pool_graph.call_key`), the cache's bounds (keys
and bytes a device) and its least-recently-used order, a capture that fails
or a graph too large leaving its key eager, and the counters staying 0 on
CPU planes.  The ``cuda`` cases hold replayed calls on the card bit for bit
against the eager call on the same planes and against the native oracle's
shared pool, from a fresh pool and from a carried one, count captures and
replays, and find a replay's kernels in the profiler's trace.
This module imports neither JAX nor the test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pool_graph.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.ops import pool_carry as pc  # noqa: E402
from sangnom_tpu_torch.ops import pool_graph as pg  # noqa: E402
from sangnom_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream  # noqa: E402
from sangnom_tpu_torch.oracle import sangnom2_clip_oracle  # noqa: E402
from sangnom_tpu_torch.utils import profiling as pr  # noqa: E402

COUNTERS = ("pool_graph_captures", "pool_graph_replays", "pool_graph_eager_fallbacks")


def _clip(fname, w, h, n, seed, device="cpu", parity=None):
    """A seed-made clip; samples over the whole stored range past 8 bits
    (out-of-nominal codes included), so the C path's 16-bit wrap shows."""
    fmt = get_format(fname)
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if fmt.bits <= 8 else np.uint16
    top = (1 << fmt.bits) - 1 if fmt.bits <= 8 else min(((1 << fmt.bits) - 1) * 2, 65535)
    shapes = [(n, h, w)] + [(n, h >> fmt.subsampling_h, w >> fmt.subsampling_w)] * (
        fmt.num_planes - 1)
    planes = [rng.integers(0, top + 1, s, dtype=dtype) for s in shapes]
    return T.Clip.from_numpy(planes, fname, device=device, parity=parity)


def _counts(fn):
    """``fn()`` with spans on; its result and how far each graph counter
    moved."""
    before = pr.counters()
    with pr.tracing():
        out = fn()
    pr.drain()
    after = pr.counters()
    return out, {c: after.get(c, 0) - before.get(c, 0) for c in COUNTERS}


# --- the key ---------------------------------------------------------------

def _planes(luma=(4, 16, 64), dtype=torch.uint8, device="cpu"):
    n, h, w = luma
    return [torch.empty(luma, dtype=dtype, device=device)] + [
        torch.empty((n, h // 2, w // 2), dtype=dtype, device=device)] * 2


KEY = dict(stream=0, fresh=True, fmt_name="YUV420P8", offsets=[0, 1, 0, 1], order=0, aa=48, aac=0,
           dh=False, luma=True, chroma=True, numerics="c", opt=-1, arms=(True, False))

# (what changes, the changed arguments, the changed planes)
KEY_CHANGES = [
    ("shape", {}, _planes((4, 16, 96))),
    ("frames", dict(offsets=[0, 1, 0, 1, 0]), _planes((5, 16, 64))),
    ("dtype", dict(fmt_name="YUV420P10"), _planes(dtype=torch.uint16)),
    ("dtype_only", {}, _planes(dtype=torch.uint16)),
    ("format", dict(fmt_name="YUV422P8"), None),
    ("parity", dict(offsets=[1, 0, 1, 0]), None),
    ("order", dict(order=1, offsets=[0, 0, 0, 0]), None),
    ("order_same_offsets", dict(order=2), None),
    ("aa", dict(aa=40), None),
    ("aac", dict(aac=12), None),
    ("dh", dict(dh=True), None),
    ("luma", dict(luma=False), None),
    ("chroma", dict(chroma=False), None),
    ("numerics", dict(numerics="sse2"), None),
    ("opt", dict(opt=1), None),
    ("pool_fused", dict(arms=(False, False)), None),
    ("pool_split3", dict(arms=(True, True)), None),
    ("stream", dict(stream=94371968), None),
    ("carried_pool", dict(fresh=False), None),
    ("device", {}, _planes(device="meta")),
]


def test_key_is_a_pure_function_of_the_call():
    """The same call gives the same key, on other tensors of the same
    shapes; the key's first member is the device."""
    a = pg.call_key(_planes(), **KEY)
    b = pg.call_key(_planes(), **KEY)
    assert a == b and hash(a) == hash(b)
    assert a[0] == torch.device("cpu")


@pytest.mark.parametrize("what,change,planes", KEY_CHANGES, ids=[c[0] for c in KEY_CHANGES])
def test_key_changes_with_each_input(what, change, planes):
    base = pg.call_key(_planes(), **KEY)
    other = pg.call_key(_planes() if planes is None else planes, **{**KEY, **change})
    assert other != base


# --- where it engages ------------------------------------------------------

CUDA = torch.device("cuda", 0)
ENGAGES = [
    ("cuda_kernel_route", dict(device=CUDA, opt=-1, batched=False), True),
    ("cuda_opt1", dict(device=CUDA, opt=1, batched=False), True),
    ("cpu_tensors", dict(device=torch.device("cpu"), opt=-1, batched=False), False),
    ("opt0", dict(device=CUDA, opt=0, batched=False), False),
    ("pool_fast", dict(device=CUDA, opt=-1, batched=True), False),
]


@pytest.mark.parametrize("kw,want", [c[1:] for c in ENGAGES], ids=[c[0] for c in ENGAGES])
def test_engage_rule(kw, want):
    assert pg.engages(**kw) is want


CPU_CALLS = [
    ("bob", dict(pool_fast=False)),
    ("bob_pool_fast", dict(pool_fast=True)),
    ("bob_opt0", dict(opt=0)),
    ("stream_carried_pool", dict(stream=True)),
]


@pytest.mark.parametrize("kw", [c[1] for c in CPU_CALLS], ids=[c[0] for c in CPU_CALLS])
def test_cpu_calls_take_no_graph(monkeypatch, kw):
    """Pool-compat calls on CPU planes run eagerly, whatever the route:
    the cache holds no key for them and the counters stay 0."""
    monkeypatch.setattr(pc, "POOL_FAST", kw.get("pool_fast", False))
    clip = _clip("YUV420P8", 32, 8, 2, 5)
    held = dict(pg.CACHE.entries)

    def calls():
        outs = []
        for _ in range(3):
            if kw.get("stream"):
                woven = T.double_weave(T.separate_fields(clip))
                out, pool = sangnom2_pool_stream(woven, None, order=0)
                out, pool = sangnom2_pool_stream(woven, pool, order=0)
                outs.append(out.planes)
            else:
                outs.append(T.bob(clip, pool_compat=True, opt=kw.get("opt", -1)).planes)
        return outs

    outs, moved = _counts(calls)
    assert moved == dict.fromkeys(COUNTERS, 0)
    assert dict(pg.CACHE.entries) == held
    for o in outs[1:]:
        for g, w in zip(o, outs[0]):
            assert torch.equal(g, w)


# --- the cache -------------------------------------------------------------

def _k(device, name):
    return (torch.device(device), name)


def _stub(nbytes):
    """A held graph of ``nbytes`` bytes, for the cache's bounds."""
    return pg._Graph(None, [], None, (), None, nbytes)


def test_cache_keeps_its_bound_and_drops_the_least_recently_used():
    cache = pg.GraphCache(bound=2)
    assert cache.insert(_k("cpu", "a"), "A") == []
    assert cache.insert(_k("cpu", "b"), "B") == []
    assert cache.lookup(_k("cpu", "a")) == "A"  # a is now the most recent
    assert cache.insert(_k("cpu", "c"), "C") == [_k("cpu", "b")]
    assert list(cache.entries) == [_k("cpu", "a"), _k("cpu", "c")]
    assert cache.lookup(_k("cpu", "b")) is None
    assert cache.insert(_k("cpu", "d"), "D") == [_k("cpu", "a")]
    assert len(cache.entries) == 2


def test_cache_bound_is_a_device_s():
    """Keys of another device neither count against a device's bound nor
    are dropped for it."""
    cache = pg.GraphCache(bound=1)
    cache.insert(_k("meta", "x"), "X")
    cache.insert(_k("cpu", "a"), "A")
    assert cache.insert(_k("cpu", "b"), "B") == [_k("cpu", "a")]
    assert set(cache.entries) == {_k("meta", "x"), _k("cpu", "b")}


def test_cache_default_bound():
    assert pg.CACHE.bound == pg.GRAPHS_PER_DEVICE >= 2
    assert pg.CACHE.budget is pg.device_budget and 0 < pg.GRAPH_MEMORY_SHARE <= 1 / 8


def test_cache_keeps_a_device_s_graphs_within_its_bytes():
    """Graphs of one device hold at most ``budget`` bytes together: the
    least recently used graphs go first, keys without a graph (seen, eager)
    weigh nothing, and another device's graphs are not counted."""
    cache = pg.GraphCache(bound=8, budget=lambda d: 100)
    cache.insert(_k("meta", "x"), _stub(90))
    assert cache.insert(_k("cpu", "a"), _stub(40)) == []
    assert cache.insert(_k("cpu", "s"), pg._SEEN) == []
    assert cache.insert(_k("cpu", "b"), _stub(40)) == []
    cache.lookup(_k("cpu", "a"))  # b is now the least recent graph
    assert cache.insert(_k("cpu", "c"), _stub(30)) == [_k("cpu", "b")]
    assert set(cache.entries) == {_k("meta", "x"), _k("cpu", "a"), _k("cpu", "s"),
                                  _k("cpu", "c")}
    assert cache.insert(_k("cpu", "d"), _stub(100)) == [_k("cpu", "a"), _k("cpu", "c")]


def test_eager_keys_count_against_the_bound():
    """Keys left eager are held like any other, so their number is bounded
    too."""
    cache = pg.GraphCache(bound=3, budget=lambda d: 100)
    for n in range(10):
        cache.insert(_k("cpu", n), pg._EAGER)
    assert list(cache.entries) == [_k("cpu", n) for n in (7, 8, 9)]


class _Rerun:
    """A stand-in for a CUDA graph: a replay re-runs ``work`` on the
    static inputs into the static outputs, as a graph's replay writes
    them, and issues no wrapper launch."""

    def __init__(self, work, inputs, pool_in, outs, pool):
        self.work, self.inputs, self.pool_in = work, inputs, pool_in
        self.outs, self.pool = outs, pool

    def replay(self):
        outs, pool = self.work(self.inputs, self.pool_in)
        for o, n in zip(self.outs, outs):
            o.copy_(n)
        self.pool.copy_(pool)


def _work(ps, pool0):
    pool = ps[0].sum(dim=0) if pool0 is None else pool0.add_(ps[0].sum(dim=0))
    return (ps[0] + 1, ps[0] * 2), pool


def _body(ps, pool0):
    """The call, issuing three wrapper launches as the K7 route counts
    them."""
    pk.LAUNCHES["prepare"] += 3
    return _work(ps, pool0)


def _stand_in(nbytes):
    def capture(planes, pool0, body, device):
        inputs = [torch.empty_like(p) for p in planes]
        pool_in = None if pool0 is None else torch.empty_like(pool0)
        outs, pool = body(inputs, pool_in)
        return pg._Graph(_Rerun(_work, inputs, pool_in, outs, pool), inputs, pool_in,
                         outs, pool, nbytes)
    return capture


def test_run_is_eager_then_captures_then_replays(monkeypatch):
    """A key's first call runs eagerly, its second captures and replays,
    later ones replay: each call's outputs and pool are its own (a later
    replay leaves them), from the planes it was given.  The wrappers'
    launches are counted where they are issued, on the eager call and on
    the capture; a replay adds none."""
    monkeypatch.setattr(pg, "_capture", _stand_in(10))
    cache = pg.GraphCache(budget=lambda d: 100)
    key = _k("cpu", "k")
    clips = [[torch.full((2, 3), v, dtype=torch.int32)] for v in (5, 9)]
    start = pk.LAUNCHES["prepare"]
    got, moved = _counts(lambda: [cache.run(key, clips[k % 2], None, _body)
                                  for k in range(5)])
    assert moved == {"pool_graph_captures": 1, "pool_graph_replays": 3,
                     "pool_graph_eager_fallbacks": 0}
    assert pk.LAUNCHES["prepare"] - start == 3 * 2
    for k, (outs, pool) in enumerate(got):
        want_outs, want_pool = _work(clips[k % 2], None)
        for o, w in zip(outs, want_outs):
            assert torch.equal(o, w)
        assert torch.equal(pool, want_pool)
    graph = cache.lookup(key)
    for outs, pool in got:
        assert all(o.data_ptr() != s.data_ptr() for o, s in zip(outs, graph.outs))
        assert pool.data_ptr() != graph.pool.data_ptr()


def test_run_carries_the_caller_s_pool(monkeypatch):
    """From a caller's pool, every call (eager, captured, replayed) starts
    from it and updates it in place, as the eager call does, and returns
    it."""
    monkeypatch.setattr(pg, "_capture", _stand_in(10))
    cache = pg.GraphCache(budget=lambda d: 100)
    key = _k("cpu", "carried")
    planes = [torch.arange(6, dtype=torch.int32).reshape(2, 3)]
    pool = torch.zeros(3, dtype=torch.int32)
    for k in range(4):
        want = pool + planes[0].sum(dim=0)
        outs, got = cache.run(key, planes, pool, _body)
        assert got is pool and torch.equal(pool, want), k
        assert torch.equal(outs[0], planes[0] + 1)
    assert isinstance(cache.lookup(key), pg._Graph)


def test_graph_larger_than_its_device_s_bytes_stays_eager(monkeypatch):
    """A graph that alone exceeds its device's bytes is not kept: its key
    runs eagerly from then on, counted as a fallback, and the graphs held
    stay."""
    monkeypatch.setattr(pg, "_capture", _stand_in(101))
    cache = pg.GraphCache(budget=lambda d: 100)
    cache.insert(_k("cpu", "held"), _stub(60))
    key = _k("cpu", "big")
    planes = [torch.ones((2, 3), dtype=torch.int32)]
    start = pk.LAUNCHES["prepare"]
    got, moved = _counts(lambda: [cache.run(key, planes, None, _body) for _ in range(4)])
    assert moved == {"pool_graph_captures": 0, "pool_graph_replays": 0,
                     "pool_graph_eager_fallbacks": 3}
    assert cache.entries[key] is pg._EAGER and _k("cpu", "held") in cache.entries
    # the three eager calls and the dropped capture issued their launches
    assert pk.LAUNCHES["prepare"] - start == 3 * 5
    for outs, _ in got:
        assert torch.equal(outs[0], planes[0] + 1)


def test_failed_capture_leaves_the_key_eager():
    """A key whose capture raises (here: no CUDA) runs eagerly on every
    call after, counted as a fallback, and the launch counts are those the
    eager calls made."""
    cache = pg.GraphCache(budget=lambda d: 100)
    key = _k("cpu", "k")
    planes = [torch.arange(6, dtype=torch.uint8).reshape(1, 2, 3)]
    runs = []

    def body(ps, pool0):
        runs.append(ps[0].data_ptr())
        pk.LAUNCHES["prepare"] += 1
        return (ps[0] + 1,), torch.zeros(1)

    start = dict(pk.LAUNCHES)
    (outs, moved) = _counts(lambda: [cache.run(key, planes, None, body) for _ in range(4)])
    assert moved == {"pool_graph_captures": 0, "pool_graph_replays": 0,
                     "pool_graph_eager_fallbacks": 3}
    assert cache.entries[key] is pg._EAGER
    # every call ran eagerly on the caller's planes: the capture raised
    # before its body ran
    assert runs == [planes[0].data_ptr()] * 4
    assert pk.LAUNCHES["prepare"] - start["prepare"] == 4
    for o, _ in outs:
        assert torch.equal(o[0], planes[0] + 1)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def fresh_cache():
    pg.CACHE.clear()
    yield pg.CACHE
    pg.CACHE.clear()


def _woven(clip, entry, kw):
    """(the clip the pool pass sees, its order): the bob's woven fields at
    order 0, else the clip itself."""
    if entry == "bob":
        return T.double_weave(T.separate_fields(clip)), 0
    return clip, kw["order"]


def _call(entry, kw):
    if entry == "bob":
        return lambda c: T.bob(c, pool_compat=True, **kw)
    return lambda c: T.sangnom2(c, pool_compat=True, **kw)


def _impl(clip, order, pool0=None, opt=-1):
    """The pool pass on ``clip`` (woven): (planes, final pool)."""
    return pc.sangnom2_pool_impl(clip.planes, clip.parity_array(), clip.format, order,
                                 48, 0, False, True, True, pool0=pool0, opt=opt)


def _eager(clip, order, pool0=None):
    """The pool pass on ``clip`` with the graph off: the eager call."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pg, "engages", lambda *a: False)
        return _impl(clip, order, pool0=pool0)


def _oracle(clip, entry, kw):
    """The native oracle's shared pool over the woven clip: planes [N, h, w]."""
    woven, order = _woven(clip, entry, kw)
    frames = [[p[n].cpu().numpy() for p in woven.planes] for n in range(woven.num_frames)]
    out = sangnom2_clip_oracle(frames, woven.format, order=order, aa=48, aac=0,
                               parities=list(woven.parity_array()), pool_compat=True)
    return [torch.from_numpy(np.stack([f[i] for f in out])) for i in range(len(out[0]))]


def _equal(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g.cpu(), w.cpu()), f"{what} plane {i}"


# fname, w, h, frames, entry, kwargs
CARD_CASES = [
    # the benchmark's call: 8 interlaced 1080 frames, 16 out
    ("YUV420P8", 1920, 1080, 8, "bob", dict(aa=48, aac=0)),
    # samples past 8 bits: the C path's 16-bit wrap, full-height chroma
    ("YUV422P10", 200, 64, 4, "bob", dict(aa=48, aac=0)),
    # a width off the 32-column stride: the pool carries its pad columns
    ("GRAY8", 61, 40, 4, "sangnom2", dict(order=1, aa=48, aac=0)),
    ("GRAY8", 61, 40, 4, "sangnom2", dict(order=2, aa=48, aac=0)),
]
CARD_IDS = [f"{c[0]}_{c[1]}x{c[2]}_{c[4]}{c[5].get('order', '')}" for c in CARD_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("fname,w,h,n,entry,kw", CARD_CASES, ids=CARD_IDS)
def test_replays_equal_eager_and_oracle_on_card(cuda, fresh_cache, fname, w, h, n, entry, kw):
    """Four calls of one key through the public entry: the first eager, the
    second captured, two replayed; every output equals the oracle's shared
    pool and the eager call on the same planes."""
    clip = _clip(fname, w, h, n, w + h, device=cuda, parity=np.arange(n) % 2 == 0)
    woven, order = _woven(clip, entry, kw)
    eager, _ = _eager(woven, order)
    outs, moved = _counts(lambda: [_call(entry, kw)(clip).planes for _ in range(4)])
    assert moved == {"pool_graph_captures": 1, "pool_graph_replays": 2,
                     "pool_graph_eager_fallbacks": 0}
    want = _oracle(clip, entry, kw)
    _equal(eager, want, "eager")
    for k, got in enumerate(outs):
        _equal(got, want, f"call {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("fname,w,h,n,entry,kw", CARD_CASES, ids=CARD_IDS)
def test_replayed_pool_equals_eager_and_plain_on_card(cuda, fresh_cache, fname, w, h, n,
                                                      entry, kw):
    """The final pool of a replayed call equals the eager kernel route's
    from a fresh pool and the plain path's (opt=0), as do its planes."""
    clip = _clip(fname, w, h, n, w * h, device=cuda, parity=np.arange(n) % 2 == 1)
    woven, order = _woven(clip, entry, kw)
    eager = _eager(woven, order)
    plain = _impl(woven, order, opt=0)
    runs = [_impl(woven, order) for _ in range(4)]
    for k, (planes, pool) in enumerate(runs):
        for what, (wp, wpool) in (("eager", eager), ("plain", plain)):
            _equal(planes, wp, f"call {k} vs {what}")
            assert torch.equal(pool, wpool), f"call {k} pool vs {what}"
    assert runs[2][1].data_ptr() != runs[3][1].data_ptr()


@pytest.mark.cuda
def test_two_clips_in_turn_keep_their_outputs_on_card(cuda, fresh_cache):
    """Two clips of one key called in turn, six calls, every output held
    until the end: each equals its own clip's eager output, so no replay
    overwrote what an earlier call returned (the first call's among
    them)."""
    clips = [_clip("YUV420P8", 1920, 1080, 8, s, device=cuda) for s in (11, 12)]
    wants = []
    for c in clips:
        woven, order = _woven(c, "bob", {})
        wants.append(_eager(woven, order)[0])
    torch.cuda.synchronize()
    outs, moved = _counts(lambda: [T.bob(clips[k % 2], pool_compat=True).planes
                                   for k in range(6)])
    assert moved["pool_graph_captures"] == 1 and moved["pool_graph_replays"] == 4
    for k, got in enumerate(outs):
        _equal(got, wants[k % 2], f"call {k}")
    assert not all(torch.equal(a, b) for a, b in zip(wants[0], wants[1]))


@pytest.mark.cuda
def test_counts_and_launches_over_calls_of_one_key_on_card(cuda, fresh_cache):
    """Over n calls of one key one capture and n-2 replays; the wrappers
    count the launches they issue, on the eager call and on the capture
    (the K7 route: three a plane pass, 3 planes x 8 frames), and a replay
    adds none."""
    clip = _clip("YUV420P8", 1920, 1080, 4, 3, device=cuda)
    n = 6
    pk.reset_launches()
    _, moved = _counts(lambda: [T.bob(clip, pool_compat=True) for _ in range(n)])
    torch.cuda.synchronize()
    assert moved == {"pool_graph_captures": 1, "pool_graph_replays": n - 2,
                     "pool_graph_eager_fallbacks": 0}
    passes = 3 * 2 * 4
    assert pk.LAUNCHES == {"smooth": 0, "split3": 2 * passes, "prepare": 2 * passes,
                           "finalize": 2 * passes}


POOL_KERNELS = ("pool_prepare_kernel", "pool_smooth_kernel", "pool_finalize_kernel")


def _pool_kernels(fn) -> dict:
    """The pool kernels the profiler's trace shows on the card during
    ``fn()``: a count by name (prepare, the K6 walk, finalize)."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    seen: dict = {}
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for k in POOL_KERNELS:
                if k in e.get("name", ""):
                    seen[k] = seen.get(k, 0) + 1
    return seen


@pytest.mark.cuda
def test_replay_runs_the_eager_call_s_kernels_on_card(cuda, fresh_cache):
    """A replayed call runs on the card the pool kernels the eager call
    launches, as many of each, though no wrapper counts them: read from
    the profiler's trace."""
    clip = _clip("YUV420P8", 1920, 1080, 4, 5, device=cuda)
    woven, _ = _woven(clip, "bob", {})
    eager = _pool_kernels(lambda: _eager(woven, 0))
    for _ in range(2):
        T.bob(clip, pool_compat=True)
    pk.reset_launches()
    replayed, moved = _counts(lambda: _pool_kernels(lambda: T.bob(clip, pool_compat=True)))
    assert moved["pool_graph_replays"] == 1
    assert sum(pk.LAUNCHES.values()) == 0
    passes = 3 * 2 * 4
    assert sum(eager.values()) == 3 * passes and len(eager) == 3
    assert replayed == eager


@pytest.mark.cuda
@pytest.mark.parametrize("fname,w,h", [("YUV420P8", 1920, 1080), ("GRAY8", 61, 40)])
def test_carried_pool_windows_replay_on_card(cuda, fresh_cache, fname, w, h):
    """A windowed stream that carries its pool (the CLI's and the hosts'
    windows): the first window starts fresh, the second is its key's first
    call, the third captures and the rest replay; the joined windows and
    the final pool equal one eager call over the whole clip, and the
    stream leaves the caller's pool as it was."""
    n, win = 12, 2
    clip = _clip(fname, w, h, n, 17, device=cuda)
    whole, whole_pool = _eager(clip, 1)

    def windows():
        outs, pool, given = [], None, []
        for k in range(0, n, win):
            out, new = sangnom2_pool_stream(clip[k:k + win], pool, order=1)
            if pool is not None:
                given.append((pool, pool.clone()))
            outs.append(out)
            pool = new
        return outs, pool, given

    (outs, pool, given), moved = _counts(windows)
    assert moved == {"pool_graph_captures": 1, "pool_graph_replays": n // win - 3,
                     "pool_graph_eager_fallbacks": 0}
    _equal(T.Clip.concat(*outs).planes, whole, "windows")
    assert torch.equal(pool, whole_pool)
    for before, kept in given:
        assert torch.equal(before, kept)


@pytest.mark.cuda
def test_impl_updates_the_caller_s_pool_in_place_on_card(cuda, fresh_cache):
    """`sangnom2_pool_impl` with a caller's pool updates it in place and
    returns it, on every call of a key (eager, captured, replayed), as the
    eager call does."""
    clip = _clip("YUV420P8", 96, 32, 8, 21, device=cuda)
    halves = [clip[0:4], clip[4:8]]
    _, pool = _eager(halves[0], 1)
    want_b, want_pool = _eager(halves[1], 1, pool0=pool.clone())
    for k in range(4):
        p0 = pool.clone()
        got, got_pool = _impl(halves[1], 1, pool0=p0)
        assert got_pool is p0 and torch.equal(p0, want_pool), k
        _equal(got, want_b, f"call {k}")


@pytest.mark.cuda
def test_new_parity_or_stream_captures_anew_on_card(cuda, fresh_cache):
    """A flipped parity pattern is another key, and so is a caller's own
    stream: each captures on its own second call; the outputs equal the
    eager call's."""
    clip = _clip("YUV420P8", 96, 32, 4, 9, device=cuda)
    kinds = [dict(tff=True), dict(tff=True), dict(tff=False), dict(tff=False),
             dict(tff=True)]
    outs, moved = _counts(lambda: [T.bob(clip, pool_compat=True, **kw).planes
                                   for kw in kinds])
    assert moved == {"pool_graph_captures": 2, "pool_graph_replays": 1,
                     "pool_graph_eager_fallbacks": 0}
    for kw, got in zip(kinds, outs):
        woven = T.double_weave(T.separate_fields(clip, tff=kw["tff"]))
        _equal(got, _eager(woven, 0)[0], str(kw))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got, moved = _counts(lambda: [T.bob(clip, pool_compat=True).planes
                                      for _ in range(3)])
    side.synchronize()
    assert moved == {"pool_graph_captures": 1, "pool_graph_replays": 1,
                     "pool_graph_eager_fallbacks": 0}
    for g in got:
        _equal(g, outs[0], "caller stream")
