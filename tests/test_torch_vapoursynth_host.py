"""The port's VapourSynth adapter (sangnom_tpu_torch.hosts.vapoursynth)
against the JAX package's adapter and the port's direct API.

VapourSynth is not installed here, so both adapters run against the mock
host of tests/test_vapoursynth_host.py (imported, not copied): its
ModifyFrame prefetches every dependency before the selector runs and its
source node counts nested fetches.  Frames must equal the JAX adapter's and
the direct API's; the stress tests drive parallel out-of-order requests
through the plain and pool_compat paths.  The adapter's windows run on
``device`` ("cpu" here; it defaults to cuda).  Also here: the shared
runner's host-neutral fetch timeout.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.api import SangNomError  # noqa: E402
from sangnom_tpu_torch.hosts import window as twindow  # noqa: E402

from test_vapoursynth_host import (  # noqa: E402
    _MockFormat, _hammer, _install_mock, _src_node)

CPU = {"device": "cpu"}


def _want(stacked, fmt_name="YUV420P8", parity=None, legacy=False, **kw):
    clip = T.Clip.from_numpy(stacked, fmt_name, device="cpu", parity=parity)
    return (T.sangnom if legacy else T.sangnom2)(clip, **kw).to_numpy()


def _frames(node, indices, planes=3):
    out = {}
    for n in indices:
        f = node.get_frame(n)
        out[n] = [np.array(f[i]) for i in range(planes)]
    return out


def _check(got, want):
    for n, planes in got.items():
        for i, p in enumerate(planes):
            np.testing.assert_array_equal(p, want[i][n],
                                          err_msg=f"frame {n} plane {i}")


def test_imports_without_vapoursynth(monkeypatch):
    """The module imports, and registers, with no vapoursynth installed."""
    monkeypatch.setitem(sys.modules, "vapoursynth", None)
    import importlib

    import sangnom_tpu_torch.hosts.vapoursynth as host

    importlib.reload(host)
    ns: dict = {}
    assert host.register(ns) == "SangNom2" == host.register()
    assert set(ns) == {"SangNom2", "SangNom"}


def test_adapter_matches_jax_adapter_and_api(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_tpu.hosts.vapoursynth import SangNom2 as JSangNom2
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, n=7)
    out = SangNom2(node, order=1, dh=True, batch=4, **CPU)
    assert out.height == 32
    got = _frames(out, range(7))
    _check(got, _want(stacked, order=1, dh=True))
    jout = JSangNom2(node, order=1, dh=True, opt=0, batch=4)
    _check(got, [np.stack([_frames(jout, [n])[n][i] for n in range(7)])
                 for i in range(3)])
    assert node.nested_fetches == 0


def test_adapter_partial_last_window(rng, monkeypatch):
    """num_frames not divisible by batch: the end-padded gather clips must
    not leak padding into the outputs."""
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, n=7)
    out = SangNom2(node, order=2, opt=0, batch=4, **CPU)
    _check(_frames(out, (6, 5, 4, 0, 3)), _want(stacked, order=2))
    assert node.nested_fetches == 0


def test_adapter_order0_field_props(rng, monkeypatch):
    """order=0 parity comes from the _Field frame prop (1 = top)."""
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    props = {k: {"_Field": k % 2} for k in range(6)}
    node, stacked = _src_node(vs, rng, props=props)
    out = SangNom2(node, order=0, batch=8, **CPU)
    _check(_frames(out, range(6)),
           _want(stacked, parity=np.arange(6) % 2 == 1, order=0))


@pytest.mark.parametrize("seeks", [(0, 1, 2, 3, 4, 5, 6, 0),
                                   (6, 2, 5, 0, 3)])
def test_adapter_pool_compat_matches_jax_adapter(rng, monkeypatch, seeks):
    """pool_compat chains the pool through windows smaller than the clip, in
    playback order and with seeks forward and back (unaligned w=52,
    batch=3), equal to the whole clip and to the JAX adapter."""
    vs = _install_mock(monkeypatch)
    from sangnom_tpu.hosts.vapoursynth import SangNom2 as JSangNom2
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, w=52, h=16, n=7)
    out = SangNom2(node, order=2, batch=3, pool_compat=True, **CPU)
    got = _frames(out, seeks)
    _check(got, _want(stacked, order=2, pool_compat=True))
    jout = JSangNom2(node, order=2, opt=0, batch=3, pool_compat=True)
    jgot = _frames(jout, seeks)
    for n in got:
        for a, b in zip(got[n], jgot[n]):
            np.testing.assert_array_equal(a, b)
    assert node.nested_fetches == 0


def test_adapter_propagates_source_props(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    props = {k: {"_Matrix": 1, "_ColorRange": 1, "_Field": k % 2}
             for k in range(6)}
    node, _ = _src_node(vs, rng, props=props)
    f = SangNom2(node, order=0, batch=8, **CPU).get_frame(2)
    assert f.props["_Matrix"] == 1 and f.props["_ColorRange"] == 1
    assert f.props["_FieldBased"] == 0
    assert "_Field" not in f.props


def test_adapter_rejects_unsupported_depth(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    node, _ = _src_node(vs, rng)
    node.format = _MockFormat(vs.YUV, 9, vs.INTEGER, 1, 1)
    with pytest.raises(SangNomError, match="unsupported bit depth 9"):
        SangNom2(node, **CPU)
    node.format = _MockFormat(vs.RGB, 8, vs.INTEGER, 0, 0)
    with pytest.raises(SangNomError, match="Y/YUV planar"):
        SangNom2(node, **CPU)


def test_adapter_legacy_and_errors(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom, register

    node, stacked = _src_node(vs, rng)
    out = SangNom(node, order=0, batch=3, **CPU)  # legacy 0 = keep bottom
    _check(_frames(out, (0, 5)), _want(stacked, legacy=True, order=0))
    ns: dict = {}
    assert register(ns) == "SangNom2"
    with pytest.raises(SangNomError, match="order must be between 0..2."):
        ns["SangNom2"](node, order=5, **CPU).get_frame(0)


def test_adapter_device_defaults_to_cuda(rng, monkeypatch):
    """No device argument means CUDA: on a machine without a card a frame
    request fails loudly instead of running on the CPU."""
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, n=2)
    out = SangNom2(node, batch=2)
    if torch.cuda.is_available():
        _check(_frames(out, [1]), _want(stacked))
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            out.get_frame(0)


# --- multithreaded stress ----------------------------------------------------

def test_stress_parallel_out_of_order(rng, monkeypatch):
    """N threads, shuffled request orders: every frame equal to the direct
    filter, zero nested fetches."""
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    N = 12
    node, stacked = _src_node(vs, rng, n=N)
    out = SangNom2(node, order=1, batch=4, **CPU)
    results = _hammer(out, [list(rng.permutation(N)) for _ in range(6)],
                      n_threads=6)
    assert len(results) == N
    _check(results, _want(stacked, order=1))
    assert node.nested_fetches == 0


def test_stress_single_flight_dedup(rng, monkeypatch):
    """All threads storming ONE window: the window is computed once."""
    vs = _install_mock(monkeypatch)
    import sangnom_tpu_torch.hosts.vapoursynth as host

    node, stacked = _src_node(vs, rng, n=8)
    runs = []
    orig = host._WindowRunner._run_window

    def counting_run(self, frames):
        runs.append(threading.get_ident())
        return orig(self, frames)

    monkeypatch.setattr(host._WindowRunner, "_run_window", counting_run)
    out = host.SangNom2(node, order=1, batch=8, **CPU)
    results = _hammer(out, [list(range(8))] * 8, n_threads=8)
    assert len(runs) == 1, f"window recomputed {len(runs)}x despite dedup"
    _check(results, _want(stacked, order=1))


def test_stress_pool_compat_parallel(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_tpu_torch.hosts.vapoursynth import SangNom2

    N = 10
    node, stacked = _src_node(vs, rng, w=52, h=16, n=N)
    out = SangNom2(node, order=2, batch=3, pool_compat=True, **CPU)
    results = _hammer(out, [list(rng.permutation(N)) for _ in range(5)],
                      n_threads=5)
    assert len(results) == N
    _check(results, _want(stacked, order=2, pool_compat=True))
    assert node.nested_fetches == 0


def test_stress_pool_compat_sequential_parallel_lookahead(rng, monkeypatch):
    """Sequential playback with parallel lookahead: equal frames, zero
    nested fetches and zero off-worker fetches (ordered turn-taking)."""
    vs = _install_mock(monkeypatch)
    import sangnom_tpu_torch.hosts.vapoursynth as host

    off_worker = []
    orig_fetch = host._WindowRunner._fetch_off_worker

    def counting_fetch(self, start):
        off_worker.append(start)
        return orig_fetch(self, start)

    monkeypatch.setattr(host._WindowRunner, "_fetch_off_worker",
                        counting_fetch)
    N = 12
    node, stacked = _src_node(vs, rng, n=N)
    out = host.SangNom2(node, order=1, batch=4, pool_compat=True, **CPU)
    results = _hammer(out, [list(range(off, N)) for off in range(4)],
                      n_threads=4)
    _check(results, _want(stacked, order=1, pool_compat=True))
    assert node.nested_fetches == 0
    assert off_worker == []


# --- the shared runner's fetch timeout -----------------------------------------

def test_advice_fetch_timeout_is_host_neutral(monkeypatch):
    """Deviation from the JAX runner (its hosts/window.py:180 reads only
    SANGNOM_VS_FETCH_TIMEOUT and names VapourSynth's workers): the timeout
    is SANGNOM_FETCH_TIMEOUT, the old name is its alias, and the message
    names no host."""
    for name in twindow.FETCH_TIMEOUT_ENV:
        monkeypatch.delenv(name, raising=False)
    assert twindow.fetch_timeout() == twindow.FETCH_TIMEOUT_DEFAULT == 120.0
    monkeypatch.setenv("SANGNOM_VS_FETCH_TIMEOUT", "0.2")
    assert twindow.fetch_timeout() == 0.2
    monkeypatch.setenv("SANGNOM_FETCH_TIMEOUT", "0.1")
    assert twindow.fetch_timeout() == 0.1  # the host-neutral name wins

    release = threading.Event()

    def stuck_fetch(k):  # a host that cannot serve the request
        release.wait(30)
        raise RuntimeError("released")

    runner = twindow.WindowRunner(8, "GRAY8", dict(pool_compat=True),
                                  tff=True, batch=2, host_fetch=stuck_fetch,
                                  device="cpu")
    frame = {"planes": [np.zeros((8, 16), np.uint8)], "parity": True}
    try:
        for name in twindow.FETCH_TIMEOUT_ENV:
            monkeypatch.delenv("SANGNOM_FETCH_TIMEOUT", raising=False)
            monkeypatch.setenv(name, "0.1")
            with pytest.raises(SangNomError, match="timed out") as e:
                runner.get(6, lambda: [frame, frame])  # a seek past the chain
            msg = str(e.value)
            assert "SANGNOM_FETCH_TIMEOUT" in msg
            assert "VS_" not in msg and "VapourSynth" not in msg
    finally:
        release.set()
