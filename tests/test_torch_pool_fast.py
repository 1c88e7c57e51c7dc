"""The port's frame-parallel pool_compat path (``pool_carry.POOL_FAST``)
and the frame-batched pool kernels it runs (``pool_kernel.interp_batch``).

On the CPU the path goes through the batched wrappers, which run their
plain twins; its output and final pool are held bit for bit against the
port's sequential loop and the TPU package's sequential scan, and the
cases that are not provably frame-independent must stay on the loop.  The
``cuda`` cases launch the batched prepare, walk and finalize kernels and
hold each against its plain twin, and the whole path against the
sequential K7 route with its launch formula.  The TPU package is imported
inside the tests that use it, so on a card the ``cuda`` cases run with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pool_fast.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds  # noqa: E402
from sangnom_tpu_torch.ops import pool_carry as pc  # noqa: E402
from sangnom_tpu_torch.ops import pool_kernel as pk  # noqa: E402
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.ops.sangnom import sangnom2_pool_stream as stream  # noqa: E402


@pytest.fixture
def fast(monkeypatch):
    """POOL_FAST on at the given chunk size; records each engagement of the
    fast path.  The module's flags are restored after the test."""
    calls = []
    real = pc._sangnom2_pool_batched

    def spy(*a, **k):
        calls.append(a[0][0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(pc, "_sangnom2_pool_batched", spy)

    def on(batch=16):
        monkeypatch.setattr(pc, "POOL_FAST", True)
        monkeypatch.setattr(pc, "POOL_FAST_BATCH", batch)
        return calls

    return on


def _planes(seed, n, w, h, fmt_name="YUV420P8"):
    rng = np.random.default_rng(seed)
    fmt = get_format(fmt_name)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        top = (1 << (8 * fmt.component_size)) - 1
        planes.append(rng.integers(0, top + 1, (n, ph, pw)).astype(fmt.np_dtype))
    return planes


def _equal(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} plane {i}")


def test_pool_fast_is_off_by_default():
    assert pc.POOL_FAST is False and pc.POOL_FAST_BATCH == 16


def test_pool_fast_hook_matches_scan(fast):
    """The counterpart of tests/test_pool_backend_hooks.py's
    test_pool_fast_hook_matches_scan: on its engagement geometry the path
    equals the TPU package's sequential scan, frames and final pool."""
    import sangnom_tpu as J
    from sangnom_tpu.ops.sangnom import sangnom2_pool_stream as jstream

    fmt = get_format("YUV420P8")
    planes = _planes(0, 3, 64, 16)
    kw = dict(order=1, dh=True)
    want, want_pool = jstream(J.Clip.from_numpy(planes, "YUV420P8"), None, opt=0, **kw)
    calls = fast()
    assert pc._frames_independent(64, 16, fmt, True, True)
    clip = T.Clip.from_numpy(planes, "YUV420P8", device="cpu")
    got = T.sangnom2(clip, pool_compat=True, opt=-1, **kw)
    out, pool = stream(clip, None, **kw)
    assert calls == [3, 3]
    _equal(got.planes, want.planes, "sangnom2")
    _equal(out.planes, want.planes, "stream")
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want_pool))


@pytest.mark.parametrize("case", ["bob-ragged", "order0-irregular", "order2-ragged",
                                  "dh-gray16", "float"])
def test_fast_path_ragged_chunks_match_jax(fast, case):
    """Chunks of 2 over 5 frames (the last chunk ragged), order 0 with
    alternating parity (the pool bob's woven frames) and, in one chunk of
    5, with irregular parity, order 2, 16-bit and float: equal to the
    port's loop and the TPU package's scan."""
    import sangnom_tpu as J
    from sangnom_tpu.ops.sangnom import sangnom2_pool_stream as jstream

    fmt_name, w, h, kw = {
        "bob-ragged": ("YUV420P8", 64, 32, dict(order=0)),
        "order0-irregular": ("YUV420P8", 64, 32, dict(order=0)),
        "order2-ragged": ("YUV420P8", 64, 32, dict(order=2, aac=24)),
        "dh-gray16": ("GRAY16", 32, 8, dict(order=1, dh=True, numerics="sse2")),
        "float": ("GRAYS", 32, 12, dict(order=1)),
    }[case]
    if fmt_name == "GRAYS":
        rng = np.random.default_rng(5)
        planes = [(rng.random((5, h, w), np.float32) * 1.5 - 0.25).astype(np.float32)]
    else:
        planes = _planes(5, 5, w, h, fmt_name)
    parity = np.arange(5) % 2 == 0
    if case == "order0-irregular":
        parity = np.array([True, True, False, True, False])
    want, want_pool = jstream(J.Clip.from_numpy(planes, fmt_name, parity=parity), None,
                              opt=0, **kw)
    clip = T.Clip.from_numpy(planes, fmt_name, device="cpu", parity=parity)
    seq, seq_pool = stream(clip, None, **kw)
    calls = fast(batch=5 if case == "order0-irregular" else 2)
    out, pool = stream(clip, None, **kw)
    assert calls == [5]
    _equal(out.planes, want.planes, case)
    _equal(seq.planes, want.planes, f"{case} sequential")
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want_pool))
    assert torch.equal(pool, seq_pool)


@pytest.mark.parametrize("case", ["pool0", "noluma", "unaligned", "opt0"])
def test_not_independent_stays_sequential(fast, case):
    """A caller's pool, luma=False without dh, an unaligned luma width
    (pad columns carry) and the plain route (opt=0) take the sequential
    loop, with the flag on, and equal it."""
    w = 52 if case == "unaligned" else 64
    kw = dict(order=1, luma=case != "noluma")
    opt = 0 if case == "opt0" else -1
    clip = T.Clip.from_numpy(_planes(9, 4, w, 16), "YUV420P8", device="cpu")
    pool0 = None
    if case == "pool0":
        _, pool0 = stream(clip[0:1], None, **kw)
    want, want_pool = stream(clip, pool0, opt=opt, **kw)
    calls = fast(batch=2)
    got, pool = stream(clip, pool0, opt=opt, **kw)
    assert calls == []
    _equal(got.planes, want.planes, case)
    assert torch.equal(pool, want_pool)
    fmt = get_format("YUV420P8")
    assert pc._frames_independent(w, 16, fmt, False, kw["luma"]) == (case in ("pool0", "opt0"))


def _batch_inputs(fmt, K, P, S, bufH, w, device, rng, strided):
    """Kept rows [K, bufH, w] (frames and rows strided when ``strided``) and
    a batched carry holding the stale content of one earlier pass."""
    spec = KernelSpec.from_format(fmt)
    kept = torch.from_numpy(
        rng.integers(0, 256 if fmt.component_size == 1 else 65536,
                     (K, 2 * bufH + 1, w + 3)).astype(fmt.np_dtype)).to(device)
    kept = kept[:, 1::2, 2 : w + 2] if strided else kept[:, :bufH, :w].contiguous()
    zeros = torch.zeros((K, 9, S), dtype=spec.acc_dtype, device=device)
    body = torch.zeros((K, 9, P - 1, S), dtype=spec.acc_dtype, device=device)
    stale = torch.from_numpy(rng.integers(0, 256 if fmt.component_size == 1 else 65536,
                                          (K, P, S)).astype(fmt.np_dtype)).to(device)
    pk.interp_batch(stale, zeros, body, zeros, 20, spec)
    return spec, kept, (zeros, body, zeros)


@pytest.mark.parametrize("strided", [False, True])
def test_batch_twins_equal_per_frame_passes(strided):
    """The batched plain twins equal K per-frame K7 passes (their plain
    twins), interpolated rows and each frame's pool."""
    fmt = get_format("GRAY8")
    rng = np.random.default_rng(3)
    K, P, S, bufH, w = 3, 9, 40, 6, 37
    spec, kept, (z, body, _) = _batch_inputs(fmt, K, P, S, bufH, w, "cpu", rng, strided)
    bodies = [body[k].clone() for k in range(K)]
    got = pk.interp_batch(kept, z, body, z, 33, spec)
    for k in range(K):
        want = pk.interp_fused_plain(kept[k], z[k], bodies[k], z[k], 33, spec)
        assert torch.equal(got[k], want)
        assert torch.equal(body[k], bodies[k])


def test_batch_wrappers_refuse_bad_input():
    fmt = get_format("GRAY8")
    spec = KernelSpec.from_format(fmt)
    z = torch.zeros((2, 9, 8), dtype=torch.int32)
    body = torch.zeros((2, 9, 4, 8), dtype=torch.int32)
    kept = torch.zeros((2, 4, 8), dtype=torch.uint8)
    for call, msg in (
        (lambda: pk.interp_batch(kept[:1], z, body, z, 1, spec), "kept must be"),
        (lambda: pk.smooth_batch_(z[:1], body, z, spec), "row0 must be"),
        (lambda: pk.prepare_batch_(kept, body[:, :8], spec), "body must be"),
        (lambda: pk.finalize_batch(kept.to(torch.int32), body, 1, spec), "dtype"),
        (lambda: pk.interp_batch(torch.zeros((2, 6, 8), dtype=torch.uint8), z, body, z,
                                 1, spec), "does not fit"),
    ):
        with pytest.raises(ValueError, match=msg):
            call()


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


CUDA_FORMATS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False),
                ("YUV420P10", True), ("GRAYS", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CUDA_FORMATS, ids=str)
@pytest.mark.parametrize("K,P,S,bufH,w", [(3, 9, 64, 9, 64), (16, 41, 736, 20, 360),
                                          (2, 30, 1920, 30, 1920), (5, 6, 5, 3, 5)])
@pytest.mark.parametrize("strided", [False, True])
def test_batch_kernels_match_twins_on_card(cuda, fmt_name, sse2, K, P, S, bufH, w,
                                           strided):
    """The batched prepare, walk and finalize kernels against their plain
    twins on the same CUDA tensors: one launch each, whatever K."""
    fmt = get_format(fmt_name)
    rng = np.random.default_rng(K * 1000 + S)
    if fmt.is_float:
        kept = torch.from_numpy((rng.random((K, 2 * bufH + 1, w + 3), np.float32) * 1.5
                                 - 0.25).astype(np.float32)).to(cuda)
        kept = kept[:, 1::2, 2 : w + 2] if strided else kept[:, :bufH, :w].contiguous()
        spec = KernelSpec.from_format(fmt)
        z = torch.zeros((K, 9, S), dtype=spec.acc_dtype, device=cuda)
        body = torch.from_numpy(rng.random((K, 9, P - 1, S), np.float32)).to(cuda)
    else:
        spec, kept, (z, body, _) = _batch_inputs(fmt, K, P, S, bufH, w, cuda, rng, strided)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    b_plain = body.clone()
    pk.prepare_batch_plain_(kept, b_plain, spec)
    before = dict(pk.LAUNCHES)
    b_kern = pk.prepare_batch_(kept, body.clone(), spec)
    assert torch.equal(b_kern, b_plain), "prepare"
    pk.smooth_batch_plain_(z, b_plain, z, spec)
    pk.smooth_batch_(z, b_kern, z, spec)
    assert torch.equal(b_kern, b_plain), "walk"
    got = pk.finalize_batch(kept, b_kern, aaf, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.finalize_batch_plain(kept, b_plain, aaf, spec)), "finalize"
    assert {k: pk.LAUNCHES[k] - before[k] for k in before} == {
        "smooth": 0, "split3": 1, "prepare": 1, "finalize": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 7])
def test_fast_path_on_card_equals_sequential(cuda, fast, batch):
    """The fast path on CUDA tensors (the batched kernels) against the
    sequential K7 route: frames and final pool bit-equal, and 3 launches a
    plane and chunk."""
    parity = np.arange(18) % 2 == 0
    clip = T.Clip.from_numpy(_planes(11, 18, 128, 64), "YUV420P8", device=cuda,
                             parity=parity)
    want, want_pool = stream(clip, None, order=0)
    calls = fast(batch=batch)
    pk.reset_launches()
    got, pool = stream(clip, None, order=0)
    torch.cuda.synchronize()
    chunks = -(-18 // batch)
    assert calls == [18]
    assert pk.LAUNCHES == {"smooth": 0, "split3": 3 * chunks, "prepare": 3 * chunks,
                           "finalize": 3 * chunks}
    _equal(got.planes, want.planes, "fast path")
    assert torch.equal(pool, want_pool)


@pytest.mark.cuda
def test_walk_occupancy_on_card(cuda):
    threads, blocks = pk.walk_occupancy(KernelSpec.from_format(get_format("YUV420P8")), 1920)
    assert threads == 480 and blocks >= 1
