"""Width sharding across the devices of one process
(sangnom_tpu_torch.parallel.cross_device): a mesh row whose ``space`` slots
are different devices, each slot with its own tensors and launches.

On the CPU the route runs with ``"cpu"`` slots (``cross_device.
sangnom2_across`` sends a row through the route even where its slots
repeat a device): every slot has its own slab, carried rows and plain
steps, and the halo copies, the scatter and the gather go between the
slots' tensors.  Outputs must be bit-equal (tolerance 0, float too) to JAX
``sangnom2_sharded`` on the conftest's 8-device CPU mesh: its scan arm for
most cases, its Pallas kernel arms (interpret mode) on one or two small
clips each.  The halo exchanges and ``PEER_BYTES`` are held to their
formulas, and results to independence of ``chunk_rows``.

The ``cuda`` cases hold the per-slot K4 and K5 routes on ``cuda:0`` slots
against their plain versions and the one-device cluster route, and run a
real mesh of two cards, which skips below two cards.  This module imports
neither JAX nor the test conftest at module level (the JAX tests import it
inside), so on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cross_device.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.core.geometry import (  # noqa: E402
    aaf_as_pixel,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from sangnom_tpu_torch.ops.primitives import KernelSpec  # noqa: E402
from sangnom_tpu_torch.parallel import cross_device as cd  # noqa: E402
from sangnom_tpu_torch.parallel import default_mesh  # noqa: E402
from sangnom_tpu_torch.parallel import fused_smooth as fs  # noqa: E402
from sangnom_tpu_torch.parallel import shard_kernel as sk  # noqa: E402
from sangnom_tpu_torch.parallel import width_sharded as ws  # noqa: E402
from sangnom_tpu_torch.parallel.sharding import (  # noqa: E402
    Mesh,
    _sharded_pad_width,
    sangnom2_sharded,
)

ARMS = ["scan", "chunked", "fused", "fused_noweave"]


def _rand(rng, shape, fmt):
    """Full-range samples (tests/conftest.make_plane's distribution)."""
    if fmt.is_float:
        return (rng.random(shape, dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
    top = min(((1 << fmt.bits) - 1) * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=shape).astype(fmt.np_dtype)


def _planes(fmt_name, w, h, n, seed):
    rng = np.random.default_rng(seed)
    fmt = get_format(fmt_name)
    return [_rand(rng, (n,) + fmt.plane_dims(w, h, i)[::-1], fmt)
            for i in range(fmt.num_planes)]


def _clip(fmt_name, w, h, n, parity=None, seed=11, device="cpu"):
    parity = None if parity is None else np.asarray(parity)
    return T.Clip.from_numpy(_planes(fmt_name, w, h, n, seed), fmt_name, device=device,
                             parity=parity)


def _equal(a_planes, b_planes):
    assert len(a_planes) == len(b_planes)
    for i, (a, b) in enumerate(zip(a_planes, b_planes)):
        a = a if isinstance(a, np.ndarray) else np.asarray(a)
        np.testing.assert_array_equal(b, a, err_msg=f"plane {i}")


def _jax_sharded(fmt_name, w, h, n, data, space, parity=None, seed=11, **kw):
    """JAX sangnom2_sharded on the conftest's CPU mesh, same seeded input."""
    J = pytest.importorskip("sangnom_tpu")
    JP = pytest.importorskip("sangnom_tpu.parallel")
    planes = _planes(fmt_name, w, h, n, seed)
    jc = J.Clip.from_numpy(planes, fmt_name,
                           parity=None if parity is None else np.asarray(parity))
    out = JP.sangnom2_sharded(jc, JP.default_mesh(data=data, space=space),
                              space_axis="space", **kw)
    return [np.asarray(p) for p in out.planes]


def _across(fmt_name, w, h, n, data, space, parity=None, seed=11, chunk_rows=None, **kw):
    """The port's route across slots on a data x space grid of "cpu" slots."""
    grid = [["cpu"] * space for _ in range(data)]
    got = cd.sangnom2_across(_clip(fmt_name, w, h, n, parity, seed), grid,
                             chunk_rows=chunk_rows, **kw)
    return got.to_numpy()


def _vs_jax(fmt_name, w, h, n, data, space, smooth, jax_smooth="scan", parity=None,
            chunk_rows=None, **kw):
    want = _jax_sharded(fmt_name, w, h, n, data, space, parity, smooth=jax_smooth, **kw)
    cd.reset_peer_bytes()
    got = _across(fmt_name, w, h, n, data, space, parity, chunk_rows=chunk_rows,
                  smooth=smooth, **kw)
    _equal(want, got)
    assert cd.PEER_BYTES["kept"] > 0  # the route ran, halos and all


# --- against JAX sangnom2_sharded ----------------------------------------------

@pytest.mark.parametrize("smooth", ARMS)
def test_each_arm_matches_the_jax_arm(smooth):
    """Each arm against the same JAX arm (Pallas interpret mode for the
    kernel arms) on 1x4: subsampled chroma, order=0 per-frame offsets."""
    _vs_jax("YUV420P8", 64, 16, 3, 1, 4, smooth, jax_smooth=smooth,
            parity=[True, False, True], order=0, aa=48, aac=48)


@pytest.mark.parametrize("smooth", ["fused", "chunked"])
def test_kernel_arms_space2_match_the_jax_arm(smooth):
    _vs_jax("GRAY8", 64, 16, 2, 1, 2, smooth, jax_smooth=smooth, order=1, dh=True)


@pytest.mark.parametrize("smooth", ARMS)
@pytest.mark.parametrize("space", [2, 4])
def test_space_2_and_4(space, smooth):
    _vs_jax("YUV420P8", 64, 16, 2, 1, space, smooth, order=2, aac=32)


@pytest.mark.parametrize("smooth", ["scan", "chunked", "fused"])
def test_data_space_mesh_2x2(smooth):
    """A 2x2 data x space grid: each data row through the route."""
    _vs_jax("YUV444P8", 64, 16, 4, 2, 2, smooth, order=2, aa=96)


@pytest.mark.parametrize("smooth", ["chunked", "fused", "fused_noweave"])
def test_chroma_slot_past_the_width(monkeypatch, smooth):
    """YUV420P8 dh: the chroma plane (32 columns) is padded to 60 over 4
    slots; at R = 1 the last slot's slab starts past column 32, so its raw
    maps are zero throughout (local width 0)."""
    seen = []
    orig = cd._local_width
    monkeypatch.setattr(cd, "_local_width", lambda *a: seen.append(orig(*a)) or seen[-1])
    _vs_jax("YUV420P8", 64, 16, 2, 1, 4, smooth, chunk_rows=1, order=1, dh=True)
    assert 0 in seen, seen


@pytest.mark.parametrize("fmt_name,kw", [
    ("YUV420P10", dict(order=1, dh=True, aac=96)),
    ("GRAY16", dict(order=1, aa=128, aac=64)),
    ("GRAYS", dict(order=2)),
    ("YUV422PS", dict(order=1, aa=96, aac=96)),
], ids=["10bit", "u16", "float", "float422"])
@pytest.mark.parametrize("smooth", ["scan", "chunked", "fused"])
def test_10bit_u16_and_float(fmt_name, kw, smooth):
    _vs_jax(fmt_name, 64, 16, 2, 1, 4, smooth, **kw)


def test_float_fused_matches_the_jax_arm():
    _vs_jax("GRAYS", 64, 16, 2, 1, 4, "fused", jax_smooth="fused", order=1)


@pytest.mark.parametrize("order,dh,parity", [
    (0, False, [True, False, True]), (0, True, [False, True, True]),
    (1, False, None), (2, True, None),
], ids=["pf", "pf-dh", "offset0", "offset1-dh"])
@pytest.mark.parametrize("smooth", ["chunked", "fused"])
def test_weave_offsets(order, dh, parity, smooth):
    """The per-slot weave (K4 launches, the finalize step) for offsets 0, 1
    and per frame."""
    _vs_jax("YUV420P8", 64, 8, 3, 1, 4, smooth, parity=parity, order=order, dh=dh,
            aac=32)


@pytest.mark.parametrize("smooth", ["scan", "chunked", "fused"])
def test_sse2_numerics(smooth):
    _vs_jax("YUV420P8", 64, 16, 2, 1, 4, smooth, order=1, aa=0, numerics="sse2")


@pytest.mark.parametrize("fmt_name,w,space", [("GRAY8", 40, 4), ("YUV411P8", 128, 4),
                                              ("GRAY8", 64, 8)],
                         ids=["non-mod32", "411", "thin"])
@pytest.mark.parametrize("smooth", ["chunked", "fused"])
def test_uneven_widths(fmt_name, w, space, smooth):
    """A width off the stride, 4:1:1 chroma cut hardest below the stride,
    and 8-column slots (K4 takes the K5 route there, as on one device)."""
    _vs_jax(fmt_name, w, 16, 2, 1, space, smooth, order=1, dh=fmt_name == "YUV411P8",
            aac=48 if fmt_name == "YUV411P8" else 0)


# --- chunk_rows, exchanges and bytes ---------------------------------------------

@pytest.mark.parametrize("smooth", ["chunked", "fused", "fused_noweave"])
def test_results_do_not_depend_on_chunk_rows(smooth):
    kw = dict(order=0, parity=[True, False], smooth=smooth, dh=True, aac=48)
    want = _across("YUV420P8", 128, 16, 2, 1, 4, chunk_rows=1, **kw)
    for chunk_rows in (2, 5, None, 64):
        _equal(want, _across("YUV420P8", 128, 16, 2, 1, 4, chunk_rows=chunk_rows, **kw))


def _passes(w, h, n_frames, n_space):
    """(fields, rows of the kept field, padded width) of each plane pass of a
    YUV420P8 dh call: luma, then the fused U+V batch."""
    fmt = get_format("YUV420P8")
    stride = buffer_stride_elems(w, 1)
    out = [(n_frames, h, stride)]
    cw, ch = fmt.plane_dims(w, h, 1)
    out.append((2 * n_frames, ch, _sharded_pad_width(cw, ch, stride, n_space, fmt, True)))
    return out


def _expected(w, h, n_frames, n, smooth, chunk_rows):
    """HALO_EXCHANGES and PEER_BYTES of one u8 dh call across n slots: per
    plane pass one kept exchange, then a carry exchange between chunks
    (K4, K5 route) or a row exchange a row (scan); each exchange moves
    2(n-1) halos; the scatter and the gather move slots 1..n-1's own
    columns."""
    exch = {"kept": 0, "carry": 0, "row": 0}
    peer = {k: 0 for k in cd.PEER_BYTES}
    for N, bufH, S in _passes(w, h, n_frames, n):
        W = S // n
        steps = bufH - 1
        peer["scatter"] += (n - 1) * N * bufH * W
        if smooth == "scan":
            halo, rows_out = 3, bufH - 1
            exch["row"] += steps
            peer["row"] += steps * 2 * (n - 1) * 3 * 9 * N * 4
        else:
            geometry = cd.k4_geometry if smooth.startswith("fused") else cd.k5_geometry
            R, halo = geometry(W, steps, chunk_rows)
            chunks = math.ceil(steps / R)
            exch["carry"] += chunks - 1
            peer["carry"] += (chunks - 1) * 2 * (n - 1) * halo * 9 * N * 4
            rows_out = 2 * bufH if smooth in ("fused", "chunked") else bufH - 1
        exch["kept"] += 1
        peer["kept"] += 2 * (n - 1) * halo * N * bufH
        peer["gather"] += (n - 1) * N * rows_out * W
    return exch, peer


@pytest.mark.parametrize("smooth", ARMS)
@pytest.mark.parametrize("n,chunk_rows", [(2, None), (4, 3)])
def test_exchanges_and_peer_bytes(smooth, n, chunk_rows):
    ws.reset_exchanges()
    cd.reset_peer_bytes()
    before = dict(sk.LAUNCHES)
    clip = _clip("YUV420P8", 256, 16, 2)
    got = cd.sangnom2_across(clip, ["cpu"] * n, chunk_rows=chunk_rows, order=1, dh=True,
                             smooth=smooth)
    _equal([p.numpy() for p in T.sangnom2(clip, order=1, dh=True, opt=0).planes],
           got.to_numpy())
    exch, peer = _expected(256, 16, 2, n, smooth, chunk_rows)
    assert ws.HALO_EXCHANGES == exch
    assert cd.PEER_BYTES == peer
    assert sk.LAUNCHES == before  # the plain steps launch nothing


@pytest.mark.parametrize("fmt_name", ["GRAY8", "GRAYS"])
@pytest.mark.parametrize("route", ["fused", "chunked"])
def test_carried_rows_are_exact_after_each_exchange(monkeypatch, fmt_name, route):
    """The carry exchange's invariant: at the start of every chunk, each
    slot's carried smoothed row equals the whole plane's (one slot, no cut)
    at all of the slab's columns, halo included.  The outputs alone would
    not show a missing exchange at these sizes: the smoothing damps a cut's
    error within the slab's halo."""
    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    kept = torch.from_numpy(_rand(np.random.default_rng(4), (2, 24, 96), fmt))
    if route == "fused":
        name, run, geometry = "_k4_step", cd.fused_pass, cd.k4_geometry

        def carried(slab, out, offsets, gin, gout, lo, *a):
            return lo, gin.clone() if lo > 1 else None
    else:
        name, run, geometry = "_smooth_step", cd.chunked_pass, cd.k5_geometry

        def carried(raw, sm, base, *a):
            return base, sm[:, base - 1].clone() if base else None
    orig = getattr(cd, name)
    calls = []
    monkeypatch.setattr(cd, name, lambda *a: calls.append(carried(*a)) or orig(*a))
    run(kept, 0, aaf, spec, ["cpu"], None, 2)
    whole = dict(calls)
    calls.clear()
    n = 4
    run(kept, 0, aaf, spec, ["cpu"] * n, None, 2)
    _, halo = geometry(96 // n, 23, 2)
    assert len(calls) == n * len(whole) and len(whole) == 12
    for i, (start, rows) in enumerate(calls):
        if rows is None:
            continue
        x0, width, _ = cd._span(i % n, n, 96 // n, halo)
        assert torch.equal(rows, whole[start][..., x0:x0 + width]), (i % n, start)


# --- the router and its failures -----------------------------------------------

def test_router_mixes_one_device_and_cross_device_rows(monkeypatch):
    """A 2x2 mesh: the row of one device keeps the one-device route, the row
    of two devices ("cpu" and "cpu:0" are two devices to the mesh) takes
    the route across devices; the whole equals JAX on the same mesh shape."""
    from sangnom_tpu_torch.parallel import sharding

    routes = []
    orig_cross, orig_one = cd.sharded_interp, sharding._sharded_interp
    monkeypatch.setattr(cd, "sharded_interp", lambda s, d, c=None: routes.append(
        ("across", [str(x) for x in d])) or orig_cross(s, d, c))
    monkeypatch.setattr(sharding, "_sharded_interp", lambda s, n: routes.append(
        ("one", n)) or orig_one(s, n))
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu:0"]])
    kw = dict(order=1, aac=48)
    got = sangnom2_sharded(_clip("YUV420P8", 64, 16, 4), mesh, space_axis="space",
                           smooth="fused", **kw)
    _equal(_jax_sharded("YUV420P8", 64, 16, 4, 2, 2, smooth="scan", **kw), got.to_numpy())
    assert routes == [("one", 2), ("across", ["cpu", "cpu:0"])]


def test_cross_device_row_never_takes_the_one_device_route(monkeypatch):
    """No fallback: a row across devices runs none of the one-device
    routes' entries."""
    def refuse(*a, **k):
        raise AssertionError("one-device route")

    from sangnom_tpu_torch.parallel import sharding

    for name in ("deinterlace_fused_full", "interpolate_fused_full", "deinterlace_chunked",
                 "interpolate_chunked"):
        monkeypatch.setattr(fs, name, refuse)
    monkeypatch.setattr(ws, "interpolate_field_width_sharded", refuse)
    monkeypatch.setattr(sharding, "interpolate_field_width_sharded", refuse)
    clip = _clip("GRAY8", 64, 16, 2)
    want = T.sangnom2(clip, order=1, opt=0)
    for smooth in ARMS:
        got = sangnom2_sharded(clip, Mesh([["cpu", "cpu:0"]]), order=1, space_axis="space",
                               smooth=smooth)
        _equal([p.numpy() for p in want.planes], got.to_numpy())


def test_a_slot_on_a_device_without_data_raises_naming_it():
    """A "meta" slot holds no data: the route raises, naming the slot and
    its device, and does not run the row on one device."""
    with pytest.raises(RuntimeError, match=r"slot \d on (cpu|meta).*meta"):
        sangnom2_sharded(_clip("GRAY8", 64, 16, 2), Mesh([["cpu", "meta"]]),
                         space_axis="space", smooth="fused")


def test_a_failed_step_raises_naming_the_slot(monkeypatch):
    calls = []

    def step(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return orig(*a, **k)

    orig = fs._full_chunk_plain
    monkeypatch.setattr(fs, "_full_chunk_plain", step)
    with pytest.raises(RuntimeError, match=r"slot 0 on cpu: K4 steps \d+\.\.\d+ failed: "
                                           "launch failed"):
        cd.sangnom2_across(_clip("GRAY8", 64, 16, 2), ["cpu", "cpu"], chunk_rows=2,
                           order=1, smooth="fused")


# --- the pieces ----------------------------------------------------------------

@pytest.mark.parametrize("n,W,radius", [(2, 5, 3), (3, 9, 9), (4, 12, 7)])
def test_exchange_halo_across_matches_the_one_device_exchange(n, W, radius):
    """Each slot's halo columns after the exchange are its neighbours' own
    edge columns: those of width_sharded._exchange_halo at the cuts."""
    x = torch.arange(2 * n * W, dtype=torch.int32).view(2, n * W)
    want = ws._exchange_halo(ws._shards(x[None], n)[:, 0], radius, "kept")
    parts = []
    for q in range(n):
        x0, width, cl = cd._span(q, n, W, radius)
        part = torch.full((2, width), -1, dtype=torch.int32)
        part[:, cl:cl + W] = x[:, q * W:(q + 1) * W]
        parts.append(part)
    ws.reset_exchanges()
    cd.reset_peer_bytes()
    cd.exchange_halo_across(parts, radius, "carry")
    for q, part in enumerate(parts):
        lo = radius if q else 0
        assert torch.equal(part, want[q][:, radius - lo: radius - lo + part.shape[1]])
    assert ws.HALO_EXCHANGES["carry"] == 1
    assert cd.PEER_BYTES["carry"] == 2 * (n - 1) * radius * 2 * 4


@pytest.mark.parametrize("W,steps,chunk_rows", [(9, 100, None), (480, 539, None),
                                                (480, 539, 64), (7, 3, 16), (20, 4, 16)])
def test_geometry_keeps_halos_within_one_slot(W, steps, chunk_rows):
    for geometry, extra in ((cd.k4_geometry, 6), (cd.k5_geometry, 3)):
        if W - extra < 3 and geometry is cd.k4_geometry:
            continue
        R, halo = geometry(W, steps, chunk_rows)
        default = sk.SLOT_ROWS if geometry is cd.k4_geometry else sk.SLOT_ROWS_K5
        assert 1 <= R <= min(steps, chunk_rows or default)
        assert halo == 3 * R + extra and halo <= W


def test_one_shard_chunk_wrappers_refuse_cpu_tensors():
    spec = KernelSpec.from_format(get_format("GRAY8"))
    kept = torch.zeros((1, 4, 16), dtype=torch.uint8)
    carry = torch.zeros((1, 9, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        sk.full_chunk(kept, torch.zeros((1, 3, 16), dtype=torch.uint8), None, carry, carry,
                      1, 3, 10.0, spec, 16)
    raw = torch.zeros((9, 5, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        sk.smooth_chunk(raw, torch.zeros((9, 3, 16), dtype=torch.int32), 0, 3, spec)


def test_slot_plans_are_one_shard_chunk_plans():
    plan = sk.full_plan(1, 588, 540, 1, 227 * 1024, cluster=False)
    assert (plan.cluster, plan.H, plan.launches) == (False, 0, math.ceil(539 / plan.R))
    p5 = sk.smooth_plan(1, 534, 540, 227 * 1024, cluster=False)
    assert (p5.cluster, p5.H) == (False, 0)


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda:0")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (cross-device peer copies)")
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


CARD_FORMATS = [("GRAY8", False), ("GRAY8", True), ("GRAY16", False),
                ("YUV420P10", True), ("GRAYS", False)]
# (slots, columns a slot, true width short of the padded width by)
CARD_GEOMS = [(2, 20, 3), (4, 12, 7), (4, 70, 0), (3, 300, 11), (8, 9, 2)]


def _kept(fmt_name, N, bufH, S, short, seed, device):
    """[N, bufH, S] kept fields whose true width S - short is edge-padded, as
    parallel.sharding pads a plane."""
    k = _rand(np.random.default_rng(seed), (N, bufH, S - short), get_format(fmt_name))
    k = np.concatenate([k, np.repeat(k[:, :, -1:], short, axis=2)], axis=2)
    return torch.from_numpy(np.ascontiguousarray(k)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,sse2", CARD_FORMATS, ids=str)
@pytest.mark.parametrize("geom", CARD_GEOMS, ids=str)
def test_slot_routes_match_plain_on_card(cuda, fmt_name, sse2, geom):
    """The K4 and K5 routes on cuda:0 slots against their plain steps on the
    same tensors, every weave mode, chunk_rows 1 / 5 / 16, bit-equal; the
    launches a pass equal their formula."""
    n, W, short = geom
    fmt = get_format(fmt_name)
    spec = KernelSpec.from_format(fmt, sse2=sse2)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    S, N, bufH = n * W, 3, 13
    kept = _kept(fmt_name, N, bufH, S, short, n * 100 + W, cuda)
    pw = S - short if short else None
    devices = [cuda] * n
    rng = np.random.default_rng(W)
    for chunk_rows in (1, 5, 16):
        for weave in (None, 0, 1, "pf"):
            offs = weave if weave != "pf" else torch.from_numpy(
                rng.integers(0, 2, N).astype(np.int32)).to(cuda)
            for route, geometry in ((cd.fused_pass, cd.k4_geometry),
                                    (cd.chunked_pass, cd.k5_geometry)):
                sk.reset_launches()
                got = route(kept, offs, aaf, spec, devices, pw, chunk_rows)
                torch.cuda.synchronize()
                chunks = math.ceil((bufH - 1) / geometry(W, bufH - 1, chunk_rows)[0])
                if route is cd.fused_pass:
                    want_launches = {"full": n * chunks, "smooth": 0, "prepare": 0,
                                     "finalize": 0}
                else:
                    want_launches = {"full": 0, "smooth": n * chunks, "prepare": n,
                                     "finalize": n}
                assert sk.LAUNCHES == want_launches, (route.__name__, chunk_rows)
                want = route(kept, offs, aaf, spec, devices, pw, chunk_rows, plain=True)
                assert torch.equal(got, want), (route.__name__, chunk_rows, weave)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt_name,kw", [
    ("YUV420P8", dict(order=1, dh=True)),
    ("YUV420P8", dict(order=0)),
    ("YUV420P10", dict(order=2, aac=96)),
    ("GRAYS", dict(order=1)),
], ids=["dh", "pf", "10bit", "float"])
def test_slots_on_one_card_match_the_cluster_route(cuda, fmt_name, kw):
    """sangnom2 through four cuda:0 slots (K4, K5 route, scan) equals the
    one-device cluster routes and the single-device kernel path."""
    clip = _clip(fmt_name, 256, 32, 4, parity=[True, False, True, False], device=cuda)
    want = T.sangnom2(clip, **kw)
    mesh = Mesh([[cuda] * 4])
    for smooth in ("fused", "chunked", "scan"):
        one = sangnom2_sharded(clip, mesh, space_axis="space", smooth=smooth, **kw)
        got = cd.sangnom2_across(clip, [cuda] * 4, smooth=smooth, **kw)
        for a, b, c in zip(got.planes, one.planes, want.planes):
            assert torch.equal(a, b) and torch.equal(a, c), smooth


@pytest.mark.cuda
def test_real_multi_device_mesh(two_cards):
    """default_mesh(1, 2) over two cards runs the route across devices:
    peer halo copies, bit-equal to one card; with three cards or more, a
    2x2 grid mixing a row of one card with a row of two."""
    clip = _clip("YUV420P8", 256, 32, 4, device=two_cards[0])
    kw = dict(order=1, dh=True)
    want = T.sangnom2(clip, **kw)
    for smooth in ("fused", "chunked"):
        cd.reset_peer_bytes()
        got = sangnom2_sharded(clip, default_mesh(1, 2), space_axis="space",
                               smooth=smooth, **kw)
        assert cd.PEER_BYTES["carry"] > 0
        assert all(torch.equal(a, b) for a, b in zip(got.planes, want.planes)), smooth
    if len(two_cards) >= 3:
        mesh = Mesh([[two_cards[0]] * 2, two_cards[1:3]])
        got = sangnom2_sharded(clip, mesh, space_axis="space", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got.planes, want.planes))
