"""The port's sharded entry point (sangnom_tpu_torch.parallel) against
sangnom_tpu.parallel, mirroring tests/test_sharding.py.

The same seeded numpy inputs go through JAX ``sangnom2_sharded`` on the
conftest's 8-device CPU mesh and through the port's ``sangnom2_sharded`` on
a mesh of ``"cpu"`` slots; outputs must be bit-equal (tolerance 0, float
too), and equal to the single-device ``opt=0`` path.  The JAX fused and
chunked arms run in Pallas interpret mode, so those comparisons use one or
two small clips per arm; the rest are held against single-device JAX
``opt=0``, which tests/test_sharding.py ties to the JAX sharded path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
import sangnom_tpu.parallel as JP  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch.api import SangNomError  # noqa: E402
from sangnom_tpu_torch.parallel import (  # noqa: E402
    default_mesh,
    fused_smooth,
    sangnom2_sharded,
    width_sharded,
)
from sangnom_tpu_torch.parallel.sharding import Mesh  # noqa: E402

from conftest import make_planes  # noqa: E402


def _both(fmt_name, w, h, n, parity=None, seed=11):
    rng = np.random.default_rng(seed)
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    if parity is not None:
        parity = np.asarray(parity)
    return (J.Clip.from_numpy(planes, fmt_name, parity=parity),
            T.Clip.from_numpy(planes, fmt_name, device="cpu", parity=parity))


def _same(jclip, tclip):
    assert tclip.num_planes == jclip.num_planes
    for i, (a, b) in enumerate(zip(jclip.planes, tclip.to_numpy())):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"plane {i}")


def _mesh(data, space):
    return default_mesh(data, space, devices=["cpu"] * (data * space))


def _vs_single(fmt_name, w, h, n, data, space, kw, parity=None, **skw):
    """The port's sharded call == JAX single-device opt=0."""
    jc, tc = _both(fmt_name, w, h, n, parity)
    want = J.sangnom2(jc, opt=0, **kw)
    got = sangnom2_sharded(tc, _mesh(data, space), **skw, **kw)
    _same(want, got)


# --- the mesh ----------------------------------------------------------------

def test_mesh_construction(monkeypatch):
    mesh = _mesh(4, 2)
    assert mesh.shape == {"data": 4, "space": 2}
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="mesh 8x2 needs 16 devices, have 8"):
        default_mesh(data=8, space=2, devices=["cpu"] * 8)
    # no CUDA device and no devices: it raises, never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="mesh 1x1 needs 1 devices, have 0"):
        default_mesh()
    assert default_mesh(1, 4, devices=["cuda:0"] * 4).devices.shape == (1, 4)


def test_space_across_devices_not_ported():
    _, tc = _both("GRAY8", 64, 16, 2)
    mesh = Mesh([["cpu", "meta"]])
    with pytest.raises(NotImplementedError, match="multi-host"):
        sangnom2_sharded(tc, mesh, space_axis="space")
    # a data-only run takes each row's first slot
    got = sangnom2_sharded(tc, mesh, order=1)
    _same(J.sangnom2(_both("GRAY8", 64, 16, 2)[0], opt=0, order=1), got)


# --- the data axis -------------------------------------------------------------

def test_data_parallel_frames():
    jc, tc = _both("YUV420P8", 32, 16, 8)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=8), order=1, opt=0)
    _same(want, sangnom2_sharded(tc, _mesh(8, 1), order=1, opt=0))
    _same(J.sangnom2(jc, opt=0, order=1), sangnom2_sharded(tc, _mesh(8, 1), order=1))


def test_data_parallel_uneven_batch():
    """N=5 frames over 4 data rows: padding and trim."""
    _vs_single("GRAY8", 32, 16, 5, 4, 2, dict(order=2), opt=0)


def test_data_parallel_order0_parity():
    _vs_single("GRAY8", 32, 16, 4, 4, 1, dict(order=0),
               parity=[True, False, False, True], opt=0)


# --- the space axis ------------------------------------------------------------

@pytest.mark.parametrize("n_space", [2, 4, 8])
def test_width_sharded(n_space):
    _vs_single("GRAY8", 64, 16, 2, 1, n_space, dict(order=1), space_axis="space")


def test_width_sharded_2d_mesh():
    _vs_single("YUV444P8", 64, 16, 4, 2, 4, dict(order=2, aa=96), space_axis="space")


def test_width_sharded_chroma_subsampling():
    _vs_single("YUV420P8", 64, 16, 2, 2, 2, dict(order=1, dh=True), space_axis="space")


@pytest.mark.parametrize("smooth", ["scan", "chunked", "fused", "fused_noweave"])
def test_each_arm_matches_jax_sharded(smooth):
    """Each backend against the same JAX arm (Pallas interpret mode for the
    kernels) on a 2x4 mesh, subsampled chroma, order=0 per-frame offsets."""
    parity = [True, False, True]
    jc, tc = _both("YUV420P8", 64, 16, 3, parity)
    kw = dict(order=0, aa=48, aac=48, space_axis="space", smooth=smooth)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=2, space=4), **kw)
    got = sangnom2_sharded(tc, _mesh(2, 4), **kw)
    _same(want, got)
    _same(J.sangnom2(jc, opt=0, order=0, aa=48, aac=48), got)


@pytest.mark.parametrize("fmt_name,kw,parity,mode", [
    ("YUV420P8", dict(order=1, dh=True), None, 0),
    ("GRAY8", dict(order=2), None, 1),
    ("GRAY8", dict(order=0), [True, False, True], "pf"),
], ids=["offset0", "offset1", "per-frame"])
def test_fused_weave_matches_jax(monkeypatch, fmt_name, kw, parity, mode):
    """The fused arm goes through the sharded weave for offsets 0, 1 and per
    frame, and equals the JAX fused arm and single-device opt=0."""
    seen = []
    orig = fused_smooth.deinterlace_fused_full

    def spy(kept, offsets, *a, **k):
        seen.append(offsets if isinstance(offsets, int) else "pf")
        return orig(kept, offsets, *a, **k)

    monkeypatch.setattr(fused_smooth, "deinterlace_fused_full", spy)
    jc, tc = _both(fmt_name, 64, 16, 3, parity)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=1, space=4),
                               space_axis="space", opt=1, **kw)
    got = sangnom2_sharded(tc, _mesh(1, 4), space_axis="space", smooth="fused", **kw)
    _same(want, got)
    _same(J.sangnom2(jc, opt=0, **kw), got)
    assert mode in seen, seen


@pytest.mark.parametrize("fmt_name,kw", [
    ("GRAY16", dict(order=1, aa=128, aac=64)),
    ("GRAYS", dict(order=2)),
], ids=["u16", "float"])
@pytest.mark.parametrize("smooth", ["scan", "chunked", "fused", "fused_noweave"])
def test_u16_and_float_match_jax_sharded(fmt_name, kw, smooth):
    jc, tc = _both(fmt_name, 64, 16, 2)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=1, space=4),
                               space_axis="space", smooth=smooth, **kw)
    got = sangnom2_sharded(tc, _mesh(1, 4), space_axis="space", smooth=smooth, **kw)
    _same(want, got)


def test_fused_thin_shards_match_jax():
    """8 shards of a 64-column stride: 8-column shards, below K4's 9, take
    the chunked smoothing and weave_assemble, as in JAX."""
    jc, tc = _both("GRAY8", 64, 16, 2)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=1, space=8), order=1,
                               space_axis="space", opt=1)
    got = sangnom2_sharded(tc, _mesh(1, 8), order=1, space_axis="space", smooth="fused")
    _same(want, got)


@pytest.mark.parametrize("fmt_name,kw", [
    ("GRAY16", dict(order=1, aa=128, aac=64)),
    ("YUV420P10", dict(order=1, dh=True, aac=96)),
    ("GRAYS", dict(order=2)),
], ids=["u16", "10bit", "float"])
@pytest.mark.parametrize("smooth", ["fused", "chunked"])
def test_kernel_arms_u16_10bit_float(fmt_name, kw, smooth):
    _vs_single(fmt_name, 64, 16, 2, 1, 4, kw, space_axis="space", smooth=smooth)


@pytest.mark.parametrize("order,dh,parity", [
    (0, False, [True, False, True]), (0, True, [True, False, True]),
    (1, False, None), (1, True, None), (2, False, None), (2, True, None),
])
@pytest.mark.parametrize("smooth", ["scan", "fused", "fused_noweave"])
def test_orders_and_dh(order, dh, parity, smooth):
    """Order 0/1/2 with and without dh: weave offsets 0, 1 and per frame."""
    _vs_single("YUV420P8", 64, 8, 3, 1, 4, dict(order=order, dh=dh, aac=32),
               parity=parity, space_axis="space", smooth=smooth)


@pytest.mark.parametrize("smooth", ["scan", "fused"])
def test_sse2_numerics(smooth):
    _vs_single("YUV420P8", 64, 16, 2, 2, 4, dict(order=1, aa=0, numerics="sse2"),
               space_axis="space", smooth=smooth)


def test_bogus_numerics_rejected():
    _, tc = _both("YUV420P8", 64, 16, 2)
    with pytest.raises(SangNomError, match="numerics"):
        sangnom2_sharded(tc, _mesh(2, 4), numerics="bogus")


def test_float():
    _vs_single("GRAYS", 64, 16, 2, 1, 4, dict(order=1), space_axis="space")


def test_float_chroma_aac():
    _vs_single("YUV422PS", 64, 16, 2, 2, 4, dict(order=1, aa=96, aac=96),
               space_axis="space", smooth="fused")


@pytest.mark.parametrize("fmt_name,kw", [
    ("YUV420P8", dict(order=1, aa=48, aac=48)),
    ("YUV422P10", dict(order=2, aa=96, aac=96)),
], ids=["420", "422p10"])
@pytest.mark.parametrize("smooth", ["scan", "fused"])
def test_chroma_aac(fmt_name, kw, smooth):
    """Subsampled chroma smooths against the LUMA stride with zero-defined
    padding; aac > 0 runs the directional select on chroma."""
    _vs_single(fmt_name, 64, 16, 2, 2, 4, kw, space_axis="space", smooth=smooth)


@pytest.mark.parametrize("smooth", ["scan", "chunked", "fused"])
def test_non_mod32_width(smooth):
    _vs_single("GRAY8", 40, 16, 2, 1, 4, dict(order=1, aa=32), space_axis="space",
               smooth=smooth)


def test_alpha_passthrough():
    _vs_single("YUVA444P8", 64, 16, 2, 1, 8, dict(order=2), space_axis="space")


@pytest.mark.parametrize("fmt_name,kw", [
    ("YUV411P8", dict(order=1, dh=True, aac=48)),
    ("YUV422P16", dict(order=2, aa=128)),
], ids=["411", "422p16"])
@pytest.mark.parametrize("smooth", ["scan", "fused"])
def test_deep_stride_cut(fmt_name, kw, smooth):
    """4:1:1 chroma, cut hardest below the luma stride by _sharded_pad_width,
    and u16 with its wider decay bound."""
    _vs_single(fmt_name, 128, 16, 2, 1, 4, kw, space_axis="space", smooth=smooth)


def test_order0_dh():
    _vs_single("YUV420P8", 64, 8, 3, 1, 4, dict(order=0, dh=True, aac=32),
               parity=[True, False, True], space_axis="space")


def test_pad_width_matches_jax():
    from sangnom_tpu.parallel.sharding import _sharded_pad_width as jpad
    from sangnom_tpu_torch.parallel.sharding import _sharded_pad_width as tpad

    for fmt_name in ("YUV420P8", "YUV411P8", "YUV422P16", "GRAYS"):
        for w, h, stride, n, dh in ((960, 540, 1920, 4, True), (32, 8, 128, 4, False),
                                    (360, 240, 736, 8, False), (16, 16, 64, 8, True)):
            assert tpad(w, h, stride, n, T.get_format(fmt_name), dh) == \
                jpad(w, h, stride, n, J.get_format(fmt_name), dh)


# --- checks and messages -----------------------------------------------------

def test_smooth_requires_space_axis():
    _, tc = _both("GRAY8", 32, 16, 2)
    with pytest.raises(ValueError, match="requires space_axis"):
        sangnom2_sharded(tc, _mesh(8, 1), order=1, smooth="scan")


def test_smooth_unknown_name_rejected():
    _, tc = _both("GRAY8", 64, 16, 2)
    with pytest.raises(ValueError, match="expected one of"):
        sangnom2_sharded(tc, _mesh(4, 2), order=1, space_axis="space", smooth="fusd")


def test_width_sharding_validation():
    _, tc = _both("GRAY8", 32, 16, 2)  # stride 32
    with pytest.raises(ValueError, match="does not divide"):
        sangnom2_sharded(tc, _mesh(2, 3), space_axis="space")
    with pytest.raises(ValueError, match="local width 2 < 3"):
        sangnom2_sharded(_both("GRAY8", 32, 16, 2)[1],
                         default_mesh(1, 16, devices=["cpu"] * 16), space_axis="space")


def test_sharded_validates_params():
    _, tc = _both("GRAY8", 32, 16, 2)
    with pytest.raises(SangNomError, match=r"order must be between 0\.\.2\."):
        sangnom2_sharded(tc, _mesh(2, 1), order=9)
    with pytest.raises(SangNomError, match=r"opt must be between -1\.\.2\."):
        sangnom2_sharded(tc, _mesh(2, 1), opt=5)
    with pytest.raises(SangNomError, match="opt=1 requires a CUDA backend"):
        sangnom2_sharded(tc, _mesh(1, 4), space_axis="space", opt=1)


def test_pool_compat_sharded_rejected():
    _, tc = _both("YUV420P8", 32, 16, 4)
    with pytest.raises(SangNomError, match="pool_compat is not supported under sharding"):
        sangnom2_sharded(tc, _mesh(4, 2), order=1, pool_compat=True)


@pytest.mark.parametrize("smooth", ["fused", "chunked", "scan"])
def test_entry_point_halo_exchanges(smooth):
    """Exchanges per call: per plane pass (luma, fused U+V) one kept
    exchange and a carry exchange per chunk (K4, K5: also the raw maps'
    exchange), or a row exchange per row (scan), whatever the frame count;
    launch counts on the CPU stay 0."""
    from sangnom_tpu_torch.parallel import shard_kernel

    jc, tc = _both("YUV420P8", 256, 16, 2)
    width_sharded.reset_exchanges()
    before = dict(shard_kernel.LAUNCHES)
    got = sangnom2_sharded(tc, _mesh(1, 8), order=1, dh=True, space_axis="space",
                           smooth=smooth)
    _same(J.sangnom2(jc, opt=0, order=1, dh=True), got)
    assert shard_kernel.LAUNCHES == before
    # luma: W_loc 32, bufH 16; chroma (U+V): width 128 padded to 160, W_loc 20, bufH 8
    want = {"kept": 0, "carry": 0, "row": 0}
    for w_loc, bufH in ((32, 16), (20, 8)):
        if smooth == "fused":
            R = fused_smooth.chunk_geometry_k4(w_loc, bufH)[0]
            want["kept"] += 1
            want["carry"] += -(-bufH // R)
        elif smooth == "chunked":
            R = fused_smooth.chunk_geometry_k5(w_loc, bufH - 1)[0]
            want["kept"] += 2
            want["carry"] += -(-(bufH - 1) // R)
        else:
            want["kept"] += 1
            want["row"] += bufH - 1
    assert width_sharded.HALO_EXCHANGES == want


@pytest.mark.parametrize("fmt_name,kw", [
    ("YUV420P8", dict(order=1)),
    ("GRAY16", dict(order=2, aa=128)),
    ("GRAYS", dict(order=1)),
], ids=["yuv420", "u16", "float"])
def test_chunked_stages_match_jax(monkeypatch, fmt_name, kw):
    """The chunked route's plain stages (the prepare twin, the chunk loop on
    the whole plane, the finalize twin), put in place of the CPU route's
    glue, == the JAX chunked arm (Pallas interpret mode), chroma included."""
    from sangnom_tpu_torch.parallel import sharding

    def staged(kept, aaf, spec, n_space, plane_width=None, smooth="scan"):
        assert smooth == "chunked"
        return fused_smooth.interpolate_chunked_plain(kept, aaf, spec, n_space, plane_width)

    monkeypatch.setattr(sharding, "interpolate_field_width_sharded", staged)
    jc, tc = _both(fmt_name, 64, 16, 2)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=1, space=4),
                               space_axis="space", smooth="chunked", **kw)
    got = sangnom2_sharded(tc, _mesh(1, 4), space_axis="space", smooth="chunked", **kw)
    _same(want, got)


@pytest.mark.parametrize("fmt_name,order,parity", [
    ("GRAY8", 1, None), ("GRAY8", 2, None), ("GRAY16", 0, [True, False, True]),
], ids=["offset0", "offset1", "per-frame"])
def test_chunked_weave_stages_match_jax(fmt_name, order, parity):
    """The chunked route's weave (the finalize twin writing the woven plane)
    on a dh call's kept fields == the JAX chunked arm's output plane."""
    from sangnom_tpu_torch.core.geometry import aaf_as_pixel, scaled_aa_thresholds
    from sangnom_tpu_torch.ops.primitives import KernelSpec
    from sangnom_tpu_torch.ops.sangnom import field_offsets

    jc, tc = _both(fmt_name, 64, 16, 3, parity)
    want = JP.sangnom2_sharded(jc, JP.default_mesh(data=1, space=4), space_axis="space",
                               smooth="chunked", order=order, dh=True)
    fmt = T.get_format(fmt_name)
    spec = KernelSpec.from_format(fmt)
    aaf = aaf_as_pixel(scaled_aa_thresholds(48, 0, fmt)[0], fmt)
    offs = field_offsets(order, tc.parity if parity is not None else None, torch.device("cpu"))
    got = fused_smooth.deinterlace_chunked_plain(tc.planes[0], offs, aaf, spec, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.planes[0]))


def test_parallel_imports_no_jax():
    """The sharded path runs where JAX is absent: importing it and running a
    tiny width-sharded call on a CPU mesh loads neither jax nor sangnom_tpu."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, numpy as np, sangnom_tpu_torch as T\n"
        "from sangnom_tpu_torch.parallel import default_mesh, sangnom2_sharded\n"
        "from sangnom_tpu_torch.parallel import fused_smooth, shard_kernel\n"
        "p = np.arange(2 * 8 * 64, dtype=np.uint8).reshape(2, 8, 64)\n"
        "c = T.Clip.from_numpy([p], 'GRAY8', device='cpu')\n"
        "m = default_mesh(1, 4, devices=['cpu'] * 4)\n"
        "out = sangnom2_sharded(c, m, space_axis='space', smooth='fused')\n"
        "assert out.num_frames == 2 and out.height == 8\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'sangnom_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
