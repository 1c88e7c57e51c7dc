"""The port's formats, geometry and primitives against sangnom_tpu.

Every registered format, the geometry helpers over a grid, and each
elementwise primitive on full-range arrays (wrap and SSE2 saturation cases
included) must agree exactly with the TPU package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sangnom_tpu.core import formats as jf  # noqa: E402
from sangnom_tpu.core import geometry as jg  # noqa: E402
from sangnom_tpu.ops import primitives as jp  # noqa: E402
from sangnom_tpu.ops import reference as jr  # noqa: E402
from sangnom_tpu_torch.core import formats as tf  # noqa: E402
from sangnom_tpu_torch.core import geometry as tg  # noqa: E402
from sangnom_tpu_torch.ops import primitives as tp  # noqa: E402
from sangnom_tpu_torch.ops import reference as tr  # noqa: E402

_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
             np.dtype(np.float32): torch.float32}


@pytest.mark.parametrize("name", sorted(jf.FORMATS))
def test_format_registry_matches(name):
    j, t = jf.get_format(name), tf.get_format(name.lower())
    for attr in ("name", "family", "bits", "is_float", "subsampling_w",
                 "subsampling_h", "num_planes", "planar", "component_size",
                 "is_yuv", "is_rgb", "is_420"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.np_dtype == j.dtype
    assert t.dtype == _TORCH_OF[j.dtype]
    assert t.has_alpha() == j.has_alpha()
    for plane in range(4):
        assert t.plane_dims(1920, 1080, plane) == j.plane_dims(1920, 1080, plane)
    assert set(tf.FORMATS) == set(jf.FORMATS)


def test_unknown_format():
    with pytest.raises(KeyError, match="unknown video format"):
        tf.get_format("NV12")


@pytest.mark.parametrize("name", ["GRAY8", "YUV420P10", "GRAY16", "YUV444PS",
                                  "YUVA422P12", "YV411"])
def test_geometry_matches(name):
    jfmt, tfmt = jf.get_format(name), tf.get_format(name)
    for aa in (0, 1, 47, 48, 64, 127, 128):
        for aac in (0, 33, 128):
            assert (tg.scaled_aa_thresholds(aa, aac, tfmt)
                    == jg.scaled_aa_thresholds(aa, aac, jfmt))
            for v in tg.scaled_aa_thresholds(aa, aac, tfmt):
                a, b = tg.aaf_as_pixel(v, tfmt), jg.aaf_as_pixel(v, jfmt)
                assert a == b and type(a) is type(b)
    for w in (1, 5, 31, 32, 33, 720, 960, 1920, 3840):
        assert (tg.buffer_stride_elems(w, tfmt.component_size)
                == jg.buffer_stride_elems(w, jfmt.component_size))
    for h in (1, 2, 15, 540, 1081):
        assert tg.buffer_height(h) == jg.buffer_height(h)


@pytest.mark.parametrize("is_float,mask", [(False, 0xFF), (False, 0xFFFF),
                                           (True, 0)])
def test_width_tiers_and_creep_match(is_float, mask):
    tspec = tp.KernelSpec(is_float, mask)
    jspec = jp.KernelSpec(is_float, mask)
    assert tg.decay_hops(mask or 1) == jg.decay_hops(mask or 1)
    for w in (5, 61, 640, 960, 1920):
        for bufH in (1, 4, 42, 270, 540):
            for S in (tg.buffer_stride_elems(w, 1), 1280, 1920, 3840):
                if S < w:
                    continue
                assert tg.creep_bound(w, bufH, tspec) == jg.creep_bound(w, bufH, jspec)
                tiers = tg.width_tiers(w, bufH, S, tspec)
                assert tiers == jg.width_tiers(w, bufH, S, jspec)
                # the smoothing clamp sits at S or at/after the creep bound
                S_clamp = tiers[2]
                assert S_clamp == S or S_clamp >= tg.creep_bound(w, bufH, tspec)
                assert w <= S_clamp <= S


SPECS = [
    pytest.param((False, 0xFF, False), id="u8_c"),
    pytest.param((False, 0xFF, True), id="u8_sse2"),
    pytest.param((False, 0xFFFF, False), id="u16_c"),
    pytest.param((False, 0xFFFF, True), id="u16_sse2"),
    pytest.param((True, 0, False), id="f32"),
]


def _operands(rng, spec, n=4096):
    """Full-range storage values, with the extremes forced in."""
    if spec[0]:
        a = (rng.random((3, n), dtype=np.float32) * 1.5 - 0.25).astype(np.float32)
        return a
    a = rng.integers(0, spec[1] + 1, size=(3, n)).astype(np.int32)
    a[:, :4] = [[0, spec[1], 0, spec[1]], [0, spec[1], spec[1], 0],
                [spec[1], 0, spec[1], 9]]
    return a


@pytest.mark.parametrize("spec", SPECS)
def test_primitives_match(spec):
    ts, js = tp.KernelSpec(*spec), jp.KernelSpec(*spec)
    assert ts.acc_dtype == (torch.float32 if spec[0] else torch.int32)
    rng = np.random.default_rng(sum(spec[:2]) + spec[2])
    p1, p2, p3 = _operands(rng, spec)
    t = [torch.from_numpy(x) for x in (p1, p2, p3)]
    j = [jnp.asarray(x) for x in (p1, p2, p3)]

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == ts.acc_dtype

    same(tp.calc_sangnom(*t, ts), jp.calc_sangnom(*j, js))
    same(tp.calc_sangnom(t[2], t[0], t[1], ts), jp.calc_sangnom(j[2], j[0], j[1], js))
    same(tp.avg_pair(t[0], t[1], ts), jp.avg_pair(j[0], j[1], js))
    same(tp.abs_diff(t[0], t[2]), jp.abs_diff(j[0], j[2]))
    # the writeback sees 21-tap sums of map values (up to 21 * mask)
    h = (p1 + p2 + p3) * 7 if not spec[0] else (p1 + p2) * np.float32(7)
    same(tp.smooth_writeback(torch.from_numpy(h), ts),
         jp.smooth_writeback(jnp.asarray(h), js))


def test_calc_sangnom_wrap_cases():
    """The wrapped and saturated predictor extremes named in the reference
    (s = -9 wraps to 65534 for 16-bit C numerics)."""
    z, nine = torch.tensor([0], dtype=torch.int32), torch.tensor([9], dtype=torch.int32)
    assert int(tp.calc_sangnom(z, z, nine, tp.KernelSpec(False, 0xFFFF))) == 65534
    assert int(tp.calc_sangnom(z, z, nine, tp.KernelSpec(False, 0xFFFF, True))) == 65535
    assert int(tp.calc_sangnom(z, z, nine, tp.KernelSpec(False, 0xFF))) == 254
    assert int(tp.calc_sangnom(z, z, nine, tp.KernelSpec(False, 0xFF, True))) == 255


@pytest.mark.parametrize("w", [1, 2, 3, 7, 40])
def test_neighborhood_and_taps_match(w):
    rng = np.random.default_rng(w)
    a = rng.integers(0, 65536, size=(2, 3, w)).astype(np.int32)
    got = tp.neighborhood(torch.from_numpy(a), 3)
    want = jp.neighborhood(jnp.asarray(a), 3)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    b = rng.integers(0, 65536, size=(2, 3, w)).astype(np.int32)
    for spec in ((False, 0xFFFF, False), (False, 0xFFFF, True)):
        tt, tpr = tr.pair_taps(torch.from_numpy(a), torch.from_numpy(b), tp.KernelSpec(*spec))
        jt, jpr = jr.pair_taps(jnp.asarray(a), jnp.asarray(b), jp.KernelSpec(*spec))
        for g, wv in zip(list(tt) + list(tpr), list(jt) + list(jpr)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
        for g, wv in zip(tr.error_maps_list(tt, tpr), jr.error_maps_list(jt, jpr)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def test_enums_match():
    assert [(b.name, int(b)) for b in tp.Buffers] == [(b.name, int(b)) for b in jp.Buffers]
    assert [int(b) for b in tp.SELECT_PRIORITY] == [int(b) for b in jp.SELECT_PRIORITY]
    assert tp.TOTAL_BUFFERS == jp.TOTAL_BUFFERS == 9


@pytest.mark.parametrize("name", ["GRAY8", "YUV420P10", "GRAY16", "GRAYS"])
def test_kernel_spec_from_format(name):
    for sse2 in (False, True):
        t = tp.KernelSpec.from_format(tf.get_format(name), sse2=sse2)
        j = jp.KernelSpec.from_format(jf.get_format(name), sse2=sse2)
        assert (t.is_float, t.mask, t.sse2) == (j.is_float, j.mask, j.sse2)
