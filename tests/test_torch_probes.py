"""The port's cost-model path (sangnom_tpu_torch.tools, utils.cost_model)
against the JAX package's tools and cost model.

Every K8 arm (tools/calibrate_vpu.py), every K9 arm (tools/archive/
isolate_step.py) and K10 (tools/archive/probe_pool_dynrow.py) runs through
the JAX tool in Pallas interpret mode and through the port's plain version
on the CPU, from the same numpy seed; they must be bit-equal.  The only
exception is columns 120..127 of the transposed K8 arms, which the JAX
kernel never writes.  The JAX tools are loaded by path (``tools/`` is not a
package); ``calibrate_vpu._run`` reads its module-global ``STEPS`` at trace
time, so it is set once, before the first call.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sangnom_tpu.core.formats import get_format as jax_get_format  # noqa: E402
from sangnom_tpu.utils import cost_model as jax_cm  # noqa: E402
from sangnom_tpu_torch.core.formats import get_format  # noqa: E402
from sangnom_tpu_torch.tools import calibrate_vpu as cv  # noqa: E402
from sangnom_tpu_torch.tools import isolate_step as iso  # noqa: E402
from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn  # noqa: E402
from sangnom_tpu_torch.utils import cost_model as cm  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
STEPS = 4   # K8 grid steps in these tests
W_TEST = 256


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_cal():
    mod = _load("_jax_calibrate_vpu", "tools/calibrate_vpu.py")
    mod.STEPS = STEPS
    return mod


@pytest.fixture(scope="module")
def jax_iso():
    return _load("_jax_isolate_step", "tools/archive/isolate_step.py")


@pytest.fixture(scope="module")
def src():
    return np.random.default_rng(0).integers(0, 255, (cv.G, cv.W)).astype(np.int32)


def _k8_pair(jax_cal, src, kind, k, w):
    want = np.asarray(jax_cal._run(jnp.asarray(src), kind, k, w))
    got = cv.run(src, kind, k, w=w, steps=STEPS, device="cpu").numpy()
    assert got.shape == want.shape == (STEPS, cv.G, 128)
    if kind in cv.TRANSPOSED:  # columns 120..127: undefined in the reference
        assert not got[:, :, cv.G:].any()
        got, want = got[:, :, :cv.G], want[:, :, :cv.G]
    return got, want


@pytest.mark.parametrize("kind", list(cv.OPS_PER_ITER))
def test_calibrate_arm_matches_jax(jax_cal, src, kind):
    k = 2 if kind in cv.STEP_KINDS else 3
    got, want = _k8_pair(jax_cal, src, kind, k, W_TEST)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arm", ["mix@128", "vshift6@384"])
def test_calibrate_narrow_width_matches_jax(jax_cal, src, arm):
    kind, _, w = arm.partition("@")
    got, want = _k8_pair(jax_cal, src, kind, 3, int(w))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["mmbf16", "mmf32", "mmroll"])
def test_calibrate_mm_past_f32_overflow(jax_cal, src, kind):
    """60 iterations a step grow the Fibonacci chain past f32 (inf, then NaN
    from inf * 0 in the product) within the 4 steps; both cast as XLA does."""
    got, want = _k8_pair(jax_cal, src, kind, 60, W_TEST)
    np.testing.assert_array_equal(got, want)
    if kind == "mmbf16":
        assert not got[-1].any()  # NaN casts to 0
        assert got[0].any()


def test_calibrate_rejects_bad_width():
    with pytest.raises(ValueError):
        cv.run(np.zeros((cv.G, cv.W), np.int32), "add", 1, w=200, steps=1, device="cpu")
    with pytest.raises(ValueError):
        cv.run(np.zeros((cv.G, cv.W), np.int32), "nope", 1, steps=1, device="cpu")


ISO_ARMS = [f"{k}@1" for k in iso.KINDS if k != "bigslab"] + [
    "unroll@2", "hboxfull@2", "ramt1@1", "ramt130@2", "bigslab_iota@1",
    "slab3d_iota@1", "bigshift_iota@1", "hboxfull_iota@1"]


@pytest.mark.parametrize("arm", ISO_ARMS)
def test_isolate_arm_matches_jax(jax_iso, src, arm):
    kind, _, k = arm.partition("@")
    want = np.asarray(jax_iso._run(jnp.asarray(src), kind, int(k)))
    got = iso.run(src, kind, int(k), device="cpu").numpy()
    assert got.shape == want.shape == (iso.STEPS, iso.G, 128)
    np.testing.assert_array_equal(got, want)


def test_isolate_bigslab_raises_in_both(jax_iso, src):
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jax_iso._run(jnp.asarray(src), "bigslab", 1)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        iso.run(src, "bigslab", 1, device="cpu")


def test_hbox7_is_the_clamped_box():
    """The TPU form (rolls, edge slabs) is the 7-tap box clamped at S for
    columns < S and circular over the padded width beyond: the form the
    CUDA device function computes (hboxfull runs it against JAX above)."""
    a = np.random.default_rng(5).integers(-(1 << 30), 1 << 30, (2, 3, 2048)).astype(np.int64)
    x = np.arange(2048)
    want = np.zeros_like(a)
    for k in range(-3, 4):
        want += np.where(x < 1920, a[..., np.clip(x + k, 0, 1919)], a[..., (x + k) % 2048])
    want = ((want + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    got = iso.hbox7(torch.from_numpy(a.astype(np.int32)), 1920).numpy()
    np.testing.assert_array_equal(got, want)


class _Recorder:
    """Stands in for the JAX probe's ``pl``: records each pallas_call's output."""

    def __init__(self, pl):
        self._pl, self.outs = pl, []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        call = self._pl.pallas_call(*args, **kwargs)

        def run(*a):
            out = call(*a)
            self.outs.append(np.asarray(out))
            return out
        return run


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_dynrow_matches_jax(monkeypatch, dtype):
    mod = _load("_jax_probe_pool_dynrow", "tools/archive/probe_pool_dynrow.py")
    rec = _Recorder(mod.pl)
    monkeypatch.setattr(mod, "pl", rec)
    assert mod.run(dtype)
    got = dyn.dynrow(torch.from_numpy(dyn.probe_input(dtype)), 70).numpy()
    np.testing.assert_array_equal(got, rec.outs[0])
    assert dyn.run(dtype, device="cpu")


@pytest.mark.parametrize("fmt_name", ["GRAY8", "YUV420P8", "YUV422P10", "YUV444PS"])
@pytest.mark.parametrize("dh", [False, True])
def test_kernel_ops_per_frame_matches_jax(fmt_name, dh):
    for size in ((1920, 1080), (720, 480), (61, 30)):
        for luma, chroma in ((True, True), (True, False), (False, True)):
            want = jax_cm.kernel_ops_per_frame(jax_get_format(fmt_name), *size, dh,
                                               luma=luma, chroma=chroma)
            got = cm.kernel_ops_per_frame(get_format(fmt_name), *size, dh,
                                          luma=luma, chroma=chroma)
            assert got == want, (size, luma, chroma)


def test_utilization_formula(monkeypatch):
    monkeypatch.setitem(cm.MEASURED_OP_RATES, "mix", 2.0e12)
    fmt = get_format("YUV420P8")
    u = cm.utilization(1000.0, fmt, 1920, 540, dh=True)
    ops = cm.kernel_ops_per_frame(fmt, 1920, 540, dh=True)
    assert u["ops_per_frame"] == ops
    assert u["achieved_ops_per_s"] == ops * 1000.0
    assert u["utilization"] == ops * 1000.0 / cm.PEAK_INT32_S
    assert u["vs_measured_achievable"] == ops * 1000.0 / 2.0e12


def test_predicted_step_time_formula(monkeypatch):
    for k in cm.STEP_OP_CLASSES:
        monkeypatch.setitem(cm.MEASURED_OP_RATES, k, 1.0e12)
    want = sum(cm.STEP_OP_CLASSES.values()) * 120 * 1920 / 1.0e12
    assert cm.predicted_step_time_s(120, 1920) == pytest.approx(want, rel=1e-12)


def test_measured_rates_carry_the_card():
    assert set(cm.STEP_OP_CLASSES) <= set(cm.MEASURED_OP_RATES)
    assert "H100" in cm.CALIBRATION_CARD and " W" in cm.CALIBRATION_CARD


def test_bound():
    assert cm.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert cm.bound(0, cm.PEAK_INT32_S) == (pytest.approx(1e3), "operations")


@pytest.mark.parametrize("arm", ["add", "mul", "min", "where", "shift_and", "mix", "roll"])
def test_int32_peak_above_measured_rates(arm):
    # A bound is the least time the card could take, so the peak it divides
    # by lies above every integer rate the card was measured at.
    assert cm.MEASURED_OP_RATES[arm] < cm.PEAK_INT32_S


_SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_111line_kernelILi0EEEvPKiPiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x0 */
        /*0010*/                   IADD3 R2, R2, R3, RZ ;                 /* 0x0 */
        /*0020*/                   IMAD.IADD R3, R3, 0x1, R2 ;            /* 0x0 */
        /*0030*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;      /* 0x0 */
        /*0040*/               @P0 BRA 0x10 ;                             /* 0x0 */
        /*0050*/                   IADD3 R5, R5, R6, RZ ;                 /* 0x0 */
        /*0060*/              @!P1 BRA 0x50 ;                             /* 0x0 */
        /*0070*/                   BRA 0x0 ;                              /* 0x0 */
        /*0080*/                   EXIT ;                                 /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_111line_kernelILi9EEEvPKiPiiii
        /*0000*/                   IMAD R2, R2, R2, RZ ;                  /* 0x0 */
        /*0010*/                   BRA 0x0 ;                              /* 0x0 */
"""


def test_sass_mix_parses_innermost_loops():
    from sangnom_tpu_torch.tools import sass_mix

    funcs = sass_mix.functions(_SASS)
    assert [len(b) for b in funcs.values()] == [9, 2]
    # the outer loop 0x0..0x70 holds both inner ones and is not reported
    assert sass_mix.arm_loops(_SASS, "add") == [
        ["IADD3", "IMAD.IADD", "ISETP.NE.AND", "BRA"], ["IADD3", "BRA"]]
    assert sass_mix.arm_loops(_SASS, "mul") == [["IMAD", "BRA"]]
    with pytest.raises(KeyError):
        sass_mix.arm_loops(_SASS, "where")
