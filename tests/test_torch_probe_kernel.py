"""The probe kernels K8, K9 and K10 (csrc/probes.cu) against their plain
versions on the card.

Each case runs an arm through its kernel (``run`` on a CUDA tensor) and
through its plain PyTorch version (``run_plain`` on the same CUDA tensor);
they must be bit-equal.  All cases need a card and skip without one.  This
module imports neither JAX nor the test conftest, so on a machine with a
card and no JAX they run with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_probe_kernel.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch.tools import calibrate_vpu as cv  # noqa: E402
from sangnom_tpu_torch.tools import isolate_step as iso  # noqa: E402
from sangnom_tpu_torch.tools import probe_kernel as pk  # noqa: E402
from sangnom_tpu_torch.tools import probe_pool_dynrow as dyn  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


def _src(device, w=cv.W):
    return torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (cv.G, w))).to(device, torch.int32)


def _equal(got, want, kind=""):
    torch.cuda.synchronize()
    if kind in cv.TRANSPOSED:
        assert not got[:, :, cv.G:].any()
    assert torch.equal(got, want), (kind, int((got != want).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(cv.OPS_PER_ITER))
def test_calibrate_arm_on_card(cuda, kind):
    src = _src(cuda)
    k = 2 if kind in cv.STEP_KINDS else 3
    key = "mm" if kind in cv.MM_KINDS else "calibrate"
    for w in (256, 128):
        before = pk.LAUNCHES[key]
        got = cv.run(src, kind, k, w=w, steps=4)
        assert pk.LAUNCHES[key] == before + 1
        _equal(got, cv.run_plain(src, kind, k, w=w, steps=4), kind)


LINE_AND_STEP = [k for k in cv.OPS_PER_ITER if k not in cv.MM_KINDS]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 384, 1024, 2048])
@pytest.mark.parametrize("kind", LINE_AND_STEP)
def test_line_and_step_arms_on_card(cuda, kind, w):
    """Every line_kernel and step_kernel arm at widths of one warp (128) and
    of several: the one-warp lines wrap through shuffles alone, the longer
    ones trade warp edges through shared memory; at 384 the step arms run
    their 4-column build."""
    src = _src(cuda)
    k = 2 if kind in cv.STEP_KINDS else 3
    got = cv.run(src, kind, k, w=w, steps=3)
    _equal(got, cv.run_plain(src, kind, k, w=w, steps=3), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", cv.DEFAULT_ARMS + cv.MM_KINDS + ("stepv", "stepm"))
def test_calibrate_full_shape_on_card(cuda, kind):
    """Full G x W, 8 steps, at the differential's long chain (past the f32
    overflow for the mm arms: inf, then NaN from inf * 0, cast to 0)."""
    src = _src(cuda)
    k = cv.chain_lengths(kind)[1]
    _equal(cv.run(src, kind, k, steps=8), cv.run_plain(src, kind, k, steps=8), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 384])
@pytest.mark.parametrize("kind", cv.MM_KINDS)
def test_mm_arms_ragged_tiles_on_card(cuda, kind, w):
    """The mm arms where the last 16-row tile is ragged (r = 120 and 360
    rows), over 288 iterations: past the f32 overflow."""
    src = _src(cuda)
    got = cv.run(src, kind, 96, w=w, steps=3)
    _equal(got, cv.run_plain(src, kind, 96, w=w, steps=3), kind)
    if kind in ("mmbf16", "mmf32"):
        assert got[0].any() and not got[-1].any()  # finite, then NaN cast to 0


@pytest.mark.cuda
@pytest.mark.parametrize("arm", [f"{k}@1" for k in iso.KINDS if k != "bigslab"] + [
    "unroll@4", "hboxfull@2", "ramt1@1", "ramt130@2", "bigslab_iota@1",
    "slab3d_iota@1", "bigshift_iota@1"])
def test_isolate_arm_on_card(cuda, arm):
    kind, _, k = arm.partition("@")
    src = _src(cuda)
    _equal(iso.run(src, kind, int(k)), iso.run_plain(src, kind, int(k)))


ISO_SWEEP = ([f"{k}@1" for k in iso.KINDS if k != "bigslab"]
             + [f"ramt{n}@2" for n in (1, 3, 7, 8, 9, 255, 1024, 2047)]
             + [f"{k}_iota@1" for k in ("bigslab", "slab3d", "bigshift", "hboxfull",
                                         "ramt2047", "ramt9")])


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ISO_SWEEP)
def test_isolate_arm_sweep_on_card(cuda, arm):
    """Every K9 arm; ramtN on the shuffle route (N mod W within 3 of 0: 1,
    3, 2047) and the whole-line route; the _iota seeds."""
    kind, _, k = arm.partition("@")
    src = _src(cuda)
    got = iso.run(src, kind, int(k), steps=3)
    _equal(got, iso.run_plain(src, kind, int(k), steps=3))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["cols", "threads", "blocks", "smem_bytes"])
@pytest.mark.parametrize("kind", ["mix", "vshift6", "roll_sub", "stepv", "mmbf16", "mmf32",
                                  "mmint8", "unroll", "ramt130", "ramt2047", "dynrow"])
def test_launcher_refuses_a_plan_off_the_layout(cuda, monkeypatch, kind, field):
    """The library holds a plan to the grid the kernel's layout needs: a
    plan with another C, thread or block count, or too few shared bytes,
    raises instead of launching."""
    k9 = kind in ("unroll", "ramt130", "ramt2047")
    name = "isolate_plan" if k9 else "dynrow_plan" if kind == "dynrow" else "line_plan"
    right = getattr(pk, name)

    def off(*args):
        plan = right(*args)
        value = getattr(plan, field)
        return plan._replace(**{field: 12 - value if field == "cols" else
                                value - 4 if field == "smem_bytes" else value + 32})

    monkeypatch.setattr(pk, name, off)
    src = _src(cuda)
    before = dict(pk.LAUNCHES)
    with pytest.raises(RuntimeError):
        if kind == "dynrow":
            dyn.dynrow(torch.from_numpy(dyn.probe_input(np.uint8)).to(cuda), 70)
        elif k9:
            iso.run(src, kind, 1, steps=1)
        else:
            cv.run(src, kind, 1, steps=1)
    assert pk.LAUNCHES == before


@pytest.mark.cuda
def test_isolate_bigslab_raises_on_card(cuda):
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        iso.run(_src(cuda), "bigslab", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
@pytest.mark.parametrize("shape", [(64, 256, 70), (540, 1920, 542), (60, 1000, 30), (5, 17, 9)])
def test_dynrow_on_card(cuda, dtype, shape):
    """K10 on aligned rows and on rows that are not 16-byte aligned (S =
    1000 and 17: 8 and 1 columns past the last whole u8 group), with steps
    past H (the clamp repeats the last row)."""
    H, S, steps = shape
    kept = torch.from_numpy(dyn.probe_input(dtype, H, S)).to(cuda)
    before = pk.LAUNCHES["dynrow"]
    _equal(dyn.dynrow(kept, steps), dyn.dynrow_plain(kept, steps))
    assert pk.LAUNCHES["dynrow"] == before + 1
    assert dyn.run(dtype, H, S, steps)
