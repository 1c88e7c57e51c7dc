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
    for w in (256, 128):
        before = pk.LAUNCHES["calibrate"]
        got = cv.run(src, kind, k, w=w, steps=4)
        assert pk.LAUNCHES["calibrate"] == before + 1
        _equal(got, cv.run_plain(src, kind, k, w=w, steps=4), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", cv.DEFAULT_ARMS + ("mmbf16", "mmint8", "stepv", "stepm"))
def test_calibrate_full_shape_on_card(cuda, kind):
    """Full G x W, 8 steps, at the differential's long chain (past the f32
    overflow for the mm arms)."""
    src = _src(cuda)
    k = cv.chain_lengths(kind)[1]
    _equal(cv.run(src, kind, k, steps=8), cv.run_plain(src, kind, k, steps=8), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", [f"{k}@1" for k in iso.KINDS if k != "bigslab"] + [
    "unroll@4", "hboxfull@2", "ramt1@1", "ramt130@2", "bigslab_iota@1",
    "slab3d_iota@1", "bigshift_iota@1"])
def test_isolate_arm_on_card(cuda, arm):
    kind, _, k = arm.partition("@")
    src = _src(cuda)
    _equal(iso.run(src, kind, int(k)), iso.run_plain(src, kind, int(k)))


@pytest.mark.cuda
def test_isolate_bigslab_raises_on_card(cuda):
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        iso.run(_src(cuda), "bigslab", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
@pytest.mark.parametrize("shape", [(64, 256, 70), (540, 1920, 542)])
def test_dynrow_on_card(cuda, dtype, shape):
    H, S, steps = shape
    kept = torch.from_numpy(dyn.probe_input(dtype, H, S)).to(cuda)
    _equal(dyn.dynrow(kept, steps), dyn.dynrow_plain(kept, steps))
    assert dyn.run(dtype, H, S, steps)
