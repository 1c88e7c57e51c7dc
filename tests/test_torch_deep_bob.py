"""The port's bob on samples deeper than 8 bits against the benchmark's
plain reference (`benchmark/reference/sangnom.py`, plain torch, importing
neither JAX nor the port), bit for bit on seeded random samples: the 10-bit
4:2:2 1080i bob's format at a small size, both field orders, the default
and a chroma threshold, the shared pool, 12 bits.  And the spans it adds:
the ``u16_fields`` counter and the plane span's ``elem`` on the CPU; on
the card, the field kernel's launch spans name its build and shape.  This
module imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_deep_bob.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as snt  # noqa: E402
from benchmark import reference  # noqa: E402
from sangnom_tpu_torch.utils import profiling as pr  # noqa: E402

SEEDS = [2**31 + 101, 2**33 + 7, 3_900_000_021]


@pytest.fixture(autouse=True)
def spans_off():
    pr.disable()
    pr.drain()
    yield
    pr.disable()
    pr.drain()


def _planes(name, seed, n=2, h=24, w=64, device="cpu"):
    """[n, h, w] planes of format ``name``, uniform over its depth, in its
    storage dtype."""
    fmt = snt.get_format(name)
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if fmt.bits == 8 else np.uint16
    return [torch.from_numpy(rng.integers(0, 1 << fmt.bits, (n, *reversed(fmt.plane_dims(w, h, i))),
                                          dtype=dtype)).to(device)
            for i in range(fmt.num_planes)]


def _same_as_reference(name, planes, tff, **kwargs):
    got = snt.bob(snt.Clip(planes, name, tff=tff), **kwargs)
    want, parity = reference.run("bob", planes, snt.get_format(name).bits, tff, kwargs)
    assert [p.dtype for p in got.planes] == [p.dtype for p in want]
    for a, b in zip(got.planes, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert got.parity_array().tolist() == parity


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tff", [True, False])
@pytest.mark.parametrize("aa,aac", [(48, 0), (64, 32)])
def test_yuv422p10_bob_matches_the_reference(aa, aac, tff, seed):
    _same_as_reference("YUV422P10", _planes("YUV422P10", seed), tff, aa=aa, aac=aac)


def test_yuv422p10_pool_compat_bob_matches_the_reference():
    _same_as_reference("YUV422P10", _planes("YUV422P10", SEEDS[0], n=3, w=60), True,
                       aa=48, aac=0, pool_compat=True)


def test_12_bit_bob_matches_the_reference():
    _same_as_reference("YUV422P12", _planes("YUV422P12", SEEDS[1], w=60), False, aa=48, aac=48)


@pytest.mark.parametrize("name,elem", [("YUV422P10", 2), ("YUV420P8", 1)])
def test_u16_fields_counts_the_two_byte_fields_of_each_plane(name, elem):
    n = 3
    planes = _planes(name, SEEDS[2], n=n)
    before = pr.counters().get("u16_fields", 0)
    with pr.tracing():
        snt.bob(snt.Clip(planes, name, tff=True))
    recs = pr.drain()
    grown = pr.counters().get("u16_fields", 0) - before
    assert grown == (2 * n * 3 if elem == 2 else 0)
    plane_spans = [r for r in recs if r.name == pr.PLANE]
    assert sorted(str(r.counts["plane"]) for r in plane_spans) == ["0", "uv"]
    for r in plane_spans:
        assert r.counts["elem"] == elem
        assert r.counts.get("u16_fields", 0) == (r.counts["fields"] if elem == 2 else 0)


@pytest.mark.cuda
def test_field_kernel_launch_spans_name_their_build_and_shape():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sangnom_tpu_torch.core.formats import get_format
    from sangnom_tpu_torch.core.geometry import buffer_stride_elems, width_tiers
    from sangnom_tpu_torch.ops import cuda_library as cl
    from sangnom_tpu_torch.ops.launch_geometry import launch_shape
    from sangnom_tpu_torch.ops.primitives import KernelSpec

    cl.build()
    name, n, h, w = "YUV422P10", 2, 64, 256
    planes = _planes(name, SEEDS[0], n=n, h=h, w=w, device="cuda")
    _same_as_reference(name, planes, True, aa=48, aac=0)
    with pr.tracing():
        snt.bob(snt.Clip(planes, name, tff=True), opt=1)
    launches = [r for r in pr.drain() if r.name == pr.LAUNCH]
    fmt = get_format(name)
    spec = KernelSpec.from_format(fmt)
    stride = buffer_stride_elems(w, fmt.component_size)
    want = []
    for pw in (w, w // 2):  # luma, then U+V's one launch
        S = width_tiers(pw, h // 2, stride, spec)[2]
        want.append({"elem": 2, "rows": h // 2, "cols": pw, "smoothed": S,
                     "cols_per_thread": launch_shape(S)[0]})
    got = sorted(({k: r.counts[k] for k in want[0]} for r in launches), key=lambda c: -c["cols"])
    assert got == want
