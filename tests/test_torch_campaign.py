"""The port's parity campaigns (sangnom_tpu_torch.tools.parity_campaign and
parity_campaign_cpu).

The card campaign's generators must reproduce, line for line, the cases the
TPU campaign recorded in ``results/tpu_campaign_*.txt``, so the card's logs
can be held against them.  ``run_cases`` runs each mode on the CPU through
the plain path; a flipped sample or a raising case must show as a failure.
The CPU campaign's SSE2 compat cases, which its oracle cannot anchor, are
held against ``tests/scalar_model.py`` (it needs the JAX package).

This module imports neither JAX nor the test conftest at import time, so on
a machine with a card and no JAX the ``cuda`` case runs with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_campaign.py
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch  # noqa: E402
from sangnom_tpu_torch.tools import parity_campaign as pc  # noqa: E402
from sangnom_tpu_torch.tools import parity_campaign_cpu as pcc  # noqa: E402

RESULTS = Path(__file__).resolve().parent.parent / "results"

# recorded TPU campaign -> (mode flag or None for the fixed set, N, seed)
RECORDED = {
    "tpu_campaign_r02c_roll.txt": (None, 12, None),
    "tpu_campaign_random30_r05.txt": ("--random", 30, 551),
    "tpu_campaign_compat16_r05.txt": ("--compat", 16, 552),
    "tpu_campaign_sharded10_r05.txt": ("--sharded", 10, 553),
    "tpu_campaign_bob10_r05.txt": ("--bob", 10, 554),
}

# tiny hand-picked cases a mode: 4:1:1, alpha with dh, float, 10-bit,
# pool_compat with sse2, mixed parity, every smooth arm
TINY = {
    "oracle": [
        ("YUV411P8", 64, 16, 2, dict(order=1, aa=48, aac=48)),
        ("YUVA420P8", 48, 16, 1, dict(order=1, dh=True)),
        ("GRAYS", 40, 12, 2, dict(order=0, aa=20, aac=9, luma=True, chroma=False)),
    ],
    "compat": [
        ("GRAY10", 64, 16, 2, dict(order=0, dh=False, aa=59, aac=56, pool_compat=True,
                                   numerics="c")),
        ("YUV422P8", 60, 16, 2, dict(order=2, dh=True, aa=119, aac=56, pool_compat=True,
                                     numerics="sse2")),
        ("YUV444PS", 40, 12, 1, dict(order=1, dh=False, aa=26, aac=105, pool_compat=True)),
    ],
    "bob": [
        ("YUV420P10", 48, 24, 2, dict(aa=23, aac=42, tff=True)),
        ("YUV411P8", 64, 16, 1, dict(aa=5, aac=62, tff=False)),
    ],
    "sharded": [
        ("YUV422P12", 72, 16, 2, dict(order=0, dh=False, aa=125, aac=115, smooth="chunked",
                                      numerics="sse2")),
        ("GRAY10", 64, 12, 3, dict(order=0, dh=False, aa=57, aac=27, smooth="fused")),
        ("GRAYS", 40, 16, 1, dict(order=1, dh=True, aa=60, aac=23, smooth="scan")),
        ("YUV444P8", 64, 8, 2, dict(order=2, dh=True, aa=7, aac=114, smooth="fused_noweave")),
    ],
}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_generators_reproduce_recorded_tpu_cases(name):
    flag, n, seed = RECORDED[name]
    want = [re.sub(r": OK$", "", ln.rstrip("\n"))
            for ln in (RESULTS / name).read_text().splitlines() if ln.startswith("[")]
    if flag is None:
        cases, mode = pc.CASES, "oracle"
    else:
        gen, mode, _ = pc.MODES[flag]
        cases = gen(n, seed)
    got = [pc.case_line(k, len(cases), c, mode) for k, c in enumerate(cases)]
    assert len(want) == n
    assert got == want


@pytest.mark.parametrize("mode", sorted(TINY))
def test_run_cases_on_cpu(mode, capsys):
    stats = {}
    assert pc.run_cases(TINY[mode], mode, "cpu", stats) == 0
    out = capsys.readouterr().out
    assert out.count("}: OK\n") == len(TINY[mode])
    if mode == "sharded":  # the 1x4 mesh and the route across devices ran too
        assert out.count("    mesh 1x4: OK") == out.count("    across 2 slots: OK") == 4
    if mode == "compat":  # the POOL_FAST arm: the plain path never takes the fast route
        assert stats == {"pool": 3, "fast": 0}
        assert out.count("    POOL_FAST: OK") == 3


def _flip_one(real):
    def flipped(clip, *a, **kw):
        out = real(clip, *a, **kw)
        p0 = out.planes[0].cpu().numpy().copy()
        p0.reshape(-1)[5] ^= 1
        return out.with_planes([torch.from_numpy(p0)] + list(out.planes[1:]))
    return flipped


@pytest.mark.parametrize("mode", ["oracle", "compat"])
def test_flipped_sample_is_a_failure(mode, monkeypatch, capsys):
    monkeypatch.setattr(sangnom_tpu_torch, "sangnom2", _flip_one(sangnom_tpu_torch.sangnom2))
    case = TINY[mode][0]
    assert pc.run_cases([case], mode, "cpu") > 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "MISMATCH" in ln]
    assert lines and all(f"{case[0]} {case[1]}x{case[2]}" in ln for ln in lines)
    assert "first at (0, 5)" in lines[0]
    assert f"{pc.case_line(0, 1, case, mode)}: FAIL" in out


def test_raising_case_is_a_failure(monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(sangnom_tpu_torch, "sangnom2", boom)
    cases = TINY["oracle"][:2]
    assert pc.run_cases(cases, "oracle", "cpu") == 2
    out = capsys.readouterr().out
    assert out.count("ERROR YUV") == 2 and "kernel launch failed" in out
    assert "[2/2] YUVA420P8 48x16 n=1 {'order': 1, 'dh': True}: FAIL (1)" in out


def test_campaign_main_on_cpu(capsys):
    assert pc.main(["--bob", "1", "7", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("bob campaign: 1 cases, seed 7")
    assert lines[-1] == "CPU CAMPAIGN DONE: 1 cases, 0 failures"


CPU_SEED = 77005  # its first four compat cases: three SSE2 pool cases, one C pool case


def test_cpu_campaign_and_sse2_against_scalar_model(capsys):
    assert pcc.main(["6", str(CPU_SEED), "4"]) == 0
    out = capsys.readouterr().out
    assert "CAMPAIGN DONE: 6 configs, 0 failures" in out
    assert "COMPAT CAMPAIGN DONE: 4 configs, 0 failures, 3 unanchored (sse2)" in out

    pytest.importorskip("jax")
    from scalar_model import sangnom2_clip_scalar

    from sangnom_tpu.core.formats import get_format as jax_format

    for case in range(4):
        d = pcc.compat_case(case, CPU_SEED)
        if d["numerics"] != "sse2":
            continue
        got = pcc.run_compat_case(d)
        want = sangnom2_clip_scalar(d["frames"], jax_format(d["fmt"].name),
                                    parities=d["parities"], pool_compat=d["pool_compat"],
                                    numerics="sse2", **d["kw"])
        for f, frame in enumerate(want):
            for i, wp in enumerate(frame):
                np.testing.assert_array_equal(got[i][f], np.asarray(wp, got[i].dtype),
                                              err_msg=f"case {case} frame {f} plane {i}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("flag", sorted(pc.MODES))
def test_two_random_cases_a_mode_on_card(cuda, flag, capsys):
    gen, mode, _ = pc.MODES[flag]
    stats = {}
    assert pc.run_cases(gen(2, 551), mode, cuda, stats) == 0, capsys.readouterr().out
