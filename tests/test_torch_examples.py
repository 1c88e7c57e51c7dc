"""The port's examples (sangnom_tpu_torch/examples/) against the scripts
of examples/, byte for byte.

Each port example runs in-process with ``--device cpu`` on the tiny y4m
that tests/test_examples.py makes, and its output file must equal the TPU
package's example's output on the same file.  ``sharded_batch`` writes
nothing in the TPU package: its output clip (the 8 x 1920x540 batch of
seed 0) is written with the TPU package's ``write_y4m`` and compared with
the port example's ``--out`` file.
"""

import os
import runpy
import sys

import pytest

pytest.importorskip("torch")

from sangnom_tpu.io import write_y4m  # noqa: E402

from test_examples import EXAMPLES, _tiny_clip  # noqa: E402

PORT = ["deinterlace_file", "antialias_2x", "bob_double_rate",
        "reference_compat", "avisynth_host"]


@pytest.fixture
def tiny_y4m(tmp_path):
    src = str(tmp_path / "in.y4m")
    write_y4m(src, _tiny_clip())
    return src


def _run_jax(script, argv):
    old = sys.argv
    sys.argv = [script] + argv
    try:
        return runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    finally:
        sys.argv = old


def _port(name):
    import importlib

    return importlib.import_module(f"sangnom_tpu_torch.examples.{name}")


@pytest.mark.parametrize("name", PORT)
def test_file_example_matches_jax(tiny_y4m, tmp_path, name):
    want, got = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    _run_jax(f"{name}.py", [tiny_y4m, str(want)])
    _port(name).main([tiny_y4m, str(got), "--device", "cpu"])
    assert got.read_bytes() == want.read_bytes()


def test_sharded_batch_example_matches_jax(tmp_path):
    want, got = tmp_path / "jax.y4m", tmp_path / "port.y4m"
    write_y4m(str(want), _run_jax("sharded_batch.py", [])["out"])
    out = _port("sharded_batch").main(["--device", "cpu", "--out", str(got)])
    assert out.num_frames == 8 and (out.width, out.height) == (1920, 1080)
    assert got.read_bytes() == want.read_bytes()

