"""The port's streaming tools (sangnom_tpu_torch.tools.stream_soak and
stream_attr) and its trace context (sangnom_tpu_torch.utils.profile_trace),
at toy sizes on the CPU.

The soak's whole-clip and windowed CLI runs must write the same bytes and
report their peak RSS; the attribution harness must give a positive rate for
every stage and both end-to-end arms (its own assertion holds the overlap
arm's output byte-identical to the serial one).  This module imports
neither JAX nor the test conftest, so on a machine with a card and no JAX
the ``cuda`` case runs with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream_tools.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sangnom_tpu_torch.tools import stream_attr, stream_soak  # noqa: E402
from sangnom_tpu_torch.utils import profile_trace  # noqa: E402


@pytest.mark.parametrize("mode", ["plain", "bob"])
def test_stream_soak_windowed_is_byte_identical(mode, capsys):
    assert stream_soak.main(["8", "3", mode, "64x32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("whole: PEAK_RSS_MB=")
    assert out[1].startswith("windowed: PEAK_RSS_MB=")
    assert out[-1].startswith("byte-identical: True")
    assert ("-> 16 frames" if mode == "bob" else "-> 8 frames") in out[1]


def test_stream_attr_smoke(capsys):
    res = stream_attr.main(["6", "64x32", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    for key in ("read_upload_fps", "read_parse_only_fps", "device_fps",
                "fetch_fps", "serialize_fps", "pipeline_bound_fps",
                "e2e_serial_fps", "e2e_overlap_fps"):
        assert res[key] > 0, (key, res)
    assert res["frames"] == 6 and res["device"] == "cpu"


def test_profile_trace_writes_a_trace(tmp_path):
    from sangnom_tpu_torch import Clip, sangnom2

    clip = Clip.from_numpy([np.zeros((1, 8, 32), np.uint8)], "GRAY8", device="cpu")
    with profile_trace(str(tmp_path / "trace")) as log_dir:
        sangnom2(clip, opt=0)
    assert log_dir == str(tmp_path / "trace")
    (trace,) = (tmp_path / "trace").glob("trace-*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("sangnom/" in ev.get("name", "") for ev in events)


@pytest.mark.cuda
def test_profile_trace_records_the_kernel_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sangnom_tpu_torch import Clip, sangnom2

    clip = Clip.from_numpy([np.zeros((2, 64, 128), np.uint8)], "GRAY8", device="cuda")
    sangnom2(clip, opt=1)  # builds or loads the kernel library outside the trace
    with profile_trace(str(tmp_path)):
        sangnom2(clip, opt=1)
    (trace,) = tmp_path.glob("trace-*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(ev.get("cat") == "kernel" and "deint" in ev.get("name", "") for ev in events)
