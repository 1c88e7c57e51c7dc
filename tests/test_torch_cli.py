"""The port's CLI (sangnom_tpu_torch.cli) against sangnom_tpu.cli.

Both CLIs run in-process on the same y4m file, written from numpy planes
made from a seed; the port's output file must be byte-equal to the JAX
CLI's in every mode, and its error paths keep the exit code 2 and the
message.  The port runs with ``--device cpu``: ``--device`` defaults to
cuda, and without a card the CLI exits 2.  Also here: ``--cache-dir``
(the kernel library's build directory), the rejected ``prewarm`` verb, and
the thread-safe first load of the kernel library.
"""

import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
from sangnom_tpu import cli as jcli  # noqa: E402
from sangnom_tpu.io import write_y4m as j_write_y4m  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch import cli as tcli  # noqa: E402
from sangnom_tpu_torch.io import read_y4m  # noqa: E402
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402

from conftest import make_planes  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def _write_input(path, fmt_name="YUV420P8", w=64, h=48, n=5, seed=3,
                 interlace="t"):
    rng = np.random.default_rng(seed)
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    j_write_y4m(str(path), J.Clip.from_numpy(planes, fmt),
                fps=(30000, 1001), interlace=interlace)
    return planes


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    _write_input(d / "yuv.y4m")
    _write_input(d / "p10.y4m", fmt_name="YUV422P10", w=32, h=16, n=3)
    return d


def _run_both(src, tmp_path, flags, tag="o"):
    """(port bytes, JAX bytes) of one CLI invocation each."""
    t_out, j_out = tmp_path / f"{tag}_t.y4m", tmp_path / f"{tag}_j.y4m"
    assert tcli.main([str(src), str(t_out), *flags, *CPU]) == 0
    assert jcli.main([str(src), str(j_out), *flags]) == 0
    return t_out.read_bytes(), j_out.read_bytes()


MODES = {
    "whole": ("yuv", []),
    "window": ("yuv", ["--window", "2", "--no-overlap-write"]),
    "window-overlap": ("yuv", ["--window", "2", "--overlap-write"]),
    "frames-window": ("yuv", ["--frames", "3", "--window", "2"]),
    "bob": ("yuv", ["--bob"]),
    "bob-window": ("yuv", ["--bob", "--window", "2", "--no-overlap-write"]),
    "bob-window-overlap": ("yuv", ["--bob", "--window", "2", "--overlap-write"]),
    "bob-fps": ("yuv", ["--bob", "--fps", "60000:1001"]),
    "bob-fps-window": ("yuv", ["--bob", "--fps", "60000:1001", "--window", "2"]),
    "dh": ("yuv", ["--order", "2", "--dh", "--aac", "32"]),
    "legacy": ("yuv", ["--legacy", "--order", "0", "--aa", "32"]),
    "bff-order0": ("yuv", ["--order", "0", "--bff"]),
    "tff-order0-sse2": ("yuv", ["--order", "0", "--tff", "--numerics", "sse2"]),
    "pool-whole": ("yuv", ["--pool-compat"]),
    "pool-window": ("yuv", ["--pool-compat", "--numerics", "sse2", "--aac",
                            "48", "--window", "2"]),
    "pool-window-legacy": ("yuv", ["--legacy", "--order", "2", "--pool-compat",
                                   "--dh", "--no-chroma", "--window", "2"]),
    "passthrough": ("yuv", ["--no-luma", "--no-chroma"]),
    "10bit-window": ("p10", ["--order", "2", "--aa", "128", "--window", "2"]),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_matches_jax(inputs, tmp_path, mode):
    name, flags = MODES[mode]
    got, want = _run_both(inputs / f"{name}.y4m", tmp_path, flags)
    assert got == want
    header = got.split(b"\n", 1)[0].decode()
    if mode == "passthrough":
        assert " It " in header  # the input's tag, not restamped
    elif mode.startswith("bob-fps"):
        assert "F60000:1001" in header  # an explicit --fps is the output rate
    elif mode.startswith("bob"):
        assert "F60000:1001" in header and " Ip " in header


def test_cli_windowed_equals_whole_clip(inputs, tmp_path):
    """Every windowed mode writes the whole-clip bytes, the bob's
    cross-window field pairing and the carried pool included."""
    src = str(inputs / "yuv.y4m")
    for flags in ([], ["--bob"], ["--pool-compat", "--order", "2"]):
        outs = []
        for extra in ([], ["--window", "2", "--no-overlap-write"],
                      ["--window", "3", "--overlap-write"]):
            dst = tmp_path / f"o{len(outs)}.y4m"
            assert tcli.main([src, str(dst), *flags, *extra, *CPU]) == 0
            outs.append(dst.read_bytes())
        assert outs[0] == outs[1] == outs[2], flags


def test_cli_output_equals_api(inputs, tmp_path):
    """The CLI's frames are the API's: the port's sangnom2 and bob on the
    clip read from the same file."""
    src = str(inputs / "yuv.y4m")
    clip = read_y4m(src, device="cpu")
    for flags, want in ((["--order", "2"], T.sangnom2(clip, order=2)),
                        (["--bob"], T.bob(clip))):
        dst = tmp_path / "o.y4m"
        assert tcli.main([src, str(dst), *flags, *CPU]) == 0
        got = read_y4m(str(dst), device="cpu")
        for g, w in zip(got.to_numpy(), want.to_numpy()):
            np.testing.assert_array_equal(g, w)


def _truncated(tmp_path):
    src = tmp_path / "trunc.y4m"
    j_write_y4m(str(src), J.Clip.from_numpy(
        [np.zeros((3, 8, 16), np.uint8)], "GRAY8"))
    data = src.read_bytes()
    src.write_bytes(data[: len(data) - 40])  # cut mid-frame
    return src


def _gray(tmp_path, n=3):
    src = tmp_path / "gray.y4m"
    j_write_y4m(str(src), J.Clip.from_numpy(
        [np.zeros((n, 16, 32), np.uint8)], "GRAY8"))
    return src


ERRORS = {  # name -> (input maker, output name, flags, part of the message)
    "legacy-bob": (_gray, "o.y4m", ["--legacy", "--bob"],
                   "--legacy cannot be combined with --bob"),
    "pool-bob-window": (_gray, "o.y4m", ["--bob", "--pool-compat", "--window",
                                         "2"], "--pool-compat with --bob"),
    "bad-fps": (_gray, "o.y4m", ["--fps", "25"], "error:"),
    "zero-fps": (_gray, "o.y4m", ["--fps", "0:1"], "invalid --fps"),
    "output-write": (_gray, "no_such_dir/o.y4m", [], "No such file"),
    "writer-thread": (_gray, "no_such_dir/o.y4m", ["--opt", "0", "--window",
                                                   "1", "--overlap-write"],
                      "No such file"),
    "reader-thread": (_truncated, "o.y4m", ["--opt", "0", "--window", "1",
                                            "--overlap-write"], "truncated"),
    "overlap-no-window": (_gray, "o.y4m", ["--overlap-write"],
                          "--overlap-write requires --window"),
    "pool-opt-window": (_gray, "o.y4m", ["--pool-compat", "--opt", "9",
                                         "--window", "1"],
                        "opt must be between -1..2."),
    "missing-input": (lambda p: p / "absent.y4m", "o.y4m", [], "No such file"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_cli_errors_match_jax(tmp_path, capsys, case):
    """Exit code 2 and JAX's message, no traceback; an output file exactly
    where JAX leaves one (a stream that fails after its first window)."""
    make, out_name, flags, part = ERRORS[case]
    src = make(tmp_path)
    dst = tmp_path / out_name
    rc = tcli.main([str(src), str(dst), *flags, *CPU])
    t_err = capsys.readouterr().err
    t_written = dst.exists()
    dst.unlink(missing_ok=True)
    assert jcli.main([str(src), str(dst), *flags]) == rc == 2
    j_err = capsys.readouterr().err
    assert t_err.strip().startswith("error:") and part in t_err
    assert "Traceback" not in t_err
    assert t_err.strip().splitlines()[-1] == j_err.strip().splitlines()[-1]
    assert t_written == dst.exists()


def test_cli_device_defaults_to_cuda(inputs, tmp_path, capsys, monkeypatch):
    """--device defaults to cuda, with no CPU fallback: on a machine without
    a card both verbs exit 2 and say how to run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = str(inputs / "yuv.y4m"), tmp_path / "o.y4m"
    recipe = tmp_path / "r.avs"
    recipe.write_text("SangNom2()\n")
    for argv in ([src, str(dst)], [src, str(dst), "--window", "2"],
                 ["script", str(recipe), src, str(dst)]):
        assert tcli.main(argv) == 2
        err = capsys.readouterr().err
        assert "no CUDA device is available" in err and "--device cpu" in err
        assert not dst.exists()


@pytest.fixture
def fresh_kernel_library(monkeypatch):
    """The kernel library's module state, restored after the test; nothing
    loaded."""
    for name in ("_build_dir", "_lib"):
        monkeypatch.setattr(cl, name, getattr(cl, name))
    monkeypatch.setattr(cl, "_lib", None)
    return cl


def test_cli_cache_dir_sets_build_dir(inputs, tmp_path, capsys,
                                      fresh_kernel_library, monkeypatch):
    """--cache-dir points the kernel library's build and load at DIR before
    any load, without building on the CPU; once the library is loaded,
    another directory is refused (the same one is accepted)."""
    built = []
    monkeypatch.setattr(cl, "build", lambda verbose=False: built.append(verbose))
    cache = tmp_path / "kcache"
    src = str(inputs / "yuv.y4m")
    assert tcli.main([src, str(tmp_path / "o.y4m"), "--cache-dir",
                      str(cache), *CPU]) == 0
    assert cl.build_dir() == cache.resolve()
    assert not built and not cache.exists()

    cl._lib = object()  # as after a load
    cl.set_build_dir(cache)
    with pytest.raises(ValueError, match="already loaded"):
        cl.set_build_dir(tmp_path / "other")
    assert tcli.main([src, str(tmp_path / "o2.y4m"), "--cache-dir",
                      str(tmp_path / "other"), *CPU]) == 2
    assert "already loaded" in capsys.readouterr().err


def test_load_builds_once_across_threads(fresh_kernel_library, monkeypatch):
    """Eight threads asking for the kernel library at once: one build, one
    load, every thread gets the same library."""
    builds = []

    def fake_build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a build in progress while the others arrive
        return 0.0

    class FakeCDLL:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):  # a C function: settable argtypes
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cl, "build", fake_build)
    monkeypatch.setattr(cl.ctypes, "CDLL", FakeCDLL)
    barrier = threading.Barrier(8)
    libs = []

    def worker():
        barrier.wait(timeout=10)
        libs.append(cl.load())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert len(libs) == 8 and len({id(lib) for lib in libs}) == 1


def test_module_entry_point(inputs, tmp_path):
    """``python -m sangnom_tpu_torch`` in a fresh process, as a user runs
    it; the CLI, the I/O layer and the hosts load neither JAX nor
    sangnom_tpu."""
    dst = tmp_path / "o.y4m"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['sangnom_tpu_torch', {str(inputs / 'yuv.y4m')!r}, "
        f"{str(dst)!r}, '--order', '2', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('sangnom_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import sangnom_tpu_torch.hosts.vapoursynth, sangnom_tpu_torch.hosts.avs_script\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'sangnom_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr
    assert "5 frames 64x48 -> 64x48" in res.stderr
    want = T.sangnom2(read_y4m(str(inputs / "yuv.y4m"), device="cpu"), order=2)
    for g, w in zip(read_y4m(str(dst), device="cpu").to_numpy(),
                    want.to_numpy()):
        np.testing.assert_array_equal(g, w)
