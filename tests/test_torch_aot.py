"""Prewarmed artifacts of the port (sangnom_tpu_torch.aot, the CLI's
prewarm verb and --aot) against sangnom_tpu.

An artifact is a fast-start record: a dispatch runs the same code whether
its artifact hits or misses, so every test pins BYTE IDENTITY between a
run with artifacts and one without (and, for the CLI, the TPU package's
``prewarm`` and ``--aot`` runs), plus the hit/miss accounting that proves
the artifact was actually found.  The ``cuda`` test shows that an ``--aot``
load on a card runs no nvcc.  The TPU package is imported inside the tests
that use it, so on a machine with a card and no JAX the ``cuda`` test runs
with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_aot.py
"""

import io
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu_torch as T  # noqa: E402
from sangnom_tpu_torch import aot  # noqa: E402
from sangnom_tpu_torch.cli import main as tmain  # noqa: E402
from sangnom_tpu_torch.ops import cuda_library as cl  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def J():
    """The TPU package, its aot module and its CLI's main."""
    import sangnom_tpu
    from sangnom_tpu import aot as jaot
    from sangnom_tpu.cli import main

    yield types.SimpleNamespace(Clip=sangnom_tpu.Clip, sangnom2=sangnom_tpu.sangnom2,
                                bob=sangnom_tpu.bob, aot=jaot, main=main)
    jaot.configure(None)


@pytest.fixture
def _aot_off():
    yield
    aot.configure(None)


def _planes(rng, n=4, w=64, h=32, fmt_name="YUV420P8"):
    fmt = T.get_format(fmt_name)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        planes.append(rng.integers(0, 256, (n, ph, pw)).astype(fmt.np_dtype))
    return planes


def _clips(planes, J, parity=None):
    return (T.Clip.from_numpy(planes, "YUV420P8", device="cpu", parity=parity),
            J.Clip.from_numpy(planes, "YUV420P8", parity=parity))


def _equal(got, want):
    assert len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _save(tmp_path, kind, clip, statics):
    return aot.save_program(tmp_path, kind, clip.format,
                            aot.plane_shapes(clip.planes), statics, device="cpu")


def test_filter_program_roundtrip(rng, tmp_path, _aot_off, J):
    """save_program -> configure -> sangnom2 counts a hit and matches the
    run without artifacts and the TPU package bit for bit."""
    tclip, jclip = _clips(_planes(rng), J)
    kw = dict(order=1, aa=48, aac=0, dh=True, luma=True, chroma=True,
              opt=0, numerics="c")
    want = T.sangnom2(tclip, order=1, dh=True, opt=0)
    path = _save(tmp_path, "filter", tclip, aot.filter_statics(**kw))
    assert path.exists() and path.stat().st_size > 0

    aot.configure(tmp_path)
    got = T.sangnom2(tclip, order=1, dh=True, opt=0)
    assert aot.STATS == {"hits": 1, "misses": 0}
    _equal(got, J.sangnom2(jclip, order=1, dh=True, opt=0))
    for a, b in zip(got.planes, want.planes):
        assert torch.equal(a, b)


def test_filter_order0_parity_matches_static_split(rng, tmp_path, _aot_off, J):
    """order=0 with mixed parity: a hit, and the output equals the run
    without artifacts and the TPU package."""
    parity = np.arange(5) % 2 == 0
    tclip, jclip = _clips(_planes(rng, n=5), J, parity)
    kw = dict(order=0, aa=48, aac=0, dh=True, luma=True, chroma=True,
              opt=0, numerics="c")
    _save(tmp_path, "filter", tclip, aot.filter_statics(**kw))
    aot.configure(tmp_path)
    got = T.sangnom2(tclip, order=0, dh=True, opt=0)
    assert aot.STATS["hits"] == 1
    _equal(got, J.sangnom2(jclip, order=0, dh=True, opt=0))


def test_bob_program_roundtrip(rng, tmp_path, _aot_off, J):
    tclip, jclip = _clips(_planes(rng, n=3), J)
    _save(tmp_path, "bob", tclip, aot.bob_statics(48, 0, True, 0, "c"))
    aot.configure(tmp_path)
    got = T.bob(tclip, opt=0)
    assert aot.STATS == {"hits": 1, "misses": 0}
    assert got.num_frames == 2 * tclip.num_frames
    _equal(got, J.bob(jclip, opt=0))


def test_miss_falls_back(rng, tmp_path, _aot_off):
    """Unmatched geometry/params run the normal path with a recorded miss;
    pool_compat dispatches count neither."""
    tclip = T.Clip.from_numpy(_planes(rng), "YUV420P8", device="cpu")
    aot.configure(tmp_path)  # empty dir: everything misses
    got = T.sangnom2(tclip, order=2, opt=0)
    assert aot.STATS == {"hits": 0, "misses": 1}
    T.sangnom2(tclip, order=2, opt=0, pool_compat=True)
    assert aot.STATS == {"hits": 0, "misses": 1}
    aot.configure(None)
    want = T.sangnom2(tclip, order=2, opt=0)
    for a, b in zip(got.planes, want.planes):
        assert torch.equal(a, b)


@pytest.mark.parametrize("damage", ["garbage", "stale", "other-key"])
def test_corrupt_artifact_is_a_miss(rng, tmp_path, _aot_off, capsys, damage):
    """A corrupt artifact, one made against another kernel library, or one
    whose content is another key's: a miss with the warning line."""
    tclip = T.Clip.from_numpy(_planes(rng), "YUV420P8", device="cpu")
    kw = dict(order=1, aa=48, aac=0, dh=False, luma=True, chroma=True,
              opt=0, numerics="c")
    path = _save(tmp_path, "filter", tclip, aot.filter_statics(**kw))
    if damage == "garbage":
        path.write_bytes(b"not a program")
    else:
        art = json.loads(path.read_bytes())
        if damage == "stale":
            art["library"] = "0" * 16
        else:
            art["statics"]["aa"] = 49
        path.write_text(json.dumps(art))
    aot.configure(tmp_path)
    got = T.sangnom2(tclip, order=1, opt=0)
    assert aot.STATS == {"hits": 0, "misses": 1}
    err = capsys.readouterr().err
    assert f"warning: AOT artifact {path.name} unusable" in err, err
    aot.configure(None)
    want = T.sangnom2(tclip, order=1, opt=0)
    for a, b in zip(got.planes, want.planes):
        assert torch.equal(a, b)


def test_key_distinguishes_params_shapes_and_device(rng, monkeypatch):
    tclip = T.Clip.from_numpy(_planes(rng), "YUV420P8", device="cpu")
    sh = aot.plane_shapes(tclip.planes)
    assert sh[0] == ((4, 32, 64), "uint8")
    base = aot.filter_statics(1, 48, 0, False, True, True, 0, "c")
    k0 = aot.program_key("filter", "YUV420P8", sh, base, device="cpu")
    assert k0.startswith("filter-YUV420P8-64x32x4-")
    assert k0 != aot.program_key("filter", "YUV420P8", sh, dict(base, aa=49),
                                 device="cpu")
    assert k0 != aot.program_key("bob", "YUV420P8", sh, base, device="cpu")
    sh2 = tuple((tuple(s[:-1]) + (s[-1] + 2,), d) for s, d in sh)
    assert k0 != aot.program_key("filter", "YUV420P8", sh2, base, device="cpu")
    # two cards of other names or compute capabilities never share a key
    keys = set()
    for name, cap in (("NVIDIA H100 80GB HBM3", (9, 0)),
                      ("NVIDIA H100 80GB HBM3", (8, 0)),
                      ("NVIDIA H200", (9, 0))):
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i, n=name: n)
        monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i, c=cap: c)
        keys.add(aot.program_key("filter", "YUV420P8", sh, base, device="cuda"))
    assert len(keys) == 3 and k0 not in keys


# --- CLI integration ---------------------------------------------------------

def _write_y4m_file(rng, path, n=5, w=64, h=32):
    from sangnom_tpu_torch.io import write_y4m

    planes = _planes(rng, n=n, w=w, h=h)
    buf = io.BytesIO()
    write_y4m(buf, T.Clip.from_numpy(planes, "YUV420P8", device="cpu"), fps=(25, 1))
    path.write_bytes(buf.getvalue())


def test_cli_prewarm_and_aot_run(rng, tmp_path, _aot_off, capsys, J):
    """prewarm verb -> main verb --aot: byte-identical to the run without
    it and to the TPU package's prewarm + --aot run, with the hits noted."""
    src = tmp_path / "in.y4m"
    _write_y4m_file(rng, src, n=5)
    adir, jdir = tmp_path / "aot", tmp_path / "jaot"
    flags = ["--order", "1", "--dh", "--opt", "0"]
    pre = ["prewarm", "--format", "YUV420P8", "--size", "64x32", "--window", "2"]
    assert tmain([*pre, "--aot", str(adir), *flags, *CPU]) == 0
    arts = list(adir.glob("*.json"))
    assert len(arts) == 1 and arts[0].name.startswith("filter-YUV420P8-")
    assert J.main([*pre, "--aot", str(jdir), *flags]) == 0

    run = [str(src), None, *flags, "--window", "2", "--no-overlap-write"]
    outs = {}
    for name, main, extra in (("plain", tmain, CPU),
                              ("aot", tmain, ["--aot", str(adir), *CPU]),
                              ("jax", J.main, ["--aot", str(jdir)])):
        outs[name] = tmp_path / f"{name}.y4m"
        capsys.readouterr()
        assert main([run[0], str(outs[name]), *run[2:], *extra]) == 0
        err = capsys.readouterr().err
        if name != "plain":
            # 5 frames in windows of 2 -> two full windows hit, the trailing
            # 1-frame window misses
            assert "aot: 2 dispatch(es) served from artifacts, 1 miss(es)" in err, err
    data = {k: p.read_bytes() for k, p in outs.items()}
    assert data["aot"] == data["plain"] == data["jax"]


def test_cli_prewarm_bob_windowed(rng, tmp_path, _aot_off, capsys, J):
    src = tmp_path / "in.y4m"
    _write_y4m_file(rng, src, n=5)
    adir = tmp_path / "aot"
    assert tmain(["prewarm", "--aot", str(adir), "--format", "YUV420P8",
                  "--size", "64x32", "--window", "2", "--bob", "--opt", "0",
                  "--no-warm-call", *CPU]) == 0
    assert len(list(adir.glob("bob-*.json"))) == 2  # N and N+1 feeds
    assert not aot.is_configured()  # prewarm leaves the process as it found it

    out_plain, out_aot, out_jax = (tmp_path / f"{n}.y4m" for n in ("p", "a", "j"))
    run = ["--bob", "--opt", "0", "--window", "2", "--no-overlap-write"]
    assert tmain([str(src), str(out_plain), *run, *CPU]) == 0
    capsys.readouterr()
    assert tmain([str(src), str(out_aot), *run, "--aot", str(adir), *CPU]) == 0
    assert "aot: 2 dispatch(es) served from artifacts, 1 miss(es)" in capsys.readouterr().err
    # the next run without --aot does not inherit the directory
    assert tmain([str(src), str(out_plain), *run, *CPU]) == 0
    assert not aot.is_configured() and "aot:" not in capsys.readouterr().err
    assert J.main([str(src), str(out_jax), *run]) == 0
    assert out_plain.read_bytes() == out_aot.read_bytes() == out_jax.read_bytes()


@pytest.mark.parametrize("argv,msg", [
    (["--size", "64x30", "--frames", "2"], "height must be mod4"),
    (["--size", "64x32", "--frames", "2", "--order", "7"],
     "order must be between 0..2."),
    (["--size", "64x32", "--frames", "0"], "--window/--frames must be positive"),
    (["--size", "64", "--frames", "2"], "invalid --size '64' (want WxH)"),
    (["--size", "64x32", "--frames", "2", "--legacy", "--bob"],
     "--legacy cannot be combined with --bob"),
])
def test_cli_prewarm_validation_errors(tmp_path, capsys, argv, msg, _aot_off, J):
    """The reference's error strings, for the port's verb and the TPU
    package's alike."""
    base = ["prewarm", "--aot", str(tmp_path), "--format", "YUV420P8", *argv]
    assert tmain(base + CPU) == 2
    assert msg in capsys.readouterr().err
    assert J.main(base) == 2
    assert msg in capsys.readouterr().err


def test_aot_library_wins_over_cache_dir(tmp_path, monkeypatch, _aot_off):
    """A library prewarmed into the --aot directory under the current source
    hash loads from there with no build; --cache-dir's directory serves
    only when the --aot directory holds none; the hash, not file times,
    keys a build."""
    for name in ("_build_dir", "_lib", "LIB_PATH", "BUILDS"):
        monkeypatch.setattr(cl, name, getattr(cl, name))
    monkeypatch.setattr(cl, "_lib", None)
    loaded, built = [], []

    class FakeCDLL:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_compile(lib, verbose=False):
        built.append(lib)
        lib.parent.mkdir(parents=True, exist_ok=True)
        lib.write_bytes(b"lib")
        cl.BUILDS += 1
        return 0.0

    monkeypatch.setattr(cl.ctypes, "CDLL", FakeCDLL)
    monkeypatch.setattr(cl, "compile_library", fake_compile)
    adir, cache = tmp_path / "aot", tmp_path / "cache"
    cl.set_build_dir(cache)
    aot.configure(adir)
    cl.load()  # the --aot directory holds no library: build into the cache
    assert built == [cache.resolve() / "libsangnom_cuda.so"]
    assert (cache / "libsangnom_cuda.so.key").read_text() == cl.source_hash()
    assert cl.build() == 0.0 and cl.BUILDS == 1  # up to date by its hash

    (adir / cl.library_name()).parent.mkdir(parents=True)
    (adir / cl.library_name()).write_bytes(b"lib")
    cl._lib = None
    cl.load()
    assert cl.LIB_PATH == adir / cl.library_name()
    assert loaded[-1] == str(adir / cl.library_name()) and cl.BUILDS == 1
    aot.configure(None)
    assert aot.library_path() is None


@pytest.mark.cuda
def test_aot_load_runs_no_nvcc_on_card(tmp_path, rng, _aot_off):
    """On a card: a fresh process given --aot DIR from a prewarmed DIR
    loads the library from DIR (no nvcc), counts hits only, and writes the
    bytes of a run without --aot."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    src = tmp_path / "in.y4m"
    from sangnom_tpu_torch.io import write_y4m

    write_y4m(str(src), T.Clip.from_numpy(_planes(rng, n=4, w=128, h=64),
                                          "YUV420P8", device="cpu"))
    adir = tmp_path / "aot"
    assert tmain(["prewarm", "--aot", str(adir), "--format", "YUV420P8",
                  "--size", "128x64", "--frames", "4", "--bob"]) == 0
    code = ("import sys; from sangnom_tpu_torch import cli; "
            "from sangnom_tpu_torch.ops import cuda_library as cl; "
            "rc = cli.main(sys.argv[1:]); print('BUILDS', cl.BUILDS, cl.LIB_PATH); "
            "sys.exit(rc)")
    outs = []
    for extra in ([], ["--aot", str(adir)]):
        out = tmp_path / f"o{len(outs)}.y4m"
        r = subprocess.run([sys.executable, "-c", code, str(src), str(out),
                            "--bob", *extra], capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr
        outs.append((out.read_bytes(), r.stdout, r.stderr))
    assert outs[0][0] == outs[1][0]
    assert f"BUILDS 0 {adir / cl.library_name()}" in outs[1][1], outs[1][1]
    assert "aot: 1 dispatch(es) served from artifacts, 0 miss(es)" in outs[1][2]
