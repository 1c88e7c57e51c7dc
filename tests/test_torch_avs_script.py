"""AviSynth script-text evaluation in the port (hosts/avs_script.py and the
CLI's ``script`` verb) against the JAX package's evaluator and CLI, and the
port's direct API: the exact lines a reference user writes, run against
the protocol host on the CPU device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
import sangnom_tpu.hosts.avisynth as javs  # noqa: E402
from sangnom_tpu import cli as jcli  # noqa: E402
from sangnom_tpu.hosts.avs_script import eval_script as j_eval  # noqa: E402
from sangnom_tpu.io import write_y4m as j_write_y4m  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
import sangnom_tpu_torch.hosts.avisynth as tavs  # noqa: E402
from sangnom_tpu_torch import cli as tcli  # noqa: E402
from sangnom_tpu_torch.hosts.avisynth import (  # noqa: E402
    ArraySource, AvisynthError, ScriptEnvironment, avisynth_plugin_init)
from sangnom_tpu_torch.hosts.avs_script import eval_script  # noqa: E402
from sangnom_tpu_torch.io import read_y4m  # noqa: E402

from conftest import make_planes  # noqa: E402


def _env():
    env = ScriptEnvironment(device="cpu")
    avisynth_plugin_init(env)
    return env


def _jenv():
    env = javs.ScriptEnvironment()
    javs.avisynth_plugin_init(env)
    return env


def _planes(rng, n=4, fmt_name="YUV420P8", w=32, h=16):
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    return [np.stack([fr[i] for fr in frames]) for i in range(fmt.num_planes)]


def _collect(clip, env):
    vi = clip.get_video_info()
    frames = [clip.get_frame(n, env) for n in range(vi.num_frames)]
    return [np.stack([fr.planes[i] for fr in frames])
            for i in range(vi.num_components())]


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"plane {i}")


def _both(script, planes, fmt_name, var=None):
    """The script's frames through the port's evaluator and JAX's, the
    source bound as ``last`` or, given ``var``, as that variable."""
    def run(mod, env, evaluate):
        src = mod.ArraySource(planes, fmt_name)
        kw = {"variables": {var: src}} if var else {"last": src}
        return _collect(evaluate(env, script, **kw), env)

    got = run(tavs, _env(), eval_script)
    _same(got, run(javs, _jenv(), j_eval))
    return got


def test_verbatim_double_rate_recipe_matches_bob_and_jax(rng):
    """The reference's documented recipe as literal script text
    (src/SangNom2.cpp:18-23), with a comment and a continuation."""
    planes = _planes(rng, n=3)
    script = """
    # classic double-rate bob
    AssumeTFF()
    SeparateFields()
    DoubleWeave()
    SangNom2(order=0, \\
             aa=48)
    """
    got = _both(script, planes, "YUV420P8")
    _same(got, T.bob(T.Clip.from_numpy(planes, "YUV420P8", device="cpu"),
                     tff=True).to_numpy())


def test_oop_chaining_variables_and_return(rng):
    planes = _planes(rng, n=3)
    script = """
    x = clip.AssumeBFF().SeparateFields()
    y = x.Weave()
    return y.SangNom2(order=1, dh=true)
    """
    got = _both(script, planes, "YUV420P8", var="CLIP")
    _same(got, T.sangnom2(T.Clip.from_numpy(planes, "YUV420P8", device="cpu"),
                          order=1, dh=True).to_numpy())


@pytest.mark.parametrize("script", [
    "SANGNOM2(ORDER=2, DH=yes)",
    'SangNom2(aa=0, numerics="sse2")',
    "SangNom2(opt=-1, order=1)",
    "SeparateFields()\nSelectEven()\nSangNom(order=2)",
], ids=["case-bool-words", "string", "negative", "select-legacy"])
def test_script_lines_match_jax(rng, script):
    _both(script, _planes(rng, n=2, fmt_name="GRAY8"), "GRAY8")


def test_implicit_last_updates_through_statements(rng):
    env = _env()
    out = eval_script(env, "SeparateFields()\nSelectEven()",
                      last=ArraySource(_planes(rng), "YUV420P8"))
    assert out.get_video_info().num_frames == 4  # 8 fields -> evens
    assert out.get_video_info().height == 8


def test_script_errors_match_jax(rng):
    """Line-numbered errors with the JAX evaluator's messages."""
    planes = _planes(rng)
    env, jenv = _env(), _jenv()
    for script, use_last, part in [
        ("AssumeTFF()\nBogus()", True, "line 2: there is no function"),
        ("SangNom2(order=9)", True, "order must be"),
        ("SangNom2()", False, "'last' is not set"),
        ("x = 1 + 2", True, "outside the supported"),
        ("SangNom2(order=1, 48)", True, "positional argument after"),
        ("SangNom2(order=-true)", True, "numeric sign"),
        ("x = undefined_name", True, "I don't know what"),
    ]:
        with pytest.raises(AvisynthError, match=part) as te:
            eval_script(env, script, last=ArraySource(planes, "YUV420P8")
                        if use_last else None)
        with pytest.raises(javs.AvisynthError) as je:
            j_eval(jenv, script, last=javs.ArraySource(planes, "YUV420P8")
                   if use_last else None)
        assert str(te.value) == str(je.value)


def _echo_env(mod, env):
    mod.avisynth_plugin_init(env)
    env.add_function("Echo", "s", lambda args, user_data, e: args[0].as_string())
    return env


def test_advice_script_strings_have_no_escapes():
    """Deviation from the JAX evaluator (its hosts/avs_script.py:47 reads
    backslash escapes): as in AviSynth, a string runs to the next double
    quote and a backslash is a literal backslash."""
    env = _echo_env(tavs, ScriptEnvironment(device="cpu"))
    jenv = _echo_env(javs, javs.ScriptEnvironment())
    assert eval_script(env, r'return Echo("C:\clips\")') == "C:\\clips\\"
    assert eval_script(env, r'return Echo("a\\b")') == "a\\\\b"
    with pytest.raises(AvisynthError):
        eval_script(env, r'return Echo("a\"b")')  # the quote ends the string
    # the JAX evaluator reads the same text with escapes
    assert j_eval(jenv, r'return Echo("a\\b")') == "a\\b"
    with pytest.raises(javs.AvisynthError):
        j_eval(jenv, r'return Echo("C:\clips\")')
    # strings without backslashes read the same in both
    assert eval_script(env, 'return Echo("sse2")') == \
        j_eval(jenv, 'return Echo("sse2")') == "sse2"


@pytest.fixture
def clip_file(rng, tmp_path):
    planes = _planes(rng, n=5, w=32, h=16)
    path = tmp_path / "in.y4m"
    j_write_y4m(str(path), J.Clip.from_numpy(planes, "YUV420P8"), fps=(30, 1))
    return path, planes


@pytest.mark.parametrize("recipe,extra", [
    ("AssumeTFF()\nSeparateFields()\nDoubleWeave()\nSangNom2(order=0)\n", []),
    ("SangNom2(order=2, dh=true)\n", ["--fps", "24000:1001"]),
    ("SeparateFields()\nSelectOdd()\nSangNom(order=2)\n", ["--bff"]),
    ("SangNom2(order=0, pool_compat=true, batch=2)\n", []),
], ids=["bob", "dh-fps", "select-legacy-bff", "pool"])
def test_cli_script_verb_matches_jax(clip_file, tmp_path, recipe, extra):
    """sangnom-tpu-torch script RECIPE in.y4m out.y4m writes the JAX CLI's
    bytes (frames, header and the frame-count-scaled rate)."""
    src, _ = clip_file
    path = tmp_path / "r.avs"
    path.write_text(recipe)
    t_out, j_out = tmp_path / "t.y4m", tmp_path / "j.y4m"
    assert tcli.main(["script", str(path), str(src), str(t_out), *extra,
                      "--device", "cpu"]) == 0
    assert jcli.main(["script", str(path), str(src), str(j_out), *extra]) == 0
    assert t_out.read_bytes() == j_out.read_bytes()


def test_cli_script_verb_bob_equals_bob_verb(clip_file, tmp_path):
    """The canonical recipe through the script verb writes the main verb's
    ``--bob`` bytes: the same frames at the same doubled rate."""
    src, planes = clip_file
    path = tmp_path / "bob.avs"
    path.write_text(
        "AssumeTFF()\nSeparateFields()\nDoubleWeave()\nSangNom2(order=0)\n")
    s_out, b_out = tmp_path / "s.y4m", tmp_path / "b.y4m"
    assert tcli.main(["script", str(path), str(src), str(s_out),
                      "--device", "cpu"]) == 0
    assert tcli.main([str(src), str(b_out), "--bob", "--device", "cpu"]) == 0
    assert s_out.read_bytes() == b_out.read_bytes()
    got = read_y4m(str(s_out), device="cpu")
    assert got.num_frames == 10 and got.props["y4m_fps"] == (60, 1)


def test_cli_script_verb_errors(clip_file, tmp_path, capsys):
    src, _ = clip_file
    bad = tmp_path / "bad.avs"
    bad.write_text("x = 3\nreturn x\n")
    dst = tmp_path / "o.y4m"
    assert tcli.main(["script", str(bad), str(src), str(dst),
                      "--device", "cpu"]) == 2
    assert "script result is not a clip" in capsys.readouterr().err
    assert not dst.exists()
    assert tcli.main(["script", str(tmp_path / "none.avs"), str(src),
                      str(dst), "--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err


def test_advice_script_verb_streams_output(clip_file, tmp_path, monkeypatch):
    """Deviation from the JAX CLI (its cli.py:701 stacks every output frame
    before writing): the script verb writes the header from the result's
    VideoInfo with the first window, then appends the frames a window
    (SCRIPT_WINDOW frames) at a time."""
    src, _ = clip_file
    path = tmp_path / "bob.avs"
    path.write_text("SeparateFields()\nDoubleWeave()\nSangNom2(order=0)\n")
    writes = []
    real_header, real_frames = tcli.write_y4m, tcli.write_y4m_frames
    monkeypatch.setattr(tcli, "write_y4m", lambda fh, clip, **kw: (
        writes.append(("header", clip.num_frames)),
        real_header(fh, clip, **kw))[1])
    monkeypatch.setattr(tcli, "write_y4m_frames", lambda fh, clip: (
        writes.append(("frames", clip.num_frames)),
        real_frames(fh, clip))[1])
    monkeypatch.setattr(tcli, "SCRIPT_WINDOW", 3)
    dst = tmp_path / "o.y4m"
    assert tcli.main(["script", str(path), str(src), str(dst),
                      "--device", "cpu"]) == 0
    assert writes == [("header", 3), ("frames", 3), ("frames", 3),
                      ("frames", 1)]
    jdst = tmp_path / "j.y4m"
    assert jcli.main(["script", str(path), str(src), str(jdst)]) == 0
    assert dst.read_bytes() == jdst.read_bytes()
