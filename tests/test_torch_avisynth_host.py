"""The port's AviSynth-model host (sangnom_tpu_torch.hosts.avisynth) against
the JAX package's host and the port's direct API.

The module ships its own protocol (`ScriptEnvironment`, `ArraySource`), so
the tests are the host: signature-string registration, AVSValue binding,
Create_ factory validation through env.throw_error, GetFrame/GetParity
serving through the shared `WindowRunner`, the SetCacheHints MT contract,
the field built-ins, and parallel out-of-order requests.  The same numpy
planes go through both hosts; every frame must be equal.  The filter runs
on the environment's device (``ScriptEnvironment(device="cpu")`` here; it
defaults to cuda).  Also here: the ``opt1_ok`` override of
``api._validate`` that the factories' opt=1 gate rides on.
"""

import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sangnom_tpu as J  # noqa: E402
import sangnom_tpu.hosts.avisynth as javs  # noqa: E402
import sangnom_tpu_torch as T  # noqa: E402
import sangnom_tpu_torch.hosts.avisynth as tavs  # noqa: E402
from sangnom_tpu_torch.api import SangNomError, _validate  # noqa: E402
from sangnom_tpu_torch.hosts.avisynth import (  # noqa: E402
    CACHE_GET_MTMODE, CPUF_CUDA, MT_MULTI_INSTANCE, MT_SERIALIZED,
    SIG_SANGNOM, SIG_SANGNOM2, ArraySource, AvisynthError,
    ScriptEnvironment, avisynth_plugin_init, bind_args, parse_signature,
)

from conftest import make_planes  # noqa: E402


def _env(device="cpu", **kw):
    env = ScriptEnvironment(device=device, **kw)
    assert avisynth_plugin_init(env) == "SangNom2"
    return env


def _jenv():
    env = javs.ScriptEnvironment()
    javs.avisynth_plugin_init(env)
    return env


def _stacked(rng, w=32, h=16, n=6, fmt_name="YUV420P8"):
    fmt = J.get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    return [np.stack([fr[i] for fr in frames]) for i in range(fmt.num_planes)]


def _collect(flt, env, order=None):
    vi = flt.get_video_info()
    order = range(vi.num_frames) if order is None else order
    outs = {n: flt.get_frame(n, env) for n in order}
    return [np.stack([outs[n].planes[i] for n in range(vi.num_frames)])
            for i in range(len(outs[0].planes))]


def _tclip(planes, fmt_name, **kw):
    return T.Clip.from_numpy(planes, fmt_name, device="cpu", **kw)


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"plane {i}")


# --- registration + binding ------------------------------------------------

def test_signature_strings_match_reference_verbatim():
    # the AddFunction strings at reference src/SangNom2.cpp:481-482
    assert SIG_SANGNOM2 == \
        "c[order]i[aa]i[aac]i[threads]i[dh]b[luma]b[chroma]b[opt]i"
    assert SIG_SANGNOM == "c[order]i[aa]i[opt]i"
    env, jenv = _env(), _jenv()
    for name in ("SangNom2", "sangnom", "SeparateFields", "Trim"):
        assert env.function_signature(name) == jenv.function_signature(name)


def test_parse_signature():
    assert parse_signature("c[order]i[dh]b") == [
        (None, "c"), ("order", "i"), ("dh", "b")]
    with pytest.raises(AvisynthError):
        parse_signature("c[x]q")


def test_bind_positional_named_and_errors(rng):
    src = ArraySource(_stacked(rng), "YUV420P8")
    sig = SIG_SANGNOM2
    args = bind_args(sig, (src, 2, 100), {"DH": True, "Opt": 0})
    assert args[1].as_int(1) == 2 and args[2].as_int(48) == 100
    assert args[5].as_bool(False) is True  # case-insensitive names
    assert args[8].as_int(-1) == 0
    assert args[3].as_int(0) == 0 and not args[3].defined()
    for pos, named, msg in [
        ((src,), {"bogus": 1}, "unknown named"),
        ((src, 1), {"order": 1}, "twice"),
        ((src, "one"), {}, "expects type"),
        ((src,), {"dh": 1}, "expects type"),  # b is strictly bool
    ]:
        with pytest.raises(AvisynthError, match=msg):
            bind_args(sig, pos, named)
    with pytest.raises(AvisynthError, match="too many"):
        bind_args(SIG_SANGNOM, (src, 1, 48, 0, 99), {})
    np_args = bind_args(sig, (src, np.int64(2)), {"dh": np.True_})
    assert np_args[1].as_int(1) == 2 and np_args[5].as_bool(False) is True
    with pytest.raises(AvisynthError, match="out of range"):
        bind_args(SIG_SANGNOM, (src,), {})[7]


# --- factory validation and the opt=1 gate ----------------------------------

def test_factory_validation_error_strings_match_jax(rng):
    env, jenv = _env(), _jenv()
    planes = _stacked(rng)
    odd = [p[:, :15] if i == 0 else p[:, :7] for i, p in enumerate(planes)]
    cases = [
        ("SangNom2", planes, "YUV420P8", dict(order=3)),
        ("SangNom2", planes, "YUV420P8", dict(aa=129)),
        ("SangNom2", planes, "YUV420P8", dict(aac=-1)),
        ("SangNom2", planes, "YUV420P8", dict(opt=5)),
        ("SangNom2", planes, "YUV420P8", dict(numerics="fast")),
        ("SangNom2", odd, "YUV420P8", {}),
        ("SangNom2", [planes[0]], "YUY2", {}),
        ("SangNom", planes, "YUV420P8", dict(order=-1)),
    ]
    for name, pl, fmt, kw in cases:
        with pytest.raises(AvisynthError) as te:
            env.invoke(name, ArraySource(pl, fmt), **kw)
        with pytest.raises(javs.AvisynthError) as je:
            jenv.invoke(name, javs.ArraySource(pl, fmt), **kw)
        assert str(te.value) == str(je.value), (name, kw)


def test_opt1_gate_rides_env_cpu_flags(rng):
    src = ArraySource(_stacked(rng), "YUV420P8")
    with pytest.raises(AvisynthError,
                       match="SangNom2: opt=1 requires a CUDA backend."):
        _env(cpu_flags=0).invoke("SangNom2", src, opt=1)
    flt = _env(cpu_flags=CPUF_CUDA).invoke("SangNom2", src, opt=1)
    assert flt.get_video_info().height == 16
    # the default flags follow the environment's device
    assert ScriptEnvironment().get_cpu_flags() == CPUF_CUDA
    assert ScriptEnvironment(device="cuda:0").get_cpu_flags() == CPUF_CUDA
    assert ScriptEnvironment(device="cpu").get_cpu_flags() == 0
    with pytest.raises(AvisynthError, match="opt=1 requires"):
        _env().invoke("SangNom", src, opt=1)


def _fake_clip(device):
    return types.SimpleNamespace(format=T.get_format("GRAY8"), height=16,
                                 device=torch.device(device))


@pytest.mark.parametrize("opt1_ok", [None, True, False])
@pytest.mark.parametrize("clip", [None, "cpu", "cuda"])
def test_validate_opt1_ok_override(opt1_ok, clip):
    """A bool decides the opt=1 gate alone; None lets the clip's device
    decide, and without a clip skips the gate."""
    c = None if clip is None else _fake_clip(clip)
    ok = opt1_ok if opt1_ok is not None else clip != "cpu"
    _validate("SangNom2", c, 1, 48, 0, 0, opt1_ok=opt1_ok)  # opt=0: no gate
    if ok:
        _validate("SangNom2", c, 1, 48, 0, 1, opt1_ok=opt1_ok)
    else:
        with pytest.raises(SangNomError,
                           match="SangNom2: opt=1 requires a CUDA backend."):
            _validate("SangNom2", c, 1, 48, 0, 1, opt1_ok=opt1_ok)


# --- frame serving: the JAX host and the direct API --------------------------

@pytest.mark.parametrize("fmt_name,order,dh,aa", [
    ("YUV420P8", 1, False, 48),
    ("YUV420P8", 2, True, 48),
    ("GRAY16", 0, False, 128),
    ("YUV444PS", 1, True, 0),
])
def test_adapter_matches_jax_host_and_api(rng, fmt_name, order, dh, aa):
    planes = _stacked(rng, n=6, fmt_name=fmt_name)
    env, jenv = _env(), _jenv()
    flt = env.invoke("SangNom2", ArraySource(planes, fmt_name), order=order,
                     dh=dh, aa=aa, batch=4)
    vi = flt.get_video_info()
    assert vi.height == (32 if dh else 16) and vi.num_frames == 6
    got = _collect(flt, env)
    jflt = jenv.invoke("SangNom2", javs.ArraySource(planes, fmt_name),
                       order=order, dh=dh, aa=aa, batch=4)
    _same(got, _collect(jflt, jenv))
    _same(got, T.sangnom2(_tclip(planes, fmt_name), order=order, dh=dh,
                          aa=aa).to_numpy())


def test_order0_consults_child_parity(rng):
    planes = _stacked(rng, n=6, fmt_name="GRAY8")
    parity = np.array([True, False, True, True, False, False])
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8", parity=parity),
                     order=0, batch=3)
    ref = T.sangnom2(_tclip(planes, "GRAY8", parity=parity), order=0)
    _same(_collect(flt, env), ref.to_numpy())
    # GetParity delegates to the child (GenericVideoFilter default)
    assert [flt.get_parity(k) for k in range(6)] == list(map(bool, parity))


def test_legacy_sangnom_matches_jax_host(rng):
    planes = _stacked(rng, n=5, fmt_name="YUV420P8")
    env, jenv = _env(), _jenv()
    for order in (0, 1, 2):
        flt = env.invoke("SangNom", ArraySource(planes, "YUV420P8"),
                         order=order, aa=32, batch=4)
        assert flt.get_video_info().height == 16  # legacy has no dh
        got = _collect(flt, env)
        _same(got, T.sangnom(_tclip(planes, "YUV420P8"), order=order,
                             aa=32).to_numpy())
        jflt = jenv.invoke("SangNom", javs.ArraySource(planes, "YUV420P8"),
                           order=order, aa=32, batch=4)
        _same(got, _collect(jflt, jenv))
    with pytest.raises(AvisynthError, match="unknown named"):
        env.invoke("SangNom", ArraySource(planes, "YUV420P8"), dh=True)


def test_props_propagation_and_field_rewrite(rng):
    planes = _stacked(rng, n=3, fmt_name="GRAY8")

    def props_fn(n):
        return {"_Matrix": 1, "_Field": 1, "_FieldBased": 2, "n": n}

    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8",
                                             props_fn=props_fn), batch=2)
    fr = flt.get_frame(1, env)
    assert fr.props["_Matrix"] == 1 and fr.props["n"] == 1
    assert fr.props["_FieldBased"] == 0 and "_Field" not in fr.props


def test_set_cache_hints_mt_contract(rng):
    planes = _stacked(rng, n=2, fmt_name="GRAY8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8"))
    assert flt.set_cache_hints(CACHE_GET_MTMODE, 0) == MT_MULTI_INSTANCE
    assert flt.set_cache_hints(0, 0) == 0
    pooled = env.invoke("SangNom2", ArraySource(planes, "GRAY8"),
                        pool_compat=True)
    assert pooled.set_cache_hints(CACHE_GET_MTMODE, 0) == MT_SERIALIZED


def test_pool_compat_chains_across_windows_matches_jax(rng):
    planes = _stacked(rng, n=7, fmt_name="YUV420P8")
    env, jenv = _env(), _jenv()
    flt = env.invoke("SangNom2", ArraySource(planes, "YUV420P8"),
                     pool_compat=True, batch=3)
    got = _collect(flt, env)
    _same(got, T.sangnom2(_tclip(planes, "YUV420P8"),
                          pool_compat=True).to_numpy())
    jflt = jenv.invoke("SangNom2", javs.ArraySource(planes, "YUV420P8"),
                       pool_compat=True, batch=3)
    _same(got, _collect(jflt, jenv))


def test_frame_index_clamping(rng):
    planes = _stacked(rng, n=3, fmt_name="GRAY8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8"), batch=2)
    np.testing.assert_array_equal(flt.get_frame(-5, env).planes[0],
                                  flt.get_frame(0, env).planes[0])
    np.testing.assert_array_equal(flt.get_frame(99, env).planes[0],
                                  flt.get_frame(2, env).planes[0])


def test_env_device_defaults_to_cuda(rng):
    """The environment's device defaults to cuda, with no CPU fallback: on a
    machine without a card a frame request fails loudly."""
    planes = _stacked(rng, n=2, fmt_name="GRAY8")
    env = ScriptEnvironment()
    avisynth_plugin_init(env)
    assert env.device == "cuda"
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8"))
    if torch.cuda.is_available():
        want = T.sangnom2(_tclip(planes, "GRAY8")).to_numpy()
        _same(flt.get_frame(0, env).planes, [want[0][0]])
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            flt.get_frame(0, env)


# --- MT stress -------------------------------------------------------------

def _hammer(flt, env, indices, n_threads):
    results = {}
    lock = threading.Lock()

    def worker(ns):
        for n in ns:
            fr = flt.get_frame(n, env)
            with lock:
                results.setdefault(n, []).append(
                    [p.copy() for p in fr.planes])

    chunks = [indices[i::n_threads] for i in range(n_threads)]
    ex = ThreadPoolExecutor(n_threads)
    try:
        for fut in [ex.submit(worker, c) for c in chunks]:
            fut.result(timeout=120)
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
    return results


@pytest.mark.parametrize("pool_compat", [False, True])
def test_stress_parallel_out_of_order(rng, pool_compat):
    planes = _stacked(rng, n=10, fmt_name="YUV420P8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "YUV420P8"),
                     pool_compat=pool_compat, batch=3)
    order = list(rng.permutation(np.repeat(np.arange(10), 3)))
    results = _hammer(flt, env, order, n_threads=6)
    refp = T.sangnom2(_tclip(planes, "YUV420P8"),
                      pool_compat=pool_compat).to_numpy()
    assert sorted(results) == list(range(10))
    for n, copies in results.items():
        for planes_copy in copies:
            for i, p in enumerate(planes_copy):
                np.testing.assert_array_equal(p, refp[i][n])


def test_stress_multi_instance_model(rng):
    """MT_MULTI_INSTANCE: the host instantiates one filter per thread via
    the factory; every instance must agree bit-for-bit."""
    planes = _stacked(rng, n=6, fmt_name="GRAY16")
    env = _env()
    src = ArraySource(planes, "GRAY16")
    refp = T.sangnom2(_tclip(planes, "GRAY16"), dh=True).to_numpy()[0]

    def one_instance(seed):
        flt = env.invoke("SangNom2", src, dh=True, batch=4)
        order = list(np.random.default_rng(seed).permutation(6))
        return [flt.get_frame(n, env).planes[0] for n in order], order

    with ThreadPoolExecutor(4) as ex:
        for got, order in ex.map(one_instance, range(4)):
            for p, n in zip(got, order):
                np.testing.assert_array_equal(p, refp[n])


# --- host built-ins + the canonical double-rate recipe ----------------------

def test_separate_weave_round_trip(rng):
    planes = _stacked(rng, n=4, fmt_name="YUV420P8")
    env = _env()
    for assume in ("AssumeTFF", "AssumeBFF"):
        src = env.invoke(assume, ArraySource(planes, "YUV420P8"))
        flds = env.invoke("SeparateFields", src)
        vi = flds.get_video_info()
        assert vi.num_frames == 8 and vi.height == 8
        tff = assume == "AssumeTFF"
        assert [flds.get_parity(k) for k in range(4)] == [tff, not tff] * 2
        back = env.invoke("Weave", flds)
        _same(_collect(back, env), planes)


def test_select_even_odd(rng):
    planes = _stacked(rng, n=5, fmt_name="GRAY8")
    env = _env()
    src = ArraySource(planes, "GRAY8")
    ev = env.invoke("SelectEven", src)
    od = env.invoke("SelectOdd", src)
    assert ev.get_video_info().num_frames == 3
    assert od.get_video_info().num_frames == 2
    np.testing.assert_array_equal(_collect(ev, env)[0], planes[0][0::2])
    np.testing.assert_array_equal(_collect(od, env)[0], planes[0][1::2])


def test_advice_select_even_odd_halves_fps(rng):
    """Deviation from the JAX host (its hosts/avisynth.py:633 keeps the
    child's rate): SelectEven/SelectOdd halve the frame rate with the frame
    count, as AviSynth's do.  The frames are the JAX host's."""
    planes = _stacked(rng, n=5, fmt_name="GRAY8")
    env, jenv = _env(), _jenv()
    for name in ("SelectEven", "SelectOdd"):
        vi = env.invoke(name, env.invoke(
            "SeparateFields", ArraySource(planes, "GRAY8"))).get_video_info()
        jvi = jenv.invoke(name, jenv.invoke(
            "SeparateFields", javs.ArraySource(planes, "GRAY8"))
        ).get_video_info()
        # fields at 60000/1001, every other one: 30000/1001 again
        assert (vi.fps_numerator / vi.fps_denominator) == 30000 / 1001
        assert (jvi.fps_numerator, jvi.fps_denominator) == (60000, 1001)
        got = _collect(env.invoke(name, ArraySource(planes, "GRAY8")), env)
        want = _collect(jenv.invoke(name, javs.ArraySource(planes, "GRAY8")),
                        jenv)
        _same(got, want)


def test_separate_fields_height_error(rng):
    env = _env()
    src = ArraySource([p[:, :7] for p in _stacked(rng, fmt_name="GRAY8",
                                                  h=16)], "GRAY8")
    with pytest.raises(AvisynthError, match="SeparateFields: height"):
        env.invoke("SeparateFields", src)


@pytest.mark.parametrize("assume", ["AssumeTFF", "AssumeBFF"])
def test_canonical_bob_recipe_matches_core_bob_and_jax(rng, assume):
    """The reference's documented double-rate recipe (src/SangNom2.cpp:
    18-23) through the host equals the port's bob() and the JAX host."""
    planes = _stacked(rng, n=3, fmt_name="YUV420P8")

    def recipe(env, mod):
        return env.invoke("SangNom2", env.invoke("DoubleWeave", env.invoke(
            "SeparateFields", env.invoke(assume, mod.ArraySource(
                planes, "YUV420P8")))), order=0, batch=4)

    env, jenv = _env(), _jenv()
    chain = recipe(env, tavs)
    vi = chain.get_video_info()
    assert vi.num_frames == 6 and vi.height == 16
    got = _collect(chain, env)
    _same(got, T.bob(_tclip(planes, "YUV420P8"),
                     tff=(assume == "AssumeTFF")).to_numpy())
    _same(got, _collect(recipe(jenv, javs), jenv))


def test_trim_builtin(rng):
    planes = _stacked(rng, n=6, fmt_name="GRAY8")
    env = _env()
    src = ArraySource(planes, "GRAY8", parity=np.array([True, False] * 3))
    t = env.invoke("Trim", src, 2, 4)  # inclusive last index
    assert t.get_video_info().num_frames == 3
    np.testing.assert_array_equal(_collect(t, env)[0], planes[0][2:5])
    assert t.get_parity(0) == src.get_parity(2)
    assert env.invoke("Trim", src, first=4).get_video_info().num_frames == 2
    tn = env.invoke("Trim", src, 1, -2)  # negative last = count
    np.testing.assert_array_equal(_collect(tn, env)[0], planes[0][1:3])
    with pytest.raises(AvisynthError, match="Trim: first frame"):
        env.invoke("Trim", src, 99)
    with pytest.raises(AvisynthError, match="Trim: invalid range"):
        env.invoke("Trim", src, 4, 2)
