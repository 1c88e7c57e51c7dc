"""AviSynth-model host adapter — the reference plugin's OWN host contract.

The reference is an AviSynth+ plugin: `AvisynthPluginInit3` registers two
script functions with typed signature strings, the host binds script
arguments into an AVSValue array, `Create_*` factories validate through
`env->ThrowError` and return a filter object, and the host pulls frames
through `GetFrame(n, env)` / `GetParity(n)` under the MT contract declared
via `SetCacheHints` (reference src/SangNom2.cpp:399-484, src/SangNom2.h:
61-66).  This module reimplements that exact contract as a Python host
protocol so an AviSynth-minded user (or a Python scripting host built on
AviSynth semantics) drives the CUDA filter through the same surface:

* verbatim signature strings (`SIG_SANGNOM2` / `SIG_SANGNOM` match
  reference src/SangNom2.cpp:481-482 byte for byte; the framework's
  additive, named-only extension args are appended after them),
* AVSValue semantics — positional-or-named binding against the signature
  (names case-insensitive, as in AviSynth), undefined slots, and
  `as_int(default)` / `as_bool(default)` defaulting exactly where the
  reference factories apply theirs (src/SangNom2.cpp:402-405, 424-434),
* `Create_SangNom2` / `Create_SangNom` factories whose validation (order
  of checks, exact error strings, the env CPU-flags gate for opt=1)
  reaches the caller through `env.throw_error`,
* a `SangNom2AVSFilter` whose `get_frame` fetches the source frame from
  `child` inside the call — the AviSynth pull model, exactly what the
  reference's GetFrame does (child->GetFrame(n, env),
  src/SangNom2.cpp:343) — batched through the shared `WindowRunner`, and
  whose `set_cache_hints(CACHE_GET_MTMODE)` answers `MT_MULTI_INSTANCE`
  exactly like the reference (src/SangNom2.h:63-66).

Deliberate deviations:

* (shared with the rest of the framework, docs/PARITY.md deviation 2) the
  legacy `SangNom` factory implements the
  DOCUMENTED legacy surface (order remap {0->2, 1->1, 2->0}, aac fixed 0)
  rather than replicating the reference's out-of-bounds argument reads
  (src/SangNom2.cpp:443-444, 462-470 index slots 4..8 of a 4-slot
  signature).  Accordingly `AVSArgs` raises on out-of-range access instead
  of reading past the array.
* SelectEven/SelectOdd halve the frame rate along with the frame count, as
  AviSynth's own do (the JAX package's host keeps the child's rate).

Device: the filter's windows run on the ScriptEnvironment's ``device``
("cuda" unless the host asks for another); the opt=1 gate rides the
environment's `CPUF_CUDA` flag, which a CUDA-device environment sets.

Threading: AviSynth+ serves `GetFrame` from a thread pool in which
nested `child->GetFrame` calls are the normal, safe call model — there
is no VapourSynth-style bounded-worker deadlock hazard to design around
(see hosts/vapoursynth.py's THREADING MODEL for that host).  The shared
`WindowRunner`'s single-flight / ordered-pool-chain guarantees therefore
hold trivially here; `set_cache_hints` additionally reports
`MT_SERIALIZED` when the stateful `pool_compat` extension is on, so a
conforming host serializes requests to the mode whose semantics are
sequential anyway.

Usage (script-environment style):

    from sangnom_tpu_torch.hosts.avisynth import (ArraySource,
                                                  ScriptEnvironment,
                                                  avisynth_plugin_init)
    env = ScriptEnvironment(device="cuda")
    avisynth_plugin_init(env)
    clip = ArraySource(planes, "YUV420P8")     # any chain head works
    flt = env.invoke("SangNom2", clip, order=1, aa=48, dh=True)
    frame = flt.get_frame(0, env)              # numpy planes + props
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

import torch

from sangnom_tpu_torch.api import (SangNomError, _validate,
                                   _validate_geometry, _validate_numerics)
from sangnom_tpu_torch.core.formats import VideoFormat, get_format
from sangnom_tpu_torch.hosts.window import WindowRunner

# --- AviSynth+ ABI constants (avisynth.h values) ---------------------------
# SetCacheHints query selector + MT-mode answers (reference src/SangNom2.h:
# 63-66 answers MT_MULTI_INSTANCE to CACHE_GET_MTMODE).
CACHE_GET_MTMODE = 209
MT_NICE_FILTER = 1
MT_MULTI_INSTANCE = 2
MT_SERIALIZED = 3

# The reference factory gates opt=1 on env->GetCPUFlags() & CPUF_SSE2
# (src/SangNom2.cpp:422); the analogue flag says "the CUDA backend is
# available in this environment".
CPUF_CUDA = 1 << 24

# Registered signature strings.  The prefixes are VERBATIM the reference's
# AddFunction strings (src/SangNom2.cpp:481-482); the extension suffix adds
# the framework's named-only compat/integration knobs.
SIG_SANGNOM2 = "c[order]i[aa]i[aac]i[threads]i[dh]b[luma]b[chroma]b[opt]i"
SIG_SANGNOM = "c[order]i[aa]i[opt]i"
SIG_EXTENSIONS = "[pool_compat]b[numerics]s[batch]i"


class AvisynthError(SangNomError):
    """Raised by `ScriptEnvironment.throw_error` — the script-visible error
    channel (env->ThrowError in the reference factories)."""


# --- AVSValue --------------------------------------------------------------

class AVSValue:
    """A defined-or-undefined script value with the AVSValue accessor
    surface the reference factories use: ``as_clip()``, ``as_int(d)``,
    ``as_bool(d)`` — undefined values yield the accessor's default, which
    is how the reference applies parameter defaults
    (src/SangNom2.cpp:402-405)."""

    _UNDEFINED = object()

    def __init__(self, value: Any = _UNDEFINED):
        self._v = value

    @classmethod
    def undefined(cls) -> "AVSValue":
        return cls()

    def defined(self) -> bool:
        return self._v is not AVSValue._UNDEFINED

    def as_clip(self):
        if not self.defined():
            raise AvisynthError("AVSValue: undefined clip argument.")
        return self._v

    def as_int(self, default: int = 0) -> int:
        return int(self._v) if self.defined() else default

    def as_bool(self, default: bool = False) -> bool:
        return bool(self._v) if self.defined() else default

    def as_float(self, default: float = 0.0) -> float:
        return float(self._v) if self.defined() else default

    def as_string(self, default: str = "") -> str:
        return str(self._v) if self.defined() else default


class AVSArgs:
    """The bound argument array a Create_ factory receives (``args[i]`` ->
    `AVSValue`).  Out-of-range access raises — the documented-surface
    stance on the reference's OOB legacy reads (module docstring)."""

    def __init__(self, values: list[AVSValue]):
        self._values = values

    def __len__(self) -> int:
        return len(self._values)

    def __getitem__(self, i: int) -> AVSValue:
        if not 0 <= i < len(self._values):
            raise AvisynthError(
                f"AVSValue: argument index {i} out of range for "
                f"{len(self._values)}-slot signature (the reference's "
                "out-of-bounds legacy reads are deliberately not "
                "replicated, docs/PARITY.md deviation 2).")
        return self._values[i]


def parse_signature(sig: str) -> list[tuple[Optional[str], str]]:
    """Parse an AviSynth parameter-type string into (name-or-None, code)
    slots.  Codes used by this plugin: c=clip, i=int, b=bool, f=float,
    s=string (the format of AddFunction's second argument, reference
    src/SangNom2.cpp:481-482)."""
    out: list[tuple[Optional[str], str]] = []
    i = 0
    while i < len(sig):
        name = None
        if sig[i] == "[":
            j = sig.index("]", i)
            name = sig[i + 1:j]
            i = j + 1
        code = sig[i]
        if code not in "cibfs":
            raise AvisynthError(f"unsupported signature type code {code!r}")
        out.append((name, code))
        i += 1
    return out


_BOOLS = (bool, np.bool_)
_INTS = (int, np.integer)
_TYPE_CHECK: dict[str, Callable[[Any], bool]] = {
    "c": lambda v: hasattr(v, "get_video_info") and hasattr(v, "get_frame"),
    "i": lambda v: isinstance(v, _INTS) and not isinstance(v, _BOOLS),
    "b": lambda v: isinstance(v, _BOOLS),
    "f": lambda v: (isinstance(v, (float, np.floating) + _INTS)
                    and not isinstance(v, _BOOLS)),
    "s": lambda v: isinstance(v, str),
}


def bind_args(sig: str, pos_args: tuple, named: dict) -> AVSArgs:
    """Bind a script call onto a signature, AviSynth-style: unnamed
    arguments fill slots in declaration order, named arguments (names
    case-insensitive, as in AviSynth scripts) land on their slot, every
    unset slot stays undefined for the accessor defaults to fill."""
    slots = parse_signature(sig)
    values = [AVSValue.undefined()] * len(slots)
    if len(pos_args) > len(slots):
        raise AvisynthError(
            f"too many arguments: {len(pos_args)} for "
            f"{len(slots)}-slot signature {sig!r}")
    for i, v in enumerate(pos_args):
        _check_type(sig, slots[i], i, v)
        values[i] = AVSValue(v)
    lower_index = {nm.lower(): i for i, (nm, _) in enumerate(slots) if nm}
    for nm, v in named.items():
        i = lower_index.get(nm.lower())
        if i is None:
            raise AvisynthError(f"unknown named argument {nm!r} for "
                                f"signature {sig!r}")
        if values[i].defined():
            raise AvisynthError(f"argument {nm!r} given twice")
        _check_type(sig, slots[i], i, v)
        values[i] = AVSValue(v)
    return AVSArgs(values)


def _check_type(sig, slot, i, v):
    name, code = slot
    if not _TYPE_CHECK[code](v):
        label = name or f"#{i}"
        raise AvisynthError(
            f"argument {label} of signature {sig!r} expects type "
            f"{code!r}, got {type(v).__name__}")


# --- the frame/clip protocol ----------------------------------------------

@dataclass
class VideoInfo:
    """The filter-visible clip metadata (the VideoInfo fields the reference
    reads: geometry, format predicates, frame count — src/SangNom2.cpp:
    401-412 and the ctor's ComponentSize/NumComponents dispatch)."""

    format: VideoFormat
    width: int
    height: int
    num_frames: int
    fps_numerator: int = 30000
    fps_denominator: int = 1001

    def is_rgb(self) -> bool:
        return self.format.is_rgb

    def is_planar(self) -> bool:
        return self.format.planar

    def is_420(self) -> bool:
        return self.format.is_420

    def component_size(self) -> int:
        return self.format.component_size

    def num_components(self) -> int:
        return self.format.num_planes


class VideoFrame:
    """One served frame: numpy planes plus v8-style frame props."""

    def __init__(self, planes: list[np.ndarray],
                 props: Optional[dict] = None):
        self.planes = list(planes)
        self.props = dict(props or {})

    def get_read_ptr(self, plane: int) -> np.ndarray:
        return self.planes[plane]


class ArraySource:
    """A chain-head source clip over numpy plane arrays ([N, h, w] each) —
    the test/script analogue of the host's source filters.  ``parity`` is
    a bool (constant field order) or per-frame bool array, answered
    through ``get_parity`` exactly like the host parity the reference
    consults for order=0 (src/SangNom2.cpp:338)."""

    def __init__(self, planes, fmt, parity=True, props_fn=None):
        fmt = get_format(fmt) if isinstance(fmt, str) else fmt
        self._planes = [np.asarray(p) for p in planes]
        self._fmt = fmt
        self._parity = parity
        self._props_fn = props_fn  # n -> dict, optional per-frame props
        n, h, w = self._planes[0].shape
        self._vi = VideoInfo(fmt, w, h, n)

    def get_video_info(self) -> VideoInfo:
        return self._vi

    def get_parity(self, n: int) -> bool:
        if isinstance(self._parity, (bool, np.bool_)):
            return bool(self._parity)
        return bool(self._parity[n])

    def get_frame(self, n: int, env=None) -> VideoFrame:
        n = min(max(n, 0), self._vi.num_frames - 1)  # host-style clamping
        props = self._props_fn(n) if self._props_fn else {}
        return VideoFrame([p[n].copy() for p in self._planes], props)

    def set_cache_hints(self, cachehints: int, frame_range: int) -> int:
        return 0


# --- the filter ------------------------------------------------------------

class SangNom2AVSFilter:
    """The reference filter object's host-facing contract: constructed by a
    Create_ factory, pulls source frames from ``child`` inside
    ``get_frame`` (reference src/SangNom2.cpp:332-397), answers
    ``get_parity`` by delegation (the GenericVideoFilter default — the
    reference does not override it) and declares its MT contract through
    ``set_cache_hints`` (src/SangNom2.h:63-66).  Frame requests batch
    through the shared `WindowRunner` so sequential host playback hits
    the device once per ``batch`` frames, on ``device``."""

    def __init__(self, child, order: int, aa: int, aac: int, threads: int,
                 dh: bool, luma: bool, chroma: bool, opt: int, env,
                 pool_compat: bool = False, numerics: str = "c",
                 batch: int = 8, legacy: bool = False,
                 device: torch.device | str = "cuda"):
        del threads, env  # accepted-and-ignored, as in the reference ctor
        vi = child.get_video_info()
        self.child = child
        self.pool_compat = bool(pool_compat)
        self._legacy = bool(legacy)
        dh = bool(dh) and not legacy
        self.vi = VideoInfo(vi.format, vi.width,
                            vi.height * 2 if dh else vi.height,
                            vi.num_frames, vi.fps_numerator,
                            vi.fps_denominator)
        self._env_cell: list = [None]  # most recent env, for host_fetch
        if legacy:
            params = dict(order=order, aa=aa, opt=opt,
                          pool_compat=pool_compat, numerics=numerics,
                          _legacy=True)
        else:
            params = dict(order=order, aa=aa, aac=aac, dh=dh, luma=luma,
                          chroma=chroma, opt=opt, pool_compat=pool_compat,
                          numerics=numerics)
        self._runner = WindowRunner(
            vi.num_frames, vi.format.name, params, tff=True,
            batch=batch, host_fetch=self._host_fetch, device=device,
        )

    # -- chain protocol ----------------------------------------------------
    def get_video_info(self) -> VideoInfo:
        return self.vi

    def get_parity(self, n: int) -> bool:
        # GenericVideoFilter default: delegate to child (the reference
        # declares no GetParity override, src/SangNom2.h:55-66)
        return self.child.get_parity(n)

    def set_cache_hints(self, cachehints: int, frame_range: int = 0) -> int:
        if cachehints != CACHE_GET_MTMODE:
            return 0
        # the reference answers MT_MULTI_INSTANCE unconditionally
        # (src/SangNom2.h:63-66); the stateful pool_compat extension has
        # no reference analogue and is honestly declared MT_SERIALIZED
        # (the runner's ordered chain keeps it safe even if the host
        # ignores the hint, but its semantics are sequential by nature)
        return MT_SERIALIZED if self.pool_compat else MT_MULTI_INSTANCE

    # -- frame serving -----------------------------------------------------
    def _host_fetch(self, k: int) -> dict:
        # pool-compat random access only (WindowRunner contract): a child
        # fetch outside any current request's window
        return self._frame_dict(k, self._env_cell[0])

    def _frame_dict(self, k: int, env, frame: Optional[VideoFrame] = None):
        fr = frame if frame is not None else self.child.get_frame(k, env)
        return {
            "planes": [np.asarray(p) for p in fr.planes],
            "parity": bool(self.child.get_parity(k)),
        }

    def get_frame(self, n: int, env=None) -> VideoFrame:
        n = min(max(n, 0), self.vi.num_frames - 1)  # host-style clamping
        self._env_cell[0] = env
        # fetch the request's own source frame exactly like the reference
        # (child->GetFrame(n, env), src/SangNom2.cpp:343); its props seed
        # the output frame (the v8 NewVideoFrameP analogue, :344)
        src = self.child.get_frame(n, env)
        batch = self._runner.batch
        start = (n // batch) * batch
        end = min(start + batch, self.vi.num_frames)

        def window_frames_fn():
            # nested child fetches are the AviSynth call model (module
            # docstring); n's own frame reuses the fetch above
            return [
                self._frame_dict(k, env, frame=src if k == n else None)
                for k in range(start, end)
            ]

        outs = self._runner.get(n, window_frames_fn)
        props = dict(src.props)
        # the filter emits progressive content: field-ness props are
        # rewritten, everything else forwards (same policy as the
        # VapourSynth adapter)
        props["_FieldBased"] = 0
        props.pop("_Field", None)
        return VideoFrame([p.copy() for p in outs], props)


# --- factories + registration ----------------------------------------------

def _throw(env, err: SangNomError):
    env.throw_error(str(err))
    # a conforming throw_error raises; guard against hosts that return
    raise AvisynthError(str(err))


def _opt1_flag_ok(env) -> bool:
    return bool(env.get_cpu_flags() & CPUF_CUDA)


def _env_device(env):
    """The device the environment's filters run on ("cuda" for a host
    environment that does not say)."""
    return getattr(env, "device", "cuda")


def Create_SangNom2(args: AVSArgs, user_data, env) -> SangNom2AVSFilter:
    """Factory for the full surface — argument slots, defaults, validation
    order and error strings exactly as reference Create_SangNom2
    (src/SangNom2.cpp:399-435), with the opt=1 gate riding the host
    environment's CPU-flags analogue."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    order = args[1].as_int(1)
    aa = args[2].as_int(48)
    aac = args[3].as_int(0)
    opt = args[8].as_int(-1)
    numerics = args[10].as_string("c")
    try:
        _validate_geometry("SangNom2", vi.format, vi.height)
        _validate("SangNom2", None, order, aa, aac, opt,
                  opt1_ok=_opt1_flag_ok(env))
        _validate_numerics("SangNom2", numerics)
    except SangNomError as e:
        _throw(env, e)
    return SangNom2AVSFilter(
        child, order, aa, aac, args[4].as_int(0), args[5].as_bool(False),
        args[6].as_bool(True), args[7].as_bool(True), opt, env,
        pool_compat=args[9].as_bool(False), numerics=numerics,
        batch=args[11].as_int(8), device=_env_device(env),
    )


def Create_SangNom(args: AVSArgs, user_data, env) -> SangNom2AVSFilter:
    """Factory for the legacy surface — the DOCUMENTED semantics (order
    remap via ord[]={2,1,0} at src/SangNom2.cpp:441,463; aac fixed 0; no
    dh/luma/chroma knobs), not the reference's OOB argument reads (module
    docstring)."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    order = args[1].as_int(1)
    aa = args[2].as_int(48)
    opt = args[3].as_int(-1)
    numerics = args[5].as_string("c")
    try:
        _validate_geometry("SangNom", vi.format, vi.height)
        _validate("SangNom", None, order, aa, 0, opt,
                  opt1_ok=_opt1_flag_ok(env))
        _validate_numerics("SangNom", numerics)
    except SangNomError as e:
        _throw(env, e)
    return SangNom2AVSFilter(
        child, order, aa, 0, 0, False, True, True, opt, env,
        pool_compat=args[4].as_bool(False), numerics=numerics,
        batch=args[6].as_int(8), legacy=True, device=_env_device(env),
    )


def avisynth_plugin_init(env) -> str:
    """The AvisynthPluginInit3 analogue: register both script functions
    with the reference's verbatim signature strings (plus the framework's
    named-only extension args) and return the plugin identifier
    (reference src/SangNom2.cpp:477-484).  Also registers the host
    built-ins the reference's recipes depend on (`avisynth_builtin_init`)
    — a real AviSynth host ships those itself."""
    env.add_function("SangNom2", SIG_SANGNOM2 + SIG_EXTENSIONS,
                     Create_SangNom2, 0)
    env.add_function("SangNom", SIG_SANGNOM + SIG_EXTENSIONS,
                     Create_SangNom, 0)
    avisynth_builtin_init(env)
    return "SangNom2"


# --- host built-ins the reference's recipes depend on ----------------------
#
# The reference's double-rate mode documents "user must call
# std.SeparateFields().std.DoubleWeave() before use" (reference
# src/SangNom2.cpp:18-23), and the classic bob recipe wraps that in
# AssumeTFF/SelectEven-style bookkeeping.  A real AviSynth host ships these
# built-ins; this protocol host ships them too (lazy per-frame numpy row
# shuffles — no device involvement), with the same field semantics as the
# batched core helpers (core/fields.py), so the canonical script
#     AssumeTFF().SeparateFields().DoubleWeave().SangNom2(order=0)
# is value-identical to the core `bob()` fast path.

class _ChainClip:
    """A lazy chain filter over the clip protocol: callables supply the
    frame mapping and parity so each built-in stays a few lines."""

    def __init__(self, child, vi, frame_fn, parity_fn):
        self.child = child
        self._vi = vi
        self._frame_fn = frame_fn
        self._parity_fn = parity_fn

    def get_video_info(self) -> VideoInfo:
        return self._vi

    def get_parity(self, n: int) -> bool:
        return self._parity_fn(n)

    def get_frame(self, n: int, env=None) -> VideoFrame:
        n = min(max(n, 0), self._vi.num_frames - 1)
        return self._frame_fn(n, env)

    def set_cache_hints(self, cachehints: int, frame_range: int = 0) -> int:
        return MT_NICE_FILTER if cachehints == CACHE_GET_MTMODE else 0


def _assume_parity(args: AVSArgs, tff: bool, env) -> _ChainClip:
    child = args[0].as_clip()
    vi = child.get_video_info()
    return _ChainClip(child, vi,
                      lambda n, e: child.get_frame(n, e),
                      lambda n: tff)


def _separate_fields(args: AVSArgs, user_data, env) -> _ChainClip:
    """Frame k -> field frames (2k, 2k+1) in dominance order: the first
    field of a TFF frame is the top field (rows 0::2).  Output parity
    marks top fields True — the alternation order=0 consumes (same
    layout as core/fields.separate_fields)."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    if vi.height % 2:
        env.throw_error("SeparateFields: height must be even.")
    out_vi = VideoInfo(vi.format, vi.width, vi.height // 2,
                       vi.num_frames * 2, vi.fps_numerator * 2,
                       vi.fps_denominator)

    def frame(n, e):
        src = child.get_frame(n // 2, e)
        top_first = bool(child.get_parity(n // 2))
        want_top = (n % 2 == 0) == top_first
        off = 0 if want_top else 1
        return VideoFrame([p[off::2].copy() for p in src.planes],
                          src.props)

    def parity(n):
        return (n % 2 == 0) == bool(child.get_parity(n // 2))

    return _ChainClip(child, out_vi, frame, parity)


def _weave_frames(first: VideoFrame, second: VideoFrame,
                  first_is_top: bool) -> list[np.ndarray]:
    out = []
    for a, b in zip(first.planes, second.planes):
        h, w = a.shape
        p = np.empty((2 * h, w), a.dtype)
        p[0::2], p[1::2] = (a, b) if first_is_top else (b, a)
        out.append(p)
    return out


def _double_weave(args: AVSArgs, user_data, env) -> _ChainClip:
    """Field frames -> same-count full-height frames: frame n weaves
    fields (n, n+1) by field n's parity; the last frame weaves (N-1, N-1)
    degenerately (core/fields.double_weave's final duplicated pairing)."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    out_vi = VideoInfo(vi.format, vi.width, vi.height * 2, vi.num_frames,
                       vi.fps_numerator, vi.fps_denominator)

    def frame(n, e):
        a = child.get_frame(n, e)
        b = child.get_frame(min(n + 1, vi.num_frames - 1), e)
        return VideoFrame(
            _weave_frames(a, b, bool(child.get_parity(n))), a.props)

    return _ChainClip(child, out_vi, frame, child.get_parity)


def _weave(args: AVSArgs, user_data, env) -> _ChainClip:
    """Inverse of SeparateFields: field pairs (2k, 2k+1) -> full frames."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    if vi.num_frames % 2:
        env.throw_error("Weave: field count must be even.")
    out_vi = VideoInfo(vi.format, vi.width, vi.height * 2,
                       vi.num_frames // 2, vi.fps_numerator,
                       vi.fps_denominator * 2)
    # keep fps ratio: fields at 2x rate weave back to 1x

    def frame(k, e):
        a = child.get_frame(2 * k, e)
        b = child.get_frame(2 * k + 1, e)
        return VideoFrame(
            _weave_frames(a, b, bool(child.get_parity(2 * k))), a.props)

    return _ChainClip(child, out_vi, frame,
                      lambda k: bool(child.get_parity(2 * k)))


def _trim(args: AVSArgs, user_data, env) -> _ChainClip:
    """AviSynth Trim(c, first, last): ``last=0`` keeps to the end,
    ``last>0`` is the inclusive last frame index, ``last=-count`` keeps
    ``count`` frames from ``first``."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    first = args[1].as_int(0)
    last = args[2].as_int(0)
    if not 0 <= first < vi.num_frames:
        env.throw_error(f"Trim: first frame {first} out of range.")
    if last == 0:
        count = vi.num_frames - first
    elif last > 0:
        count = last - first + 1
    else:
        count = -last
    if count < 1 or first + count > vi.num_frames:
        env.throw_error(f"Trim: invalid range (first={first}, last={last}).")
    out_vi = VideoInfo(vi.format, vi.width, vi.height, count,
                       vi.fps_numerator, vi.fps_denominator)
    return _ChainClip(child, out_vi,
                      lambda n, e: child.get_frame(first + n, e),
                      lambda n: bool(child.get_parity(first + n)))


def _select_stride(args: AVSArgs, odd: bool, env) -> _ChainClip:
    """SelectEven/SelectOdd: every other frame, at half the frame rate."""
    child = args[0].as_clip()
    vi = child.get_video_info()
    count = vi.num_frames // 2 if odd else (vi.num_frames + 1) // 2
    out_vi = VideoInfo(vi.format, vi.width, vi.height, max(count, 1),
                       vi.fps_numerator, vi.fps_denominator * 2)
    base = 1 if odd else 0
    return _ChainClip(child, out_vi,
                      lambda n, e: child.get_frame(2 * n + base, e),
                      lambda n: bool(child.get_parity(2 * n + base)))


def avisynth_builtin_init(env) -> None:
    """Register the field-bookkeeping built-ins the plugin's recipes use
    (all signature "c", as in AviSynth)."""
    env.add_function("AssumeTFF", "c",
                     lambda a, u, e: _assume_parity(a, True, e))
    env.add_function("AssumeBFF", "c",
                     lambda a, u, e: _assume_parity(a, False, e))
    env.add_function("SeparateFields", "c", _separate_fields)
    env.add_function("DoubleWeave", "c", _double_weave)
    env.add_function("Weave", "c", _weave)
    env.add_function("SelectEven", "c",
                     lambda a, u, e: _select_stride(a, False, e))
    env.add_function("SelectOdd", "c",
                     lambda a, u, e: _select_stride(a, True, e))
    env.add_function("Trim", "c[first]i[last]i", _trim)


class ScriptEnvironment:
    """A minimal IScriptEnvironment analogue: a typed function registry
    with AVSValue binding (`invoke` is the script-call entry), the error
    channel, the CPU-flags query the opt=1 gate consults, and the
    ``device`` the plugin's filters run on ("cuda" by default).  Hosts with
    their own environment object need only this surface."""

    def __init__(self, cpu_flags: Optional[int] = None,
                 device: torch.device | str = "cuda"):
        self._functions: dict[str, tuple[str, Callable, Any]] = {}
        self._cpu_flags = cpu_flags
        self.device = device

    def add_function(self, name: str, signature: str, apply: Callable,
                     user_data: Any = None) -> None:
        self._functions[name.lower()] = (signature, apply, user_data)

    def function_signature(self, name: str) -> str:
        return self._functions[name.lower()][0]

    def function_exists(self, name: str) -> bool:
        return name.lower() in self._functions

    def invoke(self, name: str, *args, **named):
        """Call a registered function AviSynth-script-style (function
        names are case-insensitive in AviSynth, as are argument names)."""
        entry = self._functions.get(name.lower())
        if entry is None:
            raise AvisynthError(f"there is no function named {name!r}")
        signature, apply, user_data = entry
        return apply(bind_args(signature, args, named), user_data, self)

    def throw_error(self, msg: str, *fmt) -> None:
        raise AvisynthError(msg % fmt if fmt else msg)

    def get_cpu_flags(self) -> int:
        """The given flags, else `CPUF_CUDA` when ``device`` is a CUDA
        device."""
        if self._cpu_flags is not None:
            return self._cpu_flags
        return CPUF_CUDA if torch.device(self.device).type == "cuda" else 0
