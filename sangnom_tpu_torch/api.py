"""Public filter API: the analogue of the AviSynth registration surface.

Replicates the two script functions the reference registers (reference
src/SangNom2.cpp:474-484):

    SangNom2(clip, order, aa, aac, threads, dh, luma, chroma, opt)
    SangNom(clip, order, aa, opt)            # legacy

with the factories' parameter defaults and validation rules, including the
exact error strings (reference Create_SangNom2, src/SangNom2.cpp:399-435 and
Create_SangNom, src/SangNom2.cpp:437-472):
  * the opt error string says "-1..2" while the accepted range is -1..1
    (src/SangNom2.cpp:419-420), replicated verbatim;
  * the legacy SangNom surface is the documented one: order remapped
    {0 -> 2, 1 -> 1, 2 -> 0}, aac fixed to 0 (README.md:70-74);
  * `threads` is accepted and ignored, as in the reference.

``opt=1`` (the CUDA kernel) requires the clip's planes on a CUDA device, the
analogue of the reference's "opt=1 requires SSE2." gate.
"""

from __future__ import annotations

from sangnom_tpu_torch.core.clip import Clip
from sangnom_tpu_torch.ops.sangnom import sangnom2_op
from sangnom_tpu_torch.utils.profiling import CALL, span


class SangNomError(ValueError):
    """Parameter/format validation failure (the analogue of
    env->ThrowError in the reference factories)."""


def _validate(name: str, clip: Clip | None, order: int, aa: int, aac: int,
              opt: int, opt1_ok: bool | None = None) -> None:
    """The reference factories' validation rules and exact error strings
    (src/SangNom2.cpp:407-422 / 446-459).  ``clip=None`` skips the
    clip-dependent checks (SangNom2Filter binds clips late).  ``opt1_ok``
    decides the opt=1 gate when it is a bool (the AviSynth-model host passes
    its environment's CPU-flags analogue, as the reference factory consults
    env->GetCPUFlags, src/SangNom2.cpp:422); ``None`` lets the clip's device
    decide, and without a clip skips the gate."""
    if clip is not None:
        _validate_geometry(name, clip.format, clip.height)
    if order < 0 or order > 2:
        raise SangNomError(f"{name}: order must be between 0..2.")
    if aa < 0 or aa > 128:
        raise SangNomError(f"{name}: aa must be between 0..128.")
    if aac < 0 or aac > 128:
        raise SangNomError(f"{name}: aac must be between 0..128.")
    if opt < -1 or opt > 1:
        # verbatim, including the reference's off-by-one upper bound
        raise SangNomError(f"{name}: opt must be between -1..2.")
    if opt1_ok is None:
        opt1_ok = clip is None or clip.device.type == "cuda"
    if opt == 1 and not opt1_ok:
        raise SangNomError(f"{name}: opt=1 requires a CUDA backend.")


def _validate_geometry(name: str, fmt, height: int) -> None:
    """The clip-geometry half of the factory validation."""
    if fmt.is_rgb or not fmt.planar:
        raise SangNomError(f"{name}: clip must be in Y/YUV planar format.")
    if height % 2 != 0:
        raise SangNomError(f"{name}: height must be even.")
    if fmt.is_420 and height % 4:
        raise SangNomError(f"{name}: height must be mod4.")


def _validate_numerics(name: str, numerics: str) -> None:
    """The numerics-contract check (an extension with no reference
    analogue)."""
    if numerics not in ("c", "sse2"):
        raise SangNomError(
            f"{name}: numerics must be 'c' or 'sse2', got {numerics!r}."
        )


def sangnom2(
    clip: Clip,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    threads: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    pool_compat: bool = False,
    numerics: str = "c",
) -> Clip:
    """SangNom2: edge-directed single-field deinterlacer / anti-aliaser.

    Defaults match the reference factory (src/SangNom2.cpp:402-405,
    424-434): order=1 (keep top field), aa=48, aac=0, threads=0 (ignored),
    dh=False, luma=True, chroma=True, opt=-1 (auto: the CUDA kernel for a
    clip on a CUDA device, the plain PyTorch path otherwise).

    ``numerics``: "c" (the reference's C-path contract, the parity target)
    or "sse2" (its SSE2 path, which diverges at integer extremes).
    ``pool_compat=True`` reproduces the reference's shared buffer pool
    bit for bit (ops/pool_carry.py), at the cost of processing frames in
    order; composable with ``numerics``.
    """
    del threads
    with span(CALL) as sp:
        if sp:
            sp.set(entry="sangnom2", path="pool" if pool_compat else "main",
                   frames_in=clip.num_frames)
        _validate("SangNom2", clip, order, aa, aac, opt)
        _validate_numerics("SangNom2", numerics)
        out = sangnom2_op(
            clip, order=order, aa=aa, aac=aac, dh=dh, luma=luma, chroma=chroma,
            opt=opt, pool_compat=pool_compat, numerics=numerics,
        )
        if sp:
            sp.set(frames_out=out.num_frames)
    return out


# Legacy order remap: 0=keep-bottom, 1=keep-top, 2=double-rate
# (reference README.md:70-74; ord[3] = {2, 1, 0}, src/SangNom2.cpp:441, 463).
_LEGACY_ORDER_REMAP = (2, 1, 0)


def sangnom(clip: Clip, order: int = 1, aa: int = 48, opt: int = -1,
            pool_compat: bool = False, numerics: str = "c") -> Clip:
    """Legacy SangNom wrapper (the documented surface)."""
    with span(CALL) as sp:
        if sp:
            sp.set(entry="sangnom", path="pool" if pool_compat else "main",
                   frames_in=clip.num_frames)
        _validate("SangNom", clip, order, aa, 0, opt)
        _validate_numerics("SangNom", numerics)
        new_order = _LEGACY_ORDER_REMAP[order] if order != 1 else 1
        out = sangnom2_op(clip, order=new_order, aa=aa, aac=0, opt=opt,
                          pool_compat=pool_compat, numerics=numerics)
        if sp:
            sp.set(frames_out=out.num_frames)
    return out


class SangNom2Filter:
    """A pre-configured, reusable filter instance: the analogue of the
    reference's filter object (the ctor validates, GetFrame processes;
    reference src/SangNom2.cpp:275-330, 332-397).

    Clip-independent parameters are validated at construction, as the
    reference factory does; format, geometry and the opt=1 device gate are
    checked per call.  Instances hold no state between calls.
    """

    MT_CONTRACT = "stateless (one instance may serve any thread or device)"

    def __init__(self, order: int = 1, aa: int = 48, aac: int = 0,
                 threads: int = 0, dh: bool = False, luma: bool = True,
                 chroma: bool = True, opt: int = -1,
                 pool_compat: bool = False, numerics: str = "c"):
        _validate("SangNom2", None, order, aa, aac, opt)
        _validate_numerics("SangNom2", numerics)
        del threads
        self.order, self.aa, self.aac = order, aa, aac
        self.dh, self.luma, self.chroma, self.opt = dh, luma, chroma, opt
        self.pool_compat, self.numerics = pool_compat, numerics

    def __call__(self, clip: Clip) -> Clip:
        return sangnom2(
            clip, order=self.order, aa=self.aa, aac=self.aac, dh=self.dh,
            luma=self.luma, chroma=self.chroma, opt=self.opt,
            pool_compat=self.pool_compat, numerics=self.numerics,
        )

    def __repr__(self) -> str:
        return (
            f"SangNom2Filter(order={self.order}, aa={self.aa}, "
            f"aac={self.aac}, dh={self.dh}, luma={self.luma}, "
            f"chroma={self.chroma}, opt={self.opt}, "
            f"pool_compat={self.pool_compat}, numerics={self.numerics!r})"
        )


def register_plugin_functions(registry: dict) -> str:
    """Register the filter functions into a host registry (the analogue of
    AvisynthPluginInit3's AddFunction calls, reference src/SangNom2.cpp:
    476-484).  Returns the plugin identifier string."""
    registry["SangNom2"] = sangnom2
    registry["SangNom"] = sangnom
    return "SangNom2"
