"""Video format registry.

The reference plugin accepts any planar Y/YUV(A) format with 8/10/12/14/16-bit
integer or 32-bit float samples and rejects RGB / packed formats (reference
src/SangNom2.cpp:407-408).  This is a static registry of planar formats with
the per-plane geometry rules (`ComponentSize`, `BitsPerComponent`, `Is420`,
`NumComponents`) the filter's validation and precompute depend on (reference
src/SangNom2.cpp:281-288, 314, 407-412).  Each format names its storage type
twice: as a torch dtype (``dtype``, the planes of a `Clip`) and as a numpy
dtype (``np_dtype``, host arrays and the native oracle).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class VideoFormat:
    """A planar video format.

    - ``bits`` / ``component_size``: sample precision and storage width
      (reference src/SangNom2.cpp:281-282, 314-318 dispatch on ComponentSize).
    - ``subsampling_w/h``: chroma plane geometry (log2 factors).
    - ``num_planes``: 1 (GRAY), 3 (YUV), 4 (YUVA); the filter touches at most
      3 planes (reference src/SangNom2.cpp:347 ``min(NumComponents, 3)``).
    """

    name: str
    family: str  # "GRAY" | "YUV" | "YUVA" | "RGB"
    bits: int  # nominal sample bits: 8, 10, 12, 14, 16, or 32 (float)
    is_float: bool
    subsampling_w: int  # log2 horizontal chroma subsampling
    subsampling_h: int  # log2 vertical chroma subsampling
    num_planes: int
    planar: bool = True

    @property
    def component_size(self) -> int:
        """Bytes per sample: 1, 2 or 4 (reference VideoInfo::ComponentSize)."""
        if self.is_float:
            return 4
        return 1 if self.bits == 8 else 2

    @property
    def np_dtype(self) -> np.dtype:
        """Storage dtype of host (numpy) plane arrays."""
        if self.is_float:
            return np.dtype(np.float32)
        return np.dtype(np.uint8) if self.bits == 8 else np.dtype(np.uint16)

    @property
    def dtype(self) -> torch.dtype:
        """Storage dtype of plane tensors."""
        if self.is_float:
            return torch.float32
        return torch.uint8 if self.bits == 8 else torch.uint16

    @property
    def is_yuv(self) -> bool:
        return self.family in ("YUV", "YUVA")

    @property
    def is_rgb(self) -> bool:
        return self.family == "RGB"

    @property
    def is_420(self) -> bool:
        """True for 4:2:0 (both chroma axes halved): gates the mod-4 height
        rule (reference src/SangNom2.cpp:411-412)."""
        return self.is_yuv and self.subsampling_w == 1 and self.subsampling_h == 1

    def plane_dims(self, width: int, height: int, plane: int) -> tuple[int, int]:
        """(width, height) of plane ``plane`` given luma dimensions."""
        if plane == 0 or plane >= 3 or self.family == "GRAY":
            return width, height
        return width >> self.subsampling_w, height >> self.subsampling_h

    def has_alpha(self) -> bool:
        return self.family == "YUVA"


def _make_registry() -> dict[str, VideoFormat]:
    fmts: list[VideoFormat] = []
    for bits in (8, 10, 12, 14, 16):
        fmts.append(VideoFormat(f"GRAY{bits}", "GRAY", bits, False, 0, 0, 1))
    fmts.append(VideoFormat("GRAYS", "GRAY", 32, True, 0, 0, 1))
    # 4:1:1 is included: the reference accepts ANY planar Y/YUV format, and
    # the mod-4 height rule gates on Is420 only (reference
    # src/SangNom2.cpp:407-412).
    subsamp = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "411": (2, 0)}
    for tag, (sw, sh) in subsamp.items():
        for bits in (8, 10, 12, 14, 16):
            fmts.append(VideoFormat(f"YUV{tag}P{bits}", "YUV", bits, False, sw, sh, 3))
            fmts.append(
                VideoFormat(f"YUVA{tag}P{bits}", "YUVA", bits, False, sw, sh, 4)
            )
        fmts.append(VideoFormat(f"YUV{tag}PS", "YUV", 32, True, sw, sh, 3))
        fmts.append(VideoFormat(f"YUVA{tag}PS", "YUVA", 32, True, sw, sh, 4))
    # AviSynth's legacy name for 8-bit 4:1:1
    fmts.append(VideoFormat("YV411", "YUV", 8, False, 2, 0, 3))
    # RGB and one packed format exist only so the API can reject them with
    # the reference's exact error (reference src/SangNom2.cpp:407-408).
    for bits in (8, 10, 12, 14, 16):
        fmts.append(VideoFormat(f"RGBP{bits}", "RGB", bits, False, 0, 0, 3))
    fmts.append(VideoFormat("RGBPS", "RGB", 32, True, 0, 0, 3))
    fmts.append(VideoFormat("YUY2", "YUV", 8, False, 1, 0, 1, planar=False))
    return {f.name: f for f in fmts}


FORMATS: dict[str, VideoFormat] = _make_registry()


def get_format(name: str) -> VideoFormat:
    """Look up a format by name (case-insensitive)."""
    key = name.upper()
    if key not in FORMATS:
        raise KeyError(f"unknown video format: {name!r}")
    return FORMATS[key]
