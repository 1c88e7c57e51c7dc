"""Elementwise math primitives shared by the plain path and its tests.

Each helper replicates one scalar primitive of the reference's C path
(reference src/SangNom2.cpp:25-72) as a whole-tensor op:

  - `neighborhood`    <-> loadPixel edge-clamped gather (src/SangNom2.cpp:25-34)
  - `calc_sangnom`    <-> calculateSangNom (4a+5b-c)>>3 with wrap (60-72)
  - `avg_pair`        <-> avg round-half-up / float half (48-58)

Integer work is carried in int32 (torch's uint16 has almost no arithmetic,
so storage tensors are widened first); the C path's narrower accumulators
never overflow, so int32 reproduces them exactly.  Wrap to the pixel type is
an ``& mask``.  Float work is float32, one operation at a time, in the
reference's order.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from sangnom_tpu_torch.core.formats import VideoFormat


class Buffers(enum.IntEnum):
    """The nine directional error maps, valued by spatial priority index
    (reference enum Buffers, src/SangNom2.h:8-20)."""

    ADIFF_M3_P3 = 0  # |curr[x-3] - next[x+3]|
    ADIFF_M2_P2 = 1
    ADIFF_M1_P1 = 2
    SG_FORWARD = 3   # forward predictor disagreement
    ADIFF_P0_M0 = 4  # vertical
    SG_REVERSE = 5   # reverse predictor disagreement
    ADIFF_P1_M1 = 6
    ADIFF_P2_M2 = 7
    ADIFF_P3_M3 = 8


TOTAL_BUFFERS = len(Buffers)

# Finalize checks in this order and the FIRST hit wins (reference
# src/SangNom2.cpp:212-249); ADIFF_P0_M0 is special-cased first together
# with the aa threshold.
SELECT_PRIORITY = (
    Buffers.SG_REVERSE,
    Buffers.SG_FORWARD,
    Buffers.ADIFF_P1_M1,
    Buffers.ADIFF_M1_P1,
    Buffers.ADIFF_P2_M2,
    Buffers.ADIFF_M2_P2,
    Buffers.ADIFF_P3_M3,
    Buffers.ADIFF_M3_P3,
)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static per-dtype configuration (the reference's <T, IType> template
    instantiations, src/SangNom2.cpp:316-327).

    ``sse2`` selects the reference's second numerics contract: its predictor
    shifts logically and saturates (src/SangNom2_SSE2.cpp:478-481, 513-517)
    and its smoothing writeback saturates (749-761, 807-811), where C shifts
    arithmetically and wraps.  It is a no-op for float formats."""

    is_float: bool
    mask: int  # wrap mask for the storage type; unused for float
    sse2: bool = False

    @property
    def acc_dtype(self) -> torch.dtype:
        """int32 for integer formats, float32 for float."""
        return torch.float32 if self.is_float else torch.int32

    @classmethod
    def from_format(cls, fmt: VideoFormat, sse2: bool = False) -> "KernelSpec":
        if fmt.is_float:
            return cls(is_float=True, mask=0, sse2=sse2)
        return cls(
            is_float=False, mask=(1 << (8 * fmt.component_size)) - 1,
            sse2=sse2,
        )


def neighborhood(a: torch.Tensor, radius: int = 3) -> list[torch.Tensor]:
    """[a shifted by -radius .. +radius] along the last axis, edge-clamped."""
    w = a.shape[-1]
    idx = torch.arange(w, device=a.device)
    return [a[..., (idx + k).clamp(0, w - 1)] for k in range(-radius, radius + 1)]


def calc_sangnom(p1, p2, p3, spec: KernelSpec):
    """3-tap predictor (4*p1 + 5*p2 - p3)/8.

    C numerics: arithmetic >>3, wrap to the pixel type (reference
    src/SangNom2.cpp:60-72).  SSE2 numerics: logical >>3 within the SIMD
    lane (i16 for 8-bit, i32 for 16-bit), then saturate to the pixel type
    (reference src/SangNom2_SSE2.cpp:451-518)."""
    if spec.is_float:
        return (p1 * 4 + p2 * 5 - p3) * 0.125
    s = p1 * 4 + p2 * 5 - p3
    if not spec.sse2:
        return (s >> 3) & spec.mask
    if spec.mask == 0xFF:
        return torch.clamp_max((s & 0xFFFF) >> 3, 255)
    return torch.clamp_max((s >> 3) & 0x1FFFFFFF, 65535)


def smooth_writeback(h, spec: KernelSpec):
    """Writeback of the non-negative 21-tap box sum: C numerics /16 then wrap
    (reference src/SangNom2.cpp:152); SSE2 >>4 then saturate (reference
    src/SangNom2_SSE2.cpp:749-765, 798-811); float *1/16."""
    if spec.is_float:
        return h * (1.0 / 16.0)
    if spec.sse2:
        return torch.clamp_max(h >> 4, spec.mask)
    return (h >> 4) & spec.mask


def avg_pair(a, b, spec: KernelSpec):
    """Directional average: integer round-half-up, float exact half
    (reference src/SangNom2.cpp:48-58)."""
    if spec.is_float:
        return (a + b) * 0.5
    return ((a + b + 1) >> 1) & spec.mask


def abs_diff(a, b):
    """|a - b| in the accumulator domain (reference src/SangNom2.cpp:36-46)."""
    return (a - b).abs()
