"""Scratch-buffer geometry and threshold precompute.

The reference constructor's derived quantities are observable in the output
(reference src/SangNom2.cpp:275-310):

- The 9 directional-error buffers have a stride rounded up to 32 pixels
  (reference src/SangNom2.cpp:16, 287).  The horizontal 7-tap smoothing runs
  over, and clamps its taps at, that padded stride, so the padding columns
  are observable in the last <=3 output columns.  Padding columns and buffer
  rows 0 and H/2 are defined as ZERO here (the reference leaves them
  uninitialized).
- Buffer geometry comes from the LUMA plane and is reused for chroma
  (reference src/SangNom2.cpp:287-288).
- The `aa`/`aac` thresholds are scaled by 21/16 and by bit depth (reference
  src/SangNom2.cpp:280-282), then truncated to the pixel type (reference
  src/SangNom2.cpp:272 passes float ``aaf`` as ``const T``).
"""

from __future__ import annotations

import numpy as np

from sangnom_tpu_torch.core.formats import VideoFormat

# Scratch alignment in bytes (reference src/SangNom2.cpp:16).
ALIGNMENT_BYTES = 32


def buffer_stride_elems(luma_width: int, component_size: int) -> int:
    """Error-buffer stride in elements: ceil32(width) for every component
    size (reference src/SangNom2.cpp:287 rounds pixels, then scales)."""
    del component_size
    return -(-luma_width // 32) * 32


def buffer_height(output_height: int) -> int:
    """Number of kept-field lines, ``(height + 1) >> 1`` after any `dh`
    doubling (reference src/SangNom2.cpp:284-288)."""
    return (output_height + 1) >> 1


def scaled_aa_thresholds(aa: int, aac: int, fmt: VideoFormat) -> list[float]:
    """Per-plane anti-aliasing thresholds, computed in np.float32 as the
    reference does in single precision (reference src/SangNom2.cpp:280-282),
    so truncation edge cases match bit for bit."""
    aa_per_plane = [aa, aac, aac]
    out: list[float] = []
    for i in range(min(fmt.num_planes, 3)):
        v = np.float32(aa_per_plane[i]) * np.float32(21.0) / np.float32(16.0)
        if fmt.component_size < 4:
            v = v * np.float32(1 << (fmt.bits - 8))
        else:
            v = v / np.float32(256.0)
        out.append(float(v))
    return out


def aaf_as_pixel(aaf: float, fmt: VideoFormat):
    """The threshold as the kernel sees it: truncated toward zero for integer
    pixel types (reference src/SangNom2.cpp:272)."""
    if fmt.is_float:
        return np.float32(aaf)
    return int(aaf)


def round_up(x: int, m: int) -> int:
    """x rounded up to a multiple of m."""
    return -(-x // m) * m


def decay_hops(mask: int) -> int:
    """Rows until a zero-raw padding column provably decays to exactly 0.

    In the zero-defined padding (columns >= w) a column's smoothing recursion
    is ``sm[b][c] = hbox7(sm[b-1])[c] / 16``.  With m_k bounding every value
    at columns >= w + 3k, m_k = floor(7 * m_(k-1) / 16) from m_0 = the
    storage-type max, which reaches 0 after 7 hops for u8 and 14 for u16.
    """
    m, k = mask, 0
    while m:
        m = (7 * m) >> 4
        k += 1
    return k


def creep_bound(w: int, bufH: int, spec=None) -> int:
    """Rightmost column (exclusive) the smoothing recursion can observably
    reach: w + 3 columns per row of creep (+3 box taps), tightened for
    integer formats by the decay bound (+6: the last computed columns clamp
    onto a provably-zero column).  ``spec`` needs ``.is_float`` and
    ``.mask`` (an ops.primitives.KernelSpec in practice)."""
    creep = w + 3 * bufH + 3
    if spec is not None and not spec.is_float:
        creep = min(creep, w + 3 * decay_hops(spec.mask) + 6)
    return creep


def width_tiers(w: int, bufH: int, S: int, spec=None) -> tuple[int, int, int]:
    """(W_act, W_sm, S_clamp): the active width, the smoothing width and the
    column the box taps clamp at, each capped at the padded stride.

    The widths are rounded to 128 columns; the smoothing clamp ``S_clamp``
    is either the stride S or a column at or past `creep_bound`, so clamping
    there instead of at S changes no output column.  The CUDA kernel
    smooths exactly ``S_clamp`` columns.
    """
    S_pad = max(round_up(S, 128), 128)
    W_act = min(S_pad, max(round_up(w + 3, 128), 128))
    W_sm = min(S_pad, max(round_up(creep_bound(w, bufH, spec), 128), W_act))
    return W_act, W_sm, min(S, W_sm)
