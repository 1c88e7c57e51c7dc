"""The benchmark's plain reference of SangNom2 (Asd-g/AviSynth-SangNom2
v0.6.1, its C path), for integer formats.

A frozen, self-contained copy of the port's plain field path and plain
pool pass, written on whole torch tensors so it runs on the card or the
CPU.  It imports nothing of the program and recomputes everything the
program derives (strides, thresholds, the field split, the pool).

Per plane pass (reference src/SangNom2.cpp:74-273):
  1. prepare: 9 directional error maps between adjacent kept lines;
  2. smooth: the 3x7 box filter, IN PLACE, so each row's vertical 3-sum
     reads the already-smoothed row above: a scan over rows;
  3. finalize: 9-way min and the fixed-priority select (the C if-chain's
     order breaks ties).
Planes are [N, h, w] int32 tensors of unsigned samples (`reference.run`
converts the storage dtype in and out); int32 holds every intermediate of
the C path exactly.  The C path wraps to its pixel type, uint8_t at 8 bits
and uint16_t at 9-16 bits whatever the depth (src/SangNom2.cpp:316-327), so
the wrap mask is the storage width's (`storage_mask`), never the depth's.
"""

from __future__ import annotations

import numpy as np
import torch

MAPS = 9
# Fields interpolated together on the plain path; bounds the scratch maps
# to about 9 x 4 bytes x (kept rows x width x BLOCK) at a time.
BLOCK = 16


def stride_of(luma_width: int) -> int:
    """The error buffers' stride: the luma width rounded up to 32
    (src/SangNom2.cpp:16, 287); chroma reuses it."""
    return -(-luma_width // 32) * 32


def thresholds(aa: int, aac: int, bits: int) -> list[int]:
    """Per-plane thresholds: aa * 21 / 16 scaled by bit depth in float32,
    truncated to the pixel type (src/SangNom2.cpp:272, 280-282)."""
    out = []
    for a in (aa, aac, aac):
        v = np.float32(a) * np.float32(21.0) / np.float32(16.0)
        v = v * np.float32(1 << (bits - 8))
        out.append(int(v))
    return out


def storage_mask(bits: int) -> int:
    """The pixel type's mask: 0xFF for 8-bit samples, 0xFFFF for 9-16 bits
    (stored as uint16)."""
    return 0xFF if bits == 8 else 0xFFFF


def decay_rows(mask: int) -> int:
    """Rows after which a zero padding column's smoothed value is exactly 0
    (each row it is at most 7/16 of the row above)."""
    m, k = mask, 0
    while m:
        m = (7 * m) >> 4
        k += 1
    return k


def _shifts(a: torch.Tensor) -> list[torch.Tensor]:
    """a shifted by -3..+3 along the last axis, edge-clamped (loadPixel,
    src/SangNom2.cpp:25-34)."""
    w = a.shape[-1]
    pad = torch.cat([a[..., :1].expand(*a.shape[:-1], 3), a,
                     a[..., -1:].expand(*a.shape[:-1], 3)], dim=-1)
    return [pad[..., k:k + w] for k in range(7)]


def _predict(p1, p2, p3, mask):
    """(4*p1 + 5*p2 - p3) >> 3, wrapped to the pixel type
    (calculateSangNom, src/SangNom2.cpp:60-72)."""
    return ((p1 * 4 + p2 * 5 - p3) >> 3) & mask


def _avg(a, b, mask):
    """Rounded average (src/SangNom2.cpp:48-58)."""
    return ((a + b + 1) >> 1) & mask


def _pair(curr, nxt, mask):
    """Taps and the four predictors of kept-line pairs (src/SangNom2.cpp:
    87-106)."""
    c = _shifts(curr)
    n = _shifts(nxt)
    preds = (_predict(c[2], c[3], c[4], mask), _predict(n[4], n[3], n[2], mask),
             _predict(c[4], c[3], c[2], mask), _predict(n[2], n[3], n[4], mask))
    return c, n, preds


def _maps(c, n, preds) -> list[torch.Tensor]:
    """The 9 raw error maps in the reference's buffer order (enum Buffers,
    src/SangNom2.h:8-20; stores at src/SangNom2.cpp:103-117)."""
    fwd1, fwd2, bwd1, bwd2 = preds
    return [(c[0] - n[6]).abs(), (c[1] - n[5]).abs(), (c[2] - n[4]).abs(),
            (fwd1 - fwd2).abs(), (c[3] - n[3]).abs(), (bwd1 - bwd2).abs(),
            (c[4] - n[2]).abs(), (c[5] - n[1]).abs(), (c[6] - n[0]).abs()]


def _finalize(c, n, preds, bufs, aaf: int, mask):
    """The select (src/SangNom2.cpp:212-249), as masked overwrites from the
    lowest priority up: the last write wins."""
    fwd1, fwd2, bwd1, bwd2 = preds
    mn = bufs[0]
    for k in range(1, MAPS):
        mn = torch.minimum(mn, bufs[k])
    res = _avg(c[0], n[6], mask)
    for idx, val in ((8, _avg(c[6], n[0], mask)), (1, _avg(c[1], n[5], mask)),
                     (7, _avg(c[5], n[1], mask)), (2, _avg(c[2], n[4], mask)),
                     (6, _avg(c[4], n[2], mask)), (3, _avg(fwd1, fwd2, mask)),
                     (5, _avg(bwd1, bwd2, mask))):
        res = torch.where(bufs[idx] == mn, val, res)
    return torch.where((bufs[4] == mn) | (mn > aaf), _avg(c[3], n[3], mask), res)


def smooth(raw: torch.Tensor, mask: int, init: torch.Tensor | None = None) -> torch.Tensor:
    """The in-place 3x7 smoothing (src/SangNom2.cpp:126-152) over buffer
    rows 1..H-1 of ``raw`` [H+1, ..., S], seeded by the smoothed "row 0"
    ``init`` (zero when None); the box taps clamp at column S-1.  Returns
    the smoothed rows [H-1, ..., S]."""
    H = raw.shape[0] - 1
    vert = raw[1:H] + raw[2:H + 1]  # each row's two raw rows, summed once
    out = torch.empty_like(vert)
    sm = torch.zeros_like(raw[0]) if init is None else init
    for b in range(H - 1):
        t = _shifts(sm + vert[b])
        s = t[0]
        for k in range(1, 7):
            s = s + t[k]
        sm = (s >> 4) & mask
        out[b] = sm
    return out


def interpolate(kept: torch.Tensor, aaf: int, mask: int, stride: int) -> torch.Tensor:
    """[N, bufH, w] kept fields -> [N, bufH-1, w] interpolated lines, with
    zero buffer rows 0 and bufH and zero columns past w.  Only the columns
    that can reach an output are smoothed: a zero column decays to 0 within
    `decay_rows` rows, 3 columns a row, so the clamp at w + 3 * rows + 6
    reads zeros exactly as the clamp at the stride would."""
    N, bufH, w = kept.shape
    S = min(stride, w + 3 * decay_rows(mask) + 6)
    out = []
    for s in range(0, N, BLOCK):
        k = kept[s:s + BLOCK]
        c, n, preds = _pair(k[:, :-1], k[:, 1:], mask)
        raw = k.new_zeros((bufH + 1, MAPS, k.shape[0], S))
        raw[1:bufH, :, :, :w] = torch.stack(_maps(c, n, preds)).permute(2, 0, 1, 3)
        bufs = smooth(raw, mask)[..., :w].permute(1, 2, 0, 3)
        del raw
        out.append(_finalize(c, n, preds, bufs, aaf, mask))
    return torch.cat(out)


def _weave(kept: torch.Tensor, interp: torch.Tensor, offset: int) -> torch.Tensor:
    """Kept and interpolated rows of one offset woven, the boundary missing
    line duplicated (src/SangNom2.cpp:376-391)."""
    N, bufH, w = kept.shape
    out = kept.new_empty((N, 2 * bufH, w))
    if offset == 0:
        out[:, 0::2] = kept
        out[:, 1:-1:2] = interp
        out[:, -1] = kept[:, -1]
    else:
        out[:, 1::2] = kept
        out[:, 2::2] = interp
        out[:, 0] = kept[:, 0]
    return out


def sangnom2(planes, bits: int, offsets: list[int], aa: int, aac: int) -> list[torch.Tensor]:
    """SangNom2 with luma and chroma on and dh off, frame n keeping the
    field at ``offsets[n]`` (0 top, 1 bottom: order=1 keeps 0, order=2 1,
    order=0 the frame's parity, src/SangNom2.cpp:336-341).  ``planes``:
    [N, h, w] tensors, luma first."""
    mask = storage_mask(bits)
    stride = stride_of(planes[0].shape[2])
    aafs = thresholds(aa, aac, bits)
    out = []
    for i, p in enumerate(planes):
        res = torch.empty_like(p)
        for off in (0, 1):
            idx = [n for n, o in enumerate(offsets) if o == off]
            if not idx:
                continue
            sel = torch.tensor(idx, device=p.device)
            kept = p[sel][:, off::2]
            res[sel] = _weave(kept, interpolate(kept, aafs[i], mask, stride), off)
        out.append(res)
    return out


def separate_double_weave(planes, tff: bool) -> tuple[list[torch.Tensor], list[bool]]:
    """SeparateFields then DoubleWeave (AviSynth semantics): field 2n and
    2n+1 are frame n's fields in dominance order; woven frame m pairs fields
    m and m+1 (the last with itself), with field m at its own parity.
    Returns the woven planes and their per-frame parity (True: top)."""
    woven = []
    for p in planes:
        n, h, w = p.shape
        top, bot = p[:, 0::2], p[:, 1::2]
        first, second = (top, bot) if tff else (bot, top)
        fields = torch.stack([first, second], dim=1).reshape(2 * n, h // 2, w)
        nxt = torch.cat([fields[1:], fields[-1:]])
        f = torch.empty((2 * n, h, w), dtype=p.dtype, device=p.device)
        for m in range(2 * n):
            is_top = (m % 2 == 0) == tff
            a, b = (fields[m], nxt[m]) if is_top else (nxt[m], fields[m])
            f[m, 0::2], f[m, 1::2] = a, b
        woven.append(f)
    parity = [(m % 2 == 0) == tff for m in range(2 * planes[0].shape[0])]
    return woven, parity


def bob(planes, bits: int, tff: bool, aa: int, aac: int):
    """The bob recipe, SeparateFields -> DoubleWeave -> SangNom2(order=0)
    (src/SangNom2.cpp:18-23).  Returns (planes, parity)."""
    woven, parity = separate_double_weave(planes, tff)
    return sangnom2(woven, bits, [0 if t else 1 for t in parity], aa, aac), parity


# --- the shared buffer pool (pool_compat) ----------------------------------

def pool_pass(kept: torch.Tensor, pool: torch.Tensor, aaf: int, mask: int) -> torch.Tensor:
    """One plane pass on the reference's one shared pool [9, P+1, S],
    in place: prepare rows 1..bufH-1 and columns 0..w-1 only, smooth ALL of
    rows 1..P-1 over the full stride seeded by row 0 (the other rows and
    columns keep what earlier passes left), finalize from the prepared rows
    (src/SangNom2.cpp:268-272).  Returns [bufH-1, w] interpolated rows."""
    bufH, w = kept.shape
    P = pool.shape[1] - 1
    c, n, preds = _pair(kept[:-1], kept[1:], mask)
    pool[:, 1:bufH, :w] = torch.stack(_maps(c, n, preds))
    rows = pool.transpose(0, 1)  # [P+1, 9, S]
    pool[:, 1:P] = smooth(rows, mask, init=rows[0].clone()).transpose(0, 1)
    return _finalize(c, n, preds, pool[:, 1:bufH, :w], aaf, mask)


def sangnom2_pool(planes, bits: int, offsets: list[int], aa: int, aac: int) -> list[torch.Tensor]:
    """SangNom2 through one fresh shared pool, sized by luma (P = h/2 kept
    rows, stride ceil32(w)): frames in order, planes Y -> U -> V
    (src/SangNom2.cpp:287-288, 303-310)."""
    mask = storage_mask(bits)
    N, h, w = planes[0].shape
    pool = torch.zeros((MAPS, h // 2 + 1, stride_of(w)), dtype=torch.int32,
                       device=planes[0].device)
    aafs = thresholds(aa, aac, bits)
    out = [torch.empty_like(p) for p in planes]
    for f in range(N):
        off = offsets[f]
        for i, p in enumerate(planes):
            kept = p[f, off::2]
            interp = pool_pass(kept, pool, aafs[i], mask)
            out[i][f] = _weave(kept[None], interp[None], off)[0]
    return out


def bob_pool(planes, bits: int, tff: bool, aa: int, aac: int):
    """The bob recipe with the shared pool (``pool_compat=True``).
    Returns (planes, parity)."""
    woven, parity = separate_double_weave(planes, tff)
    return sangnom2_pool(woven, bits, [0 if t else 1 for t in parity], aa, aac), parity
