"""Step-isolation arms: the roll chains of the step-shaped calibration arms,
one ingredient at a time.

    python -m sangnom_tpu_torch.tools.isolate_step [arm,arm,...]

Each arm is "kind" or "kind@k" (k iterations a step, default 1) on a
[G, W] int32 input, over ``STEPS`` sequential steps in one launch; step t
writes ``out[t] = b[:, :128] + a[0 or :G, :128]``.  The carried state is
``a, a2`` ([5, G, W] for the 3-D arms, [5G, W] for ``bigslab``, [G, W]
otherwise) and ``b, b2`` ([G, W]); every step stores all four back.

  bigslab   roll+add chain on the [5G, W] slab; its seed cannot be
            broadcast to 5G rows, so it raises ValueError (``bigslab_iota``
            seeds from iotas and runs)
  slab3d    the same on [5, G, W]; slab3d1 one roll of it
  bigshift  shifts by W-1, W-2, W-3 (left shifts) on [G, W]; smallshift 1..6
  unroll    stepv's body (slab3d + bigshift); fori the same as a loop
  hbox*     the box's rotate tree: tree, sub, wb (writeback), prod (_rot
            spelling), k (the kernel's form), full (the TPU kernel's whole
            7-tap box, edge columns included); roll2ch / roll2chz two
            chained rolls; ramtN one roll by N

A ``_iota`` suffix seeds ``a`` and ``a2`` from iotas instead of the input.
``run`` launches ``csrc/probes.cu::isolate_kernel`` on a CUDA tensor
(``probe_kernel.LAUNCHES["isolate"]``; one block a row of the input, all
slabs of that row, 8 elements of each line a thread, shifts through shared
memory) and ``run_plain`` on a CPU tensor.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from sangnom_tpu_torch.tools import probe_kernel

G, W = 120, 2048
STEPS = 8
MASK = 0x00FF00FF
HBOX_S = 1920  # the smoothed width hboxfull's box clamps at

KINDS = ("roll2chz", "hboxtree", "hboxsub", "hboxwb", "hboxfull", "roll2ch",
         "hboxprod", "hboxk", "bigslab", "slab3d", "slab3d1", "unroll", "fori",
         "bigshift", "smallshift")  # and "ramtN"
SLAB3D = ("slab3d", "slab3d1", "unroll", "fori", "hboxk", "hboxprod", "hboxtree",
          "hboxsub", "hboxwb", "roll2ch", "hboxfull", "roll2chz")
DEFAULT_ARMS = ("bigslab@1", "bigshift@1", "smallshift@1", "unroll@1",
                "unroll@4", "unroll@12", "fori@12")


def base_kind(kind: str) -> str:
    base = kind.removesuffix("_iota")
    if base not in KINDS and not (base.startswith("ramt") and base[4:].isdigit()):
        raise ValueError(f"unknown arm {kind!r}")
    return base


def slab_shape(kind: str) -> tuple[int, ...]:
    """Shape of the ``a``/``a2`` state."""
    base = base_kind(kind)
    if base == "bigslab":
        return (5 * G, W)
    if base in SLAB3D or base.startswith("ramt"):
        return (5, G, W)
    return (G, W)


# ---- the TPU kernel's 7-tap box (the form hboxfull runs) -----------------

def rot(a: torch.Tensor, k: int) -> torch.Tensor:
    """Circular rotate along the last axis: out[..., x] = a[..., (x + k) % S]."""
    return torch.roll(a, -k, dims=-1)


def hbox7_exact(line: torch.Tensor, S: int) -> torch.Tensor:
    """7-tap box sum, taps clamped at [0, S-1]."""
    idx = torch.arange(line.shape[-1], device=line.device)
    s = None
    for k in range(-3, 4):
        tap = line[..., torch.clamp(idx + k, 0, S - 1)]
        s = tap if s is None else s + tap
    return s


def hbox7(line: torch.Tensor, S: int) -> torch.Tensor:
    """The integer 7-tap box of the TPU kernel (3-roll cumulative-sub bulk,
    exact 128-column edge slabs merged at the 3 columns beside each edge):
    taps clamped at S for columns < S, circular over the padded width
    beyond it."""
    b = line + rot(line, 1)
    c = b + rot(b, 2)                # taps {0..3}
    bulk = c + rot(c, -3) - line     # {-3..0} + {0..3}, tap 0 removed
    left = hbox7_exact(line[..., :128], 128)
    right = hbox7_exact(line[..., S - 128:S], 128)
    return torch.cat([left[..., :3], bulk[..., 3:S - 3], right[..., -3:], bulk[..., S:]],
                     dim=-1)


# ---- plain version -------------------------------------------------------

def _roll(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.roll(x, s, dims=-1)


def _one(kind: str, a, a2, b, b2):
    S = a.shape[-1]
    w = b.shape[-1]
    if kind in ("roll2chz", "roll2ch"):
        hb = a + _roll(a, 1)
        return hb + _roll(hb, 2), a2, b, b2
    if kind.startswith("ramt"):
        return _roll(a, int(kind[4:])) + a2, a, b, b2
    if kind in ("hboxtree", "hboxsub", "hboxwb", "hboxprod"):
        hb = a + _roll(a, (-1) % S)
        hc = hb + _roll(hb, (-2) % S)
        s = hc + _roll(hc, 3)
        if kind in ("hboxsub", "hboxprod"):
            s = s - a
        if kind in ("hboxwb", "hboxprod"):
            s = (s >> 4) & MASK
        return s, a2, b, b2
    if kind == "hboxfull":
        return (hbox7(a, HBOX_S) >> 4) & MASK, a2, b, b2
    if kind == "hboxk":
        hb = a + _roll(a, 1)
        hc = hb + _roll(hb, 2)
        return ((hc + _roll(hc, 3) - a) >> 4) & MASK, a2, b, b2
    if kind in ("bigslab", "slab3d", "slab3d1", "unroll", "fori"):
        a, a2 = _roll(a, 1) + a2, a
        if kind != "slab3d1":
            a, a2 = _roll(a, 2) + a2, a
            a, a2 = _roll(a, 3) + a2, a
    if kind in ("bigshift", "unroll", "fori", "smallshift"):
        shifts = (1, 2, 3, 4, 5, 6) if kind == "smallshift" else (1, 2, 3, w - 1, w - 2, w - 3)
        acc = b2
        for s in shifts:
            acc = acc + _roll(b, s)
        b, b2 = acc, b
    return a, a2, b, b2


def check_seed(kind: str) -> None:
    """ValueError where the input seed cannot fill the slab (``bigslab``)."""
    shape = slab_shape(kind)
    if not kind.endswith("_iota") and shape[:-2] != (5,) and shape != (G, W):
        raise ValueError(f"Incompatible shapes for broadcasting: {(G, W)} and "
                         f"requested shape {shape}")


def init_state(src: torch.Tensor, kind: str):
    """The step-0 state (a, a2, b, b2) of an arm."""
    check_seed(kind)
    shape = slab_shape(kind)
    dev = src.device
    seed = src.to(torch.int32) & 0xFF
    if kind.endswith("_iota"):
        a = (torch.arange(shape[1], device=dev) % 251).to(torch.int32)
        a = a.reshape((1, -1) + (1,) * (len(shape) - 2)).expand(shape).contiguous()
        a2 = (torch.arange(shape[0], device=dev) % 241).to(torch.int32)
        a2 = a2.reshape((-1,) + (1,) * (len(shape) - 1)).expand(shape).contiguous()
    elif shape[:-2] == (5,):
        a = torch.stack([seed] * 5)
        a2 = a ^ 0x55
    else:
        a, a2 = seed.clone(), seed ^ 0x55
    return a, a2, seed.clone(), seed ^ 0x55AA55


def run_plain(src: torch.Tensor, kind: str, k: int, steps: int = STEPS) -> torch.Tensor:
    """Plain PyTorch version of one arm: [G, W] -> [steps, G, 128] int32."""
    base = base_kind(kind)
    a, a2, b, b2 = init_state(src, kind)
    out = torch.empty((steps, G, 128), dtype=torch.int32, device=src.device)
    for t in range(steps):
        for _ in range(k):
            a, a2, b, b2 = _one(base, a, a2, b, b2)
        atail = a[0, :, :128] if a.dim() == 3 else a[:G, :128]
        out[t] = b[:, :128] + atail
    return out


# ---- entry points ---------------------------------------------------------

def run(src, kind: str, k: int, steps: int = STEPS, device: str = "cuda") -> torch.Tensor:
    """One arm on ``device``: the kernel on the card, the plain version on
    the CPU.  ``src`` [G, W] integers (numpy or tensor)."""
    src = torch.as_tensor(src).to(device=device, dtype=torch.int32)
    if tuple(src.shape) != (G, W):
        raise ValueError(f"isolate_step: input {tuple(src.shape)}, expected {(G, W)}")
    if src.device.type == "cpu":
        return run_plain(src, kind, k, steps)
    check_seed(kind)
    return probe_kernel.isolate(src.contiguous(), kind, k, steps)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    arms = argv[0].split(",") if argv else list(DEFAULT_ARMS)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    src = np.random.default_rng(0).integers(0, 255, (G, W))
    for arm in arms:
        kind, _, kspec = arm.partition("@")
        k = int(kspec) if kspec else 1
        t0 = time.perf_counter()
        try:
            out = run(src, kind, k)
        except ValueError as e:
            print(f"  {arm:14s}: FAIL after {time.perf_counter() - t0:.3f}s "
                  f"(ValueError: {str(e).splitlines()[0][:140]})", flush=True)
            continue
        s = float(out[:, :, :1].double().sum())
        print(f"  {arm:14s}: OK (build+run {time.perf_counter() - t0:.3f}s, "
              f"checksum {s:.0f})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
