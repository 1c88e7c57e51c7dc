"""Op-class rate calibration for the cost model, on the card.

    python -m sangnom_tpu_torch.tools.calibrate_vpu [reps] [arm1,arm2,...]

Measures the rate the card achieves for each integer op class the field
kernel (``csrc/deint.cu``) is built from: add, multiply, min, compare and
select, shift and mask, a kernel-shaped blend (``mix``), and the shift of a
row by a few columns, which the kernel does by reading a neighbouring
thread's column from shared memory and the TPU did with a lane roll.  Each
arm is a chain of data-dependent two-register recurrences (``x, y = f(x,
y), x``) on a [G, w] int32 slab, ``k`` iterations per step, carried over
``steps`` sequential steps inside one launch; step t writes ``out[t]``.

``run`` launches ``csrc/probes.cu``'s K8 kernels on a CUDA tensor
(``probe_kernel.LAUNCHES["calibrate"]``, the mm arms' under "mm") and
``run_plain`` on a CPU tensor.
The lines are independent: a row of the slab for arms that shift along the
last axis, a column for ``roll_sub``; the transposed ``t*`` arms shift
along the rows of the [w, G] slab, which are again the G rows of the input.
Each thread keeps C contiguous columns of its line in registers (C = 4, or
8 for the step arms, ``probe_kernel.line_plan``); a shift by fewer than C columns goes through
warp shuffles, and a line of several warps trades each warp's edge values
through shared memory behind one barrier.  The ``mm*`` and ``stepm*`` arms
multiply by 0/1 permutation matrices on the tensor cores (``mma.sync``:
bf16 -> f32, s8 -> s32), ``mmf32`` on the FP32 cores; an mm launch gives a
block each 16-row tile of the state, its new z exchanged through shared
memory once an iteration.

Method (``main``): each arm is timed at two chain lengths K1 < K2 and the
rate is the differential ``(K2 - K1) * ops * steps * G * w / (t(K2) -
t(K1))``, which cancels the per-step and per-launch costs.  On the card 120
x 2048 elements spread over 132 SMs, so the figure is the card's throughput
for the op class at this shape, not the latency-bound serial issue rate the
TPU version measured on its one core.  Rates print in Tops/s and as a share
of the card's int32 peak (``utils.cost_model.PEAK_INT32_S``).  Each arm is
"kind" or "kind@w" (w a multiple of 128 up to 2048 narrows the slab).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sangnom_tpu_torch.tools import probe_kernel

G, W = 120, 2048  # the u8 1080p luma kernel's slab shape
STEPS = 512       # ~ the 539-step 1080p walk
MASK = 0x00FF00FF

# Ops per chain iteration, in the cost model's units: where = cmp+sel = 2,
# shift_and = 3, mix = roll+cmp+add+shift+and+add+sel = 7, others 1; an mm
# iteration moves G*w elements like one roll of the slab (1), mmroll = roll
# + add + one matmul shift; the step arms count 21 shift units (3 box rolls
# x 5 slabs + 6 tap shifts), steph the 15 of the box alone.
OPS_PER_ITER = {"add": 1, "roll": 1, "roll3": 1, "roll_sub": 1,
                "concat_rot": 1, "jroll": 1, "where": 2, "shift_and": 3,
                "min": 1, "mul": 1, "mix": 7,
                "troll_sub": 1, "troll3": 1, "tadd": 1, "tmix": 7,
                "rolladd": 2, "trolladd": 2, "trolladd8": 2,
                "vshift1": 3, "vshift6": 13, "rolladd2": 4, "rollvshift": 5,
                "mmbf16": 1, "mmf32": 1, "mmint8": 1, "mmroll": 3,
                "stepv": 21, "stepm": 21, "stepmbf": 21, "steph": 15}

MM_KINDS = ("mmbf16", "mmf32", "mmint8", "mmroll")
STEP_KINDS = ("stepv", "stepm", "stepmbf", "steph")
TRANSPOSED = ("troll_sub", "troll3", "tadd", "tmix", "trolladd", "trolladd8")
PADDED = ("vshift1", "vshift6", "rollvshift")  # scratch 128 columns wider
DEFAULT_ARMS = ("add", "mul", "min", "roll", "shift_and", "where", "mix")
K1, K2 = 32, 96
K1_STEP, K2_STEP = 4, 12


def check_width(kind: str, w: int) -> None:
    if kind not in OPS_PER_ITER:
        raise ValueError(f"unknown arm {kind!r}")
    if w % 128 or not 128 <= w <= W:
        raise ValueError(f"{kind}: width {w} is not a multiple of 128 in [128, {W}]")


# ---- plain version -------------------------------------------------------

def _roll(x: torch.Tensor, s: int, dim: int = -1) -> torch.Tensor:
    """jnp.roll / pltpu.roll: out[j] = x[j - s]."""
    return torch.roll(x, s, dims=dim)


def wrap8(v: torch.Tensor) -> torch.Tensor:
    """int32 -> the int8 value it wraps to, kept in int32 (astype(int8))."""
    return ((v + 128) & 0xFF) - 128


def f32_to_i32(z: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA casts: NaN to 0, toward zero, saturating."""
    z = torch.nan_to_num(z.double(), nan=0.0)
    return z.clamp(-2147483648.0, 2147483647.0).trunc().to(torch.int32)


def dot(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a @ m with exact products and sums in float64 (inf * 0 = NaN, as the
    f32 and s32 dots give); the caller casts to the accumulator type."""
    return a.double() @ m.double()


def mm_seed(r: int, device) -> torch.Tensor:
    """[r, 128] values 0..250 (int32; the int8 arm wraps them)."""
    row = torch.arange(r, device=device)[:, None]
    col = torch.arange(128, device=device)[None, :]
    return ((row * 7 + col * 13) % 251).to(torch.int32)


def mm_perm(device) -> torch.Tensor:
    """128x128 shift-by-one permutation: (z @ m)[:, j] = z[:, j-1 mod 128]."""
    row = torch.arange(128, device=device)[:, None]
    col = torch.arange(128, device=device)[None, :]
    return (col == (row + 1) % 128).to(torch.int32)


def kernel_matrix(kind: str, device) -> torch.Tensor | None:
    """The kernel's permutation matrix for an mm or step-m arm: mmf32 f32
    [128, 128] row-major; the tensor-core arms transposed ([n][k]) in their
    input type, bf16 or int8, stepm/stepmbf the 12 blocks [1536, 128]."""
    if kind not in MM_KINDS and kind not in ("stepm", "stepmbf"):
        return None
    m = mm_perm(device)
    if kind == "mmf32":
        return m.float().contiguous()
    if kind in STEP_KINDS:
        m = m.repeat(1, 12)
    dt = torch.int8 if kind in ("mmint8", "stepm") else torch.bfloat16
    return m.t().contiguous().to(dt)


def _chain(kind: str, x, y, k: int, pad):
    """k iterations of a basic arm on [lines, w] (transposed arms on [w, G]);
    ``pad`` is the constant [G, 128] beyond column w of the padded scratch.
    Returns the chain tail x + y (+ u + v)."""
    w = x.shape[-1]

    def vload(s, stored):  # scratch[:, s:s+w] after scratch[:, :w] = stored
        return torch.cat([stored[:, s:], pad[:, :s]], dim=1)

    if kind in ("rolladd2", "rollvshift"):
        u, v = x ^ 0x33CC33, y ^ 0x0F0F0F
        for _ in range(k):
            x, y = _roll(x, 1) + y, x
            if kind == "rolladd2":
                u, v = _roll(u, 1) + v, u
            else:
                u, v = vload(1, u) + v, u
        return x + y + u + v
    for _ in range(k):
        if kind in ("add", "tadd"):
            x, y = x + y, x
        elif kind in ("roll", "jroll"):
            x, y = _roll(x, 1), x
        elif kind == "roll3":
            x, y = _roll(x, 3), x
        elif kind in ("roll_sub", "troll_sub"):
            x, y = _roll(x, 1, 0), x
        elif kind == "troll3":
            x, y = _roll(x, 3, 0), x
        elif kind == "rolladd":
            x, y = _roll(x, 1) + y, x
        elif kind == "trolladd":
            x, y = _roll(x, 1, 0) + y, x
        elif kind == "trolladd8":
            x, y = _roll(x, 8, 0) + y, x
        elif kind == "vshift1":
            x, y = vload(1, x) + y, x
        elif kind == "vshift6":
            acc = y
            for s in range(1, 7):
                acc = acc + vload(s, x)
            x, y = acc, x
        elif kind in ("mix", "tmix"):
            r = _roll(x, 1, 0 if kind == "tmix" else -1)
            x, y = torch.where(x > y, (x + r) >> 1, (r & MASK) + y), x
        elif kind == "concat_rot":
            x, y = _roll(x, -1), x
        elif kind == "where":
            x, y = torch.where(x > y, y, x), x
        elif kind == "shift_and":
            x, y = ((x >> 1) & MASK) + y, x
        elif kind == "min":
            x, y = torch.minimum(x, y), x
        elif kind == "mul":
            x = x * x
        else:
            raise ValueError(kind)
    return x + y


def _mm_step(kind: str, k: int, st: dict) -> torch.Tensor:
    """k iterations of an mm arm on the carried state; returns out[t]."""
    m = st["m"]
    z, wv = st["z"], st["wv"]
    if kind == "mmroll":
        x, y = st["x"], st["y"]
    for _ in range(k):
        if kind == "mmroll":
            x, y = _roll(x, 1) + y, x
        if kind in ("mmbf16", "mmroll"):
            z, wv = dot(z.to(torch.bfloat16), m).float() + wv, z
        elif kind == "mmf32":
            z, wv = dot(z, m).float() + wv, z
        else:  # mmint8: s32 accumulate, wrap to int8
            z, wv = wrap8(dot(z, m).to(torch.int32) + wv), z
    st["z"], st["wv"] = z, wv
    zi = z[:G] if kind == "mmint8" else f32_to_i32(z[:G])
    if kind == "mmroll":
        st["x"], st["y"] = x, y
        return x[:, :128] + zi
    return zi


def _step_step(kind: str, k: int, st: dict) -> torch.Tensor:
    """k iterations of a step arm (the box's sub3 rotate tree and writeback
    on 5 slabs, and the tap engine of one row batch); returns out[t]."""
    a, b, b2 = st["a"], st["b"], st["b2"]
    w = b.shape[-1]
    ns = w // 128
    for _ in range(k):
        hb = a + _roll(a, 1)
        hc = hb + _roll(hb, 2)
        a = ((hc + _roll(hc, 3) - a) >> 4) & MASK
        if kind == "steph":
            continue
        if kind == "stepv":
            acc = b2
            for s in (1, 2, 3, w - 1, w - 2, w - 3):
                acc = acc + _roll(b, s)
            b, b2 = acc & 0xFF, b
            continue
        m = st["m"]
        xb = wrap8(b) if kind == "stepm" else b.to(torch.bfloat16)
        taps = []
        for j in range(ns):
            xj = xb[:, j * 128:(j + 1) * 128]
            xr = xb[:, (j + 1) % ns * 128:][:, :128]
            xl = xb[:, (j - 1) % ns * 128:][:, :128]
            bulk, rc, lc = dot(xj, m[:, :768]), dot(xr, m[:, 768:1152]), dot(xl, m[:, 1152:])
            taps.append(torch.cat([bulk[:, :384] + rc, bulk[:, 384:] + lc], dim=-1))
        acc = b2
        for ti in range(6):
            tap = torch.cat([t[:, ti * 128:(ti + 1) * 128] for t in taps], dim=-1)
            tap = (tap.to(torch.int32) if kind == "stepm"
                   else f32_to_i32(tap.float()))
            acc = acc + (tap & 0xFF)
        b, b2 = acc & 0xFF, b
    st["a"], st["b"], st["b2"] = a, b, b2
    return b[:, :128] + a[0, :, :128]


def run_plain(src: torch.Tensor, kind: str, k: int, w: int = W,
              steps: int = STEPS) -> torch.Tensor:
    """Plain PyTorch version of one arm: [G, >=w] int32 -> [steps, G, 128]
    int32, on ``src``'s device."""
    check_width(kind, w)
    dev = src.device
    src = src[:, :w].to(torch.int32)
    out = torch.zeros((steps, G, 128), dtype=torch.int32, device=dev)
    if kind in MM_KINDS:
        r = G * w // 128
        z, wv = mm_seed(r, dev), ((torch.arange(r, device=dev)[:, None] * 11
                                   + torch.arange(128, device=dev)[None, :] * 5) % 241)
        if kind == "mmint8":
            st = {"z": wrap8(z), "wv": wrap8(wv.to(torch.int32))}
        else:
            st = {"z": z.float(), "wv": wv.float()}
        st["m"] = mm_perm(dev)
        if kind == "mmroll":
            st["x"], st["y"] = src.clone(), src ^ 0x55AA55
        for t in range(steps):
            out[t] = _mm_step(kind, k, st)
        return out
    if kind in STEP_KINDS:
        seed = src & 0xFF
        st = {"a": torch.stack([seed, seed ^ 0x55, (seed >> 1) & 0xFF, seed ^ 0xA3,
                                (seed + 17) & 0xFF]),
              "b": seed, "b2": (src >> 3) & 0xFF, "m": mm_perm(dev).repeat(1, 12)}
        for t in range(steps):
            out[t] = _step_step(kind, k, st)
        return out
    transposed = kind in TRANSPOSED
    x = src.t().contiguous() if transposed else src
    y = x ^ 0x55AA55  # never stored back: every step restarts y
    pad = src[:, :128] if kind in PADDED else None
    for t in range(steps):
        x = _chain(kind, x, y, k, pad)
        if transposed:
            out[t, :, :G] = x[:G, :]
        else:
            out[t] = x[:, :128]
    return out


# ---- entry points ---------------------------------------------------------

def run(src, kind: str, k: int, w: int = W, steps: int = STEPS,
        device: str = "cuda") -> torch.Tensor:
    """One arm on ``device``: the kernel on the card, the plain version on
    the CPU.  ``src`` [G, >=w] integers (numpy or tensor)."""
    src = torch.as_tensor(src).to(device=device, dtype=torch.int32)
    if src.device.type == "cpu":
        return run_plain(src, kind, k, w, steps)
    check_width(kind, w)
    return probe_kernel.calibrate(src[:, :w].contiguous(), kind, k, steps,
                                  kernel_matrix(kind, src.device))


def chain_lengths(kind: str) -> tuple[int, int]:
    """(K1, K2) of the differential: short chains for the 21-op step arms."""
    return (K1_STEP, K2_STEP) if kind in STEP_KINDS else (K1, K2)


def time_ms(src: torch.Tensor, kind: str, k: int, w: int = W, steps: int = STEPS,
            iters: int = 3) -> float:
    """Best of ``iters`` launches, ms by CUDA events, after one warm-up."""
    run(src, kind, k, w, steps)
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(src, kind, k, w, steps)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def calibrate(src: torch.Tensor, arms, reps: int = 4, steps: int = STEPS,
              log=print) -> dict:
    """Differential rate of each arm, element-ops/s, best of ``reps``; 0.0
    where every rep measured t(K2) <= t(K1)."""
    from sangnom_tpu_torch.utils.cost_model import PEAK_INT32_S

    results = {}
    for arm in arms:
        kind, _, wspec = arm.partition("@")
        w = int(wspec) if wspec else W
        check_width(kind, w)
        k1, k2 = chain_lengths(kind)
        best = 0.0
        for _ in range(reps):
            t1 = time_ms(src, kind, k1, w, steps)
            t2 = time_ms(src, kind, k2, w, steps)
            if t2 > t1:
                elems = (k2 - k1) * OPS_PER_ITER[kind] * steps * G * w
                best = max(best, elems / ((t2 - t1) * 1e-3))
        results[arm] = best
        if best == 0.0:
            log(f"  {arm:10s}: MEASUREMENT FAILED (all {reps} reps non-monotonic)")
        else:
            log(f"  {arm:10s}: {best / 1e12:8.3f} Tops/s "
                f"({best / PEAK_INT32_S * 100:6.1f}% of the int32 peak)")
    return results


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 4
    arms = tuple(argv[1].split(",")) if len(argv) > 1 else DEFAULT_ARMS
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_vpu: needs a CUDA device")
    from sangnom_tpu_torch.utils.cost_model import PEAK_INT32_S, card_line

    print(f"device: {card_line()}", flush=True)
    src = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (G, W))).to("cuda", torch.int32)
    print(f"slab [{G}, {W}] i32, {STEPS} steps, differential K={K1}->{K2} "
          f"({K1_STEP}->{K2_STEP} for step arms); int32 peak "
          f"{PEAK_INT32_S / 1e12:.2f} Tops/s", flush=True)
    results = calibrate(src, arms, reps, log=lambda s: print(s, flush=True))
    mix = results.get("mix")
    if mix == 0.0:
        print("\nkernel-blend 'mix' measurement FAILED; rerun.", flush=True)
        return 1
    if mix is not None:
        print(f"\nkernel-blend achievable ('mix'): {mix / 1e12:.3f} Tops/s = "
              f"{mix / PEAK_INT32_S * 100:.1f}% of the int32 peak", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
