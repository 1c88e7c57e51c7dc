// Probe kernels of the cost-model path for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU package's tool kernels:
//   K8  tools/calibrate_vpu.py::_kernel (launched by _run): op-class rate
//       arms, here line_kernel (integer and shift arms), mm_kernel and
//       mmf32_kernel (the permutation-matrix arms) and step_kernel (the
//       kernel-step mocks);
//   K9  tools/archive/isolate_step.py::_kernel: isolate_kernel;
//   K10 tools/archive/probe_pool_dynrow.py::_kernel: dynrow_kernel.
//
// The TPU ran each as a sequential grid of `steps` steps over scratch that
// persists in VMEM.  Here one launch walks every step of K8 and K9: each
// block owns independent lines of the state and keeps them in registers, and
// writes out[t] at the end of step t.  K10's steps never depended on each
// other, so its launch is parallel over them.
//
// Layout (line_kernel, step_kernel, isolate_kernel): a thread owns C
// contiguous columns of its line (a template parameter: 4 in line_kernel, 8
// in isolate_kernel, 8 in step_kernel but 4 where a line of 8-column threads
// would not be whole warps).  The launch plan is
// tools/probe_kernel.line_plan / isolate_plan; each launcher holds it to the
// grid the kernel's layout needs (line_grid, step_grid, ...).  A lane roll
// of the TPU is a shift of the line by s columns.  Where |s| is small it
// goes through registers and warp shuffles: element e takes its own element
// e - s, and the |s| values that cross a lane boundary come from the
// neighbouring lane (__shfl_sync).  A line that fits one warp wraps inside
// the warp and needs no shared memory and no barrier.  A line of several
// warps (one line a block) also trades each warp's |s| edge values through
// a small double-buffered shared array behind one barrier; the last warp's
// edge feeds the first.  Larger shifts (ramtN, trolladd8) store the whole
// line to shared memory and read it back shifted, and vshift1/vshift6 (and
// rollvshift's second chain) keep a shared store and a static-offset load
// every iteration, which is what they measure; both take 16-byte windows.
// The permutation-matrix arms multiply on the tensor cores with mma.sync
// (bf16 -> f32, s8 -> s32), A fragments by ldmatrix from a swizzled operand
// tile, and mmf32 register-tiled on the FP32 cores (mm_kernel).
//
// What bounds them: the dependent chains, the shuffles and, for lines of
// several warps, one barrier an exchange; not bytes: each probe reads its
// input once and writes [steps, 120, 128] int32.
//
// Each iteration's values pass through an empty asm, so the compiler cannot
// fold a chain (min and where chains collapse to their first step, add
// chains into fewer three-input adds); every iteration issues its ops.
//
// Exactness: int32 chains wrap, so additions and products run in uint32_t;
// compares, min and >> stay signed (arithmetic shift).  Float adds and
// products use the _rn intrinsics; f32 -> s32 casts use __float2int_rz
// (toward zero, saturating, NaN to 0), as XLA casts.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 120;  // rows of the probes' input slab
constexpr int kIsoW = 2048;
constexpr int kLineC = 4;    // line_kernel: columns a thread
constexpr int kIsoC = 8;     // isolate_kernel: columns a thread
constexpr int kPad = 16;     // line_kernel: padded scratch columns past a line
constexpr int kStepEW = 16;  // step_kernel: edge words a warp an exchange
constexpr int32_t kMask = 0x00FF00FF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
// Index j - s of a circular line of n, for |s| < n and 0 <= j < n.
__device__ __forceinline__ int wrapi(int j, int n) {
  return j < 0 ? j + n : j >= n ? j - n : j;
}
// Hides v's value from the optimizer, at no instruction: without it nvcc
// folds the two-register recurrences (min(min(x, y), x) = min(x, y)).
__device__ __forceinline__ void opaque(int32_t& v) { asm("" : "+r"(v)); }
// int32 -> the int8 it wraps to.
__device__ __forceinline__ int32_t wrap8(int32_t v) {
  return static_cast<int32_t>(static_cast<int8_t>(static_cast<uint8_t>(v & 0xFF)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

// C contiguous int32 at p (16-byte aligned), as C/4 vector accesses.
template <int C>
__device__ __forceinline__ void ld_vec(const int32_t* p, int32_t v[C]) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const int4 t = reinterpret_cast<const int4*>(p)[q];
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}
template <int C>
__device__ __forceinline__ void st_vec(int32_t* p, const int32_t v[C]) {
#pragma unroll
  for (int q = 0; q < C / 4; ++q)
    reinterpret_cast<int4*>(p)[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// ---- lines in registers: shuffles and warp edges -------------------------

// A thread's place in its line of TL = n / C threads; it owns columns
// t*C .. t*C + C-1.  TL <= 32 ("single"): the line is the first TL lanes of
// a 16- or 32-lane segment of one warp, and shuffles wrap inside those TL
// lanes.  TL > 32 (a multiple of 32): the line is a block of nw = TL / 32
// warps; shuffles stay inside each warp, and the values that cross a warp's
// edge are traded through shared memory (put_* before the barrier, get_*
// after it).
template <int C>
struct Place {
  int t, lane, warp, nw;
  int sl[2], sr[2];  // source lanes 1 and 2 lanes to the left / right

  __device__ Place(int tid, int TL) {
    lane = tid & 31;
    if (TL > 32) {
      t = tid;
      warp = tid >> 5;
      nw = TL >> 5;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        sl[d] = (lane - d - 1) & 31;
        sr[d] = (lane + d + 1) & 31;
      }
    } else {
      const int base = lane & (TL > 16 ? 0 : 16);
      t = lane - base;
      warp = 0;
      nw = 1;
      const int tt = t < TL ? t : 0;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        sl[d] = base + (tt - d - 1 + 2 * TL) % TL;
        sr[d] = base + (tt + d + 1) % TL;
      }
    }
  }
};

// in[i] = the line's value at column t*C - S + i (circular), S <= 2C.  Lanes
// at a warp's left edge of a multi-warp line get theirs from get_left.
template <int C, int S>
__device__ __forceinline__ void shfl_left(const Place<C>& P, const int32_t v[C], int32_t in[S]) {
  static_assert(S <= 2 * C, "a shift reaches at most two lanes");
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int o = S - i;
    const int d = (o + C - 1) / C;
    in[i] = __shfl_sync(kFull, v[d * C - o], P.sl[d - 1]);
  }
}
// in[i] = the line's value at column t*C + C + i (circular), S <= 2C.
template <int C, int S>
__device__ __forceinline__ void shfl_right(const Place<C>& P, const int32_t v[C], int32_t in[S]) {
  static_assert(S <= 2 * C, "a shift reaches at most two lanes");
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int o = C + i;
    in[i] = __shfl_sync(kFull, v[o % C], P.sr[o / C - 1]);
  }
}
// The warp's last S values into eb[warp][S] (read by the next warp).  Up
// to C values are the last lane's alone: S predicated stores, no branch.
template <int C, int S>
__device__ __forceinline__ void put_left(const Place<C>& P, const int32_t v[C], int32_t* eb) {
  if constexpr (S <= C) {
    if (P.lane == 31) {
#pragma unroll
      for (int i = 0; i < S; ++i) eb[P.warp * S + i] = v[C - S + i];
    }
  } else {
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const int q = P.lane * C + e - (32 * C - S);
      if (q >= 0) eb[P.warp * S + q] = v[e];
    }
  }
}
// The previous warp's last S values, for the lanes whose left reach leaves
// the warp.
template <int C, int S>
__device__ __forceinline__ void get_left(const Place<C>& P, int32_t in[S], const int32_t* eb) {
  const int pw = (P.warp == 0 ? P.nw : P.warp) - 1;
  if constexpr (S <= C) {
    if (P.lane == 0) {
#pragma unroll
      for (int i = 0; i < S; ++i) in[i] = eb[pw * S + i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int q = P.lane * C + i;
      if (q < S) in[i] = eb[pw * S + q];
    }
  }
}
// The warp's first S values into eb[warp][S] (read by the previous warp).
template <int C, int S>
__device__ __forceinline__ void put_right(const Place<C>& P, const int32_t v[C], int32_t* eb) {
  static_assert(S <= C, "right shifts reach one lane");
  if (P.lane == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) eb[P.warp * S + i] = v[i];
  }
}
template <int C, int S>
__device__ __forceinline__ void get_right(const Place<C>& P, int32_t in[S], const int32_t* eb) {
  static_assert(S <= C, "right shifts reach one lane");
  const int nx = P.warp + 1 == P.nw ? 0 : P.warp + 1;
  if (P.lane == 31) {
#pragma unroll
    for (int i = 0; i < S; ++i) in[i] = eb[nx * S + i];
  }
}

// The L columns left and R columns right of a thread's own, for one
// exchange: pre() before the barrier (shuffles, and the warp edges into
// eb: L*nw words, then R*nw), post() after it.  at(v, c) is the value at
// column t*C + c for -L <= c < C + R (c known at compile time).
template <int C, int L, int R>
struct Window {
  int32_t l[L > 0 ? L : 1], r[R > 0 ? R : 1];

  __device__ __forceinline__ void pre(const Place<C>& P, const int32_t v[C], int32_t* eb) {
    if constexpr (L > 0) {
      shfl_left<C, L>(P, v, l);
      if (P.nw > 1) put_left<C, L>(P, v, eb);
    }
    if constexpr (R > 0) {
      shfl_right<C, R>(P, v, r);
      if (P.nw > 1) put_right<C, R>(P, v, eb + L * P.nw);
    }
  }
  __device__ __forceinline__ void post(const Place<C>& P, const int32_t* eb) {
    if (P.nw == 1) return;
    if constexpr (L > 0) get_left<C, L>(P, l, eb);
    if constexpr (R > 0) get_right<C, R>(P, r, eb + L * P.nw);
  }
  __device__ __forceinline__ int32_t at(const int32_t v[C], int c) const {
    return c < 0 ? l[L + c] : c < C ? v[c] : r[c - C];
  }
};

// The window a roll by SH reads: |SH| columns on the side it reads from.
template <int C, int SH>
using RollWindow = Window<C, (SH > 0 ? SH : 0), (SH < 0 ? -SH : 0)>;

// ---- K10: three clamped rows a step --------------------------------------

constexpr int kDynR = 2;         // dynrow_kernel: output rows a thread
constexpr int kDynThreads = 128;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The output rows never depend on each other, so the launch is parallel
// over them: thread i owns the V = 16 / sizeof(T) contiguous columns of
// group i % groups (16 u8 or 4 i32, one 16-byte load a row) in kDynR
// consecutive output rows t0 = (i / groups) * kDynR ...  It computes each
// clamped row index min(t + d, H - 1) itself (the dynamic row read the probe
// asks about), loads the kDynR + 2 rows it needs and writes its rows as
// 16-byte stores.  A group past S, or a row that is not 16-byte aligned
// (S not a multiple of 16 / sizeof(T), or of 4 for the output), goes element
// by element.  Bound: bytes (the plane read once, the output written once).
template <typename T>
__global__ void __launch_bounds__(kDynThreads)
dynrow_kernel(const T* __restrict__ kept, int32_t* __restrict__ out, int H, int S,
              int steps, int groups) {
  constexpr int V = 16 / sizeof(T);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int t0 = static_cast<int>(i / groups) * kDynR;
  if (t0 >= steps) return;
  const int c0 = static_cast<int>(i % groups) * V;
  const int n = min(V, S - c0);
  int32_t v[kDynR + 2][V];
#pragma unroll
  for (int j = 0; j < kDynR + 2; ++j) {
    const T* p = kept + (long long)min(t0 + j, H - 1) * S + c0;
    if (n == V && aligned16(p)) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[j][e] = sizeof(T) == 1 ? static_cast<int32_t>((wd[e / 4] >> (8 * (e % 4))) & 0xFF)
                                 : static_cast<int32_t>(wd[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = e < n ? static_cast<int32_t>(p[e]) : 0;
    }
  }
#pragma unroll
  for (int r = 0; r < kDynR; ++r) {
    if (t0 + r >= steps) break;
    int32_t o[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = wadd(wadd(wmul(v[r][e], 3), wmul(v[r + 1][e], 5)), wmul(v[r + 2][e], 7));
    int32_t* q = out + (long long)(t0 + r) * S + c0;
    if (n == V && aligned16(q)) {
      st_vec<V>(q, o);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < n) q[e] = o[e];
    }
  }
}

// ---- K8: the calibration arms --------------------------------------------

enum Arm {
  kAdd, kRoll, kRoll3, kRollSub, kConcatRot, kJroll, kWhere, kShiftAnd, kMin,
  kMul, kMix, kTrollSub, kTroll3, kTadd, kTmix, kRolladd, kTrolladd,
  kTrolladd8, kVshift1, kVshift6, kRolladd2, kRollvshift, kMmbf16, kMmf32,
  kMmint8, kMmroll, kStepv, kStepm, kStepmbf, kSteph, kNumArms
};

__host__ __device__ constexpr bool is_transposed(int a) {
  return a == kTrollSub || a == kTroll3 || a == kTadd || a == kTmix ||
         a == kTrolladd || a == kTrolladd8;
}
__host__ __device__ constexpr bool is_padded(int a) {
  return a == kVshift1 || a == kVshift6 || a == kRollvshift;
}
__host__ __device__ constexpr bool two_chains(int a) { return a == kRolladd2 || a == kRollvshift; }
__host__ __device__ constexpr bool exchanges(int a) {
  return !(a == kAdd || a == kTadd || a == kWhere || a == kShiftAnd ||
           a == kMin || a == kMul);
}
// Shift of the roll exchange: out[j] = x[j - s].
__host__ __device__ constexpr int roll_shift(int a) {
  return a == kRoll3 || a == kTroll3 ? 3 : a == kTrolladd8 ? 8
         : a == kConcatRot ? -1 : 1;
}

// Integer and shift arms.  A line is a row of the [G, w] slab (n = w), or
// for roll_sub a column (n = G); the transposed arms' lines are the rows of
// the input as well.  Lines of up to 32 threads share one-warp blocks (two
// a warp when they take 16 lanes or fewer), longer lines take a block each.
// x's roll goes through shuffles where |s| < C (route "shuffle"), else
// through a whole-line shared buffer (trolladd8: "line"); vshift1/vshift6
// (x) and rollvshift (u) store the line to a shared buffer whose 16 columns
// past n hold seed[:, :16] for ever and read it back at a static offset
// ("pad").  y restarts from seed ^ 0x55AA55 every step.
template <int ARM, int C>
__global__ void __launch_bounds__(kIsoW / C)
line_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out, int w,
            int k, int steps) {
  constexpr bool SUB = ARM == kRollSub;
  constexpr int SH = roll_shift(ARM);
  constexpr int A = SH < 0 ? -SH : SH;
  constexpr bool VSH = ARM == kVshift1 || ARM == kVshift6;
  constexpr bool XROLL = exchanges(ARM) && !VSH;
  constexpr bool XSHUF = XROLL && A < C;
  constexpr bool XLINE = XROLL && A >= C;
  constexpr bool PAD = is_padded(ARM);
  constexpr bool LB = PAD || XLINE;  // a shared line buffer
  constexpr int NCH = ARM == kRolladd2 ? 2 : 1;  // arrays rolled through shuffles
  constexpr int D = ARM == kVshift6 ? 6 : 1;     // deepest padded offset
  constexpr int NV = (C + D + 3) / 4;            // 16-byte windows a padded load
  const int n = SUB ? kG : w;
  const int TL = n / C;
  const Place<C> P(threadIdx.x, TL);
  const bool multi = P.nw > 1;
  const int seg = TL > 16 ? 32 : 16;
  const int lpb = multi ? 1 : 32 / seg;
  const int li = multi ? 0 : P.lane / seg;
  const bool act = P.t < TL;
  const int line = blockIdx.x * lpb + li;
  const int c0 = P.t * C;
  const int bs = PAD ? n + kPad : n;
  extern __shared__ __align__(16) int32_t lsm[];
  int32_t* lb = lsm + li * 2 * bs;                   // [2][bs]
  int32_t* eb = lsm + (LB ? lpb * 2 * bs : 0);       // [2][NCH][nw][A]
  const int from = (c0 - A + n) % n;                 // XLINE: first source column

  int32_t x[C], y[C];
#pragma unroll
  for (int e = 0; e < C; ++e) x[e] = 0;
  if (act) {
    if (SUB) {
#pragma unroll
      for (int e = 0; e < C; ++e) x[e] = src[(c0 + e) * w + line];
    } else {
      ld_vec<C>(src + (long long)line * w + c0, x);
    }
  }
#pragma unroll
  for (int e = 0; e < C; ++e) y[e] = x[e] ^ 0x55AA55;
  if (PAD && P.t < kPad) {
    const int32_t v = src[(long long)line * w + P.t];
    lb[n + P.t] = lb[bs + n + P.t] = v;
  }
  if (LB) __syncthreads();

  int p = 0;
  for (int s = 0; s < steps; ++s) {
    int32_t yy[C], u[C], v[C];
#pragma unroll
    for (int e = 0; e < C; ++e) {
      yy[e] = y[e];
      u[e] = x[e] ^ 0x33CC33;
      v[e] = y[e] ^ 0x0F0F0F;
    }
    for (int it = 0; it < k; ++it) {
      int32_t r[C], wv[4 * NV];
      RollWindow<C, (XSHUF ? SH : 0)> wx;
      RollWindow<C, (ARM == kRolladd2 ? 1 : 0)> wu;
      if constexpr (exchanges(ARM)) {
        int32_t* ebp = eb + p * NCH * P.nw * A;
        if constexpr (XSHUF) wx.pre(P, x, ebp);
        if constexpr (ARM == kRolladd2) wu.pre(P, u, ebp + P.nw * A);
        if constexpr (LB) st_vec<C>(lb + p * bs + c0, ARM == kRollvshift ? u : x);
        if (multi || LB) __syncthreads();
        if constexpr (XSHUF) wx.post(P, ebp);
        if constexpr (ARM == kRolladd2) wu.post(P, ebp + P.nw * A);
        if constexpr (XLINE) ld_vec<C>(lb + p * bs + from, r);
        if constexpr (PAD) {
#pragma unroll
          for (int q = 0; q < NV; ++q) ld_vec<4>(lb + p * bs + c0 + 4 * q, wv + 4 * q);
        }
        p ^= 1;
      }
      if constexpr (XSHUF) {
#pragma unroll
        for (int e = 0; e < C; ++e) r[e] = wx.at(x, e - SH);
      }
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const int32_t xo = x[e], yo = yy[e];
        if (ARM == kAdd || ARM == kTadd) {
          x[e] = wadd(xo, yo);
        } else if (ARM == kRoll || ARM == kJroll || ARM == kRoll3 ||
                   ARM == kRollSub || ARM == kTrollSub || ARM == kTroll3 ||
                   ARM == kConcatRot) {
          x[e] = r[e];
        } else if (ARM == kRolladd || ARM == kTrolladd || ARM == kTrolladd8 ||
                   ARM == kRolladd2 || ARM == kRollvshift) {
          x[e] = wadd(r[e], yo);
        } else if (ARM == kVshift1) {
          x[e] = wadd(wv[e + 1], yo);
        } else if (ARM == kVshift6) {
          int32_t acc = yo;
#pragma unroll
          for (int d = 1; d <= 6; ++d) acc = wadd(acc, wv[e + d]);
          x[e] = acc;
        } else if (ARM == kMix || ARM == kTmix) {
          x[e] = xo > yo ? (wadd(xo, r[e]) >> 1) : wadd(r[e] & kMask, yo);
        } else if (ARM == kWhere) {
          x[e] = xo > yo ? yo : xo;
        } else if (ARM == kShiftAnd) {
          x[e] = wadd((xo >> 1) & kMask, yo);
        } else if (ARM == kMin) {
          x[e] = min(xo, yo);
        } else if (ARM == kMul) {
          x[e] = wmul(xo, xo);
        }
        if (ARM != kMul) yy[e] = xo;
      }
#pragma unroll
      for (int e = 0; e < C; ++e) {
        opaque(x[e]);
        opaque(yy[e]);
      }
      if constexpr (two_chains(ARM)) {
        int32_t nu[C];
#pragma unroll
        for (int e = 0; e < C; ++e)
          nu[e] = wadd(ARM == kRolladd2 ? wu.at(u, e - 1) : wv[e + 1], v[e]);
#pragma unroll
        for (int e = 0; e < C; ++e) {
          v[e] = u[e];
          u[e] = nu[e];
          opaque(u[e]);
          opaque(v[e]);
        }
      }
    }
    int32_t* o = out + (long long)s * (kG * 128);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      int32_t r = wadd(x[e], yy[e]);
      if (two_chains(ARM)) r = wadd(wadd(r, u[e]), v[e]);
      x[e] = r;
    }
    if (act) {
      if (SUB) {
        if (line < 128) {
#pragma unroll
          for (int e = 0; e < C; ++e) o[(c0 + e) * 128 + line] = x[e];
        }
      } else if (is_transposed(ARM)) {
        if (c0 < kG) {  // C divides G: a thread's columns are all below G or none
#pragma unroll
          for (int e = 0; e < C; ++e) {
            o[(c0 + e) * 128 + line] = x[e];
            if (line < 128 - kG) o[(c0 + e) * 128 + kG + line] = 0;
          }
        }
      } else if (c0 < 128) {
        st_vec<C>(o + line * 128 + c0, x);
      }
    }
  }
}

// Permutation-matrix arms on z [r, 128], r = G*w/128 rows, each row its own
// chain z, wv = z @ m + wv, z: k x steps dense 128 x 128 products.  A row's
// next product needs its whole previous row as K, so rows are the only free
// parallelism: a block owns a tile of 16 rows (rows >= r compute on zeros and
// are never written), with one warp on each of the SM's 4 sub-partitions.
// Each iteration's state passes through an empty asm, so no tile's work
// (rows 120.. are never read back) can be dropped.  Bound: the products'
// operations (tensor-core bf16 or s8, FP32 FMA for mmf32); the barrier an
// iteration is the exchange the column split needs.
//
// mm_kernel, the tensor-core arms (mma.sync m16n8k16 bf16 -> f32 for mmbf16
// and mmroll, m16n8k32 s8 -> s32 for mmint8): warp q owns columns 32q ..
// 32q+31, four n-tiles whose four independent accumulators interleave over
// the k-steps, with its B fragments of m (given transposed, [n][k]) held in
// registers for the whole launch.  The f32 (s32) z and wv of a thread's
// accumulator positions stay in registers; only the operand, bf16(z) or s8 z,
// goes through shared memory, double-buffered, its 16-byte chunks swizzled
// by row (chunk ^ (row & 7)) so that the ldmatrix.x4 of an A fragment and the
// stores of the new z are free of bank conflicts.  mmroll also runs the
// roll+add chain of input line blockIdx.x, C = 16 contiguous columns a thread
// (the first w / 16 threads): the roll by 1 takes the left lane's last value
// by __shfl_up_sync, and each warp's last value crosses to the next warp (the
// line's last to its first) through shared memory behind the tile's barrier.
// Both parts add into out (zeroed by the caller).
constexpr int kMmWarps = 4;             // mm_kernel: warps a block
constexpr int kMmThreads = 32 * kMmWarps;
constexpr int kMmNT = 16 / kMmWarps;    // n-tiles (8 columns) a warp
constexpr int kRollC = 16;              // mmroll's line: columns a thread
constexpr int kF32Threads = 128;        // mmf32_kernel: 4 x 4 patches of a tile

__device__ __forceinline__ void opaquef(float& v) { asm("" : "+f"(v)); }

// The four 8 x 8 b16 matrices of an A fragment; lane l gives the address of
// row l & 7 of matrix l >> 3.
__device__ __forceinline__ void ldsm_x4(uint32_t a[4], const unsigned char* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// Byte offset of byte b of tile row `row` in a [16][RB] swizzled operand tile.
template <int RB>
__device__ __forceinline__ int swz(int row, int b) {
  return row * RB + (((b >> 4) ^ (row & 7)) << 4) + (b & 15);
}

template <int ARM>
__global__ void __launch_bounds__(kMmThreads, 1)
mm_kernel(const int32_t* __restrict__ src, const void* __restrict__ mv,
          int32_t* __restrict__ out, int w, int k, int steps) {
  constexpr bool S8 = ARM == kMmint8;
  constexpr bool ROLL = ARM == kMmroll;
  constexpr int RB = 128 * (S8 ? 1 : 2);  // operand bytes of a tile row
  constexpr int TB = 16 * RB;             // of a tile
  constexpr int NKS = S8 ? 4 : 8;         // k-steps of a product (32 bytes of k each)
  using Acc = typename std::conditional<S8, int32_t, float>::type;
  extern __shared__ __align__(16) unsigned char msm[];
  unsigned char* zs = msm;                                  // [2][16][RB], swizzled
  int32_t* eb = reinterpret_cast<int32_t*>(msm + 2 * TB);   // mmroll: [2][kMmWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int r = kG * w / 128;
  const int row0 = blockIdx.x * 16;
  const bool has_tile = row0 < r;  // mmroll's blocks past the last tile run the line alone

  uint32_t bfr[NKS][kMmNT][2];
  {
    const unsigned char* mb = static_cast<const unsigned char*>(mv);
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
      for (int j = 0; j < kMmNT; ++j) {
        const unsigned char* q = mb + ((kMmNT * warp + j) * 8 + g) * RB + ks * 32 + tig * 4;
        bfr[ks][j][0] = __ldg(reinterpret_cast<const unsigned*>(q));
        bfr[ks][j][1] = __ldg(reinterpret_cast<const unsigned*>(q + 16));
      }
  }
  // z and wv at the thread's accumulator positions: n-tile j, q = 0..3 is
  // row g + 8 (q >> 1), column (kMmNT warp + j) 8 + 2 tig + (q & 1).
  Acc z[kMmNT][4], wv[kMmNT][4];
#pragma unroll
  for (int j = 0; j < kMmNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + g + 8 * (q >> 1);
      const int col = (kMmNT * warp + j) * 8 + 2 * tig + (q & 1);
      const int32_t zv = row < r ? (row * 7 + col * 13) % 251 : 0;
      const int32_t wvv = row < r ? (row * 11 + col * 5) % 241 : 0;
      if constexpr (S8) {
        z[j][q] = wrap8(zv);
        wv[j][q] = wrap8(wvv);
      } else {
        z[j][q] = static_cast<float>(zv);
        wv[j][q] = static_cast<float>(wvv);
      }
    }
  auto put = [&](unsigned char* zt) {  // the operand of z into a tile buffer
#pragma unroll
    for (int j = 0; j < kMmNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = swz<RB>(g + 8 * h, ((kMmNT * warp + j) * 8 + 2 * tig) * (S8 ? 1 : 2));
        if constexpr (S8)
          *reinterpret_cast<uint16_t*>(zt + o) =
              static_cast<uint16_t>((z[j][2 * h] & 0xFF) | ((z[j][2 * h + 1] & 0xFF) << 8));
        else
          *reinterpret_cast<uint32_t*>(zt + o) = pack_bf16(z[j][2 * h], z[j][2 * h + 1]);
      }
  };
  put(zs);

  const int TL = w / kRollC;  // mmroll: the line's threads
  const bool own = ROLL && tid < TL;
  const int last_warp = (TL - 1) >> 5;
  int32_t x[ROLL ? kRollC : 1], y[ROLL ? kRollC : 1];
  if constexpr (ROLL) {
#pragma unroll
    for (int e = 0; e < kRollC; ++e) x[e] = 0;
    if (own) ld_vec<kRollC>(src + (long long)blockIdx.x * w + tid * kRollC, x);
#pragma unroll
    for (int e = 0; e < kRollC; ++e) y[e] = x[e] ^ 0x55AA55;
  }
  __syncthreads();

  // lane l's ldmatrix row: matrices 0-3 are rows 0-7 / 8-15 of the k-step's
  // low 8 k, then of its high 8 (s8: 16 k)
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), ahi = lane >> 4;
  int p = 0;
  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      int32_t left = 0;
      if constexpr (ROLL) {
        left = __shfl_up_sync(kFull, x[kRollC - 1], 1);
        if (own && (lane == 31 || tid == TL - 1)) eb[p * kMmWarps + warp] = x[kRollC - 1];
      }
      if (has_tile) {
        const unsigned char* zc = zs + p * TB;
        Acc c[kMmNT][4];
#pragma unroll
        for (int j = 0; j < kMmNT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) c[j][q] = 0;
#pragma unroll
        for (int ks = 0; ks < NKS; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, zc + arow * RB + (((2 * ks + ahi) ^ (arow & 7)) << 4));
#pragma unroll
          for (int j = 0; j < kMmNT; ++j) {
            if constexpr (S8) mma_s8(c[j], a, bfr[ks][j][0], bfr[ks][j][1]);
            else mma_bf16(c[j], a, bfr[ks][j][0], bfr[ks][j][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < kMmNT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            Acc nz;
            if constexpr (S8) nz = wrap8(wadd(c[j][q], wv[j][q]));
            else nz = __fadd_rn(c[j][q], wv[j][q]);
            wv[j][q] = z[j][q];
            z[j][q] = nz;
            if constexpr (S8) {
              opaque(z[j][q]);
              opaque(wv[j][q]);
            } else {
              opaquef(z[j][q]);
              opaquef(wv[j][q]);
            }
          }
        put(zs + (p ^ 1) * TB);
      }
      __syncthreads();
      if constexpr (ROLL) {  // x, y = roll(x, 1) + y, x
        if (own && lane == 0) left = eb[p * kMmWarps + (warp == 0 ? last_warp : warp - 1)];
        int32_t nx[kRollC];
        nx[0] = wadd(left, y[0]);
#pragma unroll
        for (int e = 1; e < kRollC; ++e) nx[e] = wadd(x[e - 1], y[e]);
#pragma unroll
        for (int e = 0; e < kRollC; ++e) {
          y[e] = x[e];
          x[e] = nx[e];
          opaque(x[e]);
          opaque(y[e]);
        }
      }
      p ^= 1;
    }
    if (has_tile) {
#pragma unroll
      for (int j = 0; j < kMmNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + g + 8 * h;
          if (row >= kG) continue;
          int32_t v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (S8) v[e] = z[j][2 * h + e];
            else v[e] = __float2int_rz(z[j][2 * h + e]);
          }
          int32_t* o = out + ((long long)s * kG + row) * 128 + (kMmNT * warp + j) * 8 + 2 * tig;
          if constexpr (ROLL) {
            atomicAdd(o, v[0]);
            atomicAdd(o + 1, v[1]);
          } else {
            *reinterpret_cast<int2*>(o) = make_int2(v[0], v[1]);
          }
        }
    }
    if constexpr (ROLL) {
      if (own && tid * kRollC < 128) {
        int32_t* o = out + ((long long)s * kG + blockIdx.x) * 128 + tid * kRollC;
#pragma unroll
        for (int e = 0; e < kRollC; ++e) atomicAdd(o + e, x[e]);
      }
    }
  }
}

// mmf32 on the FP32 cores: a thread owns a 4 x 4 patch of its tile (rows
// 4 (lane & 3) .., columns 4 (8 warp + lane / 4) ..).  z goes through shared
// memory k-major ([k][16 rows], double-buffered) and m row-major ([k][128]),
// so per k one 16-byte load brings the patch's 4 row values and one its 4 m
// values for 16 FMAs; a warp's loads are 4 and 8 distinct 16-byte words, one
// wavefront each.  Each output sums its 128 products in k order.  FMA leaves
// every bit as a product and an add would: m's entries are 0 and 1 and z is
// never negative, so each output is one exact product plus exact zeros, until
// overflow gives +inf and then NaN (inf * 0), which casts to 0.
__global__ void __launch_bounds__(kF32Threads, 1)
mmf32_kernel(const float* __restrict__ mv, int32_t* __restrict__ out, int w, int k,
             int steps) {
  extern __shared__ __align__(16) float fsm[];
  float* mf = fsm;              // m [128][128]
  float* zt = fsm + 128 * 128;  // z^T [2][128 k][16 rows]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane & 3, cg = 8 * warp + (lane >> 2);
  const int r = kG * w / 128;
  const int row0 = blockIdx.x * 16;
  for (int i = tid; i < 128 * 128 / 4; i += blockDim.x)
    reinterpret_cast<float4*>(mf)[i] = __ldg(reinterpret_cast<const float4*>(mv) + i);
  float z[4][4], wv[4][4];  // [i][j]: row row0 + 4 rg + i, column 4 cg + j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + 4 * rg + i, col = 4 * cg + j;
      z[i][j] = row < r ? static_cast<float>((row * 7 + col * 13) % 251) : 0.0f;
      wv[i][j] = row < r ? static_cast<float>((row * 11 + col * 5) % 241) : 0.0f;
    }
  auto put = [&](float* zb) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(zb + (4 * cg + j) * 16 + 4 * rg) =
          make_float4(z[0][j], z[1][j], z[2][j], z[3][j]);
  };
  put(zt);
  __syncthreads();

  const float4* m4 = reinterpret_cast<const float4*>(mf);
  int p = 0;
  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      const float4* zc = reinterpret_cast<const float4*>(zt + p * 128 * 16);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 16
      for (int kk = 0; kk < 128; ++kk) {
        const float4 a = zc[kk * 4 + rg], b = m4[kk * 32 + cg];
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float nz = __fadd_rn(acc[i][j], wv[i][j]);
          wv[i][j] = z[i][j];
          z[i][j] = nz;
          opaquef(z[i][j]);
          opaquef(wv[i][j]);
        }
      put(zt + (p ^ 1) * 128 * 16);
      __syncthreads();
      p ^= 1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * rg + i;
      if (row < kG)
        *reinterpret_cast<int4*>(out + ((long long)s * kG + row) * 128 + 4 * cg) =
            make_int4(__float2int_rz(z[i][0]), __float2int_rz(z[i][1]),
                      __float2int_rz(z[i][2]), __float2int_rz(z[i][3]));
    }
  }
}

// Kernel-step mocks.  A block owns input row i: its 5 box slabs a[5], the
// tap row b and b2, C contiguous columns of each a thread (max(w/C, 32)
// threads).  Per iteration: the box's sub3 rotate tree and writeback on the
// 5 slabs (rolls by 1, 2 and 3: three exchanges), and the tap engine of row
// i: stepv 6 shifts of b (its 3 columns each side ride the first
// exchange); stepm / stepmbf the row's 128-column slabs as a [16, 128]
// matrix X (rows beyond w/128 zero) times m [128, 1536] on the tensor
// cores: in-slab blocks 0..5 from X, spill blocks 6..8 from X with rows
// rotated up one slab, 9..11 down one; tap ti = (block ti + spill block ti)
// & 0xFF.  m is given transposed ([1536][128]) in global memory.  X and the
// tap sums pass through shared memory, so the stepm arms keep the three
// barriers an iteration at every width.
template <int ARM, int C>
__global__ void __launch_bounds__(kIsoW / C)
step_kernel(const int32_t* __restrict__ src, const void* __restrict__ mv,
            int32_t* __restrict__ out, int w, int k, int steps) {
  constexpr bool MM = ARM == kStepm || ARM == kStepmbf;
  constexpr bool TAPS = ARM == kStepv;
  constexpr int kEW = kStepEW;
  extern __shared__ __align__(16) unsigned char ssm[];
  unsigned char* xa = ssm;  // MM: [16][128] s8 or bf16
  int32_t* ts = reinterpret_cast<int32_t*>(ssm + (MM ? 16 * 128 * 2 : 0));  // MM: [w]
  int32_t* eb = ts + (MM ? w : 0);  // [2][kEW][nw] warp edges

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const Place<C> P(tid, w / C);
  const bool multi = P.nw > 1;
  const bool own = tid < w / C;
  const int c0 = tid * C;
  const int ns = w / 128;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int nwb = blockDim.x >> 5;

  int32_t a[5][C], b[C], b2[C];
  {
    int32_t v[C];
#pragma unroll
    for (int e = 0; e < C; ++e) v[e] = 0;
    if (own) ld_vec<C>(src + (long long)i * w + c0, v);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const int32_t sd = v[e] & 0xFF;
      a[0][e] = sd;
      a[1][e] = sd ^ 0x55;
      a[2][e] = (sd >> 1) & 0xFF;
      a[3][e] = sd ^ 0xA3;
      a[4][e] = (sd + 17) & 0xFF;
      b[e] = sd;
      b2[e] = (v[e] >> 3) & 0xFF;
    }
  }
  if (MM)
    for (int q = tid; q < 16 * 128 * 2 / 4; q += blockDim.x)
      reinterpret_cast<uint32_t*>(xa)[q] = 0;
  __syncthreads();

  int p = 0;
  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      int32_t h[5][C];
      {  // exchange 1: a rolled by 1; stepv: b's 3 columns each side; stepm: b into X
        int32_t* ebp = eb + p * kEW * P.nw;
        RollWindow<C, 1> wa[5];
        Window<C, (TAPS ? 3 : 0), (TAPS ? 3 : 0)> wb;
#pragma unroll
        for (int q = 0; q < 5; ++q) wa[q].pre(P, a[q], ebp + q * P.nw);
        wb.pre(P, b, ebp + 5 * P.nw);
        if (MM && own) {
#pragma unroll
          for (int e = 0; e < C; ++e) {
            const int j = c0 + e;  // X row j >> 7, column j & 127
            if (ARM == kStepm) xa[j] = static_cast<unsigned char>(b[e] & 0xFF);
            else reinterpret_cast<__nv_bfloat16*>(xa)[j] = __float2bfloat16_rn(static_cast<float>(b[e]));
          }
        }
        if (multi || MM) __syncthreads();
#pragma unroll
        for (int q = 0; q < 5; ++q) wa[q].post(P, ebp + q * P.nw);
        wb.post(P, ebp + 5 * P.nw);
        p ^= 1;
#pragma unroll
        for (int q = 0; q < 5; ++q)
#pragma unroll
          for (int e = 0; e < C; ++e) h[q][e] = wadd(a[q][e], wa[q].at(a[q], e - 1));
        if constexpr (TAPS) {
          int32_t nb[C];
#pragma unroll
          for (int e = 0; e < C; ++e) {
            int32_t acc = b2[e];
#pragma unroll
            for (int d = 1; d <= 3; ++d) acc = wadd(acc, wb.at(b, e - d));
#pragma unroll
            for (int d = 1; d <= 3; ++d) acc = wadd(acc, wb.at(b, e + d));
            nb[e] = acc & 0xFF;
          }
#pragma unroll
          for (int e = 0; e < C; ++e) {
            b2[e] = b[e];
            b[e] = nb[e];
          }
        }
      }
      if (MM) {
        for (int nt = warp; nt < 16; nt += nwb) {
          using Acc = typename std::conditional<ARM == kStepm, int32_t, float>::type;
          Acc cb[6][4] = {}, cs[6][4] = {};
          const int rx0 = g, rx1 = g + 8;
          const int rr0 = g < ns ? (g + 1) % ns : g, rr1 = g + 8 < ns ? (g + 9) % ns : g + 8;
          const int rl0 = g < ns ? (g - 1 + ns) % ns : g, rl1 = g + 8 < ns ? (g + 7) % ns : g + 8;
          const int nks = ARM == kStepm ? 4 : 8;
          for (int ks = 0; ks < nks; ++ks) {
            uint32_t ax[4], ar[4], al[4];
            const int esz = ARM == kStepm ? 1 : 2;
            const int kk = ARM == kStepm ? ks * 32 + tig * 4 : ks * 16 + tig * 2;
            const int hi = ARM == kStepm ? 16 : 8;
            auto fr = [&](uint32_t f[4], int r0, int r1) {
              f[0] = ld32(xa + (r0 * 128 + kk) * esz);
              f[1] = ld32(xa + (r1 * 128 + kk) * esz);
              f[2] = ld32(xa + (r0 * 128 + kk + hi) * esz);
              f[3] = ld32(xa + (r1 * 128 + kk + hi) * esz);
            };
            fr(ax, rx0, rx1);
            fr(ar, rr0, rr1);
            fr(al, rl0, rl1);
#pragma unroll
            for (int ti = 0; ti < 6; ++ti) {
              const unsigned char* mb = static_cast<const unsigned char*>(mv);
              const long long nb = ti * 128 + nt * 8 + g, nsd = 768 + ti * 128 + nt * 8 + g;
              const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(mb + (nb * 128 + kk) * esz));
              const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(mb + (nb * 128 + kk + hi) * esz));
              const uint32_t s0 = __ldg(reinterpret_cast<const unsigned int*>(mb + (nsd * 128 + kk) * esz));
              const uint32_t s1 = __ldg(reinterpret_cast<const unsigned int*>(mb + (nsd * 128 + kk + hi) * esz));
              if constexpr (ARM == kStepm) {
                mma_s8(cb[ti], ax, b0, b1);
                mma_s8(cs[ti], ti < 3 ? ar : al, s0, s1);
              } else {
                mma_bf16(cb[ti], ax, b0, b1);
                mma_bf16(cs[ti], ti < 3 ? ar : al, s0, s1);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = q < 2 ? g : g + 8;
            if (j < ns) {
              int32_t sum = 0;
#pragma unroll
              for (int ti = 0; ti < 6; ++ti) {
                int32_t tap;
                if constexpr (ARM == kStepm) tap = wadd(cb[ti][q], cs[ti][q]);
                else tap = __float2int_rz(__fadd_rn(cb[ti][q], cs[ti][q]));
                sum = wadd(sum, tap & 0xFF);
              }
              ts[j * 128 + nt * 8 + tig * 2 + (q & 1)] = sum;
            }
          }
        }
      }
      {  // exchange 2: h rolled by 2
        int32_t* ebp = eb + p * kEW * P.nw;
        RollWindow<C, 2> wh[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) wh[q].pre(P, h[q], ebp + 2 * q * P.nw);
        if (multi || MM) __syncthreads();
#pragma unroll
        for (int q = 0; q < 5; ++q) wh[q].post(P, ebp + 2 * q * P.nw);
        p ^= 1;
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          int32_t t[C];
#pragma unroll
          for (int e = 0; e < C; ++e) t[e] = wadd(h[q][e], wh[q].at(h[q], e - 2));
#pragma unroll
          for (int e = 0; e < C; ++e) h[q][e] = t[e];
        }
        if (MM && own) {
#pragma unroll
          for (int e = 0; e < C; ++e) {
            const int32_t acc = wadd(b2[e], ts[c0 + e]);
            b2[e] = b[e];
            b[e] = acc & 0xFF;
          }
        }
      }
      {  // exchange 3: h rolled by 3, then the writeback
        int32_t* ebp = eb + p * kEW * P.nw;
        RollWindow<C, 3> wh[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) wh[q].pre(P, h[q], ebp + 3 * q * P.nw);
        if (multi || MM) __syncthreads();
#pragma unroll
        for (int q = 0; q < 5; ++q) wh[q].post(P, ebp + 3 * q * P.nw);
        p ^= 1;
#pragma unroll
        for (int q = 0; q < 5; ++q)
#pragma unroll
          for (int e = 0; e < C; ++e)
            a[q][e] = (wsub(wadd(h[q][e], wh[q].at(h[q], e - 3)), a[q][e]) >> 4) & kMask;
      }
    }
    if (own && c0 < 128) {
      int32_t v[C];
#pragma unroll
      for (int e = 0; e < C; ++e) v[e] = wadd(b[e], a[0][e]);
      st_vec<C>(out + (long long)s * (kG * 128) + i * 128 + c0, v);
    }
  }
}

// ---- K9: the step-isolation arms -----------------------------------------

enum IsoArm {
  kRoll2chz, kRamt, kHboxtree, kHboxsub, kHboxwb, kHboxfull, kRoll2ch,
  kHboxprod, kHboxk, kBigslab, kSlab3d, kSlab3d1, kUnroll, kFori, kBigshift,
  kSmallshift
};

constexpr int kIsoEW = 24;  // K9 edge words a warp an exchange: 15 for 5 slabs, 6 for b

// r = v rolled by SH (r[c] = v[c - SH]) for Q slabs, one exchange; b's
// window wb (BL columns left, BR right) rides the same barrier.
template <int Q, int C, int SH, int BL, int BR>
__device__ __forceinline__ void roll_slabs(const Place<C>& P, const int32_t (&v)[Q][C],
                                           int32_t (&r)[Q][C], int32_t* ebp,
                                           Window<C, BL, BR>& wb, const int32_t b[C]) {
  constexpr int A = SH < 0 ? -SH : SH;
  RollWindow<C, SH> wr[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) wr[q].pre(P, v[q], ebp + q * A * P.nw);
  wb.pre(P, b, ebp + 15 * P.nw);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) wr[q].post(P, ebp + q * A * P.nw);
  wb.post(P, ebp + 15 * P.nw);
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int e = 0; e < C; ++e) r[q][e] = wr[q].at(v[q], e - SH);
}
template <int Q, int C, int SH>
__device__ __forceinline__ void roll_slabs(const Place<C>& P, const int32_t (&v)[Q][C],
                                           int32_t (&r)[Q][C], int32_t* ebp) {
  Window<C, 0, 0> none;
  roll_slabs<Q, C, SH, 0, 0>(P, v, r, ebp, none, v[0]);
}

// A block owns input row i: Q slabs of a and a2 (the 3-D arms' [q, i] rows,
// bigslab's rows q*G + i), b and b2; W/C threads of C contiguous columns
// cover W = 2048, so the line spans several warps.  Rolls by 1-3 (the
// arms' own shifts, bigshift's W-1..W-3 as left shifts, and ramtN where N
// mod W is within 3 of 0: SH, a template parameter) go through shuffles and
// warp edges, one barrier an exchange; other ramtN amounts (SH = 0) through
// a whole-line shared buffer.  The arm is a template parameter, so the
// chain loop holds only its own code.
template <int ARM, int C, int SH>
__global__ void __launch_bounds__(kIsoW / C)
isolate_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out, int iota,
               int amount, int k, int steps) {
  constexpr int W = kIsoW;
  constexpr int S = 1920;  // hboxfull's clamp column
  constexpr int Q = ARM == kBigshift || ARM == kSmallshift ? 1 : 5;
  constexpr bool SLAB = ARM == kBigslab || ARM == kSlab3d || ARM == kSlab3d1 ||
                        ARM == kUnroll || ARM == kFori;
  constexpr bool BIG = ARM == kBigshift || ARM == kUnroll || ARM == kFori;
  constexpr int BL = BIG ? 3 : ARM == kSmallshift ? 6 : 0;  // b's shifts to the left
  constexpr int BR = BIG ? 3 : 0;                            // and to the right
  constexpr int kEdgeWarp = (S - 1) / C / 32;  // hboxfull: the warp of column S-1
  extern __shared__ __align__(16) int32_t ism[];
  const int i = blockIdx.x;
  const Place<C> P(threadIdx.x, W / C);
  const int c0 = threadIdx.x * C;
  int32_t* eb = ism;                          // [2][kIsoEW][nw] warp edges
  int32_t* ab = ism + 2 * kIsoEW * P.nw;      // ramt, SH = 0: [2][Q][W]

  int32_t a[Q][C], a2[Q][C], b[C], b2[C];
  {
    int32_t sd[C];
    ld_vec<C>(src + (long long)i * W + c0, sd);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      sd[e] &= 0xFF;
      b[e] = sd[e];
      b2[e] = sd[e] ^ 0x55AA55;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (!iota) {
          a[q][e] = sd[e];
          a2[q][e] = sd[e] ^ 0x55;
        } else if (Q == 5 && ARM != kBigslab) {  // [5, G, W]: axis 1 is G
          a[q][e] = i % 251;
          a2[q][e] = q % 241;
        } else {  // [5G, W] or [G, W]: axis 1 is W
          a[q][e] = (c0 + e) % 251;
          a2[q][e] = (q * kG + i) % 241;
        }
      }
    }
  }
  int widx[C];  // ramt, SH = 0: the source column of each element
#pragma unroll
  for (int e = 0; e < C; ++e) widx[e] = (c0 + e - amount + W) % W;

  int p = 0;
  auto edges = [&]() {  // this exchange's half of the edge buffer
    int32_t* e = eb + p * kIsoEW * P.nw;
    p ^= 1;
    return e;
  };
  auto chain = [&](const int32_t (&r)[Q][C]) {  // a, a2 = r + a2, a
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const int32_t ao = a[q][e];
        a[q][e] = wadd(r[q][e], a2[q][e]);
        a2[q][e] = ao;
      }
  };
  auto add = [](int32_t (&h)[Q][C], const int32_t (&u)[Q][C], const int32_t (&r)[Q][C]) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < C; ++e) h[q][e] = wadd(u[q][e], r[q][e]);
  };

  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      int32_t r[Q][C], h[Q][C];
      Window<C, BL, BR> wb;
      if constexpr (ARM == kRoll2chz || ARM == kRoll2ch) {
        roll_slabs<Q, C, 1>(P, a, r, edges());
        add(h, a, r);
        roll_slabs<Q, C, 2>(P, h, r, edges());
        add(a, h, r);
      } else if constexpr (ARM == kRamt) {
        if constexpr (SH != 0) {
          roll_slabs<Q, C, SH>(P, a, r, edges());
        } else {
          int32_t* l = ab + p * Q * W;
          p ^= 1;
#pragma unroll
          for (int q = 0; q < Q; ++q) st_vec<C>(l + q * W + c0, a[q]);
          __syncthreads();
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int e = 0; e < C; ++e) r[q][e] = l[q * W + widx[e]];
        }
        chain(r);
      } else if constexpr (ARM == kHboxtree || ARM == kHboxsub || ARM == kHboxwb ||
                           ARM == kHboxprod || ARM == kHboxk) {
        constexpr int F = ARM == kHboxk ? 1 : -1;  // rolls 1, 2 (else -1, -2), then 3
        roll_slabs<Q, C, F>(P, a, r, edges());
        add(h, a, r);
        roll_slabs<Q, C, 2 * F>(P, h, r, edges());
        add(h, h, r);
        roll_slabs<Q, C, 3>(P, h, r, edges());
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
          for (int e = 0; e < C; ++e) {
            int32_t v = wadd(h[q][e], r[q][e]);
            if (ARM == kHboxsub || ARM == kHboxprod || ARM == kHboxk) v = wsub(v, a[q][e]);
            if (ARM == kHboxwb || ARM == kHboxprod || ARM == kHboxk) v = (v >> 4) & kMask;
            a[q][e] = v;
          }
      } else if constexpr (ARM == kHboxfull) {
        // the TPU kernel's _hbox7: b = a + rot(a, 1); c = b + rot(b, 2);
        // bulk = c + rot(c, -3) - a; columns < 3 and S-3..S-1 take the box
        // of a clamped at [0, S-1] (its 128-column edge slabs), which only
        // the warps of columns 0 and S-1 compute, from a's 3 columns each
        // side (within the warp)
        roll_slabs<Q, C, -1>(P, a, r, edges());
        add(h, a, r);
        roll_slabs<Q, C, -2>(P, h, r, edges());
        add(h, h, r);
        roll_slabs<Q, C, 3>(P, h, r, edges());
        const bool ew = P.warp == 0 || P.warp == kEdgeWarp;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          int32_t v[C];
#pragma unroll
          for (int e = 0; e < C; ++e) v[e] = wsub(wadd(h[q][e], r[q][e]), a[q][e]);
          if (ew) {
            Window<C, 3, 3> wa;
            shfl_left<C, 3>(P, a[q], wa.l);
            shfl_right<C, 3>(P, a[q], wa.r);
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              if (c0 == 0) wa.l[d] = a[q][0];
              if (c0 + C == S) wa.r[d] = a[q][C - 1];
            }
#pragma unroll
            for (int e = 0; e < C; ++e) {
              const int j = c0 + e;
              if (j < 3 || (j >= S - 3 && j < S)) {
                int32_t sum = 0;
#pragma unroll
                for (int d = -3; d <= 3; ++d) sum = wadd(sum, wa.at(a[q], e + d));
                v[e] = sum;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < C; ++e) a[q][e] = (v[e] >> 4) & kMask;
        }
      }
      if constexpr (SLAB) {  // shifts 1 (b's window rides it), 2, 3
        roll_slabs<Q, C, 1, BL, BR>(P, a, r, edges(), wb, b);
        chain(r);
        if constexpr (ARM != kSlab3d1) {
          roll_slabs<Q, C, 2>(P, a, r, edges());
          chain(r);
          roll_slabs<Q, C, 3>(P, a, r, edges());
          chain(r);
        }
      } else if constexpr (BL + BR > 0) {  // bigshift, smallshift: b alone
        int32_t* ebp = edges();
        wb.pre(P, b, ebp);
        __syncthreads();
        wb.post(P, ebp);
      }
      if constexpr (BL + BR > 0) {
        int32_t nb[C];
#pragma unroll
        for (int e = 0; e < C; ++e) {
          int32_t acc = b2[e];
          if (ARM == kSmallshift) {
#pragma unroll
            for (int d = 1; d <= 6; ++d) acc = wadd(acc, wb.at(b, e - d));
          } else {
#pragma unroll
            for (int d = 1; d <= 3; ++d) acc = wadd(acc, wb.at(b, e - d));
#pragma unroll
            for (int d = 1; d <= 3; ++d) acc = wadd(acc, wb.at(b, e + d));
          }
          nb[e] = acc;
        }
#pragma unroll
        for (int e = 0; e < C; ++e) {
          b2[e] = b[e];
          b[e] = nb[e];
        }
      }
    }
    if (c0 < 128) {
      int32_t v[C];
#pragma unroll
      for (int e = 0; e < C; ++e) v[e] = wadd(b[e], a[0][e]);
      st_vec<C>(out + (long long)s * (kG * 128) + i * 128 + c0, v);
    }
  }
}

// ---- the launchers ---------------------------------------------------------

// The grid a kernel's layout needs.  Each launcher holds the caller's plan
// (tools/probe_kernel.line_plan / isolate_plan) to it: C, threads and blocks
// exactly, shared bytes at least, so a plan that drifts from the layout
// fails to launch instead of running a wrong grid.
struct Grid {
  int cols, threads, blocks, smem;
};

// line_kernel<ARM, kLineC> on [kG, w]: lines of up to 32 threads share
// one-warp blocks (two a warp at 16 threads or fewer), a longer line (whole
// warps) takes a block; shared memory holds the line buffers and the warp
// edges of a multi-warp line.
template <int ARM>
Grid line_grid(int w) {
  constexpr int C = kLineC;
  constexpr int SH = roll_shift(ARM);
  constexpr int A = SH < 0 ? -SH : SH;
  constexpr bool VSH = ARM == kVshift1 || ARM == kVshift6;
  constexpr bool XROLL = exchanges(ARM) && !VSH;
  constexpr bool LB = is_padded(ARM) || (XROLL && A >= C);
  constexpr int NCH = ARM == kRolladd2 ? 2 : 1;
  const int n = ARM == kRollSub ? kG : w;
  const int TL = n / C;
  const bool multi = TL > 32;
  if (n % C || (multi && TL % 32)) return {};
  const int lpb = multi || TL > 16 ? 1 : 2;
  const int bs = is_padded(ARM) ? n + kPad : n;
  const int words = (LB ? lpb * 2 * bs : 0) + (XROLL && A < C && multi ? 2 * NCH * (TL / 32) * A : 0);
  return {C, multi ? TL : 32, (ARM == kRollSub ? w : kG) / lpb, 4 * words};
}

// mm_kernel<ARM> (mmf32: mmf32_kernel): a block a 16-row tile, at least one
// a line (kG) for mmroll; shared memory holds the operand tile twice and
// mmroll's warp edges (mmf32: m and z^T twice).  C: the contiguous columns of
// a thread's piece, an accumulator pair (2), mmroll's line (kRollC) or
// mmf32's 4 x 4 patch (4).
template <int ARM>
Grid mm_grid(int w) {
  const int tiles = (kG * w / 128 + 15) / 16;
  if (ARM == kMmf32) return {4, kF32Threads, tiles, (128 * 128 + 2 * 128 * 16) * 4};
  const bool roll = ARM == kMmroll;
  return {roll ? kRollC : 2, kMmThreads, roll && tiles < kG ? kG : tiles,
          2 * 16 * 128 * (ARM == kMmint8 ? 1 : 2) + (roll ? 2 * kMmWarps * 4 : 0)};
}

// dynrow_kernel<T>: C = 16 / sizeof(T) columns and kDynR output rows a
// thread, one thread a (row group, column group), kDynThreads a block.
Grid dynrow_grid(int esz, int S, int steps) {
  const int C = 16 / esz;
  const long long n = (long long)((S + C - 1) / C) * ((steps + kDynR - 1) / kDynR);
  return {C, kDynThreads, static_cast<int>((n + kDynThreads - 1) / kDynThreads), 0};
}

// step_kernel's C: 8, or 4 where w / 8 threads would be several warps but
// not whole ones (w = 384, 640, ...).
int step_cols(int w) { return w / 8 > 32 && (w / 8) % 32 ? 4 : 8; }

// step_kernel<ARM, step_cols(w)>: a block an input row; shared memory holds
// the stepm arms' X and tap sums and a multi-warp line's warp edges.
template <int ARM>
Grid step_grid(int w) {
  const int C = step_cols(w), TL = w / C;
  const bool MM = ARM == kStepm || ARM == kStepmbf;
  const int words = (MM ? w : 0) + (TL > 32 ? 2 * kStepEW * (TL / 32) : 0);
  return {C, TL > 32 ? TL : 32, kG, (MM ? 16 * 128 * 2 : 0) + 4 * words};
}

// ramtN's shuffle shift (isolate_kernel's SH): N mod W as a signed shift
// where it is 1-3 columns, else 0 (the whole-line route).
int ramt_shift(int amount) {
  const int s = amount <= kIsoW / 2 ? amount : amount - kIsoW;
  return s >= -3 && s <= 3 ? s : 0;
}

// isolate_kernel<ARM, kIsoC, SH>: a block an input row of W / C threads;
// shared memory holds the warp edges and, for ramt's whole-line route, the
// Q = 5 slabs twice.
template <int ARM, int SH>
Grid isolate_grid() {
  constexpr int TL = kIsoW / kIsoC;
  constexpr int words = 2 * kIsoEW * (TL / 32) + (ARM == kRamt && SH == 0 ? 2 * 5 * kIsoW : 0);
  return {kIsoC, TL, kG, 4 * words};
}

// Check the plan against the grid the kernel needs, set the kernel's
// dynamic shared memory and launch it on the plan's grid.
template <typename... KA, typename... Args>
cudaError_t go(Grid need, void (*kern)(KA...), int cols, int blocks, int threads, int smem,
               cudaStream_t st, Args... args) {
  if (cols != need.cols || threads != need.threads || blocks != need.blocks ||
      smem < need.smem)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

cudaError_t launch_isolate(int arm, int cols, int shift, int blocks, int threads, int smem,
                           cudaStream_t st, const int32_t* src, int32_t* out, int iota,
                           int amount, int k, int steps) {
  if (amount < 0 || amount >= kIsoW || shift != (arm == kRamt ? ramt_shift(amount) : 0))
    return cudaErrorInvalidValue;
#define SNO_GO(A, SH) go(isolate_grid<A, SH>(), isolate_kernel<A, kIsoC, SH>, cols, blocks, \
                         threads, smem, st, src, out, iota, amount, k, steps)
  switch (arm) {
    case kRamt:
      switch (shift) {
        case 0: return SNO_GO(kRamt, 0);
        case 1: return SNO_GO(kRamt, 1);
        case 2: return SNO_GO(kRamt, 2);
        case 3: return SNO_GO(kRamt, 3);
        case -1: return SNO_GO(kRamt, -1);
        case -2: return SNO_GO(kRamt, -2);
        case -3: return SNO_GO(kRamt, -3);
        default: return cudaErrorInvalidValue;
      }
#define SNO_ISO(A) case A: return SNO_GO(A, 0);
    SNO_ISO(kRoll2chz) SNO_ISO(kHboxtree) SNO_ISO(kHboxsub) SNO_ISO(kHboxwb)
    SNO_ISO(kHboxfull) SNO_ISO(kRoll2ch) SNO_ISO(kHboxprod) SNO_ISO(kHboxk)
    SNO_ISO(kBigslab) SNO_ISO(kSlab3d) SNO_ISO(kSlab3d1) SNO_ISO(kUnroll)
    SNO_ISO(kFori) SNO_ISO(kBigshift) SNO_ISO(kSmallshift)
#undef SNO_ISO
#undef SNO_GO
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K10: kept [H, S] (u8 = 1: uint8, else int32) -> out [steps, 1, S] int32,
// on the grid of tools/probe_kernel.dynrow_plan (C = cols columns and rows
// output rows a thread, blocks, threads, shared bytes), which must be
// dynrow_grid's.
int sno_probe_dynrow_launch(int u8, const void* kept, void* out, int H, int S, int steps,
                            int cols, int rows, int blocks, int threads, int smem,
                            void* stream) {
  if (H < 1 || S < 1 || steps < 1 || rows != kDynR) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Grid need = dynrow_grid(u8 ? 1 : 4, S, steps);
  const int groups = (S + need.cols - 1) / need.cols;
  int32_t* o = static_cast<int32_t*>(out);
  return static_cast<int>(
      u8 ? go(need, dynrow_kernel<uint8_t>, cols, blocks, threads, smem, st,
              static_cast<const uint8_t*>(kept), o, H, S, steps, groups)
         : go(need, dynrow_kernel<int32_t>, cols, blocks, threads, smem, st,
              static_cast<const int32_t*>(kept), o, H, S, steps, groups));
}

// K8: one arm (the Arm code) on src [120, w] int32 -> out [steps, 120, 128]
// int32 (zeroed by the caller for mmroll), on the launch plan's grid
// (tools/probe_kernel.line_plan: C = cols, blocks, threads, shared bytes),
// which must be the one the arm's kernel needs (line_grid, mm_grid,
// step_grid).  m: the permutation matrix for the mm and step arms (mmf32:
// f32 [128][128]; mmbf16 / mmroll / mmint8: bf16 / s8 transposed [128 n][128
// k]; stepm / stepmbf: s8 / bf16 transposed [1536 n][128 k]), else null.
// w: a multiple of 128 <= 2048.
int sno_probe_calibrate_launch(int arm, int cols, const void* src_, const void* m, void* out_,
                               int w, int k, int steps, int blocks, int threads, int smem,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(src_);
  int32_t* out = static_cast<int32_t*>(out_);
  if (w % 128 || w < 128 || w > 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (arm) {
#define SNO_LINE(A)                                                                       \
  case A:                                                                                 \
    e = go(line_grid<A>(w), line_kernel<A, kLineC>, cols, blocks, threads, smem, st, src, \
           out, w, k, steps);                                                             \
    break;
    SNO_LINE(kAdd) SNO_LINE(kRoll) SNO_LINE(kRoll3) SNO_LINE(kRollSub)
    SNO_LINE(kConcatRot) SNO_LINE(kJroll) SNO_LINE(kWhere) SNO_LINE(kShiftAnd)
    SNO_LINE(kMin) SNO_LINE(kMul) SNO_LINE(kMix) SNO_LINE(kTrollSub)
    SNO_LINE(kTroll3) SNO_LINE(kTadd) SNO_LINE(kTmix) SNO_LINE(kRolladd)
    SNO_LINE(kTrolladd) SNO_LINE(kTrolladd8) SNO_LINE(kVshift1)
    SNO_LINE(kVshift6) SNO_LINE(kRolladd2) SNO_LINE(kRollvshift)
#undef SNO_LINE
#define SNO_MM(A)                                                                         \
  case A:                                                                                 \
    e = go(mm_grid<A>(w), mm_kernel<A>, cols, blocks, threads, smem, st, src, m, out, w, \
           k, steps);                                                                     \
    break;
    SNO_MM(kMmbf16) SNO_MM(kMmint8) SNO_MM(kMmroll)
    case kMmf32:
      e = go(mm_grid<kMmf32>(w), mmf32_kernel, cols, blocks, threads, smem, st,
             static_cast<const float*>(m), out, w, k, steps);
      break;
#undef SNO_MM
#define SNO_STEP(A)                                                                         \
  case A:                                                                                   \
    e = step_cols(w) == 4                                                                   \
            ? go(step_grid<A>(w), step_kernel<A, 4>, cols, blocks, threads, smem, st, src, \
                 m, out, w, k, steps)                                                       \
            : go(step_grid<A>(w), step_kernel<A, 8>, cols, blocks, threads, smem, st, src, \
                 m, out, w, k, steps);                                                      \
    break;
    SNO_STEP(kStepv) SNO_STEP(kStepm) SNO_STEP(kStepmbf) SNO_STEP(kSteph)
#undef SNO_STEP
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// K9: one arm (the IsoArm code; iota 1 for the _iota seeds; amount the
// ramt shift, 0..2047, and shift its shuffle route's -3..3, 0 for the
// whole-line route: ramt_shift(amount)) on src [120, 2048] int32 -> out
// [steps, 120, 128], on the grid of tools/probe_kernel.isolate_plan, which
// must be isolate_grid's.
int sno_probe_isolate_launch(int arm, int cols, int iota, int amount, int shift,
                             const void* src, void* out, int k, int steps, int blocks,
                             int threads, int smem, void* stream) {
  return static_cast<int>(launch_isolate(
      arm, cols, shift, blocks, threads, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out), iota, amount, k, steps));
}

}  // extern "C"
