// Probe kernels of the cost-model path for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU package's tool kernels:
//   K8  tools/calibrate_vpu.py::_kernel (launched by _run): op-class rate
//       arms, here line_kernel (integer and shift arms), mm_kernel (the
//       permutation-matrix arms) and step_kernel (the kernel-step mocks);
//   K9  tools/archive/isolate_step.py::_kernel: isolate_kernel;
//   K10 tools/archive/probe_pool_dynrow.py::_kernel: dynrow_kernel.
//
// The TPU ran each as a sequential grid of `steps` steps over scratch that
// persists in VMEM.  Here one launch walks every step: each block owns an
// independent part of the state and keeps it in registers (8 elements of a
// line per thread, strided so that lanes touch neighbouring words) or in
// shared memory, and writes out[t] at the end of step t.  A lane roll of the
// TPU is a shift of a line held by many threads: the line is stored to
// shared memory, one barrier, and each thread reads its shifted elements
// (buffers alternate, so one barrier an exchange suffices).  The
// permutation-matrix arms multiply on the tensor cores with mma.sync
// (bf16 -> f32, s8 -> s32), mmf32 on the FP32 cores.
//
// What bounds them: the dependent chains and the barriers, not bytes; each
// probe reads its input once and writes [steps, 120, 128] int32.
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
constexpr int kE = 8;    // elements of a line per thread
constexpr int kIsoW = 2048;
constexpr int32_t kMask = 0x00FF00FF;

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

// ---- K10: three clamped rows a step --------------------------------------

// One thread a column; rows (t, t+1, t+2) clamped at H-1 ride a register
// window, so each kept element is read once.
template <typename T>
__global__ void dynrow_kernel(const T* __restrict__ kept, int32_t* __restrict__ out,
                              int H, int S, int steps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= S) return;
  int32_t r0 = kept[c];
  int32_t r1 = kept[(long long)min(1, H - 1) * S + c];
  int32_t r2 = kept[(long long)min(2, H - 1) * S + c];
  for (int t = 0; t < steps; ++t) {
    out[(long long)t * S + c] = wadd(wadd(wmul(r0, 3), wmul(r1, 5)), wmul(r2, 7));
    r0 = r1;
    r1 = r2;
    r2 = kept[(long long)min(t + 3, H - 1) * S + c];
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

// Integer and shift arms.  A block owns `lpb` lines of n elements: rows of
// the [G, w] slab (n = w, lpb 1), or for roll_sub columns (n = G, lpb 8);
// the transposed arms' lines are the rows of the input as well.  Thread t
// of a line owns positions t + e*T.  Shared memory per line: two x buffers
// and two u buffers of n + 128 words (the padded scratch's last 128 columns
// hold seed[:, :128] for ever).  y restarts from seed ^ 0x55AA55 every step.
template <int ARM>
__global__ void __launch_bounds__(256)
line_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out, int w,
            int k, int steps) {
  constexpr bool SUB = ARM == kRollSub;
  constexpr int SH = roll_shift(ARM);
  const int n = SUB ? kG : w;
  const int T = n / kE;
  const int li = threadIdx.x / T;
  const int t = threadIdx.x - li * T;
  const int line = blockIdx.x * (blockDim.x / T) + li;
  const int bs = n + 128;
  extern __shared__ __align__(16) int32_t lsm[];
  int32_t* bx = lsm + li * 4 * bs;  // x: [2][bs]
  int32_t* bu = bx + 2 * bs;        // u: [2][bs]

  int32_t x[kE], y[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int j = t + e * T;
    x[e] = src[SUB ? (long long)j * w + line : (long long)line * w + j];
    y[e] = x[e] ^ 0x55AA55;
  }
  if (is_padded(ARM)) {
    for (int q = t; q < 128; q += T) {
      const int32_t v = src[(long long)line * w + q];
      bx[n + q] = bx[bs + n + q] = bu[n + q] = bu[bs + n + q] = v;
    }
  }
  __syncthreads();

  int p = 0;
  for (int s = 0; s < steps; ++s) {
    int32_t yy[kE], u[kE], v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      yy[e] = y[e];
      u[e] = x[e] ^ 0x33CC33;
      v[e] = y[e] ^ 0x0F0F0F;
    }
    for (int it = 0; it < k; ++it) {
      int32_t* cx = bx + p * bs;
      int32_t* cu = bu + p * bs;
      if (exchanges(ARM)) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          cx[t + e * T] = x[e];
          if (two_chains(ARM)) cu[t + e * T] = u[e];
        }
        __syncthreads();
        p ^= 1;
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int j = t + e * T;
        const int32_t xo = x[e], yo = yy[e];
        int32_t r = 0;
        if (exchanges(ARM) && !is_padded(ARM)) r = cx[wrapi(j - SH, n)];
        if (ARM == kRollvshift) r = cx[wrapi(j - 1, n)];
        if (ARM == kAdd || ARM == kTadd) {
          x[e] = wadd(xo, yo);
        } else if (ARM == kRoll || ARM == kJroll || ARM == kRoll3 ||
                   ARM == kRollSub || ARM == kTrollSub || ARM == kTroll3 ||
                   ARM == kConcatRot) {
          x[e] = r;
        } else if (ARM == kRolladd || ARM == kTrolladd || ARM == kTrolladd8 ||
                   ARM == kRolladd2 || ARM == kRollvshift) {
          x[e] = wadd(r, yo);
        } else if (ARM == kVshift1) {
          x[e] = wadd(cx[j + 1], yo);
        } else if (ARM == kVshift6) {
          int32_t acc = yo;
#pragma unroll
          for (int d = 1; d <= 6; ++d) acc = wadd(acc, cx[j + d]);
          x[e] = acc;
        } else if (ARM == kMix || ARM == kTmix) {
          x[e] = xo > yo ? (wadd(xo, r) >> 1) : wadd(r & kMask, yo);
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
        opaque(x[e]);
        opaque(yy[e]);
        if (two_chains(ARM)) {
          const int32_t uo = u[e];
          const int32_t ru = ARM == kRolladd2 ? cu[wrapi(j - 1, n)] : cu[j + 1];
          u[e] = wadd(ru, v[e]);
          v[e] = uo;
          opaque(u[e]);
          opaque(v[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int j = t + e * T;
      int32_t r = wadd(x[e], yy[e]);
      if (two_chains(ARM)) r = wadd(wadd(r, u[e]), v[e]);
      x[e] = r;
      if (SUB) {
        if (line < 128) out[((long long)s * kG + j) * 128 + line] = r;
      } else if (is_transposed(ARM)) {
        if (j < kG) {
          out[((long long)s * kG + j) * 128 + line] = r;
          if (line < 128 - kG) out[((long long)s * kG + j) * 128 + kG + line] = 0;
        }
      } else if (j < 128) {
        out[((long long)s * kG + line) * 128 + j] = r;
      }
    }
  }
}

// Permutation-matrix arms on z [r, 128], r = G*w/128 rows, each row its
// own chain z, wv = z @ m + wv, z.  A block owns a tile of 16 rows: z in
// shared memory (two buffers), wv in registers at the owning thread's
// output positions.  mma arms: warp q computes columns 16q..16q+15 (two
// n-tiles), its B fragments of m (given transposed, [n][k]) held in
// registers for the whole launch.  mmf32: thread (col, row parity) sums
// the 128 products of 8 rows in order, m row-major in shared memory.
// mmroll also runs the roll+add chain of input row blockIdx.x on its first
// w/8 threads and adds both parts into out (zeroed by the caller).
template <int ARM>
__global__ void __launch_bounds__(256)
mm_kernel(const int32_t* __restrict__ src, const void* __restrict__ mv,
          int32_t* __restrict__ out, int w, int k, int steps) {
  using Z = typename std::conditional<ARM == kMmint8, int8_t, float>::type;
  constexpr int ZW = 16 * 128;
  extern __shared__ __align__(16) unsigned char msm[];
  Z* zb = reinterpret_cast<Z*>(msm);  // [2][16][128]
  unsigned char* after = msm + 2 * ZW * sizeof(Z);
  float* mf = reinterpret_cast<float*>(after);  // mmf32: m [128][128]
  int32_t* xb = reinterpret_cast<int32_t*>(after);  // mmroll: [2][w]

  const int tid = threadIdx.x;
  const int r = kG * w / 128;
  const int tiles = (r + 15) / 16;
  const bool has_tile = blockIdx.x < tiles;
  const int row0 = blockIdx.x * 16;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;

  for (int i = tid; i < ZW; i += blockDim.x) {
    const int row = row0 + i / 128, c = i % 128;
    const int32_t zv = (row * 7 + c * 13) % 251;
    zb[i] = ARM == kMmint8 ? static_cast<Z>(wrap8(zv)) : static_cast<Z>(zv);
  }
  if (ARM == kMmf32)
    for (int i = tid; i < 128 * 128; i += blockDim.x)
      mf[i] = static_cast<const float*>(mv)[i];

  // This thread's output positions: 8 (row, col) pairs.
  int prow[8], pcol[8];
  if (ARM == kMmf32) {
#pragma unroll
    for (int q = 0; q < 8; ++q) { prow[q] = (tid >> 7) + 2 * q; pcol[q] = tid & 127; }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int nt = 2 * warp + (q >> 2);
      prow[q] = g + ((q & 2) ? 8 : 0);
      pcol[q] = nt * 8 + tig * 2 + (q & 1);
    }
  }
  float wvf[8];
  int32_t wvi[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int32_t v0 = ((row0 + prow[q]) * 11 + pcol[q] * 5) % 241;
    wvi[q] = wrap8(v0);
    wvf[q] = static_cast<float>(v0);
  }
  // B fragments: bf16 8 k-steps x 2 n-tiles, s8 4 x 2.
  uint32_t bfr[8][2][2];
  if (ARM == kMmbf16 || ARM == kMmroll || ARM == kMmint8) {
    const int nks = ARM == kMmint8 ? 4 : 8;
    const int kstep = ARM == kMmint8 ? 32 : 16;
    const int per = ARM == kMmint8 ? 4 : 2;  // k values per 32-bit word
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ks < nks) {
          const int n = (2 * warp + h) * 8 + g;
          const int kk = ks * kstep + tig * per;
          const int esz = ARM == kMmint8 ? 1 : 2;
          const unsigned char* base =
              static_cast<const unsigned char*>(mv) + ((long long)n * 128 + kk) * esz;
          bfr[ks][h][0] = ld32(base);
          bfr[ks][h][1] = ld32(base + (kstep / 2) * esz);
        }
      }
    }
  }

  // mmroll's line
  const int T = w / kE;
  const bool has_line = ARM == kMmroll && blockIdx.x < kG && tid < T;
  int32_t x[kE], y[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    x[e] = has_line ? src[(long long)blockIdx.x * w + tid + e * T] : 0;
    y[e] = x[e] ^ 0x55AA55;
  }
  __syncthreads();

  int p = 0;
  float zf[8];
  int32_t zi[8];
  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      const Z* zc = zb + p * ZW;
      Z* zn = zb + (p ^ 1) * ZW;
      int32_t* xc = xb + p * w;
      if (has_line) {
#pragma unroll
        for (int e = 0; e < kE; ++e) xc[tid + e * T] = x[e];
      }
      if (has_tile) {
        if (ARM == kMmf32) {
          float acc[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
          for (int i = 0; i < 128; ++i) {
            const float mval = mf[i * 128 + pcol[0]];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[q] = __fadd_rn(acc[q], __fmul_rn(zc[prow[q] * 128 + i], mval));
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) zf[q] = acc[q];
        } else if (ARM == kMmint8) {
          int32_t c[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int8_t* z8 = reinterpret_cast<const int8_t*>(zc);
            uint32_t a[4];
            a[0] = ld32(z8 + g * 128 + ks * 32 + tig * 4);
            a[1] = ld32(z8 + (g + 8) * 128 + ks * 32 + tig * 4);
            a[2] = ld32(z8 + g * 128 + ks * 32 + 16 + tig * 4);
            a[3] = ld32(z8 + (g + 8) * 128 + ks * 32 + 16 + tig * 4);
            mma_s8(c[0], a, bfr[ks][0][0], bfr[ks][0][1]);
            mma_s8(c[1], a, bfr[ks][1][0], bfr[ks][1][1]);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) zi[q] = c[q >> 2][q & 3];
        } else {
          float c[2][4] = {};
          const float* zz = reinterpret_cast<const float*>(zc);
#pragma unroll
          for (int ks = 0; ks < 8; ++ks) {
            const int k0 = ks * 16 + tig * 2;
            uint32_t a[4];
            a[0] = pack_bf16(zz[g * 128 + k0], zz[g * 128 + k0 + 1]);
            a[1] = pack_bf16(zz[(g + 8) * 128 + k0], zz[(g + 8) * 128 + k0 + 1]);
            a[2] = pack_bf16(zz[g * 128 + k0 + 8], zz[g * 128 + k0 + 9]);
            a[3] = pack_bf16(zz[(g + 8) * 128 + k0 + 8], zz[(g + 8) * 128 + k0 + 9]);
            mma_bf16(c[0], a, bfr[ks][0][0], bfr[ks][0][1]);
            mma_bf16(c[1], a, bfr[ks][1][0], bfr[ks][1][1]);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) zf[q] = c[q >> 2][q & 3];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int pos = prow[q] * 128 + pcol[q];
          if (ARM == kMmint8) {
            const int32_t old = zc[pos];
            zi[q] = wrap8(wadd(zi[q], wvi[q]));
            wvi[q] = old;
            zn[pos] = static_cast<Z>(zi[q]);
          } else {
            const float old = zc[pos];
            zf[q] = __fadd_rn(zf[q], wvf[q]);
            wvf[q] = old;
            zn[pos] = static_cast<Z>(zf[q]);
          }
        }
      }
      __syncthreads();
      if (has_line) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int32_t xo = x[e];
          x[e] = wadd(xc[wrapi(tid + e * T - 1, w)], y[e]);
          y[e] = xo;
        }
      }
      p ^= 1;
    }
    if (has_tile) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int row = row0 + prow[q];
        if (row < kG) {
          const int32_t v = ARM == kMmint8 ? zi[q] : __float2int_rz(zf[q]);
          int32_t* o = out + ((long long)s * kG + row) * 128 + pcol[q];
          if (ARM == kMmroll) atomicAdd(o, v); else *o = v;
        }
      }
    }
    if (has_line) {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (tid + e * T < 128)
          atomicAdd(out + ((long long)s * kG + blockIdx.x) * 128 + tid + e * T, x[e]);
    }
  }
}

// Kernel-step mocks.  A block owns input row i: its 5 box slabs a[5], the
// tap row b and b2, 8 elements of each a thread (max(w/8, 32) threads).
// Per iteration: the box's sub3 rotate tree and writeback on the 5 slabs
// (three exchanges), and the tap engine of row i: stepv 6 shifts of b read
// from shared memory; stepm / stepmbf the row's 128-column slabs as a
// [16, 128] matrix X (rows beyond w/128 zero) times m [128, 1536] on the
// tensor cores: in-slab blocks 0..5 from X, spill blocks 6..8 from X with
// rows rotated up one slab, 9..11 down one; tap ti = (block ti + spill
// block ti) & 0xFF.  m is given transposed ([1536][128]) in global memory.
template <int ARM>
__global__ void __launch_bounds__(256)
step_kernel(const int32_t* __restrict__ src, const void* __restrict__ mv,
            int32_t* __restrict__ out, int w, int k, int steps) {
  constexpr bool MM = ARM == kStepm || ARM == kStepmbf;
  extern __shared__ __align__(16) unsigned char ssm[];
  int32_t* ab = reinterpret_cast<int32_t*>(ssm);  // [2][5][w]
  int32_t* bb = ab + 10 * w;                        // [w]
  int32_t* ts = bb + w;                             // [w] tap sums
  unsigned char* xa = reinterpret_cast<unsigned char*>(ts + w);  // [16][128] s8 or bf16

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = w / kE;
  const bool own = tid < T;
  const int ns = w / 128;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
  const int nw = blockDim.x >> 5;

  int32_t a[5][kE], b[kE], b2[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int32_t v = own ? src[(long long)i * w + tid + e * T] : 0;
    const int32_t sd = v & 0xFF;
    a[0][e] = sd;
    a[1][e] = sd ^ 0x55;
    a[2][e] = (sd >> 1) & 0xFF;
    a[3][e] = sd ^ 0xA3;
    a[4][e] = (sd + 17) & 0xFF;
    b[e] = sd;
    b2[e] = (v >> 3) & 0xFF;
  }
  for (int q = tid; q < 16 * 128 * 2 / 4; q += blockDim.x)
    reinterpret_cast<uint32_t*>(xa)[q] = 0;
  __syncthreads();

  int p = 0;
  auto put = [&](const int32_t v[5][kE]) {
    if (own) {
#pragma unroll
      for (int q = 0; q < 5; ++q)
#pragma unroll
        for (int e = 0; e < kE; ++e) ab[(p * 5 + q) * w + tid + e * T] = v[q][e];
    }
  };
  auto get = [&](int q, int e, int sh) {
    return ab[(p * 5 + q) * w + wrapi(tid + e * T - sh, w)];
  };

  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      int32_t h[5][kE];
      // exchange 1: a, and b for the tap engine
      put(a);
      if (own) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int j = tid + e * T;
          if (ARM == kStepv) bb[j] = b[e];
          if (ARM == kStepm) xa[(j >> 7) * 128 + (j & 127)] = static_cast<unsigned char>(b[e] & 0xFF);
          if (ARM == kStepmbf)
            reinterpret_cast<__nv_bfloat16*>(xa)[(j >> 7) * 128 + (j & 127)] =
                __float2bfloat16_rn(static_cast<float>(b[e]));
        }
      }
      __syncthreads();
      if (own) {
#pragma unroll
        for (int q = 0; q < 5; ++q)
#pragma unroll
          for (int e = 0; e < kE; ++e) h[q][e] = wadd(a[q][e], get(q, e, 1));
        if (ARM == kStepv) {
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const int j = tid + e * T;
            int32_t acc = b2[e];
            acc = wadd(acc, bb[wrapi(j - 1, w)]);
            acc = wadd(acc, bb[wrapi(j - 2, w)]);
            acc = wadd(acc, bb[wrapi(j - 3, w)]);
            acc = wadd(acc, bb[wrapi(j + 1, w)]);
            acc = wadd(acc, bb[wrapi(j + 2, w)]);
            acc = wadd(acc, bb[wrapi(j + 3, w)]);
            b2[e] = b[e];
            b[e] = acc & 0xFF;
          }
        }
      }
      if (MM) {
        for (int nt = warp; nt < 16; nt += nw) {
          using C = typename std::conditional<ARM == kStepm, int32_t, float>::type;
          C cb[6][4] = {}, cs[6][4] = {};
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
      p ^= 1;
      // exchange 2: hb
      put(h);
      __syncthreads();
      if (own) {
#pragma unroll
        for (int q = 0; q < 5; ++q)
#pragma unroll
          for (int e = 0; e < kE; ++e) h[q][e] = wadd(h[q][e], get(q, e, 2));
        if (MM) {
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const int32_t acc = wadd(b2[e], ts[tid + e * T]);
            b2[e] = b[e];
            b[e] = acc & 0xFF;
          }
        }
      }
      p ^= 1;
      // exchange 3: hc
      put(h);
      __syncthreads();
      if (own) {
#pragma unroll
        for (int q = 0; q < 5; ++q)
#pragma unroll
          for (int e = 0; e < kE; ++e)
            a[q][e] = (wsub(wadd(h[q][e], get(q, e, 3)), a[q][e]) >> 4) & kMask;
      }
      p ^= 1;
    }
    if (own) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int j = tid + e * T;
        if (j < 128) out[((long long)s * kG + i) * 128 + j] = wadd(b[e], a[0][e]);
      }
    }
  }
}

// ---- K9: the step-isolation arms -----------------------------------------

enum IsoArm {
  kRoll2chz, kRamt, kHboxtree, kHboxsub, kHboxwb, kHboxfull, kRoll2ch,
  kHboxprod, kHboxk, kBigslab, kSlab3d, kSlab3d1, kUnroll, kFori, kBigshift,
  kSmallshift
};

// A block owns input row i: Q slabs of a and a2 (the 3-D arms' [q, i]
// rows, bigslab's rows q*G + i), b and b2; 256 threads x 8 elements cover
// W = 2048.  Every shift goes through shared memory (a: two buffers of Q
// lines, b: two of one line).
template <int Q>
__global__ void __launch_bounds__(256)
isolate_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
               int arm, int iota, int amount, int k, int steps) {
  constexpr int W = kIsoW;
  constexpr int S = 1920;  // hboxfull's clamp column
  extern __shared__ __align__(16) int32_t ism[];
  int32_t* ab = ism;              // [2][Q][W]
  int32_t* bb = ism + 2 * Q * W;  // [2][W]
  const int i = blockIdx.x;
  const int t = threadIdx.x;

  int32_t a[Q][kE], a2[Q][kE], b[kE], b2[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int j = t + e * 256;
    const int32_t sd = src[(long long)i * W + j] & 0xFF;
    b[e] = sd;
    b2[e] = sd ^ 0x55AA55;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (!iota) {
        a[q][e] = sd;
        a2[q][e] = sd ^ 0x55;
      } else if (Q == 5 && arm != kBigslab) {  // [5, G, W]: axis 1 is G
        a[q][e] = i % 251;
        a2[q][e] = q % 241;
      } else {  // [5G, W] or [G, W]: axis 1 is W
        a[q][e] = j % 251;
        a2[q][e] = (q * kG + i) % 241;
      }
    }
  }
  __syncthreads();

  int pa = 0, pb = 0;
  // r = v rolled by sh (r[j] = v[j - sh]) through shared memory.
  auto roll_a = [&](const int32_t v[Q][kE], int32_t r[Q][kE], int sh) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < kE; ++e) ab[(pa * Q + q) * W + t + e * 256] = v[q][e];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < kE; ++e) r[q][e] = ab[(pa * Q + q) * W + wrapi(t + e * 256 - sh, W)];
    pa ^= 1;
  };

  for (int s = 0; s < steps; ++s) {
    for (int it = 0; it < k; ++it) {
      int32_t r[Q][kE], h[Q][kE];
      switch (arm) {
        case kRoll2chz:
        case kRoll2ch:
          roll_a(a, r, 1);
          for (int q = 0; q < Q; ++q) for (int e = 0; e < kE; ++e) h[q][e] = wadd(a[q][e], r[q][e]);
          roll_a(h, r, 2);
          for (int q = 0; q < Q; ++q) for (int e = 0; e < kE; ++e) a[q][e] = wadd(h[q][e], r[q][e]);
          break;
        case kRamt:
          roll_a(a, r, amount);
          for (int q = 0; q < Q; ++q)
            for (int e = 0; e < kE; ++e) {
              const int32_t ao = a[q][e];
              a[q][e] = wadd(r[q][e], a2[q][e]);
              a2[q][e] = ao;
            }
          break;
        case kHboxtree:
        case kHboxsub:
        case kHboxwb:
        case kHboxprod:
        case kHboxk: {
          const bool fwd = arm == kHboxk;  // rolls 1, 2 (else -1, -2)
          roll_a(a, r, fwd ? 1 : -1);
          for (int q = 0; q < Q; ++q) for (int e = 0; e < kE; ++e) h[q][e] = wadd(a[q][e], r[q][e]);
          roll_a(h, r, fwd ? 2 : -2);
          for (int q = 0; q < Q; ++q) for (int e = 0; e < kE; ++e) h[q][e] = wadd(h[q][e], r[q][e]);
          roll_a(h, r, 3);
          for (int q = 0; q < Q; ++q)
            for (int e = 0; e < kE; ++e) {
              int32_t v = wadd(h[q][e], r[q][e]);
              if (arm == kHboxsub || arm == kHboxprod || arm == kHboxk) v = wsub(v, a[q][e]);
              if (arm == kHboxwb || arm == kHboxprod || arm == kHboxk) v = (v >> 4) & kMask;
              a[q][e] = v;
            }
          break;
        }
        case kHboxfull: {
          // the TPU kernel's _hbox7: b = a + rot(a, 1); c = b + rot(b, 2);
          // bulk = c + rot(c, -3) - a; columns < 3 and S-3..S-1 taken from
          // the box clamped at [0, S-1] (its 128-column edge slabs)
          int32_t edge[Q][kE];
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int e = 0; e < kE; ++e) ab[(pa * Q + q) * W + t + e * 256] = a[q][e];
          __syncthreads();
          for (int q = 0; q < Q; ++q)
            for (int e = 0; e < kE; ++e) {
              const int j = t + e * 256;
              const int32_t* line = ab + (pa * Q + q) * W;
              h[q][e] = wadd(a[q][e], line[wrapi(j + 1, W)]);
              int32_t sum = 0;
              if (j < 3 || (j >= S - 3 && j < S))
                for (int d = -3; d <= 3; ++d) sum = wadd(sum, line[min(max(j + d, 0), S - 1)]);
              edge[q][e] = sum;
            }
          pa ^= 1;
          roll_a(h, r, -2);
          for (int q = 0; q < Q; ++q) for (int e = 0; e < kE; ++e) h[q][e] = wadd(h[q][e], r[q][e]);
          roll_a(h, r, 3);
          for (int q = 0; q < Q; ++q)
            for (int e = 0; e < kE; ++e) {
              const int j = t + e * 256;
              int32_t v = wsub(wadd(h[q][e], r[q][e]), a[q][e]);
              if (j < 3 || (j >= S - 3 && j < S)) v = edge[q][e];
              a[q][e] = (v >> 4) & kMask;
            }
          break;
        }
        default:
          break;
      }
      if (arm == kBigslab || arm == kSlab3d || arm == kSlab3d1 || arm == kUnroll ||
          arm == kFori) {
        for (int d = 1; d <= (arm == kSlab3d1 ? 1 : 3); ++d) {
          roll_a(a, r, d);
          for (int q = 0; q < Q; ++q)
            for (int e = 0; e < kE; ++e) {
              const int32_t ao = a[q][e];
              a[q][e] = wadd(r[q][e], a2[q][e]);
              a2[q][e] = ao;
            }
        }
      }
      if (arm == kBigshift || arm == kUnroll || arm == kFori || arm == kSmallshift) {
#pragma unroll
        for (int e = 0; e < kE; ++e) bb[pb * W + t + e * 256] = b[e];
        __syncthreads();
        const int32_t* line = bb + pb * W;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int j = t + e * 256;
          int32_t acc = b2[e];
          if (arm == kSmallshift) {
            for (int d = 1; d <= 6; ++d) acc = wadd(acc, line[wrapi(j - d, W)]);
          } else {
            for (int d = 1; d <= 3; ++d) acc = wadd(acc, line[wrapi(j - d, W)]);
            for (int d = 1; d <= 3; ++d) acc = wadd(acc, line[wrapi(j + d, W)]);
          }
          b2[e] = b[e];
          b[e] = acc;
        }
        pb ^= 1;
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int j = t + e * 256;
      if (j < 128) out[((long long)s * kG + i) * 128 + j] = wadd(b[e], a[0][e]);
    }
  }
}

template <typename K>
cudaError_t launch(K kern, int grid, int threads, int smem, cudaStream_t st,
                   const int32_t* src, const void* m, int32_t* out, int w, int k,
                   int steps) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, st>>>(src, m, out, w, k, steps);
  return cudaGetLastError();
}

template <int ARM>
cudaError_t launch_line(cudaStream_t st, const int32_t* src, int32_t* out, int w, int k,
                        int steps) {
  const bool sub = ARM == kRollSub;
  const int n = sub ? kG : w;
  const int lpb = sub ? 8 : 1;
  const int threads = n / kE * lpb;
  const int smem = lpb * 4 * (n + 128) * 4;
  auto kern = line_kernel<ARM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<(sub ? w : kG) / lpb, threads, smem, st>>>(src, out, w, k, steps);
  return cudaGetLastError();
}

template <int ARM>
cudaError_t launch_mm(cudaStream_t st, const int32_t* src, const void* m, int32_t* out,
                      int w, int k, int steps) {
  const int tiles = (kG * w / 128 + 15) / 16;
  const int grid = ARM == kMmroll && tiles < kG ? kG : tiles;
  int smem = 2 * 16 * 128 * (ARM == kMmint8 ? 1 : 4);
  if (ARM == kMmf32) smem += 128 * 128 * 4;
  if (ARM == kMmroll) smem += 2 * w * 4;
  return launch(mm_kernel<ARM>, grid, 256, smem, st, src, m, out, w, k, steps);
}

template <int ARM>
cudaError_t launch_step(cudaStream_t st, const int32_t* src, const void* m, int32_t* out,
                        int w, int k, int steps) {
  const int smem = (10 * w + 2 * w) * 4 + 16 * 128 * 2;
  return launch(step_kernel<ARM>, kG, w / kE < 32 ? 32 : w / kE, smem, st, src, m, out, w, k, steps);
}

}  // namespace

extern "C" {

// K10: kept [H, S] (u8 = 1: uint8, else int32) -> out [steps, 1, S] int32.
int sno_probe_dynrow_launch(int u8, const void* kept, void* out, int H, int S, int steps,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (S + 255) / 256;
  if (u8)
    dynrow_kernel<uint8_t><<<grid, 256, 0, st>>>(static_cast<const uint8_t*>(kept),
                                                 static_cast<int32_t*>(out), H, S, steps);
  else
    dynrow_kernel<int32_t><<<grid, 256, 0, st>>>(static_cast<const int32_t*>(kept),
                                                 static_cast<int32_t*>(out), H, S, steps);
  return static_cast<int>(cudaGetLastError());
}

// K8: one arm (the Arm code) on src [120, w] int32 -> out [steps, 120, 128]
// int32 (zeroed by the caller for mmroll).  m: the permutation matrix for
// the mm and step arms (mmf32: f32 [128][128]; mmbf16 / mmroll / mmint8:
// bf16 / s8 transposed [128 n][128 k]; stepm / stepmbf: s8 / bf16
// transposed [1536 n][128 k]), else null.  w: a multiple of 128 <= 2048.
int sno_probe_calibrate_launch(int arm, const void* src_, const void* m, void* out_, int w,
                               int k, int steps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(src_);
  int32_t* out = static_cast<int32_t*>(out_);
  if (w % 128 || w < 128 || w > 2048) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (arm) {
#define SNO_LINE(A) case A: e = launch_line<A>(st, src, out, w, k, steps); break;
    SNO_LINE(kAdd) SNO_LINE(kRoll) SNO_LINE(kRoll3) SNO_LINE(kRollSub)
    SNO_LINE(kConcatRot) SNO_LINE(kJroll) SNO_LINE(kWhere) SNO_LINE(kShiftAnd)
    SNO_LINE(kMin) SNO_LINE(kMul) SNO_LINE(kMix) SNO_LINE(kTrollSub)
    SNO_LINE(kTroll3) SNO_LINE(kTadd) SNO_LINE(kTmix) SNO_LINE(kRolladd)
    SNO_LINE(kTrolladd) SNO_LINE(kTrolladd8) SNO_LINE(kVshift1)
    SNO_LINE(kVshift6) SNO_LINE(kRolladd2) SNO_LINE(kRollvshift)
#undef SNO_LINE
#define SNO_MM(A) case A: e = launch_mm<A>(st, src, m, out, w, k, steps); break;
    SNO_MM(kMmbf16) SNO_MM(kMmf32) SNO_MM(kMmint8) SNO_MM(kMmroll)
#undef SNO_MM
#define SNO_STEP(A) case A: e = launch_step<A>(st, src, m, out, w, k, steps); break;
    SNO_STEP(kStepv) SNO_STEP(kStepm) SNO_STEP(kStepmbf) SNO_STEP(kSteph)
#undef SNO_STEP
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// K9: one arm (the IsoArm code; iota 1 for the _iota seeds; amount the
// ramt shift, 0..2047) on src [120, 2048] int32 -> out [steps, 120, 128].
int sno_probe_isolate_launch(int arm, int iota, int amount, const void* src, void* out,
                             int k, int steps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool slab = !(arm == kBigshift || arm == kSmallshift);
  const int Q = slab ? 5 : 1;
  const int smem = (2 * Q * kIsoW + 2 * kIsoW) * 4;
  cudaError_t e;
  if (slab) {
    e = cudaFuncSetAttribute(isolate_kernel<5>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      isolate_kernel<5><<<kG, 256, smem, st>>>(static_cast<const int32_t*>(src),
                                               static_cast<int32_t*>(out), arm, iota,
                                               amount, k, steps);
  } else {
    e = cudaFuncSetAttribute(isolate_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      isolate_kernel<1><<<kG, 256, smem, st>>>(static_cast<const int32_t*>(src),
                                               static_cast<int32_t*>(out), arm, iota,
                                               amount, k, steps);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
