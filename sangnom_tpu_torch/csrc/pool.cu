// The shared-pool (pool_compat) kernels for NVIDIA Hopper (sm_90a).
//
// The reference smooths ONE luma-sized pool of 9 error maps, [9, P+1, S],
// for every plane of every frame, without clearing it between passes
// (reference src/SangNom2.cpp:265-272, 303-310).  A pass smooths pool rows
// b = 1..P-1 in place over the full stride S:
//   sm[b] = writeback(box7_S((sm[b-1] + pool[b]) + pool[b+1])), sm[0] = pool[0]
// with the box taps clamped at S and pool row P read but never written.
//
// Three kernels, each replacing one TPU kernel of sangnom_tpu/ops/pool_carry.py:
//   K3 pool_smooth_kernel via sno_pool_smooth_launch: the default pass's
//      smoothing (_smooth_rows_pallas / _pool_smooth_kernel), on the pool
//      in place;
//   K6 the same kernel via sno_pool_smooth_split3_launch: the smoothing on a
//      split carry (_smooth_rows_split3 / _pool_smooth_tail_kernel), row 0,
//      rows 1..P-1 ("body") and row P ("tail") in three buffers;
//   K7 pool_fused_kernel via sno_pool_fused_launch: a whole plane pass
//      (interp_field_pool_fused / _pool_fused_kernel): prepare, smoothing and
//      finalize in one walk over the split carry.
//
// What bounds them: the serial row walk.  A 1080 pass moves 75 MB (about
// 22 us at 3.35 TB/s) in 539 dependent row steps, so the time is the latency
// of one step times 539.  K3/K6 keep each step short: the 9 maps smooth
// independently, so one block walks one map (9 blocks at once); the input
// rows come from registers loaded D steps ahead; the line being summed lives
// in a double-buffered shared row, so a step has one block barrier; each
// thread reads and writes the pool only at its own columns, so smoothing in
// place needs no grid barrier.  K7 does the prepare and finalize of all 9
// maps inside the walk on one block, which lengthens every step.
//
// Exactness: the numerics of common.cuh; the vertical sum is
// (sm + row b) + row b+1 and the box strictly left to right.

#include "common.cuh"

namespace {

using namespace sno;

// Rows loaded ahead of the step that uses them.
template <int COLS>
struct Prefetch {
  static constexpr int kDepth = COLS >= 8 ? 2 : 8;
};

// K3/K6: one block per map; COLS columns per thread cover the S columns.
// Input row r of the walk (r = 0..n) is body row r for r < n and the tail
// for r == n; step t (0..n-1) writes the smoothed body row t.  Each buffer
// is [9, rows, S] with the given map stride (elements).
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
pool_smooth_kernel(const typename Ops<T, SSE2>::acc* row0,
                   typename Ops<T, SSE2>::acc* body,
                   const typename Ops<T, SSE2>::acc* tail, long long row0_ms,
                   long long body_ms, long long tail_ms, int n, int S) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int D = Prefetch<COLS>::kDepth;
  static_assert(D % 2 == 0, "the line buffer alternates with the step parity");
  extern __shared__ __align__(16) unsigned char smem[];
  A* line = reinterpret_cast<A*>(smem);  // [2][S]

  const int m = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const A* r0 = row0 + m * row0_ms;
  A* bd = body + m * body_ms;
  const A* tl = tail + m * tail_ms;
  auto input_row = [&](int r) -> const A* {
    return r < n ? bd + (long long)r * S : tl;
  };

  A h[COLS], cur[COLS], q[D][COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int c = tid + j * nt;
    h[j] = c < S ? r0[c] : A(0);   // the smoothed "row 0" seed
    cur[j] = c < S ? bd[c] : A(0);  // input row 0
  }
#pragma unroll
  for (int s = 1; s <= D; ++s) {
    if (s <= n) {
      const A* src = input_row(s);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tid + j * nt;
        q[s % D][j] = c < S ? src[c] : A(0);
      }
    }
  }

  for (int t0 = 0; t0 < n; t0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int t = t0 + s;
      if (t >= n) break;
      A* buf = line + (s & 1) * S;  // t and s share parity: D is even
      const int slot = (s + 1) % D;
      // Vertical 3-sum at own columns; input row t+1 leaves its slot.
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tid + j * nt;
        if (c < S) buf[c] = O::add(O::add(h[j], cur[j]), q[slot][j]);
        cur[j] = q[slot][j];
      }
      // Refill the slot with input row t+1+D.  It is read before this
      // thread overwrites it (step t+1+D), at this thread's columns only.
      if (t + 1 + D <= n) {
        const A* src = input_row(t + 1 + D);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int c = tid + j * nt;
          if (c < S) q[slot][j] = src[c];
        }
      }
      // One barrier: the other line buffer was last read in step t-1's box,
      // which every thread finished before reaching step t's barrier.
      __syncthreads();
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tid + j * nt;
        if (c < S) {
          h[j] = box_writeback<T, SSE2>(buf, c, S);
          bd[(long long)t * S + c] = h[j];
        }
      }
    }
  }
}

// K7: one block walks a whole plane pass over the split carry.
//   kept    [bufH_p, w] kept rows (storage type), bufH_p >= 2
//   interp  [bufH_p-1, w] output rows
//   row0    [9, S]; body [9, P-1, S], smoothed in place; tail [9, S]
// Step b = 1..P-1 reads pool row b as the raw maps of kept pair (b-1, b)
// where b <= R = bufH_p-1 and c < w, else the old body row (the stale shared
// pool); smooths it; and finalizes pair (b-1, b) into interp row b-1 where
// b <= R.  Shared memory: the smoothed row [9][S] and a 4-row ring of kept
// rows, as in deint.cu.
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
pool_fused_kernel(const T* __restrict__ kept, T* __restrict__ interp,
                  const typename Ops<T, SSE2>::acc* __restrict__ row0,
                  typename Ops<T, SSE2>::acc* __restrict__ body,
                  const typename Ops<T, SSE2>::acc* __restrict__ tail,
                  int bufH_p, int w, int P, int S,
                  typename Ops<T, SSE2>::acc aaf) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  extern __shared__ __align__(16) unsigned char smem[];
  A* sm = reinterpret_cast<A*>(smem);
  T* ring = reinterpret_cast<T*>(smem + sizeof(A) * (size_t)kMaps * S);

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int R = bufH_p - 1;
  const long long body_ms = (long long)(P - 1) * S;

  auto load_row = [&](int r) {
    const T* s = kept + (long long)r * w;
    T* slot = ring + (r & 3) * w;
    for (int c = tid; c < w; c += nt) slot[c] = s[c];
  };

  for (int i = tid; i < kMaps * S; i += nt) sm[i] = row0[i];
  for (int r = 0; r < 3 && r < bufH_p; ++r) load_row(r);
  __syncthreads();

  for (int b = 1; b < P; ++b) {
    const int t = b - 1;  // body index of pool row b
    const T* k0 = ring + ((b - 1) & 3) * w;
    const T* k1 = ring + (b & 3) * w;
    const T* k2 = ring + ((b + 1) & 3) * w;

    // Vertical 3-sum over own columns, in place: (sm + row b) + row b+1.
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * nt;
      if (c < S) {
        A rb[kMaps], rb1[kMaps];
        if (b <= R && c < w) {
          error_maps<T, SSE2>(k0, k1, c, w, rb);
        } else {
#pragma unroll
          for (int m = 0; m < kMaps; ++m) rb[m] = body[m * body_ms + (long long)t * S + c];
        }
        if (b + 1 <= R && c < w) {
          error_maps<T, SSE2>(k1, k2, c, w, rb1);
        } else if (b + 1 == P) {
#pragma unroll
          for (int m = 0; m < kMaps; ++m) rb1[m] = tail[m * S + c];
        } else {
#pragma unroll
          for (int m = 0; m < kMaps; ++m)
            rb1[m] = body[m * body_ms + (long long)(t + 1) * S + c];
        }
#pragma unroll
        for (int m = 0; m < kMaps; ++m) {
          A* p = sm + m * S + c;
          *p = O::add(O::add(*p, rb[m]), rb1[m]);
        }
      }
    }
    __syncthreads();

    // Every thread is past step b-1, so ring slot (b+2) % 4, last read as
    // row b-2, is free.
    if (b + 2 < bufH_p) load_row(b + 2);

    A h[COLS][kMaps];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * nt;
      if (c < S) {
#pragma unroll
        for (int m = 0; m < kMaps; ++m) h[j][m] = box_writeback<T, SSE2>(sm + m * S, c, S);
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * nt;
      if (c < S) {
#pragma unroll
        for (int m = 0; m < kMaps; ++m) {
          sm[m * S + c] = h[j][m];
          body[m * body_ms + (long long)t * S + c] = h[j][m];
        }
      }
      if (b <= R && c < w) {
        interp[(long long)(b - 1) * w + c] =
            static_cast<T>(finalize<T, SSE2>(k0, k1, c, w, h[j], aaf));
      }
    }
  }
}

template <typename T, bool SSE2, int COLS>
cudaError_t smooth(const void* row0, void* body, const void* tail,
                   long long row0_ms, long long body_ms, long long tail_ms,
                   int n, int S, int threads, int smem_bytes,
                   cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = pool_smooth_kernel<T, SSE2, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<kMaps, threads, smem_bytes, stream>>>(
      static_cast<const A*>(row0), static_cast<A*>(body),
      static_cast<const A*>(tail), row0_ms, body_ms, tail_ms, n, S);
  return cudaGetLastError();
}

template <typename T, bool SSE2, int COLS>
cudaError_t fused(const void* kept, void* interp, const void* row0,
                  void* body, const void* tail, int bufH_p, int w, int P,
                  int S, double aaf, int threads, int smem_bytes,
                  cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = pool_fused_kernel<T, SSE2, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<1, threads, smem_bytes, stream>>>(
      static_cast<const T*>(kept), static_cast<T*>(interp),
      static_cast<const A*>(row0), static_cast<A*>(body),
      static_cast<const A*>(tail), bufH_p, w, P, S, static_cast<A>(aaf));
  return cudaGetLastError();
}

// Dispatch on (dtype, sse2, cols) to F<T, SSE2, COLS>(args...).
// dtype: 0 uint8, 1 uint16, 2 float32; cols: 1, 4 or 8.
#define SNO_DISPATCH(F, ...)                                              \
  do {                                                                    \
    switch (dtype * 100 + (sse2 ? 10 : 0) + cols) {                      \
      case 1: return F<uint8_t, false, 1>(__VA_ARGS__);                   \
      case 4: return F<uint8_t, false, 4>(__VA_ARGS__);                   \
      case 8: return F<uint8_t, false, 8>(__VA_ARGS__);                   \
      case 11: return F<uint8_t, true, 1>(__VA_ARGS__);                   \
      case 14: return F<uint8_t, true, 4>(__VA_ARGS__);                   \
      case 18: return F<uint8_t, true, 8>(__VA_ARGS__);                   \
      case 101: return F<uint16_t, false, 1>(__VA_ARGS__);                \
      case 104: return F<uint16_t, false, 4>(__VA_ARGS__);                \
      case 108: return F<uint16_t, false, 8>(__VA_ARGS__);                \
      case 111: return F<uint16_t, true, 1>(__VA_ARGS__);                 \
      case 114: return F<uint16_t, true, 4>(__VA_ARGS__);                 \
      case 118: return F<uint16_t, true, 8>(__VA_ARGS__);                 \
      case 201: return F<float, false, 1>(__VA_ARGS__);                   \
      case 204: return F<float, false, 4>(__VA_ARGS__);                   \
      case 208: return F<float, false, 8>(__VA_ARGS__);                   \
      default: return cudaErrorInvalidValue;                              \
    }                                                                     \
  } while (0)

cudaError_t smooth_any(int dtype, int sse2, int cols, const void* row0,
                       void* body, const void* tail, long long row0_ms,
                       long long body_ms, long long tail_ms, int n, int S,
                       int threads, int smem_bytes, cudaStream_t stream) {
  SNO_DISPATCH(smooth, row0, body, tail, row0_ms, body_ms, tail_ms, n, S,
               threads, smem_bytes, stream);
}

cudaError_t fused_any(int dtype, int sse2, int cols, const void* kept,
                      void* interp, const void* row0, void* body,
                      const void* tail, int bufH_p, int w, int P, int S,
                      double aaf, int threads, int smem_bytes,
                      cudaStream_t stream) {
  SNO_DISPATCH(fused, kept, interp, row0, body, tail, bufH_p, w, P, S, aaf,
               threads, smem_bytes, stream);
}

#undef SNO_DISPATCH

}  // namespace

extern "C" {

// K3: smooths pool rows 1..P-1 of a contiguous [9, P+1, S] pool in place.
// Returns the cudaError_t of the launch.  sse2 is ignored for float.
int sno_pool_smooth_launch(int dtype, int sse2, int cols, void* pool, int P,
                           int S, int threads, int smem_bytes, void* stream) {
  char* base = static_cast<char*>(pool);
  const size_t elem = 4;  // int32 or float32 accumulators
  const long long ms = (long long)(P + 1) * S;
  return static_cast<int>(smooth_any(
      dtype, dtype == 2 ? 0 : sse2, cols, base, base + elem * S,
      base + elem * (size_t)P * S, ms, ms, ms, P - 1, S, threads, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

// K6: the same smoothing on the split carry: row0 [9, S], body [9, P-1, S]
// (smoothed in place), tail [9, S], each contiguous.
int sno_pool_smooth_split3_launch(int dtype, int sse2, int cols,
                                  const void* row0, void* body,
                                  const void* tail, int P, int S, int threads,
                                  int smem_bytes, void* stream) {
  return static_cast<int>(smooth_any(
      dtype, dtype == 2 ? 0 : sse2, cols, row0, body, tail, S,
      (long long)(P - 1) * S, S, P - 1, S, threads, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

// K7: one fused plane pass over the split carry; interp [bufH_p-1, w].
int sno_pool_fused_launch(int dtype, int sse2, int cols, const void* kept,
                          void* interp, const void* row0, void* body,
                          const void* tail, int bufH_p, int w, int P, int S,
                          double aaf, int threads, int smem_bytes,
                          void* stream) {
  return static_cast<int>(fused_any(
      dtype, dtype == 2 ? 0 : sse2, cols, kept, interp, row0, body, tail,
      bufH_p, w, P, S, aaf, threads, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
