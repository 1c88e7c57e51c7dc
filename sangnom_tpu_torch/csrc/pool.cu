// The shared-pool (pool_compat) kernels for NVIDIA Hopper (sm_90a).
//
// The reference smooths ONE luma-sized pool of 9 error maps, [9, P+1, S],
// for every plane of every frame, without clearing it between passes
// (reference src/SangNom2.cpp:265-272, 303-310).  A pass prepares the raw
// maps of its kept pairs into pool rows 1..R (R = kept rows - 1), columns
// 0..w-1; smooths pool rows b = 1..P-1 in place over the full stride S:
//   sm[b] = writeback(box7_S((sm[b-1] + pool[b]) + pool[b+1])), sm[0] = pool[0]
// with the box taps clamped at S and pool row P read but never written; and
// finalizes its interpolated rows from pool rows 1..R.
//
// The kernels, replacing the TPU kernels of sangnom_tpu/ops/pool_carry.py:
//   K3 pool_smooth_kernel via sno_pool_smooth_launch: the default pass's
//      smoothing (_smooth_rows_pallas / _pool_smooth_kernel), on the pool
//      in place;
//   K6 the same kernel via sno_pool_smooth_split3_launch: the smoothing on a
//      split carry (_smooth_rows_split3 / _pool_smooth_tail_kernel), row 0,
//      rows 1..P-1 ("body") and row P ("tail") in three buffers;
//   K7 a whole plane pass (interp_field_pool_fused / _pool_fused_kernel) as
//      three launches on one stream: pool_prepare_kernel
//      (sno_pool_prepare_launch), the K6 walk, pool_finalize_kernel
//      (sno_pool_finalize_launch).  Prepare reads only kept rows and
//      finalize only kept rows and finished smoothed rows, so both run
//      fully parallel over (row, column) and leave the serial walk; on the
//      TPU, in-kernel prepare and finalize lengthened every row step
//      (sangnom_tpu/ops/pool_carry.py:156-162), and so they did here.
//
// What bounds them.  The walk: a 1080 pass moves 75 MB (about 22 us at
// 3.35 TB/s) in 539 dependent row steps, so its time is the latency of one
// step times 539.  The 9 maps smooth independently, so one block walks one
// map (9 blocks at once).  A thread owns COLS contiguous columns; the input
// rows come from registers loaded D steps ahead; the line being summed lives
// in a double-buffered shared row with kPad pad columns on the left and
// replicated values past S (common.cuh), so a step has one block barrier and
// the box sums come from one vector window per thread; each thread reads
// and writes the pool only at its own columns, so smoothing in place needs
// no grid barrier.  Prepare and finalize: bytes (9 int32 maps a pixel,
// about 37 MB each at a 1080 luma pass).
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

// Elements of a shared line row: kPad pads, S columns, and room for the
// last group's window past S; a multiple of 4 keeps rows 16-byte aligned.
__host__ __device__ inline int line_pitch(int S, int cols) {
  return (S + cols + 8 + 3) / 4 * 4;
}

// K3/K6: one block per map; thread t owns columns c0 = t*COLS ..
// c0+COLS-1 of the S columns.  Input row r of the walk (r = 0..n) is body
// row r for r < n and the tail for r == n; step t (0..n-1) writes the
// smoothed body row t.  Each buffer is [9, rows, S] with the given map
// stride (elements).
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
pool_smooth_kernel(const typename Ops<T, SSE2>::acc* row0,
                   typename Ops<T, SSE2>::acc* body,
                   const typename Ops<T, SSE2>::acc* tail, long long row0_ms,
                   long long body_ms, long long tail_ms, int n, int S) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int D = Prefetch<COLS>::kDepth;
  constexpr int kGrp = group_align<A, COLS, 0>();
  static_assert(D % 2 == 0, "the line buffer alternates with the step parity");
  static_assert(kGrp > 0, "4-byte accumulators give word access");
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = line_pitch(S, COLS);
  A* line = reinterpret_cast<A*>(smem);  // [2][pitch], column 0 at kPad

  const int m = blockIdx.x;
  const int c0 = threadIdx.x * COLS;
  const bool active = c0 < S;
  const A* r0 = row0 + m * row0_ms;
  A* bd = body + m * body_ms;
  const A* tl = tail + m * tail_ms;
  // Word access to device memory where the group is whole and every row it
  // touches starts aligned; else element access up to column S-1.
  const bool vec = c0 + COLS <= S && (S * sizeof(A)) % kGrp == 0 &&
                   ((reinterpret_cast<uintptr_t>(r0) | reinterpret_cast<uintptr_t>(bd) |
                     reinterpret_cast<uintptr_t>(tl)) % kGrp) == 0;
  auto input_row = [&](int r) -> const A* {
    return r < n ? bd + (long long)r * S : tl;
  };
  auto gload = [&](const A* row, A (&x)[COLS]) {
    if (vec) {
      load_elems<A, COLS, kGrp>(row + c0, x);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) x[j] = c0 + j < S ? row[c0 + j] : A(0);
    }
  };

  A h[COLS], cur[COLS], q[D][COLS];
  gload(r0, h);   // the smoothed "row 0" seed
  gload(bd, cur);  // input row 0
#pragma unroll
  for (int s = 1; s <= D; ++s)
    if (s <= n) gload(input_row(s), q[s % D]);

  for (int t0 = 0; t0 < n; t0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int t = t0 + s;
      if (t >= n) break;
      A* buf = line + (s & 1) * pitch + kPad;  // t and s share parity: D is even
      const int slot = (s + 1) % D;
      // Vertical 3-sum at own columns; input row t+1 leaves its slot.
      if (active) {
        A v[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) v[j] = O::add(O::add(h[j], cur[j]), q[slot][j]);
        store_group_padded<A, COLS>(buf, c0, S, v);
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) cur[j] = q[slot][j];
      // Refill the slot with input row t+1+D.  It is read before this
      // thread overwrites it (step t+1+D), at this thread's columns only.
      if (t + 1 + D <= n) gload(input_row(t + 1 + D), q[slot]);
      // One barrier: the other line buffer was last read in step t-1's box,
      // which every thread finished before reaching step t's barrier.
      __syncthreads();
      if (active) {
        box_window<T, SSE2, COLS>(buf, c0, h);
        A* out = bd + (long long)t * S;
        if (vec) {
          store_elems<A, COLS, kGrp>(out + c0, h);
        } else {
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            if (c0 + j < S) out[c0 + j] = h[j];
        }
      }
    }
  }
}

// K7 prepare: the raw maps of kept pair (t, t+1) into body row t (pool row
// t+1), t = 0..R-1, columns 0..w-1.  kept row r is at kept + r*pitch_k.
template <typename T, bool SSE2>
__global__ void pool_prepare_kernel(const T* __restrict__ kept,
                                    typename Ops<T, SSE2>::acc* __restrict__ body,
                                    long long pitch_k, long long body_ms, int R,
                                    int w, int S) {
  using A = typename Ops<T, SSE2>::acc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= w) return;
  for (int t = blockIdx.y; t < R; t += gridDim.y) {
    const T* top = kept + t * pitch_k;
    A mp[kMaps];
    error_maps<T, SSE2>(top, top + pitch_k, c, w, mp);
    A* out = body + (long long)t * S + c;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) out[m * body_ms] = mp[m];
  }
}

// K7 finalize: interp row t (t = 0..R-1) from kept pair (t, t+1) and the
// smoothed maps in body row t, columns 0..w-1; interp is [R, w].
template <typename T, bool SSE2>
__global__ void pool_finalize_kernel(const T* __restrict__ kept,
                                     const typename Ops<T, SSE2>::acc* __restrict__ body,
                                     T* __restrict__ interp, long long pitch_k,
                                     long long body_ms, int R, int w, int S,
                                     typename Ops<T, SSE2>::acc aaf) {
  using A = typename Ops<T, SSE2>::acc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= w) return;
  for (int t = blockIdx.y; t < R; t += gridDim.y) {
    const T* top = kept + t * pitch_k;
    const A* src = body + (long long)t * S + c;
    A sm[kMaps];
#pragma unroll
    for (int m = 0; m < kMaps; ++m) sm[m] = src[m * body_ms];
    interp[(long long)t * w + c] =
        static_cast<T>(finalize<T, SSE2>(top, top + pitch_k, c, w, sm, aaf));
  }
}

constexpr int kRowThreads = 256;  // threads a block of the prepare and finalize grids

dim3 row_grid(int R, int w) {
  return dim3((w + kRowThreads - 1) / kRowThreads, R < 65535 ? R : 65535);
}

template <typename T, bool SSE2, int COLS>
cudaError_t smooth(const void* row0, void* body, const void* tail,
                   long long row0_ms, long long body_ms, long long tail_ms,
                   int n, int S, int threads, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = pool_smooth_kernel<T, SSE2, COLS>;
  const int smem_bytes = 2 * line_pitch(S, COLS) * static_cast<int>(sizeof(A));
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<kMaps, threads, smem_bytes, stream>>>(
      static_cast<const A*>(row0), static_cast<A*>(body),
      static_cast<const A*>(tail), row0_ms, body_ms, tail_ms, n, S);
  return cudaGetLastError();
}

template <typename T, bool SSE2, int COLS>
cudaError_t prepare(const void* kept, void* body, long long pitch_k, int P,
                    int R, int w, int S, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  pool_prepare_kernel<T, SSE2><<<row_grid(R, w), kRowThreads, 0, stream>>>(
      static_cast<const T*>(kept), static_cast<A*>(body), pitch_k,
      (long long)(P - 1) * S, R, w, S);
  return cudaGetLastError();
}

template <typename T, bool SSE2, int COLS>
cudaError_t finalize_rows(const void* kept, const void* body, void* interp,
                          long long pitch_k, int P, int R, int w, int S,
                          double aaf, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  pool_finalize_kernel<T, SSE2><<<row_grid(R, w), kRowThreads, 0, stream>>>(
      static_cast<const T*>(kept), static_cast<const A*>(body),
      static_cast<T*>(interp), pitch_k, (long long)(P - 1) * S, R, w, S,
      static_cast<A>(aaf));
  return cudaGetLastError();
}

// Dispatch on (dtype, sse2, cols) to F<T, SSE2, COLS>(args...).
// dtype: 0 uint8, 1 uint16, 2 float32; cols: 1, 4 or 8 (the prepare and
// finalize kernels take cols 1).
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
                       int threads, cudaStream_t stream) {
  SNO_DISPATCH(smooth, row0, body, tail, row0_ms, body_ms, tail_ms, n, S,
               threads, stream);
}

cudaError_t prepare_any(int dtype, int sse2, const void* kept, void* body,
                        long long pitch_k, int P, int R, int w, int S,
                        cudaStream_t stream) {
  const int cols = 1;
  SNO_DISPATCH(prepare, kept, body, pitch_k, P, R, w, S, stream);
}

cudaError_t finalize_any(int dtype, int sse2, const void* kept,
                         const void* body, void* interp, long long pitch_k,
                         int P, int R, int w, int S, double aaf,
                         cudaStream_t stream) {
  const int cols = 1;
  SNO_DISPATCH(finalize_rows, kept, body, interp, pitch_k, P, R, w, S, aaf,
               stream);
}

#undef SNO_DISPATCH

}  // namespace

extern "C" {

// K3: smooths pool rows 1..P-1 of a contiguous [9, P+1, S] pool in place.
// Returns the cudaError_t of the launch.  sse2 is ignored for float.
int sno_pool_smooth_launch(int dtype, int sse2, int cols, void* pool, int P,
                           int S, int threads, void* stream) {
  char* base = static_cast<char*>(pool);
  const size_t elem = 4;  // int32 or float32 accumulators
  const long long ms = (long long)(P + 1) * S;
  return static_cast<int>(smooth_any(
      dtype, dtype == 2 ? 0 : sse2, cols, base, base + elem * S,
      base + elem * (size_t)P * S, ms, ms, ms, P - 1, S, threads,
      static_cast<cudaStream_t>(stream)));
}

// K6 (and the walk of a K7 pass): the same smoothing on the split carry:
// row0 [9, S], body [9, P-1, S] (smoothed in place), tail [9, S], each
// contiguous.
int sno_pool_smooth_split3_launch(int dtype, int sse2, int cols,
                                  const void* row0, void* body,
                                  const void* tail, int P, int S, int threads,
                                  void* stream) {
  return static_cast<int>(smooth_any(
      dtype, dtype == 2 ? 0 : sse2, cols, row0, body, tail, S,
      (long long)(P - 1) * S, S, P - 1, S, threads,
      static_cast<cudaStream_t>(stream)));
}

// K7 prepare: kept rows r = 0..R (row r at kept + r*pitch_k elements, w
// columns) -> raw maps in rows 0..R-1, columns 0..w-1, of the contiguous
// body [9, P-1, S].
int sno_pool_prepare_launch(int dtype, int sse2, const void* kept, void* body,
                            long long pitch_k, int P, int R, int w, int S,
                            void* stream) {
  return static_cast<int>(prepare_any(dtype, dtype == 2 ? 0 : sse2, kept,
                                      body, pitch_k, P, R, w, S,
                                      static_cast<cudaStream_t>(stream)));
}

// K7 finalize: the same kept rows and the smoothed body -> interp [R, w].
int sno_pool_finalize_launch(int dtype, int sse2, const void* kept,
                             const void* body, void* interp, long long pitch_k,
                             int P, int R, int w, int S, double aaf,
                             void* stream) {
  return static_cast<int>(finalize_any(dtype, dtype == 2 ? 0 : sse2, kept,
                                       body, interp, pitch_k, P, R, w, S, aaf,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
