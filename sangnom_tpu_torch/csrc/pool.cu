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
//   The frame-parallel pool pass (the TPU package's fast path,
//      interp_field_pool_tm_batch, which folds K frames' pools into K3's
//      walk, sangnom_tpu/ops/pool_carry.py:770 -> _smooth_rows_pallas :528):
//      K frames that each own a pool [9, P+1, S] (fresh zeros; rows 0 and P
//      never written) take the same three kernels over a contiguous batch:
//      the walk over 9K maps, one block a map (sno_pool_smooth_batch_launch),
//      and prepare and finalize with a frame axis in their grid
//      (sno_pool_prepare_batch_launch, sno_pool_finalize_batch_launch).
//      A 1080 walk is 9K blocks of 480 threads on 132 SMs; the serial steps
//      stay 539, now shared by K frames.
//   The wide walk (the same kernel, WIDE true, via sno_pool_wide_launch):
//      K3, K6 and the batched walk on a pool past one block's columns, a
//      map's row split over the blocks of a thread-block cluster.
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

#include "cluster.cuh"

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

// The walk: K3/K6, the batched walk and, with WIDE, the wide walk.  Input
// row r of the walk (r = 0..n) is row r of `in` for r < n and the tail for
// r == n; step t writes the smoothed body row t.  Each buffer is
// [maps, rows, S] with the given map stride (elements).  Thread t owns
// columns c0 = t*COLS .. c0+COLS-1 of its block's columns.
//
// WIDE false (a row within one block): one block a map, steps 0..n-1 in
// one launch, seeded by row0, in place (`in` is the body); the arguments
// after S are not read.
//
// WIDE true (a map's row past one block's columns, cluster.cuh): block
// (m, q), q fastest, walks map m's shard q of W_loc columns plus a halo of
// H = 3R columns on each inner side over steps base..base+steps-1 and
// writes its own columns; the seed is row0 at base 0, else body row
// base-1.
//   cluster_mode: the n_blk blocks of a map form a cluster, in == body, one
//   launch walks every step, and the carried row's halo comes from the
//   neighbours' shared memory every R steps.  A block also reads the raw
//   rows at its halo columns from the pool, where the neighbour writes its
//   smoothed rows in place; it reads row r in step r-1-D (D rows ahead) or
//   before its first step, and the neighbour writes row r in step r.  With
//   R <= D+1 (the launcher refuses more) a cluster barrier lies between the
//   two (after steps R-1, 2R-1, ..., and one before step 0), so every raw
//   value is read before it is overwritten.
//   chunk mode (a row of more blocks than a cluster holds): one launch a
//   chunk of at most R steps, no exchange, `in` a copy of the body's raw
//   rows that no launch writes; the seed row comes through device memory.
// Shared memory: the line [2][pitch], then in cluster mode the exchange
// buffer [2][2][H].
template <typename T, bool SSE2, int COLS, bool WIDE>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
pool_smooth_kernel(const typename Ops<T, SSE2>::acc* row0,
                   const typename Ops<T, SSE2>::acc* in,
                   typename Ops<T, SSE2>::acc* body,
                   const typename Ops<T, SSE2>::acc* tail, long long row0_ms,
                   long long in_ms, long long body_ms, long long tail_ms, int n, int S,
                   int n_blk, int W_loc, int H, int R, int base, int steps, int pitch,
                   int cluster_mode) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int D = Prefetch<COLS>::kDepth;
  constexpr int kGrp = group_align<A, COLS, 0>();
  static_assert(D % 2 == 0, "the line buffer alternates with the step parity");
  static_assert(kGrp > 0, "4-byte accumulators give word access");
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (!WIDE) {
    pitch = line_pitch(S, COLS);
    base = 0;
    steps = n;
  }
  A* line = reinterpret_cast<A*>(smem);  // [2][pitch], column 0 at kPad

  const int m = WIDE ? blockIdx.x / n_blk : blockIdx.x;
  const Span sp = WIDE ? span_of(blockIdx.x - m * n_blk, W_loc, H, S) : Span{0, S, 0, S};
  const int c0 = threadIdx.x * COLS;
  const bool active = c0 < sp.W_c;
  A* bd = body + m * body_ms + sp.g0;
  const A* src = WIDE ? in + m * in_ms + sp.g0 : bd;
  const A* tl = tail + m * tail_ms + sp.g0;
  const A* seed = base == 0 ? row0 + m * row0_ms + sp.g0 : bd + (long long)(base - 1) * S;
  // Word access to device memory where the group is whole and every row it
  // touches starts aligned; else element access up to the block's last
  // column.
  const bool vec = c0 + COLS <= sp.W_c && (S * sizeof(A)) % kGrp == 0 &&
                   ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(bd) |
                     reinterpret_cast<uintptr_t>(tl) | reinterpret_cast<uintptr_t>(seed)) %
                    kGrp) == 0;
  auto input_row = [&](int r) -> const A* {
    return r < n ? src + (long long)r * S : tl;
  };
  auto gload = [&](const A* row, A (&x)[COLS]) {
    if (vec) {
      load_elems<A, COLS, kGrp>(row + c0, x);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) x[j] = c0 + j < sp.W_c ? row[c0 + j] : A(0);
    }
  };

  A h[1][COLS], cur[COLS], pf[D][COLS];
  gload(seed, h[0]);             // the smoothed seed row
  gload(input_row(base), cur);   // the step's first input row
#pragma unroll
  for (int s = 1; s <= D; ++s)
    if (s <= steps) gload(input_row(base + s), pf[s % D]);
  const bool exchange = WIDE && cluster_mode && n_blk > 1;
  if constexpr (WIDE) {
    // No block overwrites a row before every block of the map has read the
    // rows it loaded ahead.
    if (exchange) cg::this_cluster().sync();
  }

  int n_exch = 0;
  for (int t0 = 0; t0 < steps; t0 += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int t = t0 + s;
      if (t >= steps) break;
      A* buf = line + (s & 1) * pitch + kPad;  // t and s share parity: D is even
      const int slot = (s + 1) % D;
      // Vertical 3-sum at own columns; input row t+1 leaves its slot.
      if (active) {
        A v[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) v[j] = O::add(O::add(h[0][j], cur[j]), pf[slot][j]);
        store_group_padded<A, COLS>(buf, c0, sp.W_c, v);
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) cur[j] = pf[slot][j];
      // Refill the slot with input row t+1+D.  It is read before this
      // thread overwrites it (step t+1+D), at this thread's columns only.
      if (t + 1 + D <= steps) gload(input_row(base + t + 1 + D), pf[slot]);
      // One barrier: the other line buffer was last read in step t-1's box,
      // which every thread finished before reaching step t's barrier.
      __syncthreads();
      if (active) {
        box_window<T, SSE2, COLS>(buf, c0, h[0]);
        A* out = bd + (long long)(base + t) * S;
        if (vec && (!WIDE || (c0 >= sp.cl && c0 + COLS <= sp.cr))) {
          store_elems<A, COLS, kGrp>(out + c0, h[0]);
        } else {
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            if (c0 + j >= sp.cl && c0 + j < sp.cr) out[c0 + j] = h[0][j];
        }
      }
      if constexpr (WIDE) {
        if (exchange && (t + 1) % R == 0 && t + 1 < steps) {
          exchange_halo<A, 1, COLS>(line + 2 * pitch + (n_exch & 1) * 2 * H, sp, H, c0, h);
          ++n_exch;
        }
      }
    }
  }
  if constexpr (WIDE) {
    // No block leaves while a neighbour may still read its shared memory.
    if (exchange && n_exch > 0) cg::this_cluster().sync();
  }
}

// K7 prepare: the raw maps of kept pair (t, t+1) into body row t (pool row
// t+1), t = 0..R-1, columns 0..w-1.  kept row r of frame k (blockIdx.z) is at
// kept + k*kept_fs + r*pitch_k, its body at body + k*9*body_ms.
template <typename T, bool SSE2>
__global__ void pool_prepare_kernel(const T* __restrict__ kept,
                                    typename Ops<T, SSE2>::acc* __restrict__ body,
                                    long long kept_fs, long long pitch_k,
                                    long long body_ms, int R, int w, int S) {
  using A = typename Ops<T, SSE2>::acc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= w) return;
  kept += blockIdx.z * kept_fs;
  body += blockIdx.z * kMaps * body_ms;
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
// smoothed maps in body row t, columns 0..w-1; frame k's (blockIdx.z)
// interp is [R, w] at interp + k*interp_fs.
template <typename T, bool SSE2>
__global__ void pool_finalize_kernel(const T* __restrict__ kept,
                                     const typename Ops<T, SSE2>::acc* __restrict__ body,
                                     T* __restrict__ interp, long long kept_fs,
                                     long long pitch_k, long long interp_fs,
                                     long long body_ms, int R, int w, int S,
                                     typename Ops<T, SSE2>::acc aaf) {
  using A = typename Ops<T, SSE2>::acc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= w) return;
  kept += blockIdx.z * kept_fs;
  body += blockIdx.z * kMaps * body_ms;
  interp += blockIdx.z * interp_fs;
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

// One block of kRowThreads columns a (row, frame); rows past 65535 loop.
dim3 row_grid(int R, int w, int frames) {
  return dim3((w + kRowThreads - 1) / kRowThreads, R < 65535 ? R : 65535, frames);
}

template <typename T, bool SSE2, int COLS>
int smooth_smem_bytes(int S) {
  return 2 * line_pitch(S, COLS) * static_cast<int>(sizeof(typename Ops<T, SSE2>::acc));
}

// The walk over `maps` maps, one block each (9 for a pool, 9K for a batch).
template <typename T, bool SSE2, int COLS>
cudaError_t smooth(const void* row0, void* body, const void* tail,
                   long long row0_ms, long long body_ms, long long tail_ms,
                   int maps, int n, int S, int threads, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = pool_smooth_kernel<T, SSE2, COLS, false>;
  const int smem_bytes = smooth_smem_bytes<T, SSE2, COLS>(S);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<maps, threads, smem_bytes, stream>>>(
      static_cast<const A*>(row0), static_cast<const A*>(body), static_cast<A*>(body),
      static_cast<const A*>(tail), row0_ms, body_ms, body_ms, tail_ms, n, S, 1, S, 0,
      0, 0, n, 0, 0);
  return cudaGetLastError();
}

// Resident walk blocks an SM at this launch shape.
template <typename T, bool SSE2, int COLS>
cudaError_t smooth_occupancy(int S, int threads, int* blocks) {
  auto kern = pool_smooth_kernel<T, SSE2, COLS, false>;
  const int smem_bytes = smooth_smem_bytes<T, SSE2, COLS>(S);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads,
                                                       smem_bytes);
}

// The wide walk over `maps` maps, n_blk blocks each: a cluster of n_blk
// blocks a map (cluster_mode 1) or a chunk of steps (0).  Returns the
// cudaError_t of the launch, or kNoCluster; cudaErrorInvalidValue for a
// cluster that exchanges less often than every D + 1 rows (see the kernel).
template <typename T, bool SSE2, int COLS>
int wide(const void* row0, const void* in, void* body, const void* tail,
         long long row0_ms, long long in_ms, long long body_ms, long long tail_ms,
         int maps, int n_blk, int n, int S, int W_loc, int H, int R, int base,
         int steps, int pitch, int cluster_mode, int threads, int smem,
         cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  if (cluster_mode && R > Prefetch<COLS>::kDepth + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_ex(pool_smooth_kernel<T, SSE2, COLS, true>, maps * n_blk, threads, smem,
                   cluster_mode ? n_blk : 1, stream, static_cast<const A*>(row0),
                   static_cast<const A*>(in), static_cast<A*>(body),
                   static_cast<const A*>(tail), row0_ms, in_ms, body_ms, tail_ms, n, S,
                   n_blk, W_loc, H, R, base, steps, pitch, cluster_mode);
}

// The wide walk's build at this shape: out[4] as query_kernel (cluster.cuh).
template <typename T, bool SSE2, int COLS>
int wide_query(int threads, int smem, int cluster, int* out) {
  return query_kernel(pool_smooth_kernel<T, SSE2, COLS, true>, threads, smem, cluster, out);
}

template <typename T, bool SSE2, int COLS>
cudaError_t prepare(const void* kept, void* body, long long kept_fs,
                    long long pitch_k, int frames, int P, int R, int w, int S,
                    cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  pool_prepare_kernel<T, SSE2><<<row_grid(R, w, frames), kRowThreads, 0, stream>>>(
      static_cast<const T*>(kept), static_cast<A*>(body), kept_fs, pitch_k,
      (long long)(P - 1) * S, R, w, S);
  return cudaGetLastError();
}

template <typename T, bool SSE2, int COLS>
cudaError_t finalize_rows(const void* kept, const void* body, void* interp,
                          long long kept_fs, long long pitch_k,
                          long long interp_fs, int frames, int P, int R, int w,
                          int S, double aaf, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  pool_finalize_kernel<T, SSE2><<<row_grid(R, w, frames), kRowThreads, 0, stream>>>(
      static_cast<const T*>(kept), static_cast<const A*>(body),
      static_cast<T*>(interp), kept_fs, pitch_k, interp_fs,
      (long long)(P - 1) * S, R, w, S, static_cast<A>(aaf));
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
                       long long body_ms, long long tail_ms, int maps, int n,
                       int S, int threads, cudaStream_t stream) {
  SNO_DISPATCH(smooth, row0, body, tail, row0_ms, body_ms, tail_ms, maps, n,
               S, threads, stream);
}

cudaError_t smooth_occupancy_any(int dtype, int sse2, int cols, int S,
                                 int threads, int* blocks) {
  SNO_DISPATCH(smooth_occupancy, S, threads, blocks);
}

int wide_any(int dtype, int sse2, int cols, const void* row0, const void* in,
             void* body, const void* tail, long long row0_ms, long long in_ms,
             long long body_ms, long long tail_ms, int maps, int n_blk, int n, int S,
             int W_loc, int H, int R, int base, int steps, int pitch, int cluster_mode,
             int threads, int smem, cudaStream_t stream) {
  SNO_DISPATCH(wide, row0, in, body, tail, row0_ms, in_ms, body_ms, tail_ms, maps,
               n_blk, n, S, W_loc, H, R, base, steps, pitch, cluster_mode, threads,
               smem, stream);
}

int wide_query_any(int dtype, int sse2, int cols, int threads, int smem, int cluster,
                   int* out) {
  SNO_DISPATCH(wide_query, threads, smem, cluster, out);
}

cudaError_t prepare_any(int dtype, int sse2, const void* kept, void* body,
                        long long kept_fs, long long pitch_k, int frames,
                        int P, int R, int w, int S, cudaStream_t stream) {
  const int cols = 1;
  SNO_DISPATCH(prepare, kept, body, kept_fs, pitch_k, frames, P, R, w, S,
               stream);
}

cudaError_t finalize_any(int dtype, int sse2, const void* kept,
                         const void* body, void* interp, long long kept_fs,
                         long long pitch_k, long long interp_fs, int frames,
                         int P, int R, int w, int S, double aaf,
                         cudaStream_t stream) {
  const int cols = 1;
  SNO_DISPATCH(finalize_rows, kept, body, interp, kept_fs, pitch_k, interp_fs,
               frames, P, R, w, S, aaf, stream);
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
      base + elem * (size_t)P * S, ms, ms, ms, sno::kMaps, P - 1, S, threads,
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
      (long long)(P - 1) * S, S, sno::kMaps, P - 1, S, threads,
      static_cast<cudaStream_t>(stream)));
}

// The batched walk: the same smoothing over `maps` maps (9 a frame) of a
// contiguous batch, row0 [maps, S], body [maps, P-1, S], tail [maps, S].
int sno_pool_smooth_batch_launch(int dtype, int sse2, int cols,
                                 const void* row0, void* body,
                                 const void* tail, int maps, int P, int S,
                                 int threads, void* stream) {
  if (maps <= 0 || maps % sno::kMaps) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(smooth_any(
      dtype, dtype == 2 ? 0 : sse2, cols, row0, body, tail, S,
      (long long)(P - 1) * S, S, maps, P - 1, S, threads,
      static_cast<cudaStream_t>(stream)));
}

// Resident blocks an SM of the walk at stride S and `threads` threads.
int sno_pool_smooth_occupancy(int dtype, int sse2, int cols, int S,
                              int threads, int* blocks) {
  return static_cast<int>(smooth_occupancy_any(dtype, dtype == 2 ? 0 : sse2,
                                               cols, S, threads, blocks));
}

// The wide walk (K3, K6 and the batched walk past one block's columns) on
// `maps` maps of a walk of n steps: row0 [maps, S], the input rows `in`
// [maps, n, S] (== body in cluster mode), body [maps, n, S] smoothed in
// place at steps base..base+steps-1, tail [maps, S], each with its map
// stride.  Returns the cudaError_t of the launch, or -1 when no cluster of
// n_blk blocks can be scheduled.
int sno_pool_wide_launch(int dtype, int sse2, int cols, const void* row0, const void* in,
                         void* body, const void* tail, long long row0_ms,
                         long long in_ms, long long body_ms, long long tail_ms, int maps,
                         int n_blk, int n, int S, int W_loc, int H, int R, int base,
                         int steps, int pitch, int cluster_mode, int threads, int smem,
                         void* stream) {
  return wide_any(dtype, dtype == 2 ? 0 : sse2, cols, row0, in, body, tail, row0_ms,
                  in_ms, body_ms, tail_ms, maps, n_blk, n, S, W_loc, H, R, base, steps,
                  pitch, cluster_mode, threads, smem, static_cast<cudaStream_t>(stream));
}

// Registers, spill bytes and blocks a SM of the wide walk's build, and
// clusters of `cluster` blocks resident at once (-1 for no cluster).
int sno_pool_wide_query(int dtype, int sse2, int cols, int threads, int smem,
                        int cluster, int* out) {
  return wide_query_any(dtype, dtype == 2 ? 0 : sse2, cols, threads, smem, cluster, out);
}

// K7 prepare: kept rows r = 0..R (row r at kept + r*pitch_k elements, w
// columns) -> raw maps in rows 0..R-1, columns 0..w-1, of the contiguous
// body [9, P-1, S].
int sno_pool_prepare_launch(int dtype, int sse2, const void* kept, void* body,
                            long long pitch_k, int P, int R, int w, int S,
                            void* stream) {
  return static_cast<int>(prepare_any(dtype, dtype == 2 ? 0 : sse2, kept,
                                      body, 0, pitch_k, 1, P, R, w, S,
                                      static_cast<cudaStream_t>(stream)));
}

// The batched prepare: frame k's kept rows at kept + k*kept_fs (row pitch
// pitch_k) into its body, [frames, 9, P-1, S] contiguous.
int sno_pool_prepare_batch_launch(int dtype, int sse2, const void* kept,
                                  void* body, long long kept_fs,
                                  long long pitch_k, int frames, int P, int R,
                                  int w, int S, void* stream) {
  if (frames <= 0 || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(prepare_any(dtype, dtype == 2 ? 0 : sse2, kept,
                                      body, kept_fs, pitch_k, frames, P, R, w,
                                      S, static_cast<cudaStream_t>(stream)));
}

// K7 finalize: the same kept rows and the smoothed body -> interp [R, w].
int sno_pool_finalize_launch(int dtype, int sse2, const void* kept,
                             const void* body, void* interp, long long pitch_k,
                             int P, int R, int w, int S, double aaf,
                             void* stream) {
  return static_cast<int>(finalize_any(dtype, dtype == 2 ? 0 : sse2, kept,
                                       body, interp, 0, pitch_k, 0, 1, P, R, w,
                                       S, aaf, static_cast<cudaStream_t>(stream)));
}

// The batched finalize: frame k's interpolated rows [R, w] at
// interp + k*interp_fs, from its kept rows and body as in the prepare.
int sno_pool_finalize_batch_launch(int dtype, int sse2, const void* kept,
                                   const void* body, void* interp,
                                   long long kept_fs, long long pitch_k,
                                   long long interp_fs, int frames, int P,
                                   int R, int w, int S, double aaf,
                                   void* stream) {
  if (frames <= 0 || frames > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(finalize_any(dtype, dtype == 2 ? 0 : sse2, kept,
                                       body, interp, kept_fs, pitch_k,
                                       interp_fs, frames, P, R, w, S, aaf,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
