// The width-sharded kernels for NVIDIA Hopper (sm_90a): K4 and K5.
//
// A plane's columns are cut into n_space shards of W_loc columns.  The
// smoothing recursion moves influence 3 columns a row, so a shard with a
// halo of 3R+6 kept columns (K4) or 3R+3 carry and raw columns (K5) computes
// R rows on its own (sangnom_tpu_torch/parallel/fused_smooth.py).  Both
// kernels run one chunk of R global steps per launch, over every shard and
// field of a plane pass; the wrapper exchanges the carry row between
// launches.
//
// shard_full_kernel   replaces sangnom_tpu/parallel/fused_smooth.py
//                     _fused_full (body _full_kernel): prepare, smoothing,
//                     finalize and the weave of one chunk.  One block per
//                     (shard, field), threads over the W_ext = W_loc +
//                     2*HALO halo-extended columns.  As deint.cu: the 9-map
//                     smoothed row in shared memory (or a global scratch
//                     row when too wide), kept rows in a 4-row ring, raw
//                     maps recomputed from the ring.  Sharding deltas: the
//                     pixel taps clamp at the W_ext array edge (outside the
//                     cone), raw maps are zero at global columns >= w_glob,
//                     raw[b+1] is zero at the last global step, and on the
//                     leftmost / rightmost shard the box reads the line's
//                     halo as the global edge column (the clamp at 0 / S).
//                     The central W_loc columns go straight into the
//                     full-width output plane at their final rows, so an
//                     interpolated row of offset 1 needs no carry to the
//                     next step or chunk.
// shard_smooth_kernel replaces fused_smooth.py smooth_sharded_chunked (body
//                     _smooth_kernel): the smoothing only.  One block per
//                     (shard, map x field) row; the carried row lives in
//                     registers (a thread reads only its own columns of
//                     it), the summed line in a double-buffered shared row,
//                     one barrier a step.  After the writeback, the
//                     boundary shards' halo columns take the global edge
//                     column's value.
//
// What bounds them: as deint.cu, the serial row walk and the integer
// operations per pixel, not device-memory bytes.  Sharding adds blocks (one
// per shard and field: 480 at 4 shards of 1080 luma, against 120), and
// redundant halo work (2*HALO of every W_ext columns) and one launch per
// chunk of R rows.
//
// Exactness: common.cuh's numerics; the vertical sum (sm + raw[b]) +
// raw[b+1], the box strictly left to right.

#include "common.cuh"

namespace {

using namespace sno;

// K4.  keptx [n, N, bufH, W_ext] (storage type, halo-exchanged); smx
// [n, N, 9, W_ext] the carried row; smout [n, N, 9, W_loc] the chunk's last
// smoothed row (central columns); dst [N, weave ? 2*bufH : bufH-1, S] with
// S = n*W_loc; gsm [n*N, 9, W_ext] or null for shared memory.
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
shard_full_kernel(const T* __restrict__ keptx,
                  const typename Ops<T, SSE2>::acc* __restrict__ smx,
                  typename Ops<T, SSE2>::acc* __restrict__ smout,
                  T* __restrict__ dst, const int32_t* __restrict__ offsets,
                  typename Ops<T, SSE2>::acc* __restrict__ gsm, int n_space,
                  int N, int bufH, int W_loc, int HALO, int w_glob, int base,
                  int steps, int weave, int static_offset,
                  typename Ops<T, SSE2>::acc aaf) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  extern __shared__ __align__(16) unsigned char smem[];

  const int blk = blockIdx.x;
  const int shard = blk / N;
  const int f = blk - shard * N;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int W_ext = W_loc + 2 * HALO;
  const int S = n_space * W_loc;
  const int n_steps = bufH - 1;
  const bool left = shard == 0;
  const bool right = shard == n_space - 1;
  const int gcol0 = shard * W_loc - HALO;  // global column of array column 0

  const T* fsrc = keptx + (long long)blk * bufH * W_ext;
  A* sm = gsm ? gsm + (long long)blk * kMaps * W_ext : reinterpret_cast<A*>(smem);
  T* ring = reinterpret_cast<T*>(
      smem + (gsm ? 0 : sizeof(A) * (size_t)kMaps * W_ext));
  const int off = !weave ? 0 : static_offset >= 0 ? static_offset : offsets[f];
  T* fdst = dst + (long long)f * (weave ? 2 * bufH : n_steps) * S +
            (long long)shard * W_loc;

  // Kept row r into ring slot r % 4; a row of this chunk is also woven
  // (with the duplicated boundary line, reference src/SangNom2.cpp:379-391).
  auto load_row = [&](int r) {
    const T* s = fsrc + (long long)r * W_ext;
    T* slot = ring + (r & 3) * W_ext;
    const bool put = weave && r < base + steps;
    for (int x = tid; x < W_ext; x += nt) {
      const T v = s[x];
      slot[x] = v;
      if (put && x >= HALO && x < HALO + W_loc) {
        const int c = x - HALO;
        fdst[(long long)(2 * r + off) * S + c] = v;
        if (off == 0 && r == bufH - 1) fdst[(long long)(2 * bufH - 1) * S + c] = v;
        if (off == 1 && r == 0) fdst[c] = v;
      }
    }
  };

  const A* fsm = smx + (long long)blk * kMaps * W_ext;
  for (int i = tid; i < kMaps * W_ext; i += nt) sm[i] = fsm[i];
  for (int r = base; r < base + 3 && r < bufH; ++r) load_row(r);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int s = base + t;
    const bool interp = s < n_steps;  // the weave's extra step only weaves
    const T* r0 = ring + (s & 3) * W_ext;
    const T* r1 = ring + ((s + 1) & 3) * W_ext;
    const T* r2 = ring + ((s + 2) & 3) * W_ext;
    const bool has_next = s < n_steps - 1;

    // Vertical 3-sum in place: (sm + raw[b]) + raw[b+1].
    if (interp) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int x = tid + j * nt;
        if (x < W_ext) {
          A rb[kMaps], rb1[kMaps];
#pragma unroll
          for (int m = 0; m < kMaps; ++m) rb[m] = rb1[m] = A(0);
          if (gcol0 + x < w_glob) {
            error_maps<T, SSE2>(r0, r1, x, W_ext, rb);
            if (has_next) error_maps<T, SSE2>(r1, r2, x, W_ext, rb1);
          }
#pragma unroll
          for (int m = 0; m < kMaps; ++m) {
            A* p = sm + m * W_ext + x;
            *p = O::add(O::add(*p, rb[m]), rb1[m]);
          }
        }
      }
    }
    __syncthreads();

    // Ring slot (s+3) % 4 last held row s-1, which every thread is past.
    if (s + 3 < bufH && t + 1 < steps) load_row(s + 3);
    if (!interp) continue;  // block-uniform; the loads above are complete

    // Box sum strictly left to right; taps clamp at the array edge, and on
    // a boundary shard the halo reads the global edge column.
    A h[COLS][kMaps];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int x = tid + j * nt;
      if (x < W_ext) {
        int xs[7];
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          int xx = min(max(x + k - 3, 0), W_ext - 1);
          if (left && xx < HALO) xx = HALO;
          if (right && xx >= HALO + W_loc) xx = HALO + W_loc - 1;
          xs[k] = xx;
        }
#pragma unroll
        for (int m = 0; m < kMaps; ++m) {
          const A* row = sm + m * W_ext;
          A acc = row[xs[0]];
#pragma unroll
          for (int k = 1; k < 7; ++k) acc = O::add(acc, row[xs[k]]);
          h[j][m] = O::writeback(acc);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int x = tid + j * nt;
      if (x < W_ext) {
#pragma unroll
        for (int m = 0; m < kMaps; ++m) sm[m * W_ext + x] = h[j][m];
      }
      if (x >= HALO && x < HALO + W_loc) {
        const A res = finalize<T, SSE2>(r0, r1, x, W_ext, h[j], aaf);
        const int row = weave ? 2 * s + 1 + off : s;
        fdst[(long long)row * S + (x - HALO)] = static_cast<T>(res);
      }
    }
  }
  __syncthreads();

  A* fout = smout + (long long)blk * kMaps * W_loc;
  for (int i = tid; i < kMaps * W_loc; i += nt) {
    const int m = i / W_loc;
    fout[i] = sm[m * W_ext + HALO + (i - m * W_loc)];
  }
}

// K5.  smx [n, C, W_ext] the exchanged carry row; rawx [n, C, bufH+1,
// W_ext] the exchanged raw maps; out [n, C, bufH-1, W_loc].
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
shard_smooth_kernel(const typename Ops<T, SSE2>::acc* __restrict__ smx,
                    const typename Ops<T, SSE2>::acc* __restrict__ rawx,
                    typename Ops<T, SSE2>::acc* __restrict__ out, int n_space,
                    int C, int bufH, int W_loc, int HK, int base, int steps) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  extern __shared__ __align__(16) unsigned char smem[];
  A* lines = reinterpret_cast<A*>(smem);  // [2][W_ext]

  const int blk = blockIdx.x;
  const int shard = blk / C;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int W_ext = W_loc + 2 * HK;
  const int n_steps = bufH - 1;
  const bool left = shard == 0;
  const bool right = shard == n_space - 1;
  const A* raw = rawx + (long long)blk * (bufH + 1) * W_ext;
  A* o = out + (long long)blk * n_steps * W_loc;

  A sm[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int x = tid + j * nt;
    sm[j] = x < W_ext ? smx[(long long)blk * W_ext + x] : A(0);
  }

  for (int t = 0; t < steps; ++t) {
    const int s = base + t;
    A* line = lines + (t & 1) * W_ext;
    const A* ra = raw + (long long)(1 + s) * W_ext;
    const A* rb = ra + W_ext;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int x = tid + j * nt;
      if (x < W_ext) line[x] = O::add(O::add(sm[j], ra[x]), rb[x]);
    }
    __syncthreads();
    // The other buffer is free: every thread passed this step's barrier,
    // so none still reads the line of step t-1.
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int x = tid + j * nt;
      if (x < W_ext) {
        // The boundary shards' halo columns take the global edge column's
        // writeback: computing it at the edge column is the same value.
        int xc = x;
        if (left && xc < HK) xc = HK;
        if (right && xc >= HK + W_loc) xc = HK + W_loc - 1;
        A acc = line[max(xc - 3, 0)];
#pragma unroll
        for (int k = 1; k < 7; ++k)
          acc = O::add(acc, line[min(max(xc + k - 3, 0), W_ext - 1)]);
        sm[j] = O::writeback(acc);
        if (x >= HK && x < HK + W_loc) o[(long long)s * W_loc + (x - HK)] = sm[j];
      }
    }
  }
}

template <typename T, bool SSE2, int COLS>
cudaError_t launch_full(const void* keptx, const void* smx, void* smout,
                        void* dst, const int32_t* offsets, void* gsm,
                        int n_space, int N, int bufH, int W_loc, int HALO,
                        int w_glob, int base, int steps, int weave,
                        int static_offset, double aaf, int threads,
                        int smem_bytes, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = shard_full_kernel<T, SSE2, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<n_space * N, threads, smem_bytes, stream>>>(
      static_cast<const T*>(keptx), static_cast<const A*>(smx),
      static_cast<A*>(smout), static_cast<T*>(dst), offsets,
      static_cast<A*>(gsm), n_space, N, bufH, W_loc, HALO, w_glob, base,
      steps, weave, static_offset, static_cast<A>(aaf));
  return cudaGetLastError();
}

template <typename T, bool SSE2, int COLS>
cudaError_t launch_smooth(const void* smx, const void* rawx, void* out,
                          int n_space, int C, int bufH, int W_loc, int HK,
                          int base, int steps, int threads, int smem_bytes,
                          cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = shard_smooth_kernel<T, SSE2, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<n_space * C, threads, smem_bytes, stream>>>(
      static_cast<const A*>(smx), static_cast<const A*>(rawx),
      static_cast<A*>(out), n_space, C, bufH, W_loc, HK, base, steps);
  return cudaGetLastError();
}

// dtype 0 uint8, 1 uint16, 2 float32; cols 1, 4 or 8.
#define SNO_DISPATCH(FN, ...)                                              \
  do {                                                                     \
    cudaError_t e = cudaErrorInvalidValue;                                 \
    switch (dtype * 100 + sse2 * 10 + (cols == 1 ? 0 : cols == 4 ? 1 : cols == 8 ? 2 : 9)) { \
      case 0: e = FN<uint8_t, false, 1>(__VA_ARGS__); break;               \
      case 1: e = FN<uint8_t, false, 4>(__VA_ARGS__); break;               \
      case 2: e = FN<uint8_t, false, 8>(__VA_ARGS__); break;               \
      case 10: e = FN<uint8_t, true, 1>(__VA_ARGS__); break;               \
      case 11: e = FN<uint8_t, true, 4>(__VA_ARGS__); break;               \
      case 12: e = FN<uint8_t, true, 8>(__VA_ARGS__); break;               \
      case 100: e = FN<uint16_t, false, 1>(__VA_ARGS__); break;            \
      case 101: e = FN<uint16_t, false, 4>(__VA_ARGS__); break;            \
      case 102: e = FN<uint16_t, false, 8>(__VA_ARGS__); break;            \
      case 110: e = FN<uint16_t, true, 1>(__VA_ARGS__); break;             \
      case 111: e = FN<uint16_t, true, 4>(__VA_ARGS__); break;             \
      case 112: e = FN<uint16_t, true, 8>(__VA_ARGS__); break;             \
      case 200: e = FN<float, false, 1>(__VA_ARGS__); break;               \
      case 201: e = FN<float, false, 4>(__VA_ARGS__); break;               \
      case 202: e = FN<float, false, 8>(__VA_ARGS__); break;               \
      default: break;                                                      \
    }                                                                      \
    return static_cast<int>(e);                                            \
  } while (0)

}  // namespace

extern "C" {

// K4 on `stream`; returns the cudaError_t of the launch.
int sno_shard_full_launch(int dtype, int sse2, int cols, const void* keptx,
                          const void* smx, void* smout, void* dst,
                          const int32_t* offsets, void* gsm, int n_space,
                          int N, int bufH, int W_loc, int HALO, int w_glob,
                          int base, int steps, int weave, int static_offset,
                          double aaf, int threads, int smem_bytes,
                          void* stream) {
  SNO_DISPATCH(launch_full, keptx, smx, smout, dst, offsets, gsm, n_space, N,
               bufH, W_loc, HALO, w_glob, base, steps, weave, static_offset,
               aaf, threads, smem_bytes, static_cast<cudaStream_t>(stream));
}

// K5 on `stream`; returns the cudaError_t of the launch.
int sno_shard_smooth_launch(int dtype, int sse2, int cols, const void* smx,
                            const void* rawx, void* out, int n_space, int C,
                            int bufH, int W_loc, int HK, int base, int steps,
                            int threads, int smem_bytes, void* stream) {
  SNO_DISPATCH(launch_smooth, smx, rawx, out, n_space, C, bufH, W_loc, HK,
               base, steps, threads, smem_bytes,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
