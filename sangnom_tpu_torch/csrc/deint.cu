// SangNom2 field interpolation and weave for NVIDIA Hopper (sm_90a).
//
// Replaces sangnom_tpu/ops/pallas_kernel.py::_kernel, which the TPU package
// launches through _deint_chunk (woven full-height output) and _interp_chunk
// (interpolated rows only).  Here both are one kernel; `weave` picks the
// output form at run time.
//
// What it computes, per field with kept rows K[0..bufH-1] (reference
// src/SangNom2.cpp:74-273, zero-defined padding):
//   raw[b]  = 9 directional error maps of kept pair (b-1, b), zero at
//             columns >= w; raw[0] = raw[bufH] = 0
//   sm[b]   = writeback(box7(sm[b-1] + raw[b] + raw[b+1])), sm[0] = 0, box
//             taps clamped at column S
//   out[b-1] = priority select of pair (b-1, b) against sm[b] and aaf
// The smoothing is a serial recursion over rows, so one thread block owns
// one field and walks its rows in a loop.  A thread owns COLS contiguous
// columns, c0 = tid * COLS.
//
// The row step (common.cuh step_sum / step_box / step_carry, shared with
// shard.cu's K4), as the TPU kernel carries it across grid steps: each thread
// keeps in registers the tap windows (columns c0-4 .. c0+COLS+3) of the kept
// pair (b-1, b) and of row b+1, and each row's two mirror predictors
// P = predict(K[c-1], K[c], K[c+1]) and Q = predict(K[c+1], K[c], K[c-1]):
// a row's P and Q serve as (fwd1, bwd1) while it is the top row of a pair
// and as (bwd2, fwd2) while it is the bottom row.  So a step reads only row
// b+1's window from the kept-row ring and computes one set of 9 raw maps,
// raw[b+1]; finalize takes its taps and predictors from the carry.  The
// carried sum acc = sm[b-1] + raw[b] (the reference's first add) lives in
// registers; raw[b+1], needed again after the box, waits in a thread-private
// slice `rp` in the storage type (integer maps lie in [0, mask]).
//
// Step b:  v = acc + raw[b+1] for the thread's columns, stored to buf;
//          barrier;  box from 16-byte vector windows of buf, writeback,
//          finalize, acc = sm[b] + raw[b+1].
// Edge columns: rows of the ring and of buf keep 4 pad columns on the left
// and replicated values past the right edge, written by the owners of the
// edge columns, so that a window load reads the clamped taps.
//
// Barriers.  Route "double" (dbuf = 1) has two shared [9][pitch_b] buffers
// and ONE barrier a step: step b writes buf[b & 1] before its barrier and
// reads it after.  buf[b & 1] was last read by step b-2's box, which every
// thread finished before it reached step b-1's barrier.  Route "single" (one
// buffer, for planes whose two buffers do not fit) adds a barrier at the top
// of the step, before buf is overwritten.  The kept-row ring has 4 slots; row r
// sits in slot r & 3 and is placed before the barrier of step r-3 (rows 0-3
// before the loop).  Step b reads row b+1, placed before step b-2's
// barrier, and overwrites slot (b+3) & 3, whose row b-1 was last read at
// step b-2 (or before the prologue's second barrier), before step b-1's
// barrier.
//
// What bounds it: the serial row walk and the integer operations per pixel,
// not device-memory bytes, since every input row is read once and every
// output row written once.  One block per field fills at most 120 of the 132
// SMs at 1080p luma (120 fields).  A block takes at most 512 threads of 4
// columns (2048 smoothed columns): a wider field's columns are split over
// the blocks of a thread-block cluster by shard.cu's K4, each block within
// the 4-column build (ops/deint_kernel.wide_plan).  An 8-column build, capped
// at 64 registers a thread, spilled its carry and took 5.6x the 4-column
// build's row step.
//
// Exactness: the numerics (common.cuh) keep the reference's order of float
// operations; the vertical sum is (sm + raw[b]) + raw[b+1] and the box sum
// runs strictly left to right.

#include "common.cuh"

namespace {

using namespace sno;

// One block per field; COLS (1 or 4) contiguous columns per thread cover
// the S smoothed columns.
//   src      kept rows: field f's row r is at
//            src[j*in_frame_stride + (start + r*row_step)*w], where
//            interlaced == 0: j = f, start = 0, row_step = 1;
//            interlaced == 1 (top field first) / 2 (bottom field first):
//            j = f/2, field bit b = f%2, start = b (tff) or 1-b, row_step = 2
//   dst      weave: [N, 2*bufH, w] woven plane; else [N, bufH-1, w]
//   offsets  per-field kept-row offset (0/1), read when static_offset < 0
//   pitch_b  buf row pitch (elements, a multiple of 4, >= S + COLS + 8);
//   pitch_r  ring row pitch (a multiple of 16, >= w + COLS + 8);
//   pitch_p  rp row pitch (a multiple of 16, >= blockDim.x * COLS)
//   dbuf     1: two shared buffers, one barrier a step
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(512, 1)
deint_kernel(const T* __restrict__ src, T* __restrict__ dst,
             const int32_t* __restrict__ offsets, int bufH, int w, int S, int pitch_b, int pitch_r, int pitch_p,
             long long in_frame_stride, int interlaced, int weave,
             int static_offset, int dbuf, typename Ops<T, SSE2>::acc aaf) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int L = COLS + 8;  // window: columns c0-4 .. c0+COLS+3
  constexpr int kWinT = group_align<T, COLS, 8>();
  constexpr int kGrpT = group_align<T, COLS, 0>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int f = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int c0 = tid * COLS;
  const bool active = c0 < S;  // owns smoothed columns
  const bool kcol = c0 < w;    // owns kept columns

  const T* fsrc;
  int row_step;
  if (interlaced) {
    const int b = f & 1;
    const int start = interlaced == 1 ? b : 1 - b;
    fsrc = src + (long long)(f >> 1) * in_frame_stride + (long long)start * w;
    row_step = 2;
  } else {
    fsrc = src + (long long)f * in_frame_stride;
    row_step = 1;
  }
  const size_t buf_elems = (size_t)kMaps * pitch_b;
  A* buf = reinterpret_cast<A*>(smem);
  const size_t rp_off = (dbuf ? 2 : 1) * buf_elems * sizeof(A);
  T* rp = reinterpret_cast<T*>(smem + rp_off);
  T* ring = reinterpret_cast<T*>(smem + rp_off + sizeof(T) * (size_t)kMaps * pitch_p);
  const int off = !weave ? 0 : static_offset >= 0 ? static_offset : offsets[f];
  T* fdst = dst + (long long)f * (weave ? 2 * bufH : bufH - 1) * w;

  // Kept row r at the thread's columns, from device memory; then into ring
  // slot r % 4 with its edge pads, and the weave places it too (and the
  // duplicated boundary line, reference src/SangNom2.cpp:379-391).  A step
  // fetches before its raw maps and places after them, so the load's
  // latency hides behind them.
  auto fetch_row = [&](int r, T (&x)[COLS]) {
    const T* s = fsrc + (long long)r * row_step * w + c0;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (c0 + j < w) x[j] = s[j];
  };
  auto place_row = [&](int r, const T (&x)[COLS]) {
    T* slot = ring + (r & 3) * pitch_r + kPad;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = c0 + j;
      if (c >= w) break;
      const T v = x[j];
      slot[c] = v;
      if (c == 0) {
#pragma unroll
        for (int k = 1; k <= kPad; ++k) slot[-k] = v;
      }
      if (c == w - 1) {
#pragma unroll
        for (int k = 0; k < kPad; ++k) slot[w + k] = v;
      }
      if (weave) {
        fdst[(long long)(2 * r + off) * w + c] = v;
        if (off == 0 && r == bufH - 1) fdst[(long long)(2 * bufH - 1) * w + c] = v;
        if (off == 1 && r == 0) fdst[c] = v;
      }
    }
  };
  // The window of kept row r at the thread's columns.
  auto row_window = [&](int r, A (&x)[L]) {
    load_elems<T, L, kWinT>(ring + (r & 3) * pitch_r + c0, x);
  };

  for (int r = 0; r < 4 && r < bufH; ++r) {
    T x[COLS];
    fetch_row(r, x);
    place_row(r, x);
  }
  __syncthreads();

  // The carry: pair (b-1, b) as windows wa / wb with predictors, and
  // acc = sm[b-1] + raw[b]; at b = 1, sm[0] = 0 and raw[1] is pair (0, 1).
  A wa[L], wb[L], pa[COLS], qa[COLS], pb[COLS], qb[COLS];
  A acc[kMaps][COLS];
#pragma unroll
  for (int k = 0; k < L; ++k) wa[k] = wb[k] = A(0);
#pragma unroll
  for (int j = 0; j < COLS; ++j) pa[j] = qa[j] = pb[j] = qb[j] = A(0);
  if (kcol && bufH > 1) {
    row_window(0, wa);
    row_window(1, wb);
    mirror_predictors<O, COLS>(wa, pa, qa);
    mirror_predictors<O, COLS>(wb, pb, qb);
  }
#pragma unroll
  for (int m = 0; m < kMaps; ++m) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const A r = (bufH > 1 && c0 + j < w)
                      ? window_map<O, COLS>(m, j, wa, pa, qa, wb, pb, qb) : A(0);
      acc[m][j] = O::add(A(0), r);
    }
  }
  __syncthreads();  // rows 0 and 1 read before step 1 reuses slot 0

  for (int b = 1; b < bufH; ++b) {
    A* cur = buf + (dbuf ? (b & 1) * buf_elems : 0);
    if (!dbuf) __syncthreads();  // the previous step's box is done with buf
    const bool ahead = b + 3 < bufH;
    T nx[COLS];
    if (ahead) fetch_row(b + 3, nx);
    const bool has_next = b + 1 < bufH;

    // Row b+1: window and predictors; pair (b, b+1) gives raw[b+1].
    A wc[L], pc[COLS], qc[COLS];
#pragma unroll
    for (int k = 0; k < L; ++k) wc[k] = A(0);
#pragma unroll
    for (int j = 0; j < COLS; ++j) pc[j] = qc[j] = A(0);
    if (kcol && has_next) {
      row_window(b + 1, wc);
      mirror_predictors<O, COLS>(wc, pc, qc);
    }
    if (active)
      step_sum<T, SSE2, COLS>(cur + kPad, pitch_b, rp, pitch_p, c0, S, w, has_next, acc,
                              wb, pb, qb, wc, pc, qc);
    if (ahead) place_row(b + 3, nx);
    __syncthreads();

    if (active) {
      // Box sum from each map's window, strictly left to right.
      A h[kMaps][COLS];
      step_box<T, SSE2, COLS>(cur + kPad, pitch_b, c0, h);
      if (kcol) {
        A res[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          res[j] = window_finalize<O, COLS>(j, wa, pa, qa, wb, pb, qb, h, aaf);
        const int row = weave ? 2 * (b - 1) + 1 + off : b - 1;
        T* out = fdst + (long long)row * w + c0;
        if (c0 + COLS <= w && kGrpT &&
            reinterpret_cast<uintptr_t>(out) % (kGrpT ? kGrpT : 1) == 0) {
          store_elems<T, COLS, kGrpT>(out, res);
        } else {
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            if (c0 + j < w) out[j] = static_cast<T>(res[j]);
        }
      }
      // acc = sm[b] + raw[b+1], the next step's first add.
      step_carry<T, SSE2, COLS>(rp, pitch_p, c0, h, acc);
    }
#pragma unroll
    for (int k = 0; k < L; ++k) { wa[k] = wb[k]; wb[k] = wc[k]; }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      pa[j] = pb[j]; qa[j] = qb[j]; pb[j] = pc[j]; qb[j] = qc[j];
    }
  }
}

template <typename T, bool SSE2, int COLS>
cudaError_t launch(const void* src, void* dst, const int32_t* offsets,
                   int n_fields, int bufH, int w, int S, int pitch_b,
                   int pitch_r, int pitch_p,
                   long long in_frame_stride, int interlaced, int weave,
                   int static_offset, int dbuf, double aaf, int threads,
                   int smem_bytes, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = deint_kernel<T, SSE2, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<n_fields, threads, smem_bytes, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), offsets, bufH, w, S,
      pitch_b, pitch_r, pitch_p, in_frame_stride, interlaced, weave, static_offset,
      dbuf, static_cast<A>(aaf));
  return cudaGetLastError();
}

template <typename T, bool SSE2>
cudaError_t launch_cols(int cols, const void* src, void* dst,
                        const int32_t* offsets, int n_fields, int bufH,
                        int w, int S, int pitch_b, int pitch_r, int pitch_p, long long in_frame_stride,
                        int interlaced, int weave, int static_offset, int dbuf,
                        double aaf, int threads, int smem_bytes,
                        cudaStream_t stream) {
#define SNO_COLS(C)                                                          \
  case C:                                                                    \
    return launch<T, SSE2, C>(src, dst, offsets, n_fields, bufH,             \
                              w, S, pitch_b, pitch_r, pitch_p,               \
                              in_frame_stride, interlaced, weave,            \
                              static_offset, dbuf, aaf, threads, smem_bytes, \
                              stream);
  switch (cols) {
    SNO_COLS(1)
    SNO_COLS(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef SNO_COLS
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may opt into on `device`, in bytes.
int sno_max_smem(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

const char* sno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// dtype: 0 uint8, 1 uint16, 2 float32.  cols: 1 or 4.  The pitches, dbuf
// and smem_bytes come from ops/deint_kernel.launch_plan.
int sno_deint_launch(int dtype, int sse2, int cols, const void* src,
                     void* dst, const int32_t* offsets, int n_fields, int bufH, int w, int S, int pitch_b,
                     int pitch_r, int pitch_p, long long in_frame_stride,
                     int interlaced, int weave, int static_offset, int dbuf,
                     double aaf, int threads, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SNO_ARGS                                                            \
  cols, src, dst, offsets, n_fields, bufH, w, S, pitch_b,                   \
      pitch_r, pitch_p, in_frame_stride, interlaced, weave, static_offset,  \
      dbuf, aaf, threads, smem_bytes, st
  cudaError_t e;
  if (dtype == 0)
    e = sse2 ? launch_cols<uint8_t, true>(SNO_ARGS)
             : launch_cols<uint8_t, false>(SNO_ARGS);
  else if (dtype == 1)
    e = sse2 ? launch_cols<uint16_t, true>(SNO_ARGS)
             : launch_cols<uint16_t, false>(SNO_ARGS);
  else if (dtype == 2)
    e = launch_cols<float, false>(SNO_ARGS);
  else
    e = cudaErrorInvalidValue;
#undef SNO_ARGS
  return static_cast<int>(e);
}

}  // extern "C"
