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
// one field and walks its rows in a loop; threads stride over columns.
//
// Layout: the smoothed row sm[9][S] lives in shared memory (or, for planes
// too wide for it, in a global scratch row per field) and is overwritten in
// place, first by the vertical 3-sum, then, after a barrier, by the box sum,
// which each thread holds in registers across a second barrier.  Kept rows
// stay in a 4-row shared ring in the storage type; the row two steps ahead
// is loaded while the current one is used.  Raw maps are recomputed from
// the ring rather than carried.
//
// What bounds it: the serial row walk and the integer operations per pixel
// (about 9 x 7 box taps plus 3 x 18 prepare taps per column per row), not
// device-memory bytes, since every input row is read once and every output
// row written once.  One block per field fills at most 120 of the 132 SMs at
// 1080p luma (120 fields); splitting a field's columns across the blocks of
// a thread-block cluster is later work.
//
// Exactness: the numerics (common.cuh) keep the reference's order of float
// operations; the vertical sum is (sm + raw[b]) + raw[b+1] and the box sum
// runs strictly left to right.

#include "common.cuh"

namespace {

using namespace sno;

// One block per field; COLS columns per thread cover the S smoothed columns.
//   src      kept rows: field f's row r is at
//            src[j*in_frame_stride + (start + r*row_step)*w], where
//            interlaced == 0: j = f, start = 0, row_step = 1;
//            interlaced == 1 (top field first) / 2 (bottom field first):
//            j = f/2, field bit b = f%2, start = b (tff) or 1-b, row_step = 2
//   dst      weave: [N, 2*bufH, w] woven plane; else [N, bufH-1, w]
//   offsets  per-field kept-row offset (0/1), read when static_offset < 0
//   gsm      global smoothed rows [N, 9, S], or null to use shared memory
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
deint_kernel(const T* __restrict__ src, T* __restrict__ dst,
             const int32_t* __restrict__ offsets,
             typename Ops<T, SSE2>::acc* __restrict__ gsm, int bufH, int w,
             int S, long long in_frame_stride, int interlaced, int weave,
             int static_offset, typename Ops<T, SSE2>::acc aaf) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  extern __shared__ __align__(16) unsigned char smem[];

  const int f = blockIdx.x;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;

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
  A* sm = gsm ? gsm + (long long)f * kMaps * S : reinterpret_cast<A*>(smem);
  T* ring = reinterpret_cast<T*>(
      smem + (gsm ? 0 : sizeof(A) * (size_t)kMaps * S));
  const int off = !weave ? 0 : static_offset >= 0 ? static_offset : offsets[f];
  T* fdst = dst + (long long)f * (weave ? 2 * bufH : bufH - 1) * w;

  // Kept row r into ring slot r % 4; the weave also places it (and the
  // duplicated boundary line, reference src/SangNom2.cpp:379-391).
  auto load_row = [&](int r) {
    const T* s = fsrc + (long long)r * row_step * w;
    T* slot = ring + (r & 3) * w;
    for (int c = tid; c < w; c += nt) {
      const T v = s[c];
      slot[c] = v;
      if (weave) {
        fdst[(long long)(2 * r + off) * w + c] = v;
        if (off == 0 && r == bufH - 1) fdst[(long long)(2 * bufH - 1) * w + c] = v;
        if (off == 1 && r == 0) fdst[c] = v;
      }
    }
  };

  for (int i = tid; i < kMaps * S; i += nt) sm[i] = A(0);
  for (int r = 0; r < 3 && r < bufH; ++r) load_row(r);
  __syncthreads();

  for (int b = 1; b < bufH; ++b) {
    const T* r0 = ring + ((b - 1) & 3) * w;
    const T* r1 = ring + (b & 3) * w;
    const T* r2 = ring + ((b + 1) & 3) * w;
    const bool has_next = b + 1 < bufH;

    // Vertical 3-sum over own columns, in place: (sm + raw[b]) + raw[b+1].
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * nt;
      if (c < S) {
        A rb[kMaps], rb1[kMaps];
#pragma unroll
        for (int m = 0; m < kMaps; ++m) rb[m] = rb1[m] = A(0);
        if (c < w) {
          error_maps<T, SSE2>(r0, r1, c, w, rb);
          if (has_next) error_maps<T, SSE2>(r1, r2, c, w, rb1);
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
    if (b + 2 < bufH) load_row(b + 2);

    // Box sum, taps clamped at S, strictly left to right.
    A h[COLS][kMaps];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * nt;
      if (c < S) {
        int x[7];
#pragma unroll
        for (int k = 0; k < 7; ++k) x[k] = min(max(c + k - 3, 0), S - 1);
#pragma unroll
        for (int m = 0; m < kMaps; ++m) {
          const A* row = sm + m * S;
          A s = row[x[0]];
#pragma unroll
          for (int k = 1; k < 7; ++k) s = O::add(s, row[x[k]]);
          h[j][m] = O::writeback(s);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = tid + j * nt;
      if (c < S) {
#pragma unroll
        for (int m = 0; m < kMaps; ++m) sm[m * S + c] = h[j][m];
      }
      if (c < w) {
        const A res = finalize<T, SSE2>(r0, r1, c, w, h[j], aaf);
        const int row = weave ? 2 * (b - 1) + 1 + off : b - 1;
        fdst[(long long)row * w + c] = static_cast<T>(res);
      }
    }
  }
}

template <typename T, bool SSE2, int COLS>
cudaError_t launch(const void* src, void* dst, const int32_t* offsets,
                   void* gsm, int n_fields, int bufH, int w, int S,
                   long long in_frame_stride, int interlaced, int weave,
                   int static_offset, double aaf, int threads, int smem_bytes,
                   cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = deint_kernel<T, SSE2, COLS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return e;
  kern<<<n_fields, threads, smem_bytes, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), offsets,
      static_cast<A*>(gsm), bufH, w, S, in_frame_stride, interlaced, weave,
      static_offset, static_cast<A>(aaf));
  return cudaGetLastError();
}

template <typename T, bool SSE2>
cudaError_t launch_cols(int cols, const void* src, void* dst,
                        const int32_t* offsets, void* gsm, int n_fields,
                        int bufH, int w, int S, long long in_frame_stride,
                        int interlaced, int weave, int static_offset,
                        double aaf, int threads, int smem_bytes,
                        cudaStream_t stream) {
#define SNO_COLS(C)                                                          \
  case C:                                                                    \
    return launch<T, SSE2, C>(src, dst, offsets, gsm, n_fields, bufH, w, S,  \
                              in_frame_stride, interlaced, weave,            \
                              static_offset, aaf, threads, smem_bytes,       \
                              stream);
  switch (cols) {
    SNO_COLS(1)
    SNO_COLS(4)
    SNO_COLS(8)
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
// dtype: 0 uint8, 1 uint16, 2 float32.  cols: 1, 4 or 8.
int sno_deint_launch(int dtype, int sse2, int cols, const void* src,
                     void* dst, const int32_t* offsets, void* gsm,
                     int n_fields, int bufH, int w, int S,
                     long long in_frame_stride, int interlaced, int weave,
                     int static_offset, double aaf, int threads,
                     int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SNO_ARGS                                                            \
  cols, src, dst, offsets, gsm, n_fields, bufH, w, S, in_frame_stride,      \
      interlaced, weave, static_offset, aaf, threads, smem_bytes, st
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
