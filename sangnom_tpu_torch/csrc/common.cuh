// Device code shared by the field kernel (deint.cu) and the pool kernels
// (pool.cu): the numerics contracts, the kept-row taps, the nine raw error
// maps and the priority select (reference src/SangNom2.cpp:25-273).
//
// Exactness: float arithmetic uses the _rn intrinsics in the reference's
// order (no FMA contraction; the build also passes --fmad=false): the
// predictor as ((p1*4 + p2*5) - p3) * 0.125, and callers sum the vertical
// 3-sum as (sm + raw[b]) + raw[b+1] and the box strictly left to right.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace sno {

constexpr int kMaps = 9;

// Integer storage (uint8_t / uint16_t), int32 accumulator.
template <typename T, bool SSE2>
struct Ops {
  using acc = int32_t;
  static constexpr int32_t kMask = sizeof(T) == 1 ? 0xFF : 0xFFFF;

  __device__ static acc predict(acc p1, acc p2, acc p3) {
    const acc s = p1 * 4 + p2 * 5 - p3;
    if (!SSE2) return (s >> 3) & kMask;  // arithmetic shift, wrap
    if (kMask == 0xFF) return min((s & 0xFFFF) >> 3, 255);  // i16 lane
    return min((s >> 3) & 0x1FFFFFFF, 65535);                // i32 lane
  }
  __device__ static acc absdiff(acc a, acc b) { return abs(a - b); }
  __device__ static acc add(acc a, acc b) { return a + b; }
  __device__ static acc writeback(acc h) {
    return SSE2 ? min(h >> 4, kMask) : (h >> 4) & kMask;
  }
  __device__ static acc avg(acc a, acc b) { return ((a + b + 1) >> 1) & kMask; }
  __device__ static acc lo(acc a, acc b) { return min(a, b); }
};

// Float storage and accumulator; SSE2 numerics are identical to C here.
template <bool SSE2>
struct Ops<float, SSE2> {
  using acc = float;

  __device__ static acc predict(acc p1, acc p2, acc p3) {
    const float s = __fadd_rn(__fmul_rn(p1, 4.0f), __fmul_rn(p2, 5.0f));
    return __fmul_rn(__fsub_rn(s, p3), 0.125f);
  }
  __device__ static acc absdiff(acc a, acc b) { return fabsf(__fsub_rn(a, b)); }
  __device__ static acc add(acc a, acc b) { return __fadd_rn(a, b); }
  __device__ static acc writeback(acc h) { return __fmul_rn(h, 0.0625f); }
  __device__ static acc avg(acc a, acc b) { return __fmul_rn(__fadd_rn(a, b), 0.5f); }
  __device__ static acc lo(acc a, acc b) { return b < a ? b : a; }
};

// The 7 taps of a kept row around column c, clamped at the plane width.
template <typename T, typename A>
__device__ __forceinline__ void taps7(const T* row, int c, int w, A t[7]) {
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int x = min(max(c + k - 3, 0), w - 1);
    t[k] = static_cast<A>(row[x]);
  }
}

// The 9 raw error maps of kept pair (top, bot) at column c (reference
// src/SangNom2.cpp:87-117), in spatial priority order.
template <typename T, bool SSE2>
__device__ __forceinline__ void error_maps(const T* top, const T* bot, int c,
                                           int w,
                                           typename Ops<T, SSE2>::acc m[kMaps]) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  A ct[7], nt[7];
  taps7(top, c, w, ct);
  taps7(bot, c, w, nt);
  const A fwd1 = O::predict(ct[2], ct[3], ct[4]);
  const A fwd2 = O::predict(nt[4], nt[3], nt[2]);
  const A bwd1 = O::predict(ct[4], ct[3], ct[2]);
  const A bwd2 = O::predict(nt[2], nt[3], nt[4]);
  m[0] = O::absdiff(ct[0], nt[6]);
  m[1] = O::absdiff(ct[1], nt[5]);
  m[2] = O::absdiff(ct[2], nt[4]);
  m[3] = O::absdiff(fwd1, fwd2);
  m[4] = O::absdiff(ct[3], nt[3]);
  m[5] = O::absdiff(bwd1, bwd2);
  m[6] = O::absdiff(ct[4], nt[2]);
  m[7] = O::absdiff(ct[5], nt[1]);
  m[8] = O::absdiff(ct[6], nt[0]);
}

// Min-error priority select for one output pixel (reference
// src/SangNom2.cpp:161-257): the chain's operands are chosen in reverse
// priority, the LAST hit winning, vertical/threshold last; then averaged.
template <typename T, bool SSE2>
__device__ __forceinline__ typename Ops<T, SSE2>::acc finalize(
    const T* top, const T* bot, int c, int w,
    const typename Ops<T, SSE2>::acc sm[kMaps],
    typename Ops<T, SSE2>::acc aaf) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  A ct[7], nt[7];
  taps7(top, c, w, ct);
  taps7(bot, c, w, nt);
  A mn = sm[0];
#pragma unroll
  for (int i = 1; i < kMaps; ++i) mn = O::lo(mn, sm[i]);
  A a = ct[0], b = nt[6];                                  // buf0 M3P3
  if (sm[8] == mn) { a = ct[6]; b = nt[0]; }               // P3M3
  if (sm[1] == mn) { a = ct[1]; b = nt[5]; }               // M2P2
  if (sm[7] == mn) { a = ct[5]; b = nt[1]; }               // P2M2
  if (sm[2] == mn) { a = ct[2]; b = nt[4]; }               // M1P1
  if (sm[6] == mn) { a = ct[4]; b = nt[2]; }               // P1M1
  if (sm[3] == mn) {                                       // SG_FORWARD
    a = O::predict(ct[2], ct[3], ct[4]);
    b = O::predict(nt[4], nt[3], nt[2]);
  }
  if (sm[5] == mn) {                                       // SG_REVERSE
    a = O::predict(ct[4], ct[3], ct[2]);
    b = O::predict(nt[2], nt[3], nt[4]);
  }
  if (sm[4] == mn || mn > aaf) { a = ct[3]; b = nt[3]; }   // vertical
  return O::avg(a, b);
}

// The 7-tap box sum of a smoothed row at column c, taps clamped at S,
// summed strictly left to right, then written back.
template <typename T, bool SSE2>
__device__ __forceinline__ typename Ops<T, SSE2>::acc box_writeback(
    const typename Ops<T, SSE2>::acc* row, int c, int S) {
  using O = Ops<T, SSE2>;
  typename O::acc s = row[max(c - 3, 0)];
#pragma unroll
  for (int k = 1; k < 7; ++k) s = O::add(s, row[min(max(c + k - 3, 0), S - 1)]);
  return O::writeback(s);
}

}  // namespace sno
