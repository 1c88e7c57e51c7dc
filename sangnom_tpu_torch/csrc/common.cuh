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

// --- Contiguous column groups and vector windows -----------------------------
//
// A thread that owns COLS contiguous columns c0 = tid * COLS .. c0+COLS-1
// reads a row's taps as one window, columns c0-4 .. c0+COLS+3, from a
// shared row that keeps kPad pad columns left of column 0 and replicated
// values past its right edge (written by the owners of the edge columns), so
// the window holds the clamped taps.

constexpr int kPad = 4;  // pad columns left of column 0 in a shared row

// Byte alignment of the group start c0 * sizeof(E) (rows start 16-byte
// aligned) that also divides `extra` more elements: the widest word access
// for a window (extra 8) or a group (extra 0); 0 means element access.
template <typename E, int COLS, int EXTRA>
__host__ __device__ constexpr int group_align() {
  constexpr int g = COLS * static_cast<int>(sizeof(E));
  constexpr int e = EXTRA * static_cast<int>(sizeof(E));
  return (g % 16 == 0 && e % 16 == 0) ? 16
         : (g % 8 == 0 && e % 8 == 0) ? 8
         : (g % 4 == 0 && e % 4 == 0) ? 4
                                      : 0;
}

__device__ __forceinline__ void from_word(uint32_t x, float& v) { v = __uint_as_float(x); }
__device__ __forceinline__ void from_word(uint32_t x, int32_t& v) { v = static_cast<int32_t>(x); }
__device__ __forceinline__ uint32_t to_word(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t to_word(int32_t v) { return static_cast<uint32_t>(v); }

// N elements of E at p (aligned to ALIGN bytes) into A values.
template <typename E, int N, int ALIGN, typename A>
__device__ __forceinline__ void load_elems(const E* p, A out[N]) {
  if constexpr (ALIGN == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = static_cast<A>(p[k]);
  } else {
    constexpr int NW = N * static_cast<int>(sizeof(E)) / 4;
    uint32_t wd[NW];
    if constexpr (ALIGN == 16) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < NW / 4; ++i) {
        const uint4 v = q[i];
        wd[4 * i] = v.x; wd[4 * i + 1] = v.y; wd[4 * i + 2] = v.z; wd[4 * i + 3] = v.w;
      }
    } else if constexpr (ALIGN == 8) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) {
        const uint2 v = q[i];
        wd[2 * i] = v.x; wd[2 * i + 1] = v.y;
      }
    } else {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int i = 0; i < NW; ++i) wd[i] = q[i];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (sizeof(E) == 4) {
        E v;
        from_word(wd[k], v);
        out[k] = static_cast<A>(v);
      } else {
        constexpr int per = 4 / static_cast<int>(sizeof(E));
        out[k] = static_cast<A>(static_cast<E>(wd[k / per] >> (8 * sizeof(E) * (k % per))));
      }
    }
  }
}

// N values into N elements of E at p (aligned to ALIGN bytes).
template <typename E, int N, int ALIGN, typename A>
__device__ __forceinline__ void store_elems(E* p, const A v[N]) {
  if constexpr (ALIGN == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = static_cast<E>(v[k]);
  } else {
    constexpr int NW = N * static_cast<int>(sizeof(E)) / 4;
    uint32_t wd[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) wd[i] = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (sizeof(E) == 4) {
        wd[k] = to_word(static_cast<E>(v[k]));
      } else {
        constexpr int per = 4 / static_cast<int>(sizeof(E));
        wd[k / per] |= static_cast<uint32_t>(static_cast<E>(v[k]))
                       << (8 * sizeof(E) * (k % per));
      }
    }
    if constexpr (ALIGN == 16) {
      uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
      for (int i = 0; i < NW / 4; ++i)
        q[i] = make_uint4(wd[4 * i], wd[4 * i + 1], wd[4 * i + 2], wd[4 * i + 3]);
    } else if constexpr (ALIGN == 8) {
      uint2* q = reinterpret_cast<uint2*>(p);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) q[i] = make_uint2(wd[2 * i], wd[2 * i + 1]);
    } else {
      uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
      for (int i = 0; i < NW; ++i) q[i] = wd[i];
    }
  }
}

// Stores the group's values v (columns c0..c0+COLS-1) into a shared row
// whose column 0 is at row[0], then the edge pads: kPad copies of column 0
// on the left (by the owner of column 0) and 3 copies of column S-1 past it
// (by the owner of column S-1, after its own group store, which may have
// written past S).
template <typename A, int COLS>
__device__ __forceinline__ void store_group_padded(A* row, int c0, int S, const A (&v)[COLS]) {
  store_elems<A, COLS, group_align<A, COLS, 0>()>(row + c0, v);
  if (c0 == 0) {
#pragma unroll
    for (int k = 1; k <= kPad; ++k) row[-k] = v[0];
  }
  if (S - 1 < c0 + COLS) {
    A last = v[0];
#pragma unroll
    for (int j = 1; j < COLS; ++j)
      if (c0 + j == S - 1) last = v[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) row[S + k] = last;
  }
}

// The group's box sums from a padded shared row (column 0 at row[0]): one
// window, each 7-tap sum strictly left to right, then written back.
template <typename T, bool SSE2, int COLS>
__device__ __forceinline__ void box_window(const typename Ops<T, SSE2>::acc* row, int c0,
                                           typename Ops<T, SSE2>::acc (&h)[COLS]) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  A x[COLS + 8];
  load_elems<A, COLS + 8, group_align<A, COLS, 8>()>(row - kPad + c0, x);
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    A s = x[j + 1];
#pragma unroll
    for (int k = 2; k < 8; ++k) s = O::add(s, x[j + k]);
    h[j] = O::writeback(s);
  }
}

// --- The carried row step (deint.cu K1/K2, shard.cu K4) -----------------------
//
// A thread carries the tap windows (columns c0-4 .. c0+COLS+3) of kept pair
// (b-1, b) and each row's two mirror predictors, so a step reads one new
// row's window and computes one set of 9 raw maps, raw[b+1].

// A row's mirror predictors at the group's columns; window index j + 4 is
// column c0 + j.
template <typename O, int COLS>
__device__ __forceinline__ void mirror_predictors(const typename O::acc (&x)[COLS + 8],
                                                  typename O::acc (&p)[COLS],
                                                  typename O::acc (&q)[COLS]) {
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    p[j] = O::predict(x[j + 3], x[j + 4], x[j + 5]);
    q[j] = O::predict(x[j + 5], x[j + 4], x[j + 3]);
  }
}

// Raw error map m of kept pair (top t, bottom n) at group column j, from the
// carried windows and predictors (error_maps in common.cuh, by window).
template <typename O, int COLS>
__device__ __forceinline__ typename O::acc window_map(
    int m, int j, const typename O::acc (&t)[COLS + 8], const typename O::acc (&pt)[COLS],
    const typename O::acc (&qt)[COLS], const typename O::acc (&n)[COLS + 8],
    const typename O::acc (&pn)[COLS], const typename O::acc (&qn)[COLS]) {
  switch (m) {
    case 0: return O::absdiff(t[j + 1], n[j + 7]);
    case 1: return O::absdiff(t[j + 2], n[j + 6]);
    case 2: return O::absdiff(t[j + 3], n[j + 5]);
    case 3: return O::absdiff(pt[j], qn[j]);  // fwd1, fwd2
    case 4: return O::absdiff(t[j + 4], n[j + 4]);
    case 5: return O::absdiff(qt[j], pn[j]);  // bwd1, bwd2
    case 6: return O::absdiff(t[j + 5], n[j + 3]);
    case 7: return O::absdiff(t[j + 6], n[j + 2]);
    default: return O::absdiff(t[j + 7], n[j + 1]);
  }
}

// Priority select (finalize in common.cuh) at group column j, taps and
// predictors from the carried windows.
template <typename O, int COLS>
__device__ __forceinline__ typename O::acc window_finalize(
    int j, const typename O::acc (&t)[COLS + 8], const typename O::acc (&pt)[COLS],
    const typename O::acc (&qt)[COLS], const typename O::acc (&n)[COLS + 8],
    const typename O::acc (&pn)[COLS], const typename O::acc (&qn)[COLS],
    const typename O::acc (&h)[kMaps][COLS], typename O::acc aaf) {
  using A = typename O::acc;
  A mn = h[0][j];
#pragma unroll
  for (int i = 1; i < kMaps; ++i) mn = O::lo(mn, h[i][j]);
  A a = t[j + 1], b = n[j + 7];                             // buf0 M3P3
  if (h[8][j] == mn) { a = t[j + 7]; b = n[j + 1]; }        // P3M3
  if (h[1][j] == mn) { a = t[j + 2]; b = n[j + 6]; }        // M2P2
  if (h[7][j] == mn) { a = t[j + 6]; b = n[j + 2]; }        // P2M2
  if (h[2][j] == mn) { a = t[j + 3]; b = n[j + 5]; }        // M1P1
  if (h[6][j] == mn) { a = t[j + 5]; b = n[j + 3]; }        // P1M1
  if (h[3][j] == mn) { a = pt[j]; b = qn[j]; }              // SG_FORWARD
  if (h[5][j] == mn) { a = qt[j]; b = pn[j]; }              // SG_REVERSE
  if (h[4][j] == mn || mn > aaf) { a = t[j + 4]; b = n[j + 4]; }  // vertical
  return O::avg(a, b);
}

// The step's sum: raw[b+1] of pair (b, b+1) from the carried windows (zero
// at group columns >= lim, and everywhere when !has_next), the line
// acc + raw[b+1] into buffer rows m (pitch_b apart, column 0 at buf[0],
// padded for S columns), and raw[b+1] into the thread-private slice rp.
template <typename T, bool SSE2, int COLS>
__device__ __forceinline__ void step_sum(
    typename Ops<T, SSE2>::acc* buf, int pitch_b, T* rp, int pitch_p, int c0,
    int S, int lim, bool has_next,
    const typename Ops<T, SSE2>::acc (&acc)[kMaps][COLS],
    const typename Ops<T, SSE2>::acc (&wb)[COLS + 8],
    const typename Ops<T, SSE2>::acc (&pb)[COLS],
    const typename Ops<T, SSE2>::acc (&qb)[COLS],
    const typename Ops<T, SSE2>::acc (&wc)[COLS + 8],
    const typename Ops<T, SSE2>::acc (&pc)[COLS],
    const typename Ops<T, SSE2>::acc (&qc)[COLS]) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int kGrpT = group_align<T, COLS, 0>();
#pragma unroll
  for (int m = 0; m < kMaps; ++m) {
    A v[COLS], r1[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      r1[j] = (has_next && c0 + j < lim)
                  ? window_map<O, COLS>(m, j, wb, pb, qb, wc, pc, qc) : A(0);
      v[j] = O::add(acc[m][j], r1[j]);
    }
    store_group_padded<A, COLS>(buf + m * pitch_b, c0, S, v);
    store_elems<T, COLS, kGrpT>(rp + m * pitch_p + c0, r1);
  }
}

// The step's box: each map's box sum from its padded buffer row.
template <typename T, bool SSE2, int COLS>
__device__ __forceinline__ void step_box(const typename Ops<T, SSE2>::acc* buf,
                                         int pitch_b, int c0,
                                         typename Ops<T, SSE2>::acc (&h)[kMaps][COLS]) {
#pragma unroll
  for (int m = 0; m < kMaps; ++m) box_window<T, SSE2, COLS>(buf + m * pitch_b, c0, h[m]);
}

// The next step's first add: acc = sm[b] + raw[b+1], raw[b+1] from rp.
template <typename T, bool SSE2, int COLS>
__device__ __forceinline__ void step_carry(const T* rp, int pitch_p, int c0,
                                           const typename Ops<T, SSE2>::acc (&h)[kMaps][COLS],
                                           typename Ops<T, SSE2>::acc (&acc)[kMaps][COLS]) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int kGrpT = group_align<T, COLS, 0>();
#pragma unroll
  for (int m = 0; m < kMaps; ++m) {
    A r1[COLS];
    load_elems<T, COLS, kGrpT>(rp + m * pitch_p + c0, r1);
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = O::add(h[m][j], r1[j]);
  }
}

}  // namespace sno
