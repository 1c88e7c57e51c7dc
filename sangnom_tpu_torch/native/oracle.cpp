// Clean-room scalar oracle for the sangnom_tpu framework.
//
// Implements the SangNom deinterlace semantics (the C / opt=0 numerics
// contract described in SURVEY.md §1-2, derived from reference
// src/SangNom2.cpp:25-273) as straightforward portable C++ with ZERO-
// initialized scratch, so it is a deterministic parity target for the JAX
// backends and a measurable single-core baseline for bench.py.
//
// This is NOT a copy of the reference: different structure (field gather +
// assembly in the driver, contiguous std::vector scratch, stage functions
// over whole maps), different API (flat C entry points over plane arrays),
// and the deliberate zero-defined-padding contract the reference lacks.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <class A>
inline A clamped(const A* row, long i, long n) {
  return row[i < 0 ? 0 : (i >= n ? n - 1 : i)];
}

// The 3-tap directional predictor (4*p1 + 5*p2 - p3) / 8 with the integer
// path's arithmetic-shift-then-wrap-to-pixel semantics.
template <class T, class A, bool FLT>
inline A predict(A p1, A p2, A p3) {
  if constexpr (FLT) {
    return (p1 * 4.0f + p2 * 5.0f - p3) * 0.125f;
  } else {
    A s = p1 * 4 + p2 * 5 - p3;
    return static_cast<A>(static_cast<T>(s >> 3));
  }
}

template <class T, class A, bool FLT>
inline A halfsum(A a, A b) {  // round-half-up average (vertical/directional)
  if constexpr (FLT) {
    return (a + b) * 0.5f;
  } else {
    return static_cast<A>(static_cast<T>((a + b + 1) >> 1));
  }
}

// Gather the 7-wide clamped neighborhoods of two adjacent kept lines and the
// four predictor values; shared by the prepare and finalize stages.
template <class T, class A, bool FLT>
struct PairView {
  A c[7], n[7];  // index 0..6 == offset -3..+3
  A fwd1, fwd2, bwd1, bwd2;

  inline void load(const T* cr, const T* nr, long x, long w) {
    for (int k = 0; k < 7; ++k) {
      c[k] = static_cast<A>(clamped(cr, x + k - 3, w));
      n[k] = static_cast<A>(clamped(nr, x + k - 3, w));
    }
    fwd1 = predict<T, A, FLT>(c[2], c[3], c[4]);
    fwd2 = predict<T, A, FLT>(n[4], n[3], n[2]);
    bwd1 = predict<T, A, FLT>(c[4], c[3], c[2]);
    bwd2 = predict<T, A, FLT>(n[2], n[3], n[4]);
  }
};

template <class A>
inline A adiff(A a, A b) {
  return a > b ? a - b : b - a;
}

// Interpolate the bufH-1 interior missing lines from a contiguous kept field
// (bufH rows of width w). Output rows are written with stride out_stride.
//
// `pool`/`poolRows`: optional SHARED pool state (pool-compat mode): 9 maps of
// (poolRows+1) rows x S cols, carried across plane passes exactly like the
// reference's cross-plane buffer reuse (reference src/SangNom2.cpp:265-272 —
// prepare touches only this plane's rows/cols, processBuffers always smooths
// rows 1..bufferHeight-1 over the full stride).  nullptr = the framework's
// default zero-defined plane-local pool.
template <class T, class A, bool FLT>
void interp_field(const T* kept, long bufH, long w, long S, A aaf, T* out,
                  long out_stride, A* pool = nullptr, long poolRows = 0) {
  std::vector<A> local;
  if (!pool) {
    if (bufH < 2) return;
    // 9 error maps, spatial-priority order, rows 0..bufH all zero-defined.
    local.assign(static_cast<size_t>(9) * (bufH + 1) * S, A(0));
    pool = local.data();
    poolRows = bufH;
  }
  A* const maps_data = pool;
  const long mstride = (poolRows + 1) * S;

  for (long b = 1; b < bufH; ++b) {
    const T* cr = kept + (b - 1) * w;
    const T* nr = kept + b * w;
    A* m = maps_data + b * S;
    PairView<T, A, FLT> v;
    for (long x = 0; x < w; ++x) {
      v.load(cr, nr, x, w);
      m[0 * mstride + x] = adiff(v.c[0], v.n[6]);   // M3 / P3
      m[1 * mstride + x] = adiff(v.c[1], v.n[5]);   // M2 / P2
      m[2 * mstride + x] = adiff(v.c[2], v.n[4]);   // M1 / P1
      m[3 * mstride + x] = adiff(v.fwd1, v.fwd2);   // SG forward
      m[4 * mstride + x] = adiff(v.c[3], v.n[3]);   // vertical
      m[5 * mstride + x] = adiff(v.bwd1, v.bwd2);   // SG reverse
      m[6 * mstride + x] = adiff(v.c[4], v.n[2]);   // P1 / M1
      m[7 * mstride + x] = adiff(v.c[5], v.n[1]);   // P2 / M2
      m[8 * mstride + x] = adiff(v.c[6], v.n[0]);   // P3 / M3
    }
  }

  // Recursive 3x7 box smoothing: row b's vertical sum reads row b-1 AFTER it
  // was smoothed (a row scan, not a convolution). Horizontal taps clamp at
  // the padded stride S, and padding columns are zero by construction.
  std::vector<A> line(S);
  for (int i = 0; i < 9; ++i) {
    A* m = maps_data + i * mstride;
    for (long b = 1; b < poolRows; ++b) {
      A* up = m + (b - 1) * S;    // already smoothed
      A* mid = m + b * S;         // raw, overwritten below
      A* dn = m + (b + 1) * S;    // still raw (row poolRows: zero when
                                  // plane-local, carried when shared)
      for (long x = 0; x < S; ++x) line[x] = up[x] + mid[x] + dn[x];
      for (long x = 0; x < S; ++x) {
        A h = clamped(line.data(), x - 3, S) + clamped(line.data(), x - 2, S) +
              clamped(line.data(), x - 1, S) + line[x] +
              clamped(line.data(), x + 1, S) + clamped(line.data(), x + 2, S) +
              clamped(line.data(), x + 3, S);
        if constexpr (FLT)
          mid[x] = h / 16.0f;
        else
          mid[x] = static_cast<A>(static_cast<T>(h >> 4));
      }
    }
  }

  // Finalize: 9-way min, fixed-priority select, directional average.
  for (long b = 1; b < bufH; ++b) {
    const T* cr = kept + (b - 1) * w;
    const T* nr = kept + b * w;
    const A* m = maps_data + b * S;
    T* dst = out + (b - 1) * out_stride;
    PairView<T, A, FLT> v;
    for (long x = 0; x < w; ++x) {
      v.load(cr, nr, x, w);
      A e[9];
      for (int i = 0; i < 9; ++i) e[i] = m[i * mstride + x];
      A mn = *std::min_element(e, e + 9);
      A r;
      if (e[4] == mn || mn > aaf)
        r = halfsum<T, A, FLT>(v.c[3], v.n[3]);
      else if (e[5] == mn)
        r = halfsum<T, A, FLT>(v.bwd1, v.bwd2);
      else if (e[3] == mn)
        r = halfsum<T, A, FLT>(v.fwd1, v.fwd2);
      else if (e[6] == mn)
        r = halfsum<T, A, FLT>(v.c[4], v.n[2]);
      else if (e[2] == mn)
        r = halfsum<T, A, FLT>(v.c[2], v.n[4]);
      else if (e[7] == mn)
        r = halfsum<T, A, FLT>(v.c[5], v.n[1]);
      else if (e[1] == mn)
        r = halfsum<T, A, FLT>(v.c[1], v.n[5]);
      else if (e[8] == mn)
        r = halfsum<T, A, FLT>(v.c[6], v.n[0]);
      else
        r = halfsum<T, A, FLT>(v.c[0], v.n[6]);
      dst[x] = static_cast<T>(r);
    }
  }
}

// Full per-plane pipeline: field gather, interpolation, weave, boundary dup.
template <class T, class A, bool FLT>
void deinterlace_plane(const T* src, T* dst, long w, long h_src, long S,
                       int offset, int dh, float aaf_in, A* pool = nullptr,
                       long poolRows = 0) {
  const long h_out = dh ? 2 * h_src : h_src;
  const long bufH = h_out / 2;

  const T* kept;
  std::vector<T> gather;
  if (dh) {
    kept = src;  // height-doubling: the whole source is the kept field
  } else {
    gather.resize(bufH * w);
    for (long k = 0; k < bufH; ++k)
      std::memcpy(gather.data() + k * w, src + (offset + 2 * k) * w,
                  w * sizeof(T));
    kept = gather.data();
  }

  // kept field -> output rows offset, offset+2, ...
  for (long k = 0; k < bufH; ++k)
    std::memcpy(dst + (offset + 2 * k) * w, kept + k * w, w * sizeof(T));

  // interior missing rows (offset^1 parity), written in place
  A aaf;
  if constexpr (FLT)
    aaf = aaf_in;
  else
    aaf = static_cast<A>(static_cast<T>(aaf_in));  // float->T truncates
  // first interior missing row: 1 when keeping top (offset=0), 2 otherwise
  const long first_missing = (offset == 0) ? 1 : 2;
  interp_field<T, A, FLT>(kept, bufH, w, S, aaf, dst + first_missing * w,
                          2 * w, pool, poolRows);

  // boundary missing line: duplicate its kept neighbor
  if (offset == 0)
    std::memcpy(dst + (h_out - 1) * w, dst + (h_out - 2) * w, w * sizeof(T));
  else
    std::memcpy(dst, dst + w, w * sizeof(T));
}

}  // namespace

extern "C" {

void sno_deint_u8(const uint8_t* src, uint8_t* dst, long w, long h_src,
                  long stride, int offset, int dh, float aaf) {
  deinterlace_plane<uint8_t, int32_t, false>(src, dst, w, h_src, stride,
                                             offset, dh, aaf);
}

void sno_deint_u16(const uint16_t* src, uint16_t* dst, long w, long h_src,
                   long stride, int offset, int dh, float aaf) {
  deinterlace_plane<uint16_t, int32_t, false>(src, dst, w, h_src, stride,
                                              offset, dh, aaf);
}

void sno_deint_f32(const float* src, float* dst, long w, long h_src,
                   long stride, int offset, int dh, float aaf) {
  deinterlace_plane<float, float, true>(src, dst, w, h_src, stride, offset,
                                        dh, aaf);
}

// Pool-compat variants: `pool` is the caller-owned shared pool state,
// 9 * (poolRows+1) * stride accumulator elements, mutated in place.  The
// caller threads it through plane passes (Y->U->V per frame, frames in
// order), reproducing the reference's single constructor-allocated pool
// (reference src/SangNom2.cpp:303-310).
void sno_deint_u8_pool(const uint8_t* src, uint8_t* dst, long w, long h_src,
                       long stride, int offset, int dh, float aaf,
                       int32_t* pool, long poolRows) {
  deinterlace_plane<uint8_t, int32_t, false>(src, dst, w, h_src, stride,
                                             offset, dh, aaf, pool, poolRows);
}

void sno_deint_u16_pool(const uint16_t* src, uint16_t* dst, long w,
                        long h_src, long stride, int offset, int dh,
                        float aaf, int32_t* pool, long poolRows) {
  deinterlace_plane<uint16_t, int32_t, false>(src, dst, w, h_src, stride,
                                              offset, dh, aaf, pool,
                                              poolRows);
}

void sno_deint_f32_pool(const float* src, float* dst, long w, long h_src,
                        long stride, int offset, int dh, float aaf,
                        float* pool, long poolRows) {
  deinterlace_plane<float, float, true>(src, dst, w, h_src, stride, offset,
                                        dh, aaf, pool, poolRows);
}

}  // extern "C"
