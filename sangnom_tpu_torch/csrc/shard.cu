// The width-sharded kernels for NVIDIA Hopper (sm_90a): K4, and the chunked
// route's prepare kernel, K5 walk and finalize kernel.
//
// A plane's S columns are cut into n shards of W_loc columns.  The smoothing
// recursion moves influence 3 columns a row, so a block that computes the
// columns of its shard plus a halo of H = 3R columns a side (global columns
// [g0, g1), clipped at 0 and S: the boundary shards have no outer halo)
// walks R rows on its own: the valid part of its carried row shrinks by 3
// columns a row and reaches the shard's own columns after R rows.  Kept-row
// taps and raw maps are exact at every column of the block (they are read
// in place from the whole plane, taps clamped at global columns 0 and S-1),
// so the halo needs no extra 6 columns.  Every R rows the halo columns of
// the carried row take the neighbours' values:
//   cluster mode  the n blocks of a field (K4) or of a (map, field) row (K5)
//                 form one thread-block cluster; one launch walks every row
//                 of the plane pass, and the halo comes from the
//                 neighbours' shared memory (distributed shared memory,
//                 one cluster barrier an exchange).  The boundary blocks
//                 need no clamp: their outer edge is the global edge, where
//                 the padded shared rows replicate the edge column.
//   chunk mode    for rows of more shards than a cluster holds: one launch
//                 a chunk of R rows; the carried row goes through device
//                 memory, each block writing its own columns at the chunk's
//                 end and reading all of its columns at the next chunk's
//                 start (the launch boundary orders them).
//
// shard_full_kernel   K4, replaces sangnom_tpu/parallel/fused_smooth.py
//                     _fused_full (body _full_kernel): prepare, smoothing,
//                     finalize and the weave.  Its row step is K1's
//                     (common.cuh step_sum / step_box / step_carry): a
//                     thread owns COLS contiguous columns, computes one set
//                     of raw maps a step from tap windows and mirror
//                     predictors, carries acc = sm[b-1] + raw[b], and takes
//                     box sums from 16-byte windows of a padded shared row,
//                     one barrier a step where two rows fit.  Shard deltas:
//                     the column offset g0; raw maps zero at global columns
//                     >= w_glob; the kept rows hold 4 real neighbouring
//                     columns past each end; only row b's window is carried
//                     across the barrier (below); only the shard's own
//                     columns are finalized and woven, straight into the
//                     full-width plane.
// shard_prepare_kernel the chunked route's prepare (parallel): the 9 raw
//                     maps of every kept pair, [9, N, bufH+1, S], zero rows
//                     0 and bufH and zero at global columns >= w_glob.
// shard_smooth_kernel K5, replaces fused_smooth.py smooth_sharded_chunked
//                     (body _smooth_kernel): the smoothing walk of one map
//                     row, K3's walk (pool.cu) with the halo exchange.  Raw
//                     rows are read once each (row b+1 is carried into the
//                     next step), D rows ahead in registers; the smoothed
//                     rows go to the full-width [9N, bufH-1, S].
// shard_finalize_kernel the chunked route's finalize (parallel): the
//                     priority select into [N, bufH-1, S], or with the
//                     weave the kept and interpolated rows into the woven
//                     full-width plane.
//
// What bounds them: K4 as K1, the serial row walk and its integer
// operations; more, narrower blocks (4 x 120 at 1x4 1080 luma) fill all the
// SMs where one block a field fills 120.  The chunked route moves 9 int32
// maps a pixel three times (prepare writes, K5 reads and writes, finalize
// reads): bytes.
//
// Exactness: common.cuh's numerics; the vertical sum (sm + raw[b]) +
// raw[b+1], the box strictly left to right.

#include "cluster.cuh"

namespace {

using namespace sno;

constexpr int kRing = 5;  // K4's kept-row ring slots

// K4.  kept [N, bufH, S] (storage type); dst [N, weave ? 2*bufH : bufH-1, S];
// grid N*n blocks, shard fastest.  Steps b = lo..hi-1 (b = 1..bufH-1 in
// cluster mode).  Shared memory: [buf (dbuf ? 2 : 1) x 9 x pitch_b][rp 9 x
// pitch_p][ring kRing x pitch_r][xb 2 x 2 x 9 x H], buf and rp in global
// scratch gbuf / grp instead when they do not fit.
//
// The step differs from K1's in what it carries across its barrier: only
// row b's window and predictors; finalize reloads row b-1's window from the
// ring, and row b+1's, read before the barrier for raw[b+1], is reloaded at
// the step's end as the next step's row.  K1's full carry plus the shard's
// state spilled, and at 4 blocks a SM the spills left L1.  So the ring has 5
// slots, row r in slot r % 5: step b reads row b+1 before its barrier, rows
// b-1 and b+1 after it, and places row b+3 at its end, into the slot of row
// b-2, last read in step b-1's finalize, before this step's barrier.
//
// CLUSTER: cluster mode; else chunk mode, where gin / gout [N, 9, S] hold
// the carried smoothed row (gin read when lo > 1, gout written at the
// block's own columns when hi < bufH).
template <typename T, bool SSE2, int COLS, bool CLUSTER>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
shard_full_kernel(const T* __restrict__ kept, T* __restrict__ dst,
                  const int32_t* __restrict__ offsets,
                  typename Ops<T, SSE2>::acc* __restrict__ gbuf, T* __restrict__ grp,
                  const typename Ops<T, SSE2>::acc* __restrict__ gin,
                  typename Ops<T, SSE2>::acc* __restrict__ gout, int n, int bufH,
                  int S, int W_loc, int H, int w_glob, int R, int lo, int hi,
                  int weave, int static_offset, int dbuf, int pitch_b, int pitch_r,
                  int pitch_p, typename Ops<T, SSE2>::acc aaf) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int L = COLS + 8;  // window: columns c0-4 .. c0+COLS+3
  constexpr int kWinT = group_align<T, COLS, 8>();
  constexpr int kGrpT = group_align<T, COLS, 0>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int blk = blockIdx.x;
  const int f = blk / n;
  const int q = blk - f * n;
  const int c0 = threadIdx.x * COLS;
  const Span sp = span_of(q, W_loc, H, S);
  const bool active = c0 < sp.W_c;
  const int lim = min(sp.W_c, w_glob - sp.g0);  // local columns with raw maps

  const size_t buf_elems = (size_t)kMaps * pitch_b;
  unsigned char* next = smem;
  A* buf;
  T* rp;
  if (gbuf) {
    buf = gbuf + (long long)blk * buf_elems;
    rp = grp + (long long)blk * kMaps * pitch_p;
  } else {
    buf = reinterpret_cast<A*>(next);
    next += (dbuf ? 2 : 1) * buf_elems * sizeof(A);
    rp = reinterpret_cast<T*>(next);
    next += sizeof(T) * (size_t)kMaps * pitch_p;
  }
  T* ring = reinterpret_cast<T*>(next);
  A* xbuf = reinterpret_cast<A*>(next + sizeof(T) * kRing * (size_t)pitch_r);
  const int off = !weave ? 0 : static_offset >= 0 ? static_offset : offsets[f];
  T* fdst = dst + (long long)f * (weave ? 2 * bufH : bufH - 1) * S + sp.g0;

  // Kept row r, kPad columns more than the block's at each end (clamped at
  // the global edges): thread t fetches the COLS columns from t*COLS - kPad,
  // so the threads past the active ones fetch the right-hand pad columns
  // and no thread holds extra registers.  Fetched a few steps before they
  // are placed.
  const int k0 = c0 - kPad;  // local column of x[0]
  const bool fetcher = k0 < sp.W_c + kPad;
  auto fetch_row = [&](int r, T (&x)[COLS]) {
    const T* s = kept + ((long long)f * bufH + r) * S;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (k0 + j < sp.W_c + kPad) x[j] = s[min(max(sp.g0 + k0 + j, 0), S - 1)];
  };
  // ...into ring slot r % 5; the shard's own columns are also woven (with
  // the duplicated boundary line, reference src/SangNom2.cpp:379-391).
  auto place_row = [&](int r, const T (&x)[COLS]) {
    T* slot = ring + (r % kRing) * pitch_r + kPad;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = k0 + j;
      if (c >= sp.W_c + kPad) break;
      const T v = x[j];
      slot[c] = v;
      if (weave && c >= sp.cl && c < sp.cr) {
        fdst[(long long)(2 * r + off) * S + c] = v;
        if (off == 0 && r == bufH - 1) fdst[(long long)(2 * bufH - 1) * S + c] = v;
        if (off == 1 && r == 0) fdst[c] = v;
      }
    }
  };
  auto row_window = [&](int r, A (&x)[L]) {
    load_elems<T, L, kWinT>(ring + (r % kRing) * pitch_r + c0, x);
  };

  for (int r = lo - 1; r < lo + 3 && r < bufH; ++r) {
    T x[COLS];
    if (fetcher) {
      fetch_row(r, x);
      place_row(r, x);
    }
  }
  __syncthreads();

  // The carry: row lo's window wb and predictors, and acc = sm[lo-1] +
  // raw[lo] from pair (lo-1, lo); sm[0] = 0, else from gin at its owners.
  A wb[L], pb[COLS], qb[COLS];
  A acc[kMaps][COLS];
  {
    A wa[L], pa[COLS], qa[COLS];
#pragma unroll
    for (int k = 0; k < L; ++k) wa[k] = wb[k] = A(0);
#pragma unroll
    for (int j = 0; j < COLS; ++j) pa[j] = qa[j] = pb[j] = qb[j] = A(0);
    if (active) {
      row_window(lo - 1, wa);
      row_window(lo, wb);
      mirror_predictors<O, COLS>(wa, pa, qa);
      mirror_predictors<O, COLS>(wb, pb, qb);
    }
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = c0 + j;
        A sm = A(0);
        if (!CLUSTER && lo > 1 && c < sp.W_c)
          sm = gin[((long long)f * kMaps + m) * S + sp.g0 + c];
        const A r = c < lim ? window_map<O, COLS>(m, j, wa, pa, qa, wb, pb, qb) : A(0);
        acc[m][j] = O::add(sm, r);
      }
    }
  }

  for (int b = lo; b < hi; ++b) {
    A* cur = buf + (dbuf ? (b & 1) * buf_elems : 0);
    if (!dbuf) __syncthreads();  // the previous step's box is done with buf
    const bool has_next = b + 1 < bufH;

    // Row b+1: window and predictors; pair (b, b+1) gives raw[b+1].
    if (active) {
      A wc[L], pc[COLS], qc[COLS];
#pragma unroll
      for (int k = 0; k < L; ++k) wc[k] = A(0);
#pragma unroll
      for (int j = 0; j < COLS; ++j) pc[j] = qc[j] = A(0);
      if (has_next) {
        row_window(b + 1, wc);
        mirror_predictors<O, COLS>(wc, pc, qc);
      }
      step_sum<T, SSE2, COLS>(cur + kPad, pitch_b, rp, pitch_p, c0, sp.W_c, lim, has_next,
                              acc, wb, pb, qb, wc, pc, qc);
    }
    __syncthreads();

    // Row b+3 is fetched now and placed at the step's end (its load's
    // latency hides behind the box and finalize).
    const bool ahead = fetcher && b + 3 < bufH;
    T nx[COLS];
    if (ahead) fetch_row(b + 3, nx);
    A h[kMaps][COLS];
    if (active) {
      step_box<T, SSE2, COLS>(cur + kPad, pitch_b, c0, h);
      A wa[L], pa[COLS], qa[COLS];
      row_window(b - 1, wa);
      mirror_predictors<O, COLS>(wa, pa, qa);
      A res[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        res[j] = window_finalize<O, COLS>(j, wa, pa, qa, wb, pb, qb, h, aaf);
      const int row = weave ? 2 * (b - 1) + 1 + off : b - 1;
      T* out = fdst + (long long)row * S + c0;
      if (c0 >= sp.cl && c0 + COLS <= sp.cr && kGrpT &&
          reinterpret_cast<uintptr_t>(out) % (kGrpT ? kGrpT : 1) == 0) {
        store_elems<T, COLS, kGrpT>(out, res);
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          if (c0 + j >= sp.cl && c0 + j < sp.cr) out[j] = static_cast<T>(res[j]);
      }
    }
    if (CLUSTER && n > 1 && b % R == 0 && b + 1 < hi)
      exchange_halo<A, kMaps, COLS>(xbuf + ((b / R) & 1) * 2 * kMaps * H, sp, H, c0, h);
    if (!CLUSTER && b == hi - 1 && hi < bufH && active) {
      A* o = gout + (long long)f * kMaps * S + sp.g0 + c0;
#pragma unroll
      for (int m = 0; m < kMaps; ++m)
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          if (c0 + j >= sp.cl && c0 + j < sp.cr) o[m * S + j] = h[m][j];
    }
    // acc = sm[b] + raw[b+1], the next step's first add.
    if (active) step_carry<T, SSE2, COLS>(rp, pitch_p, c0, h, acc);
    if (ahead) place_row(b + 3, nx);
    // Row b+1 is the next step's carried row.
    if (active && b + 1 < hi) {
      row_window(b + 1, wb);
      mirror_predictors<O, COLS>(wb, pb, qb);
    }
  }
  // No block leaves while a neighbour may still read its shared memory.
  if (CLUSTER && n > 1 && R + 1 < hi) cg::this_cluster().sync();
}

// Raw rows loaded ahead of the step that uses them (as pool.cu's walk).
template <int COLS>
struct Prefetch {
  static constexpr int kDepth = COLS >= 8 ? 2 : 8;
};

// K5.  raw [C, bufH+1, S] (rows 0 and bufH zero), out [C, bufH-1, S]; grid
// C*n blocks, shard fastest.  Steps s = base..base+steps-1 (all of them in
// cluster mode): line = (sm + raw[1+s]) + raw[2+s], sm = writeback(box).
// The seed sm is 0 at base 0, else out row base-1 (chunk mode).  Shared
// memory: the line [2][pitch], then xb [2][2][H].
template <typename T, bool SSE2, int COLS>
__global__ void __launch_bounds__(COLS >= 8 ? 1024 : 512, 1)
shard_smooth_kernel(const typename Ops<T, SSE2>::acc* __restrict__ raw,
                    typename Ops<T, SSE2>::acc* __restrict__ out, int n, int bufH,
                    int S, int W_loc, int H, int R, int base, int steps, int pitch,
                    int cluster_mode) {
  using O = Ops<T, SSE2>;
  using A = typename O::acc;
  constexpr int D = Prefetch<COLS>::kDepth;
  constexpr int kGrp = group_align<A, COLS, 0>();
  static_assert(kGrp > 0, "4-byte accumulators give word access");
  extern __shared__ __align__(16) unsigned char smem[];
  A* line = reinterpret_cast<A*>(smem);  // [2][pitch], column 0 at kPad
  A* xbuf = line + 2 * pitch;

  const int blk = blockIdx.x;
  const int row = blk / n;
  const int q = blk - row * n;
  const int c0 = threadIdx.x * COLS;
  const Span sp = span_of(q, W_loc, H, S);
  const bool active = c0 < sp.W_c;
  const A* rin = raw + ((long long)row * (bufH + 1) + 1 + base) * S + sp.g0;
  A* o = out + (long long)row * (bufH - 1) * S + sp.g0;
  // Word access where the group is whole and its rows start aligned.
  const bool vec = c0 + COLS <= sp.W_c && S % 4 == 0 && sp.g0 % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(out)) %
                    16) == 0;
  auto gload = [&](const A* p, A (&x)[COLS]) {
    if (vec) {
      load_elems<A, COLS, kGrp>(p + c0, x);
    } else {
#pragma unroll
      for (int j = 0; j < COLS; ++j) x[j] = c0 + j < sp.W_c ? p[c0 + j] : A(0);
    }
  };

  A sm[1][COLS], cur[COLS], pf[D][COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) sm[0][j] = A(0);
  if (base > 0) gload(o + (long long)(base - 1) * S, sm[0]);
  gload(rin, cur);  // input row 0: raw row 1+base
#pragma unroll
  for (int i = 1; i <= D; ++i)
    if (i <= steps) gload(rin + (long long)i * S, pf[i % D]);

  const bool exchange = cluster_mode && n > 1;
  int n_exch = 0;
  for (int t0 = 0; t0 < steps; t0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int t = t0 + i;
      if (t >= steps) break;
      A* buf = line + (i & 1) * pitch + kPad;  // t and i share parity: D is even
      const int slot = (i + 1) % D;
      if (active) {
        A v[COLS];
#pragma unroll
        for (int j = 0; j < COLS; ++j) v[j] = O::add(O::add(sm[0][j], cur[j]), pf[slot][j]);
        store_group_padded<A, COLS>(buf, c0, sp.W_c, v);
      }
      // Input row t+1 becomes the next step's first row: read once.
#pragma unroll
      for (int j = 0; j < COLS; ++j) cur[j] = pf[slot][j];
      if (t + 1 + D <= steps) gload(rin + (long long)(t + 1 + D) * S, pf[slot]);
      // One barrier: the other line buffer was last read in step t-1's box.
      __syncthreads();
      if (active) {
        box_window<T, SSE2, COLS>(buf, c0, sm[0]);
        A* dst = o + (long long)(base + t) * S + c0;
        if (vec && c0 >= sp.cl && c0 + COLS <= sp.cr) {
          store_elems<A, COLS, kGrp>(dst, sm[0]);
        } else {
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            if (c0 + j >= sp.cl && c0 + j < sp.cr) dst[j] = sm[0][j];
        }
      }
      if (exchange && (t + 1) % R == 0 && t + 1 < steps) {
        exchange_halo<A, 1, COLS>(xbuf + (n_exch & 1) * 2 * H, sp, H, c0, sm);
        ++n_exch;
      }
    }
  }
  if (exchange && n_exch > 0) cg::this_cluster().sync();
}

// Chunked-route prepare: kept [N, bufH, S] -> raw [9, N, bufH+1, S].
template <typename T, bool SSE2>
__global__ void shard_prepare_kernel(const T* __restrict__ kept,
                                     typename Ops<T, SSE2>::acc* __restrict__ raw,
                                     int N, int bufH, int S, int w_glob) {
  using A = typename Ops<T, SSE2>::acc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.z;
  if (c >= S) return;
  const long long ms = (long long)N * (bufH + 1) * S;  // map stride
  for (int r = blockIdx.y; r <= bufH; r += gridDim.y) {
    A mp[kMaps];
#pragma unroll
    for (int m = 0; m < kMaps; ++m) mp[m] = A(0);
    if (r >= 1 && r < bufH && c < w_glob) {
      const T* top = kept + ((long long)f * bufH + r - 1) * S;
      error_maps<T, SSE2>(top, top + S, c, S, mp);
    }
    A* dst = raw + ((long long)f * (bufH + 1) + r) * S + c;
#pragma unroll
    for (int m = 0; m < kMaps; ++m) dst[m * ms] = mp[m];
  }
}

// Chunked-route finalize: kept [N, bufH, S] and smoothed [9, N, bufH-1, S]
// -> interpolated rows into dst [N, bufH-1, S], or with `weave` the woven
// plane [N, 2*bufH, S]: kept row r at 2r+off, interpolated row t at
// 2t+1+off, the boundary line duplicated (reference
// src/SangNom2.cpp:379-391).
template <typename T, bool SSE2>
__global__ void shard_finalize_kernel(const T* __restrict__ kept,
                                      const typename Ops<T, SSE2>::acc* __restrict__ smv,
                                      T* __restrict__ dst, const int32_t* __restrict__ offsets,
                                      int N, int bufH, int S, int weave, int static_offset,
                                      typename Ops<T, SSE2>::acc aaf) {
  using A = typename Ops<T, SSE2>::acc;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int f = blockIdx.z;
  if (c >= S) return;
  const long long ms = (long long)N * (bufH - 1) * S;
  const int off = !weave ? 0 : static_offset >= 0 ? static_offset : offsets[f];
  T* fdst = dst + (long long)f * (weave ? 2 * bufH : bufH - 1) * S + c;
  for (int t = blockIdx.y; t < bufH; t += gridDim.y) {
    const T* top = kept + ((long long)f * bufH + t) * S;
    if (weave) {
      const T v = top[c];
      fdst[(long long)(2 * t + off) * S] = v;
      if (off == 0 && t == bufH - 1) fdst[(long long)(2 * bufH - 1) * S] = v;
      if (off == 1 && t == 0) fdst[0] = v;
    }
    if (t == bufH - 1) continue;
    A sm[kMaps];
#pragma unroll
    for (int m = 0; m < kMaps; ++m)
      sm[m] = smv[m * ms + ((long long)f * (bufH - 1) + t) * S + c];
    fdst[(long long)(weave ? 2 * t + 1 + off : t) * S] =
        static_cast<T>(finalize<T, SSE2>(top, top + S, c, S, sm, aaf));
  }
}

constexpr int kRowThreads = 256;  // threads a block of the prepare and finalize grids

dim3 row_grid(int rows, int S, int N) {
  return dim3((S + kRowThreads - 1) / kRowThreads, rows < 65535 ? rows : 65535, N);
}

template <typename T, bool SSE2, int COLS>
int launch_full(const void* kept, void* dst, const int32_t* offsets, void* gbuf,
                void* grp, const void* gin, void* gout, int N, int n, int bufH, int S,
                int W_loc, int H, int w_glob, int R, int lo, int hi, int weave,
                int static_offset, int dbuf, int pitch_b, int pitch_r, int pitch_p,
                int cluster_mode, double aaf, int threads, int smem,
                cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  auto kern = cluster_mode ? shard_full_kernel<T, SSE2, COLS, true>
                           : shard_full_kernel<T, SSE2, COLS, false>;
  return launch_ex(kern, N * n, threads, smem, cluster_mode ? n : 1, stream,
                   static_cast<const T*>(kept), static_cast<T*>(dst), offsets,
                   static_cast<A*>(gbuf), static_cast<T*>(grp), static_cast<const A*>(gin),
                   static_cast<A*>(gout), n, bufH, S, W_loc, H, w_glob, R, lo, hi, weave,
                   static_offset, dbuf, pitch_b, pitch_r, pitch_p, static_cast<A>(aaf));
}

template <typename T, bool SSE2, int COLS>
int launch_smooth(const void* raw, void* out, int C, int n, int bufH, int S, int W_loc,
                  int H, int R, int base, int steps, int pitch, int cluster_mode,
                  int threads, int smem, cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  return launch_ex(shard_smooth_kernel<T, SSE2, COLS>, C * n, threads, smem,
                   cluster_mode ? n : 1, stream, static_cast<const A*>(raw),
                   static_cast<A*>(out), n, bufH, S, W_loc, H, R, base, steps, pitch,
                   cluster_mode);
}

template <typename T, bool SSE2, int COLS>
int launch_prepare(const void* kept, void* raw, int N, int bufH, int S, int w_glob,
                   cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  shard_prepare_kernel<T, SSE2><<<row_grid(bufH + 1, S, N), kRowThreads, 0, stream>>>(
      static_cast<const T*>(kept), static_cast<A*>(raw), N, bufH, S, w_glob);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SSE2, int COLS>
int launch_finalize(const void* kept, const void* smv, void* dst, const int32_t* offsets,
                    int N, int bufH, int S, int weave, int static_offset, double aaf,
                    cudaStream_t stream) {
  using A = typename Ops<T, SSE2>::acc;
  shard_finalize_kernel<T, SSE2><<<row_grid(bufH, S, N), kRowThreads, 0, stream>>>(
      static_cast<const T*>(kept), static_cast<const A*>(smv), static_cast<T*>(dst),
      offsets, N, bufH, S, weave, static_offset, static_cast<A>(aaf));
  return static_cast<int>(cudaGetLastError());
}

// which: 0 K4 (its cluster build when cluster > 1), 1 K5.
template <typename T, bool SSE2, int COLS>
int query(int which, int threads, int smem, int cluster, int* out) {
  if (which == 0)
    return cluster > 1
               ? query_kernel(shard_full_kernel<T, SSE2, COLS, true>, threads, smem, cluster, out)
               : query_kernel(shard_full_kernel<T, SSE2, COLS, false>, threads, smem, cluster, out);
  return query_kernel(shard_smooth_kernel<T, SSE2, COLS>, threads, smem, cluster, out);
}

// dtype 0 uint8, 1 uint16, 2 float32; cols 1, 4 or 8.
#define SNO_DISPATCH(FN, ...)                                              \
  do {                                                                     \
    switch (dtype * 100 + sse2 * 10 + (cols == 1 ? 0 : cols == 4 ? 1 : cols == 8 ? 2 : 9)) { \
      case 0: return FN<uint8_t, false, 1>(__VA_ARGS__);                   \
      case 1: return FN<uint8_t, false, 4>(__VA_ARGS__);                   \
      case 2: return FN<uint8_t, false, 8>(__VA_ARGS__);                   \
      case 10: return FN<uint8_t, true, 1>(__VA_ARGS__);                   \
      case 11: return FN<uint8_t, true, 4>(__VA_ARGS__);                   \
      case 12: return FN<uint8_t, true, 8>(__VA_ARGS__);                   \
      case 100: return FN<uint16_t, false, 1>(__VA_ARGS__);                \
      case 101: return FN<uint16_t, false, 4>(__VA_ARGS__);                \
      case 102: return FN<uint16_t, false, 8>(__VA_ARGS__);                \
      case 110: return FN<uint16_t, true, 1>(__VA_ARGS__);                 \
      case 111: return FN<uint16_t, true, 4>(__VA_ARGS__);                 \
      case 112: return FN<uint16_t, true, 8>(__VA_ARGS__);                 \
      case 200: return FN<float, false, 1>(__VA_ARGS__);                   \
      case 201: return FN<float, false, 4>(__VA_ARGS__);                   \
      case 202: return FN<float, false, 8>(__VA_ARGS__);                   \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
  } while (0)

// The prepare and finalize kernels have one build per (dtype, sse2).
#define SNO_DISPATCH_ROWS(FN, ...)                                         \
  do {                                                                     \
    switch (dtype * 10 + sse2) {                                           \
      case 0: return FN<uint8_t, false, 1>(__VA_ARGS__);                   \
      case 1: return FN<uint8_t, true, 1>(__VA_ARGS__);                    \
      case 10: return FN<uint16_t, false, 1>(__VA_ARGS__);                 \
      case 11: return FN<uint16_t, true, 1>(__VA_ARGS__);                  \
      case 20: return FN<float, false, 1>(__VA_ARGS__);                    \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
  } while (0)

}  // namespace

extern "C" {

// K4 on `stream`: cluster mode (cluster_mode 1: one launch walks steps
// 1..bufH-1, the n shards of a field in one cluster) or one chunk of steps
// lo..hi-1 (cluster_mode 0).  Returns the cudaError_t of the launch, or -1
// when no cluster of n blocks can be scheduled.
int sno_shard_full_launch(int dtype, int sse2, int cols, const void* kept, void* dst,
                          const int32_t* offsets, void* gbuf, void* grp, const void* gin,
                          void* gout, int N, int n, int bufH, int S, int W_loc, int H,
                          int w_glob, int R, int lo, int hi, int weave, int static_offset,
                          int dbuf, int pitch_b, int pitch_r, int pitch_p,
                          int cluster_mode, double aaf, int threads, int smem,
                          void* stream) {
  SNO_DISPATCH(launch_full, kept, dst, offsets, gbuf, grp, gin, gout, N, n, bufH, S,
               W_loc, H, w_glob, R, lo, hi, weave, static_offset, dbuf, pitch_b, pitch_r,
               pitch_p, cluster_mode, aaf, threads, smem,
               static_cast<cudaStream_t>(stream));
}

// K5 on `stream`, steps base..base+steps-1 of C map rows; as above.
int sno_shard_smooth_launch(int dtype, int sse2, int cols, const void* raw, void* out,
                            int C, int n, int bufH, int S, int W_loc, int H, int R,
                            int base, int steps, int pitch, int cluster_mode,
                            int threads, int smem, void* stream) {
  SNO_DISPATCH(launch_smooth, raw, out, C, n, bufH, S, W_loc, H, R, base, steps, pitch,
               cluster_mode, threads, smem, static_cast<cudaStream_t>(stream));
}

int sno_shard_prepare_launch(int dtype, int sse2, const void* kept, void* raw, int N,
                             int bufH, int S, int w_glob, void* stream) {
  SNO_DISPATCH_ROWS(launch_prepare, kept, raw, N, bufH, S, w_glob,
                    static_cast<cudaStream_t>(stream));
}

// weave 0: dst [N, bufH-1, S] interpolated rows; 1: the woven [N, 2*bufH, S]
// (static_offset 0/1, or -1 for the per-field offsets).
int sno_shard_finalize_launch(int dtype, int sse2, const void* kept, const void* smv,
                              void* dst, const int32_t* offsets, int N, int bufH, int S,
                              int weave, int static_offset, double aaf, void* stream) {
  SNO_DISPATCH_ROWS(launch_finalize, kept, smv, dst, offsets, N, bufH, S, weave,
                    static_offset, aaf, static_cast<cudaStream_t>(stream));
}

// Occupancy of K4 (which 0) or K5 (which 1): out[4] as query_kernel.
int sno_shard_query(int which, int dtype, int sse2, int cols, int threads, int smem,
                    int cluster, int* out) {
  SNO_DISPATCH(query, which, threads, smem, cluster, out);
}

}  // extern "C"
