// Thread-block clusters that split a row's columns over their blocks: the
// shard geometry, the halo exchange through distributed shared memory and
// the cluster launch.  Shared by the width-sharded kernels (shard.cu: K4, K5)
// and the pool walk's cluster mode (pool.cu).
//
// A row of S columns is cut into shards of W_loc columns.  The smoothing
// recursion moves influence 3 columns a row, so a block that computes its
// shard's columns plus a halo of H = 3R columns a side walks R rows on its
// own; every R rows the halo of its carried row takes the neighbours'
// values (exchange_halo).

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace sno {

namespace cg = cooperative_groups;

constexpr int kNoCluster = -1;  // returned when no cluster can be scheduled

// The columns of shard q of a row of S columns cut into shards of W_loc
// (the last one narrower where W_loc does not divide S): global columns
// [g0, g0 + W_c), a halo of H columns on each inner side included; its own
// columns are local [cl, cr).
struct Span {
  int g0, W_c, cl, cr;
};

__device__ __forceinline__ Span span_of(int q, int W_loc, int H, int S) {
  const int lo = q * W_loc;
  const int hi = min(lo + W_loc, S);
  Span s;
  s.g0 = max(lo - H, 0);
  s.W_c = min(hi + H, S) - s.g0;
  s.cl = lo - s.g0;
  s.cr = hi - s.g0;
  return s;
}

// Cluster halo exchange of NM carried rows at the thread's COLS columns.
// Each block publishes its H leftmost and H rightmost own columns into xb
// ([2 sides][NM][H], this exchange's parity), the cluster syncs, and the
// halo columns take the neighbours' values.  xb is rewritten two exchanges
// later, after the next cluster barrier, which no block passes before every
// block has read this one.  Every thread of the cluster calls it.
template <typename A, int NM, int COLS>
__device__ __forceinline__ void exchange_halo(A* xb, const Span& sp, int H, int c0,
                                              A (&v)[NM][COLS]) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int lc = c0 + j;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (lc >= sp.cl && lc < sp.cl + H) xb[m * H + lc - sp.cl] = v[m][j];
      if (lc >= sp.cr - H && lc < sp.cr) xb[(NM + m) * H + lc - (sp.cr - H)] = v[m][j];
    }
  }
  cluster.sync();
  // left neighbour's right edge: its own columns [cl - H, cl) of this block
  // (cl == H); right neighbour's left edge: [cr, cr + H)
  const A* left = rank > 0 ? cluster.map_shared_rank(xb, rank - 1) : nullptr;
  const A* right = rank < n - 1 ? cluster.map_shared_rank(xb, rank + 1) : nullptr;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int lc = c0 + j;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      if (left && lc < sp.cl) v[m][j] = left[(NM + m) * H + lc];
      if (right && lc >= sp.cr && lc < sp.W_c) v[m][j] = right[m * H + lc - sp.cr];
    }
  }
}

// Launches kern with `cluster` blocks a cluster (none when cluster <= 1);
// kNoCluster when cudaOccupancyMaxActiveClusters finds no place for one.
template <typename... P, typename... Args>
int launch_ex(void (*kern)(P...), int blocks, int threads, int smem, int cluster,
              cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n_clusters == 0) return kNoCluster;
  }
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spill) bytes a thread, blocks a SM at
// `smem`, and clusters of `cluster` blocks that fit the card at once (-1
// for no cluster).
template <typename... P>
int query_kernel(void (*kern)(P...), int threads, int smem, int cluster, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = per_sm;
  out[3] = -1;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(&out[3], kern, &cfg);
  }
  return static_cast<int>(e);
}

}  // namespace sno
