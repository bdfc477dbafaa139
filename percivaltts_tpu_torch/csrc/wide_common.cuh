// The launch plan shared by the wide recurrent kernels (bilstm_fwd_wide.cu,
// bilstm_bwd_wide.cu, bigru_fwd_wide.cu, bigru_bwd_wide.cu): one thread-block
// cluster of U blocks per direction and tile of R batch rows, block b owning
// units b·Hb … b·Hb + Hb − 1 with all of their gates (NC = gates·Hb gate
// columns: 4 for the LSTM, 3 for the GRU), NT = NC·KS threads that split the
// product over KS slices of k. The split (U, Hb, NC, KS, NT) is the one of
// ops/wide_layout.py::plan, which packs W_h per block; here the launcher
// picks R and whether the block's W_h slice stays in shared memory.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_common.cuh"

namespace percival {

struct WidePlan {
  int U, Hb, NC, KS, NT;  // the split (ops/wide_layout.py::plan)
  int R;                  // batch rows a cluster
  int w_smem;             // 1: the block's W_h slice resident in shared memory
  int clusters;           // clusters the card holds at once at this plan
  int smem;               // dynamic shared memory a block, bytes
};

constexpr int kWideMaxCluster = 16;
constexpr int kWideRows[4] = {1, 2, 4, 8};
constexpr int kWidePrefetch = 8;  // BPTT: h_prev values a thread prefetches a step

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

// Row stride of the shared-memory W_h slice, in elements: an odd number of
// 32-bit words, so that a warp reading one column over 32 rows (the BPTT's
// dz·W_hᵀ) hits 32 banks, while a warp reading one row over 32 columns (the
// products) reads consecutive words.
__host__ __device__ inline int wide_ws(int NC, int elem_bytes) {
  return NC + (elem_bytes == 2 ? 2 : 1);
}

// Row stride of the f32 h rows in shared memory, and the k-slice length: a
// whole number of float4s, so the products read h four k at a time.
__host__ __device__ inline int wide_hs(int H) { return (H + 3) & ~3; }
__host__ __device__ inline int wide_kl(int H, int KS) { return ((H + KS - 1) / KS + 3) & ~3; }

inline int wide_ks(int NC, int H, int max_threads) {
  int ks = 1;
  while (ks < 32 && 2 * ks * NC <= max_threads && 2 * ks <= H) ks *= 2;
  return ks;
}

// The BPTT's dz·W_hᵀ as work items (row k, column slice): CS slices of the
// NC columns a row (a power of two up to 8, each a whole number of float4s),
// the fewest FMAs a thread over ceil(H·CS / NT) rounds; the CS threads of a
// row are adjacent lanes and add their partials with shuffles.
__host__ __device__ inline int wide_cs(int H, int NT, int NC) {
  int best = 1, best_cost = (H + NT - 1) / NT * NC;
  for (int cs = 2; cs <= 8 && NC % (4 * cs) == 0; cs *= 2) {
    const int cost = (H * cs + NT - 1) / NT * (NC / cs);
    if (cost < best_cost) best = cs, best_cost = cost;
  }
  return best;
}

// kernel_for(R, w_smem) → the kernel's address; base_bytes(R, NC, KS) → its
// shared memory before the W_h slice. W_h stays in shared memory whenever it
// fits at some R; among the R that fit, the smallest whose 2·ceil(B/R)
// clusters the card holds at once (one wave, the shortest step), else the
// largest. Rows are bounded so that one gate pair falls to each thread
// (R·Hb <= NT) and, for the BPTT (prefetch), R·H <= kWidePrefetch·NT.
// gates: 4 (LSTM) or 3 (GRU); max_threads: the kernels' launch bound.
template <class KernelFor, class BaseBytes>
cudaError_t wide_plan(int B, int H, int Hb, int U, int gates, int max_threads, int elem_bytes,
                      bool bptt, KernelFor kernel_for, BaseBytes base_bytes, WidePlan* plan) {
  if (B < 1 || H < 1 || Hb < 1 || (gates * Hb) % 32 != 0 || U < 1 || U > kWideMaxCluster ||
      (U - 1) * Hb >= H || U * Hb < H || gates * Hb > max_threads)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  const int NC = gates * Hb, KS = wide_ks(NC, H, max_threads), NT = NC * KS;
  const size_t w_bytes = (size_t)H * wide_ws(NC, elem_bytes) * elem_bytes;
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    WidePlan best{};
    bool found = false;
    for (int R : kWideRows) {
      if (R * Hb > NT || (bptt && R * H > kWidePrefetch * NT)) continue;
      const size_t smem = base_bytes(R, NC, KS) + (w_smem ? w_bytes : 0);
      if (smem > (size_t)optin) continue;
      const void* kernel = kernel_for(R, w_smem != 0);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      const int tiles = (B + R - 1) / R;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)(U * tiles), 2);
      cfg.blockDim = dim3((unsigned)NT);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)U;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) continue;
      best = WidePlan{U, Hb, NC, KS, NT, R, w_smem, clusters, (int)smem};
      found = true;
      if (2 * tiles <= clusters) break;
    }
    if (found) {
      *plan = best;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

// Launch kernel_for(plan.R, plan.w_smem) as a grid of (U·tiles, 2) blocks in
// clusters of U along x, on `stream`, with `args` (cudaLaunchKernelExC).
template <class KernelFor>
cudaError_t wide_launch(const WidePlan& plan, int B, KernelFor kernel_for, void** args,
                        cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(plan.U * ((B + plan.R - 1) / plan.R)), 2);
  cfg.blockDim = dim3((unsigned)plan.NT);
  cfg.dynamicSmemBytes = (size_t)plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)plan.U;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(plan.R, plan.w_smem != 0), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_plan_out(const WidePlan& p, int* out) {
  const int v[9] = {p.U, p.Hb, p.NC, p.KS, p.NT, p.R, p.w_smem, p.clusters, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

}  // namespace percival
