// The launch plans and shared-memory layouts of the tensor-core wide kernels:
// the BPTTs (bilstm_bwd_wide_mma.cu, bigru_bwd_wide_mma.cu) and the forwards
// (bilstm_fwd_wide_mma.cu, bigru_fwd_wide_mma.cu). Each runs one thread-block
// cluster of U <= 16 blocks a direction and tile of R batch rows (a multiple
// of 8 up to 64), block b owning units b·Hb … b·Hb + Hb − 1 with all of their
// gates (NC = gates·Hb gate columns) in unit groups of 8 (LSTM) or 16 (GRU)
// units, H a multiple of 32 (the wrappers zero-pad other widths). The split
// (U, Hb, NC) is the one of ops/wide_mma_layout.py::plan, which packs each
// block's W_hᵀ slice; the launcher picks R from the shared memory it takes,
// the warps' share of the (unit group, 8-row tile) cells, and the clusters
// the card holds at once (ops/wide_mma_layout.py::rows and ::fwd_rows replay
// the choice).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_common.cuh"
#include "wide_common.cuh"

namespace percival {

constexpr int kWmWarps = 16;
constexpr int kWmThreads = 32 * kWmWarps;
constexpr int kWmMaxRows = 64;  // batch rows a cluster
constexpr int kWmMaxMpw = 3;    // 16-unit tiles of the dh product a warp: H <= 768
constexpr int kWmK = 32;        // H is a whole number of these

struct WideMmaPlan {
  int U, Hb, NC;      // the split (ops/wide_mma_layout.py::plan)
  int R;              // batch rows a cluster
  int MPW;            // 16-unit tiles of the dh product a warp
  int clusters;       // clusters the card holds at once
  int waves;          // ceil(2·ceil(B / R) / clusters)
  int dbuf;           // 1: two buffers of partial slots (one cluster barrier a step)
  int smem;           // dynamic shared memory a block, bytes
};

// Row strides (elements): H + 8 for the W_hᵀ slice and the h tile, NC + 8 for
// the dgates tile; each is an odd number of 16-byte units, so the 8 rows an
// ldmatrix reads fall in 8 different bank groups.
__host__ __device__ inline int wm_ws(int H) { return H + 8; }
__host__ __device__ inline int wm_ds(int NC) { return NC + 8; }

// Shared memory: s_w (NC × WS bf16) | s_h (R × WS bf16) | s_recv (bufs × U ×
// Hb × R f32) | s_dg (R × DS bf16).
__host__ __device__ inline size_t wm_w_bytes(int H, int NC) {
  return align16((size_t)NC * wm_ws(H) * 2);
}
__host__ __device__ inline size_t wm_h_bytes(int H, int R) {
  return align16((size_t)R * wm_ws(H) * 2);
}
__host__ __device__ inline size_t wm_recv_bytes(int U, int Hb, int R, int bufs) {
  return align16((size_t)bufs * U * Hb * R * 4);
}
__host__ __device__ inline size_t wm_smem(int H, int U, int Hb, int NC, int R, int bufs) {
  return wm_w_bytes(H, NC) + wm_h_bytes(H, R) + wm_recv_bytes(U, Hb, R, bufs) +
         align16((size_t)R * wm_ds(NC) * 2);
}

// The cluster barrier in two halves: arrive (release: this thread's writes,
// remote ones included, are visible to whoever waits), then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (U · ceil(B / R), 2 directions) of 512-thread blocks in clusters of U along x
inline cudaLaunchConfig_t wm_config(int U, int R, int smem, int B, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(U * ((B + R - 1) / R)), 2);
  cfg.blockDim = dim3((unsigned)kWmThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)U;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// kernel_for(MPW) → the kernel's address. ugs: units a unit group (8 LSTM,
// 16 GRU). Rows R = 8, 16, … 64 that fit shared memory and leave one
// (unit group, 8-row tile) cell a warp (groups · R / 8 <= 16); among them the
// fewest waves of 2·ceil(B/R) clusters, then the smallest R (the shortest
// step). Where a second buffer of partial slots still fits at that R, the
// kernel takes it (dbuf) and needs one cluster barrier a step, not two.
template <class KernelFor>
cudaError_t wide_mma_plan(int B, int H, int Hb, int U, int gates, int ugs, KernelFor kernel_for,
                          WideMmaPlan* plan) {
  if (B < 1 || H < kWmK || H % kWmK || Hb < ugs || Hb % ugs || U < 1 || U > kWideMaxCluster ||
      (U - 1) * Hb >= H || U * Hb < H || Hb / ugs > kWmWarps)
    return cudaErrorInvalidValue;
  const int NC = gates * Hb, NUG = Hb / ugs, MPW = (H / 16 + kWmWarps - 1) / kWmWarps;
  if (MPW > kWmMaxMpw) return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideMmaPlan best{};
  bool found = false;
  for (int R = 8; R <= kWmMaxRows; R += 8) {
    const size_t single = wm_smem(H, U, Hb, NC, R, 1), twice = wm_smem(H, U, Hb, NC, R, 2);
    if (NUG * (R / 8) > kWmWarps || single > (size_t)optin) continue;
    const int dbuf = twice <= (size_t)optin;
    const size_t smem = dbuf ? twice : single;
    const void* kernel = kernel_for(MPW);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    WideMmaPlan p{U, Hb, NC, R, MPW, 0, 0, dbuf, (int)smem};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = wm_config(p.U, R, p.smem, B, attr);
    err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    if (!found || p.waves < best.waves) best = p;
    found = true;
  }
  if (!found) return cudaErrorInvalidConfiguration;
  // the attribute of the last R tried stands: set the chosen one's
  err = cudaFuncSetAttribute(kernel_for(MPW), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             best.smem);
  if (err != cudaSuccess) return err;
  *plan = best;
  return cudaSuccess;
}

template <class KernelFor>
cudaError_t wide_mma_launch(const WideMmaPlan& plan, int B, KernelFor kernel_for, void** args,
                            cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wm_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(plan.MPW), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_mma_plan_out(const WideMmaPlan& p, int* out) {
  const int v[9] = {p.U, p.Hb, p.NC, p.R, p.MPW, p.clusters, p.waves, p.dbuf, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// ---- the forwards -----------------------------------------------------------

constexpr int kWmFwdMaxTpw = 2;  // 8-row tiles a forward warp takes

struct WideMmaFwdPlan {
  int U, Hb, NC;  // the split (ops/wide_mma_layout.py::plan)
  int R;          // batch rows a cluster
  int TPW;        // 8-row tiles a warp: its A fragments serve each of them
  int WPG;        // warps a unit group, ceil(R / 8 / TPW)
  int KSP;        // parts of K: warps a cell's product is split over (their sums meet in s_red)
  int clusters;   // clusters the card holds at once
  int waves;      // ceil(2·ceil(B / R) / clusters)
  int dbuf;       // 1: two h buffers (one cluster barrier a step)
  int smem;       // dynamic shared memory a block, bytes
};

// Shared memory of a forward block: s_w (NC × WS bf16) | bufs × s_h (R × WS
// bf16) | s_stage (16 warps × 2 tiles × 8 rows × ugs units bf16: each warp's
// round_dt(h) in rows of 16-byte chunks, the exchange's source) | s_red
// ((KSP − 1) × CW warps' partial accumulators, TPW × the unit group's m16
// tiles × 4 f32 a lane: the K parts' sums; CW = NUG · WPG warps hold a cell).
__host__ __device__ inline size_t wm_fwd_stage_bytes(int ugs) {
  return (size_t)kWmWarps * kWmFwdMaxTpw * 8 * ugs * 2;
}
__host__ __device__ inline size_t wm_fwd_red_bytes(int ksp, int cw, int tpw, int mtiles) {
  return (size_t)(ksp - 1) * cw * tpw * mtiles * 4 * 32 * 4;
}
__host__ __device__ inline size_t wm_fwd_smem(int H, int NC, int R, int bufs, int ugs,
                                              size_t red) {
  return wm_w_bytes(H, NC) + (size_t)bufs * wm_h_bytes(H, R) + wm_fwd_stage_bytes(ugs) + red;
}

// Parts of K a cell's product takes: where fewer warps hold a cell (CW) than
// the SM has warp schedulers (4), as the GRU's 2 at R = 8 and H = 512, the
// warps that no cell holds take K parts of the held cells' products, in
// powers of two, at most one part a k-step pair (KP pairs of 16-wide
// k-steps). With 4 or more cell warps the split measured slower (the LSTM at
// R = 8 / 16, tools/fwd_step_breakdown.py --wide, variant no_kparts).
constexpr int kWmSchedulers = 4;
__host__ __device__ inline int wm_fwd_ksp(int cw, int KP) {
  int ksp = 1;
  while (cw < kWmSchedulers && 2 * ksp * cw <= kWmWarps && 2 * ksp <= KP) ksp *= 2;
  return ksp;
}

// 8-row tiles a warp at NT8 tiles over NUG unit groups (16 / NUG warps a
// group): as few as the warps allow, but 2 from 4 tiles on, so that each A
// fragment read from shared memory feeds two products.
__host__ __device__ inline int wm_fwd_tpw(int NT8, int NUG) {
  const int wpg = kWmWarps / NUG, spread = (NT8 + wpg - 1) / wpg;
  return NT8 >= 4 && spread < 2 ? 2 : spread;
}

// kernel_for(TPW) → the kernel's address. Rows R = 8, 16, … 64 whose tiles
// fall at most kWmFwdMaxTpw to a warp and whose block fits shared memory with
// one h buffer (and its KSP K parts' partial sums); among them the fewest
// waves of 2·ceil(B/R) clusters, then the smallest R (rows > 0: that R
// alone, for measurements). Where a second h buffer still fits at that R, the kernel
// takes it (dbuf) and needs one cluster barrier a step; else it splits the
// barrier around the gate math.
template <class KernelFor>
cudaError_t wide_mma_fwd_plan(int B, int H, int Hb, int U, int gates, int ugs, int rows,
                              KernelFor kernel_for, WideMmaFwdPlan* plan) {
  if (B < 1 || H < kWmK || H % kWmK || Hb < ugs || Hb % ugs || U < 1 || U > kWideMaxCluster ||
      (U - 1) * Hb >= H || U * Hb < H || Hb / ugs > kWmWarps || rows < 0)
    return cudaErrorInvalidValue;
  const int NC = gates * Hb, NUG = Hb / ugs, mtiles = gates * ugs / 16;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideMmaFwdPlan best{};
  bool found = false;
  for (int R = 8; R <= kWmMaxRows; R += 8) {
    if (rows && R != rows) continue;
    const int NT8 = R / 8, TPW = wm_fwd_tpw(NT8, NUG), WPG = (NT8 + TPW - 1) / TPW;
    int KSP = wm_fwd_ksp(NUG * WPG, H / 32);  // halved until the block fits
    while (KSP > 1 && wm_fwd_smem(H, NC, R, 1, ugs, wm_fwd_red_bytes(KSP, NUG * WPG, TPW, mtiles)) >
                          (size_t)optin)
      KSP /= 2;
    const size_t red = wm_fwd_red_bytes(KSP, NUG * WPG, TPW, mtiles);
    const size_t single = wm_fwd_smem(H, NC, R, 1, ugs, red),
                 twice = wm_fwd_smem(H, NC, R, 2, ugs, red);
    if (TPW > kWmFwdMaxTpw || single > (size_t)optin) continue;
    const int dbuf = twice <= (size_t)optin;
    const size_t smem = dbuf ? twice : single;
    const void* kernel = kernel_for(TPW);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    WideMmaFwdPlan p{U, Hb, NC, R, TPW, WPG, KSP, 0, 0, dbuf, (int)smem};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = wm_config(U, R, p.smem, B, attr);
    err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    if (!found || p.waves < best.waves) best = p;
    found = true;
  }
  if (!found) return cudaErrorInvalidConfiguration;
  // the attribute of the last R tried with that kernel stands: set the chosen one's
  err = cudaFuncSetAttribute(kernel_for(best.TPW), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             best.smem);
  if (err != cudaSuccess) return err;
  *plan = best;
  return cudaSuccess;
}

template <class KernelFor>
cudaError_t wide_mma_fwd_launch(const WideMmaFwdPlan& plan, int B, KernelFor kernel_for,
                                void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wm_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(plan.TPW), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_mma_fwd_plan_out(const WideMmaFwdPlan& p, int* out) {
  const int v[11] = {p.U,   p.Hb,       p.NC,    p.R,    p.TPW, p.WPG,
                     p.KSP, p.clusters, p.waves, p.dbuf, p.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

}  // namespace percival
