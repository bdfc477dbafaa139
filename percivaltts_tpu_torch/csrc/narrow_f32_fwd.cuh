// The f32 forward at the widths one block held before (route "narrow_f32",
// ops/narrow_f32_layout.py), shared by bilstm_fwd_narrow_f32.cu and
// bigru_fwd_narrow_f32.cu: the kernel body, which the two cells specialise
// with their gate phase (f32_cells.cuh). The split, the packing of W_h, the
// plan (narrow_f32_plan with fwd set) and the product (nf_product) are the
// BPTT's (narrow_f32_common.cuh).
//
// One thread-block cluster of U <= 8 blocks a direction and tile of R batch
// rows; block b owns units b·Hb … (Hb a multiple of 8; the last block may
// hold fewer) with all of their gates. Its f32 slice of W_h (H × NCP,
// packed by ops/narrow_f32_layout.py::pack_wh) stays in shared memory for
// the whole sequence beside two buffers of the R rows of h, so each step
// reads it once for all R rows. Per step s:
//   1. the product z = h · W_h of the block's columns (nf_product, on all
//      warps), summed as the BPTT's recompute; one __syncthreads;
//   2. the gate phase of each (row, unit) pair, from z and the input gates it
//      loaded a step ahead: its new c and h in registers; h written into the
//      other buffer of h rows of every block of the cluster (distributed
//      shared memory; the block's own at U = 1);
//   3. cluster arrive (release);
//   4. under the barrier's latency: the loads of step s+1's input gates into
//      registers and step s's stores of y (and c);
//   5. cluster wait (acquire); at U = 1 a __syncthreads instead.
// The release of step 3 waits for the block's earlier memory operations, so
// the global loads and stores of a step are issued after it, a step before
// the next release. Nothing of shared memory is read or written between the
// arrive and the wait.
//
// Where the whole of W_h fits the registers of 4H threads, gates·H/4 <= 96
// words a thread (H a multiple of 16: the GRU up to H = 128, the LSTM up to
// 96), the plan may keep it there instead (resident = 1, U = 1, R = 1 or 2,
// narrow_f32_fwd_reg): thread (unit u, k lane q) holds W[k][g·H + u] of
// every gate g over the k with (k % 16) / 4 == q, the order in which the
// shared-memory product sums, and the four k lanes of a unit are
// neighbouring lanes of a warp. Per step: the product of the thread's k
// (h read from shared memory as broadcast float4s), the four lanes' sums
// added ((s0 + s1) + (s2 + s3)) by two xor shuffles, lane q the gate phase
// of row q, h into the other buffer of h rows, the next step's input gates
// loaded and y stored; one __syncthreads. No W_h is read from memory after
// the prologue, and no barrier but the block's.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "narrow_f32_common.cuh"

namespace percival {

// Step s visits frame t(s): 0 … T−1 for the forward direction, T−1 … 0 for
// the backward one. wp: the direction's packed W_h (U, H, NCP), 16-byte
// aligned.
template <class Cell, int R>
__device__ __forceinline__ void narrow_f32_fwd(Cell& cell, const float* __restrict__ wp,
                                               int n_steps, int B, int H, int Hb, int NCP,
                                               bool backward) {
  namespace cg = cooperative_groups;
  constexpr int G = Cell::kGates;
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * R;
  const int WS = nf_ws(NCP);
  const int u0 = rank * Hb, nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x, warp = tid >> 5;
  wp += (size_t)rank * H * NCP;
  auto frame = [=](int s) { return backward ? n_steps - 1 - s : s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* const s_w = reinterpret_cast<float*>(smem);  // [H][WS]
  float* const s_h = s_w + H * WS;                     // [2][R][H]
  float* const s_z = s_h + 2 * R * H;                  // [R][WS]

  // the gate phase: pair i of thread tid is q = tid + kNfThreads·i, unit
  // q % Hb, row q / Hb (consecutive threads on consecutive units); R·Hb
  // pairs, Hb <= kNfMaxHb. A pair of a unit past H does nothing; one of a
  // row past B runs on zero input gates and stores nothing
  constexpr int kNeed = (R * kNfMaxHb + kNfThreads - 1) / kNfThreads;
  constexpr int kPairs = kNeed < kNfMaxPairs ? kNeed : kNfMaxPairs;
  typename Cell::Op op[kPairs];
  int pu[kPairs], pr[kPairs];
  float hv[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int q = tid + kNfThreads * i;
    pu[i] = q % Hb;
    pr[i] = q / Hb;
    hv[i] = 0.0f;
  }
  auto live = [&](int i) { return pr[i] < R && pu[i] < nu; };
  auto row_ok = [&](int i) { return row0 + pr[i] < B; };
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
      if (live(i)) cell.load(op[i], frame(s), row0 + pr[i], u0 + pu[i], row_ok(i));
  };

  // ---- prologue: the W_h slice; h of step −1 zero; the input gates of step 0
  for (int i = tid; i < H * (NCP / 4); i += kNfThreads) {
    const int k = i / (NCP / 4), c = 4 * (i - k * (NCP / 4));
    cp_async16(s_w + k * WS + c, wp + (size_t)k * NCP + c, true);
  }
  cp_async_commit();
  for (int i = tid; i < R * H; i += kNfThreads) s_h[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
    if (live(i)) cell.init(op[i], u0 + pu[i]);
  prefetch(0);
  cp_async_wait<0>();
  if (U > 1)
    cluster.sync();  // every block running (its shared memory a target), its slice landed
  else
    __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    float* const next = s_h + ((s + 1) & 1) * R * H;
    nf_product<R>(s_w, s_h + (s & 1) * R * H, s_z, H, NCP, warp);
    __syncthreads();  // z complete
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (!live(i)) continue;
      const int u = pu[i], r = pr[i];
      float z[G];
#pragma unroll
      for (int g = 0; g < G; ++g) z[g] = s_z[r * WS + g * Hb + u];
      hv[i] = cell.step(op[i], z);
      const int k = r * H + u0 + u;
      if (U > 1) {
        for (int dst = 0; dst < U; ++dst) cluster.map_shared_rank(next, dst)[k] = hv[i];
      } else {
        next[k] = hv[i];
      }
    }
    if (U > 1) cluster_arrive();  // this block's h of step s stored in every block
    if (s + 1 < n_steps) prefetch(s + 1);
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
      if (live(i) && row_ok(i)) cell.store(op[i], frame(s), row0 + pr[i], u0 + pu[i], hv[i]);
    if (U > 1)
      cluster_wait();  // every block's h of step s stored, every z of step s read
    else
      __syncthreads();
  }
}

// ---- W_h in registers (resident = 1) --------------------------------------

constexpr int kNfRegMaxWords = 96;  // W_h words a thread
constexpr int kNfRegRows[2] = {1, 2};
// A block of the resident kernel asks for this much shared memory, so that
// no two share an SM (two need more than its 228 KB): the step is a chain
// of latencies, which a second block would lengthen.
constexpr int kNfRegSmem = 116 * 1024;
// its step estimate, in cycles (fitted as kNfFwdStep, PERF.md): the gate
// phase, the shuffles and the loop, then the product, gates·H·H·R / 71
constexpr long long kNfRegStep = 989;

__host__ __device__ inline bool nf_reg_fits(int H, int gates) {
  return H % 16 == 0 && H <= 128 && gates * H <= 4 * kNfRegMaxWords;
}

inline long long nf_reg_cost(int H, int gates, int R) {
  return kNfRegStep + (long long)gates * H * H * R / 71;
}

// Thread (u, q) = (tid / 4, tid % 4); 4H threads; KQ = H / 16 k-quads a lane.
// wp: the direction's W_h itself, (H, gates·H) with row stride NCP = gates·H
// (one block's packing is the identity but for its padding columns, so the
// launcher packs nothing).
template <class Cell, int KQ, int R>
__device__ __forceinline__ void narrow_f32_fwd_reg(Cell& cell, const float* __restrict__ wp,
                                                   int n_steps, int B, int NCP, bool backward) {
  constexpr int G = Cell::kGates, H = 16 * KQ;
  const int tid = threadIdx.x, q = tid & 3, u = tid >> 2;
  const int row0 = blockIdx.x * R;
  auto frame = [=](int s) { return backward ? n_steps - 1 - s : s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* const s_h = reinterpret_cast<float*>(smem);  // [2][R][H]

  float w[G][KQ][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < KQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[g][i][e] = wp[(size_t)(4 * (q + 4 * i) + e) * NCP + g * H + u];
  for (int i = tid; i < R * H; i += 4 * H) s_h[i] = 0.0f;
  const bool live = q < R, row_ok = row0 + q < B;  // lane q: the gate phase of row q
  typename Cell::Op op;
  if (live) {
    cell.init(op, u);
    cell.load(op, frame(0), row0 + q, u, row_ok);
  }
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const float* hb = s_h + (s & 1) * R * H;
    float acc[G][R];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
#pragma unroll
    for (int i = 0; i < KQ; ++i) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = ld4(hb + r * H + 4 * (q + 4 * i));
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g][r] = dot4(hv, make_float4(w[g][i][0], w[g][i][1], w[g][i][2], w[g][i][3]),
                           acc[g][r]);
      }
    }
    float z[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], 1);
        acc[g][r] += __shfl_xor_sync(0xffffffffu, acc[g][r], 2);
      }
      z[g] = acc[g][0];
#pragma unroll
      for (int r = 1; r < R; ++r)
        if (q == r) z[g] = acc[g][r];
    }
    if (live) {
      const float hv = cell.step(op, z);
      s_h[((s + 1) & 1) * R * H + q * H + u] = hv;
      if (s + 1 < n_steps) cell.load(op, frame(s + 1), row0 + q, u, row_ok);
      if (row_ok) cell.store(op, frame(s), row0 + q, u, hv);
    }
    __syncthreads();  // h of step s complete, h of step s − 1 read
  }
}

inline cudaLaunchConfig_t nf_reg_config(int H, int R, int B, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = nf_config(1, R, kNfRegSmem, B, attr);
  cfg.blockDim = dim3((unsigned)(4 * H));
  return cfg;
}

// The forward's plan of B rows at width H (a multiple of 8): the least of
// narrow_f32_plan's (fwd: W_h in shared memory) and, where nf_reg_fits, the
// resident kernel at R = 1 and 2 (nf_reg_cost) where its blocks fit one
// wave (a second wave measured slower than the shared-memory plans at
// B = 160), the shared-memory plan on a tie. blocks / rows > 0 as narrow_f32_plan's overrides (the resident kernel
// only at blocks <= 1), resident >= 0 takes only that kind.
// kernel_for(R) / reg_kernel_for(H, R) → the kernels' addresses.
template <class KernelFor, class RegKernelFor>
cudaError_t narrow_f32_fwd_plan(int B, int H, int gates, int blocks, int rows, int resident,
                                KernelFor kernel_for, RegKernelFor reg_kernel_for,
                                NarrowF32Plan* plan) {
  if (B < 1 || H < kNfK || H % kNfK || blocks < 0 || rows < 0 || resident > 1)
    return cudaErrorInvalidValue;
  NarrowF32Plan best{};
  long long best_cost = -1;
  if (resident != 1) {
    const cudaError_t err = narrow_f32_plan(B, H, gates, blocks, rows, kernel_for, &best, true);
    if (err == cudaSuccess)
      best_cost = nf_fwd_cost(H, best.U, best.NCP, best.R, best.waves);
    else if (err != cudaErrorInvalidConfiguration)
      return err;
  }
  if (resident != 0 && blocks <= 1 && nf_reg_fits(H, gates)) {
    for (int R : kNfRegRows) {
      if (rows && R != rows) continue;
      const void* kernel = reg_kernel_for(H, R);
      if (kernel == nullptr) return cudaErrorInvalidValue;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNfRegSmem);
      if (err != cudaSuccess) return err;
      NarrowF32Plan p{1, H, gates * H, (gates * H + kNfCols - 1) / kNfCols * kNfCols, R, 0, 0,
                      kNfRegSmem, 1};
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = nf_reg_config(H, R, B, attr);
      err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
      if (p.clusters < 1 || p.waves > 1) continue;
      const long long cost = nf_reg_cost(H, gates, R);
      if (best_cost < 0 || cost < best_cost) best = p, best_cost = cost;
    }
  }
  if (best_cost < 0) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

inline void narrow_f32_fwd_plan_out(const NarrowF32Plan& p, int* out) {
  narrow_f32_plan_out(p, out);
  out[8] = p.resident;
}

// The plan of a launch's (B, H, Hb, U, R, resident), checked against the
// split it packed W_h for; then the launch: grid (U · ceil(B / R), 2
// directions), 512 threads in clusters of U, or 4H threads for the resident
// kernel.
template <class KernelFor, class RegKernelFor>
cudaError_t narrow_f32_fwd_launch(int B, int H, int Hb, int U, int R, int resident, int gates,
                                  KernelFor kernel_for, RegKernelFor reg_kernel_for, void** args,
                                  cudaStream_t stream) {
  if (resident < 0) return cudaErrorInvalidValue;
  NarrowF32Plan plan{};
  cudaError_t err =
      narrow_f32_fwd_plan(B, H, gates, U, R, resident, kernel_for, reg_kernel_for, &plan);
  if (err != cudaSuccess) return err;
  if (plan.U != U || plan.Hb != Hb || plan.resident != resident) return cudaErrorInvalidValue;
  if (!resident) return narrow_f32_launch(plan, B, kernel_for, args, stream);
  const void* kernel = reg_kernel_for(H, R);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNfRegSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = nf_reg_config(H, R, B, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace percival
