// The streamed tensor-core cluster BPTTs (route "wide_mma_stream":
// bilstm_bwd_wide_mma_stream.cu, bigru_bwd_wide_mma_stream.cu): the launch
// plan, the shared-memory layout, the TMA ring that streams a block's W_hᵀ
// slice from L2, and the two products of a step on one chunk of it.
//
// The split and the numbers are those of "wide_mma" (wide_mma_common.cuh,
// ops/wide_mma_layout.py::plan): a cluster of U <= 16 blocks a direction and
// tile of R batch rows, block b owning units b·Hb … b·Hb + Hb − 1 with all of
// their gates, NC = gates·Hb packed W_hᵀ rows a block, both products on
// mma.sync m16n8k16 with f32 accumulators, the dh partials reduce-scattered
// into their owners' slots through distributed shared memory and added in
// block order. What differs is where the slice lives: past H = 608 (LSTM) /
// 672 (GRU) it no longer fits beside the tiles, so its K = H is cut into
// chunks of 64 k (NC × 64 bf16, 128 bytes a packed row; packed chunk-major by
// ops/wide_mma_layout.py::pack_wh_stream). The last nres chunks stay resident
// for the whole sequence; the first nstr = chunks − nres are streamed every
// step, in order, by one producer warp through a ring of kWsRing slots with
// cp.async.bulk (one TMA copy a chunk), each slot's arrival counted on its
// "full" mbarrier and its release by the 15 compute warps on its "empty" one;
// the ring wraps across steps and passes. Each chunk feeds both products of a
// step (the next step's recompute over its 64 k, this step's dh of its 64
// units), so W_h crosses L2 → SM once a step a cluster.
//
// Within a chunk's packed row the eight 16-byte units are stored XOR-swizzled
// (unit u of row p at u ^ (p % 8)), by the packing, so that the eight rows an
// ldmatrix (plain or .trans) reads fall in eight different bank groups.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_common.cuh"
#include "wide_mma_common.cuh"

namespace percival {

// 15 compute warps and the producer: 512 threads, so that ptxas may give a
// thread 128 registers (17 warps would leave 96: five warps on one of the
// SM's four schedulers)
constexpr int kWsWarps = 15;                       // compute warps
constexpr int kWsThreads = 32 * (kWsWarps + 1);    // and the producer warp
constexpr int kWsChunk = 64;                       // k a chunk of the slice
constexpr int kWsRing = 3;                         // ring slots of streamed chunks
constexpr int kWsMaxRows = 24;                     // batch rows a cluster (kernels for 8, 16, 24)
constexpr int kWsTpw = 2;                          // 8-row tiles a cell warp takes

// 8-row tiles a cell warp takes at NT8 tiles a cluster: up to kWsTpw, but one
// for the GRU at three tiles (two would leave its 128 registers short).
__host__ __device__ constexpr int ws_tpw(int gates, int NT8) {
  return gates == 3 && NT8 == 3 ? 1 : NT8 < kWsTpw ? NT8 : kWsTpw;
}

// Warps of the recompute and the gate math ("cells": a unit group and up to
// ws_tpw 8-row tiles each, every A fragment read once for all of them); every
// compute warp takes dh items.
__host__ __device__ inline int ws_cells(int gates, int NUG, int NT8) {
  const int tpw = ws_tpw(gates, NT8);
  return NUG * ((NT8 + tpw - 1) / tpw);
}

struct WideStreamPlan {
  int U, Hb, NC;   // the split (ops/wide_mma_layout.py::plan)
  int R;           // batch rows a cluster
  int nres, nstr;  // chunks resident, chunks streamed every step
  int clusters;    // clusters the card holds at once
  int waves;       // ceil(2·ceil(B / R) / clusters)
  int dbuf;        // 1: two buffers of partial slots (one cluster barrier a step)
  int smem;        // dynamic shared memory a block, bytes
};

__host__ __device__ inline int ws_chunks(int H) { return (H + kWsChunk - 1) / kWsChunk; }
__host__ __device__ inline size_t ws_tile_bytes(int NC) { return (size_t)NC * kWsChunk * 2; }

// Shared memory: s_ring (kWsRing chunk tiles) | s_res (nres chunk tiles) |
// s_h (R × WS bf16) | s_recv (bufs × U × Hb × R f32) | s_dg (R × DS bf16) |
// the ring's full and empty mbarriers. Every tile starts on a 128-byte
// boundary of the block's window (the swizzle assumes it).
__host__ __device__ inline size_t ws_smem(int H, int U, int Hb, int NC, int R, int nres,
                                          int bufs) {
  return (size_t)(kWsRing + nres) * ws_tile_bytes(NC) + wm_h_bytes(H, R) +
         wm_recv_bytes(U, Hb, R, bufs) + align16((size_t)R * wm_ds(NC) * 2) + 2 * kWsRing * 8;
}

// The step estimate the plan weighs rows against chunks and waves by, in
// picoseconds: a fixed part (the gate phase, the barriers, the ring's
// hand-offs), the streamed chunks' packed rows (128 bytes each from L2), and
// the products' R·NC·H multiply-adds; fitted by least squares to 14 steps
// timed on an H100 SXM (H = 640–1792, R = 8–24, rms 1.2 µs;
// ops/wide_mma_layout.py::stream_step_ps replays it, PERF.md).
constexpr long long kWsStepPs = 7540000, kWsRowPs = 1261, kWsMacPs = 1993;
__host__ __device__ inline long long ws_step_ps(int H, int NC, int R, int nstr) {
  return kWsStepPs + kWsRowPs * nstr * NC + kWsMacPs * ((long long)R * NC * H / 1024);
}

// grid (U · ceil(B / R), 2 directions) of kWsThreads-thread blocks in clusters of U along x
inline cudaLaunchConfig_t ws_config(int U, int R, int smem, int B, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = wm_config(U, R, smem, B, attr);
  cfg.blockDim = dim3((unsigned)kWsThreads);
  return cfg;
}

// ugs: units a unit group (8 LSTM, 16 GRU). Rows R = 8, 16, … 32 whose cells
// fit the 15 compute warps (ws_cells) and whose block fits shared memory with
// the ring and no resident chunk; at each, a second buffer of partial slots
// where it fits (one cluster barrier a step, not two), then as many chunks
// resident as fit (at most all but one); among them the least waves ×
// ws_step_ps, then the smallest R.
// kernel_for(R / 8) → the kernel instantiated for R rows a cluster.
template <class KernelFor>
cudaError_t wide_stream_plan(int B, int H, int Hb, int U, int gates, int ugs,
                             KernelFor kernel_for, WideStreamPlan* plan) {
  if (B < 1 || H < kWmK || H % kWmK || Hb < ugs || Hb % ugs || U < 1 || U > kWideMaxCluster ||
      (U - 1) * Hb >= H || U * Hb < H || Hb / ugs > kWsWarps)
    return cudaErrorInvalidValue;
  const int NC = gates * Hb, NUG = Hb / ugs, nch = ws_chunks(H);
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideStreamPlan best{};
  long long best_cost = 0;
  bool found = false;
  for (int R = 8; R <= kWsMaxRows; R += 8) {
    const size_t base = ws_smem(H, U, Hb, NC, R, 0, 1);
    if (ws_cells(gates, NUG, R / 8) > kWsWarps || base > (size_t)optin) continue;
    const int dbuf = ws_smem(H, U, Hb, NC, R, 0, 2) <= (size_t)optin;
    const size_t room =
        ((size_t)optin - ws_smem(H, U, Hb, NC, R, 0, 1 + dbuf)) / ws_tile_bytes(NC);
    const int nres = room < (size_t)(nch - 1) ? (int)room : nch - 1;
    const size_t smem = ws_smem(H, U, Hb, NC, R, nres, 1 + dbuf);
    const void* kernel = kernel_for(R / 8);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    WideStreamPlan p{U, Hb, NC, R, nres, nch - nres, 0, 0, dbuf, (int)smem};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = ws_config(U, R, p.smem, B, attr);
    err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    const long long cost = p.waves * ws_step_ps(H, NC, R, p.nstr);
    if (!found || cost < best_cost) best = p, best_cost = cost;
    found = true;
  }
  if (!found) return cudaErrorInvalidConfiguration;
  // the attribute of the last plan tried with that kernel stands: set the chosen one's
  err = cudaFuncSetAttribute(kernel_for(best.R / 8), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             best.smem);
  if (err != cudaSuccess) return err;
  *plan = best;
  return cudaSuccess;
}

template <class KernelFor>
cudaError_t wide_stream_launch(const WideStreamPlan& plan, int B, KernelFor kernel_for,
                               void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = ws_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(plan.R / 8), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_stream_plan_out(const WideStreamPlan& p, int* out) {
  const int v[10] = {p.U, p.Hb, p.NC, p.R, p.nres, p.nstr, p.clusters, p.waves, p.dbuf, p.smem};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// ---- the ring: mbarriers, TMA, the compute warps' own barrier --------------

__device__ __forceinline__ void ws_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void ws_mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WS_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WS_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void ws_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void ws_mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) global → this
// block's shared memory by the TMA, completing on bar
__device__ __forceinline__ void ws_bulk_load(void* dst, const void* src, int bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// the 15 compute warps alone (the producer warp runs its own loop)
__device__ __forceinline__ void ws_compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWsWarps) : "memory");
}

// The producer warp: every pass (the prologue's recompute, then one a step
// but the last) walks the nstr streamed chunks of the block's slice (wp: its
// (chunks, NC, 64) tiles) in order through the ring. It joins the compute
// warps' cluster barriers (barrier.cluster counts every thread), each at a
// point where the chunks the compute warps need before they arrive are in
// flight, and runs ahead by the ring (as far as the slots the compute warps
// release before they arrive).
__device__ __forceinline__ void ws_produce(const __nv_bfloat16* __restrict__ wp,
                                           __nv_bfloat16* s_ring, uint64_t* full,
                                           uint64_t* empty, int NC, int nstr, int n_steps,
                                           int dbuf, int lane) {
  const int tile = NC * kWsChunk, bytes = (int)ws_tile_bytes(NC), total = n_steps * nstr;
  int g = 0;  // the next streamed chunk of the sequence
  auto issue_upto = [&](int lim) {
    for (lim = lim < total ? lim : total; g < lim; ++g) {
      const int slot = g % kWsRing, use = g / kWsRing;
      if (use > 0) ws_mbar_wait(&empty[slot], (use - 1) & 1);  // released by every compute warp
      if (lane == 0) {
        ws_mbar_expect_tx(&full[slot], bytes);
        ws_bulk_load(s_ring + (size_t)slot * tile, wp + (size_t)(g % nstr) * tile, bytes,
                     &full[slot]);
      }
      __syncwarp();
    }
  };
  issue_upto(nstr + kWsRing);  // the prologue's pass, and the ring's worth of the next
  cluster_arrive();
  cluster_wait();
  for (int s = 0; s + 1 < n_steps; ++s) {
    if (!dbuf) {  // the compute warps arrive after the gate phase, wait after chunk 0
      cluster_arrive();
      cluster_wait();
    }
    issue_upto((s + 2) * nstr + kWsRing);  // step s's pass, and the ring's worth of the next
    cluster_arrive();
    cluster_wait();
  }
}

// One chunk of the recompute for a cell warp: z[t][j] += the unit group's m16
// tiles j of packed rows (arow: ug·GR + ld_row + 8·(ld_mat & 1), the lane's
// ldmatrix row of tile 0) · h_prevᵀ of the warp's 8-row tiles t < ntiles
// (hrow: s_h at the lane's row of its first tile and column ld_mat·8; the
// next tile 8·WS further) over the chunk's k-steps (ksteps: 4, or 2 for the
// last chunk of an H ≡ 32 mod 64), in order, in pairs; each A fragment is
// read once for the warp's tiles.
template <int MT, int TPW>
__device__ __forceinline__ void ws_recompute(float (&z)[TPW][MT][4], const __nv_bfloat16* tile,
                                             const __nv_bfloat16* hrow, int WS, int ntiles,
                                             int k0, int ksteps, int arow, int ld_row,
                                             int ld_mat) {
  for (int kp = 0; kp < ksteps; kp += 2) {
    uint32_t b[TPW][4];
#pragma unroll
    for (int t = 0; t < TPW; ++t)
      if (t < ntiles)
        ldmatrix_x4(hrow + t * 8 * WS + k0 + kp * 16, b[t][0], b[t][1], b[t][2], b[t][3]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * (kp + h) + (ld_mat >> 1);  // the lane's 16-byte unit of the row
      uint32_t a[MT][4];
#pragma unroll
      for (int j = 0; j < MT; ++j)
        ldmatrix_x4(tile + (arow + 16 * j) * kWsChunk + ((u ^ ld_row) << 3), a[j][0], a[j][1],
                    a[j][2], a[j][3]);
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        if (t >= ntiles) break;
        const uint32_t bb[2] = {b[t][2 * h], b[t][2 * h + 1]};
#pragma unroll
        for (int j = 0; j < MT; ++j) mma_bf16_16816(z[t][j], a[j], bb);
      }
    }
  }
}

// One chunk of this step's chained product: its units' dhᵀ · the dz tile,
// K = the block's NC packed rows in k-steps in order, A by ldmatrix.trans from
// the chunk, B from s_dg. An item is DHM 16-unit m-tiles (each B fragment
// read once for them; 2 for the LSTM, 1 for the GRU, whose cells hold more
// registers across the pass) and every 8-row
// n-tile; the chunk's items rotate over the compute warps from chunk to chunk
// (item i of chunk c on warp (c·items + i) % kWsWarps). Each lane's
// (unit, 2 rows) partials go to the slot (rank, unit) of the unit's owner as
// a float2.
template <int DHM, int NT8>
__device__ __forceinline__ void ws_dh_chunk(cooperative_groups::cluster_group& cluster,
                                            const __nv_bfloat16* tile,
                                            const __nv_bfloat16* s_dg, float* recv, int c,
                                            int H, int Hb, int NC, int rank, int warp,
                                            int lane) {
  const int g = lane >> 2, q = lane & 3, ld_row = lane & 7, ld_mat = lane >> 3;
  const int R = 8 * NT8, DS = wm_ds(NC);
  const int rest = H - c * kWsChunk, mtc = (rest < kWsChunk ? rest : kWsChunk) / 16;
  const int items = mtc / DHM;
  for (int i = ((warp - c * items) % kWsWarps + kWsWarps) % kWsWarps; i < items;
       i += kWsWarps) {
    float acc[DHM][NT8][4];
#pragma unroll
    for (int mi = 0; mi < DHM; ++mi)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][n][k] = 0.0f;
    const __nv_bfloat16* a_row = tile + (8 * (ld_mat >> 1) + ld_row) * kWsChunk;
    const __nv_bfloat16* b_row = s_dg + ld_row * DS + 8 * (ld_mat & 1);
#pragma unroll 2
    for (int kk = 0; kk < NC / 16; ++kk) {
      uint32_t a[DHM][4];
#pragma unroll
      for (int mi = 0; mi < DHM; ++mi) {
        const int u = 2 * (DHM * i + mi) + (ld_mat & 1);
        ldmatrix_x4_trans(a_row + kk * 16 * kWsChunk + ((u ^ ld_row) << 3), a[mi][0], a[mi][1],
                          a[mi][2], a[mi][3]);
      }
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        uint32_t b[2];
        ldmatrix_x2(b_row + n * 8 * DS + kk * 16, b[0], b[1]);
#pragma unroll
        for (int mi = 0; mi < DHM; ++mi) mma_bf16_16816(acc[mi][n], a[mi], b);
      }
    }
    // lane rows: units k = 64c + 16m + g and k + 8, batch rows 8n + 2q, +1
#pragma unroll
    for (int mi = 0; mi < DHM; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = c * kWsChunk + 16 * (DHM * i + mi) + g + 8 * h;
        const int owner = k / Hb;
        float* dst = cluster.map_shared_rank(recv, owner) + (rank * Hb + (k - owner * Hb)) * R +
                     2 * q;
#pragma unroll
        for (int n = 0; n < NT8; ++n) {
          *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[mi][n][2 * h],
                                                                acc[mi][n][2 * h + 1]);
        }
      }
    }
  }
}

}  // namespace percival
