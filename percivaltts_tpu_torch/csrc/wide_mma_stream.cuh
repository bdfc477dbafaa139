// The streamed tensor-core cluster kernels (route "wide_mma_stream"): the
// BPTTs (bilstm_bwd_wide_mma_stream.cu, bigru_bwd_wide_mma_stream.cu) and the
// forwards (bilstm_fwd_wide_mma_stream.cu, bigru_fwd_wide_mma_stream.cu):
// their launch plans, their shared-memory layouts, the TMA ring that streams
// a block's W_hᵀ slice from L2, and the products of a step on one chunk of it.
//
// The split and the numbers are those of "wide_mma" (wide_mma_common.cuh,
// ops/wide_mma_layout.py::plan): a cluster of U <= 16 blocks a direction and
// tile of R batch rows, block b owning units b·Hb … b·Hb + Hb − 1 with all of
// their gates, NC = gates·Hb packed W_hᵀ rows a block, the products on
// mma.sync m16n8k16 with f32 accumulators; in the BPTT the dh partials
// reduce-scattered into their owners' slots through distributed shared
// memory and added in block order. What differs is where the slice lives:
// past H = 608 (LSTM) / 672 (GRU) it no longer fits beside the tiles, so its
// K = H is cut into chunks of 64 k (NC × 64 bf16, 128 bytes a packed row;
// packed chunk-major by ops/wide_mma_layout.py::pack_wh_stream; up to H =
// 1536 / 1792 one packing for both passes, past it the BPTT's deep layout,
// below, packs its own 32-k chunks and the forward stays on "wide": the two
// passes' limits part until the forward's redesign). The last nres chunks
// stay resident for the whole sequence; the first nstr = chunks − nres are
// streamed every step, in order, by one producer warp through a ring of
// kWsRing slots with
// cp.async.bulk (one TMA copy a chunk), each slot's arrival counted on its
// "full" mbarrier and its release by the compute warps on its "empty" one;
// the ring wraps across steps and passes. In the BPTT each chunk feeds both
// products of a step (the next step's recompute over its 64 k, this step's
// dh of its 64 units); in the forward it feeds the step's one product over
// its 64 k. Either way W_h crosses L2 → SM once a step a cluster.
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
  int chunk;       // k a chunk: kWsChunk, or kWdChunk in the deep layout (below)
  int ppw;         // deep layout: (unit group, 8-row tile) pairs a compute warp; else 0
  int scratch;     // deep layout: bytes of dh partials a cluster in global memory; else 0
  int ring;        // ring slots: kWsRing, or in the deep layout as many as fit
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

// ---- the deep layout (past the widths the 64-k layout fits) ----------------
//
// Past H = 1536 (LSTM) / 1792 (GRU) a block of the 64-k layout no longer fits
// at 8 rows: three 64-k ring slots (NC × 128 bytes each), the whole h_prev
// tile (R × (H + 8) bf16) and the U × Hb × R f32 partial slots outgrow the
// 227 KB, and the LSTM's unit groups outnumber the 15 compute warps. The deep
// layout keeps the split, the packed rows and the products on mma.sync, and
// cuts the block's footprint:
//   * chunks of kWdChunk = 32 k (NC × 64 bytes a slot; packed chunk-major by
//     ops/wide_mma_layout.py::pack_wh_stream(…, chunk=32), 16-byte unit u of
//     row p at u ^ ((p % 8) >> 1)), all of them streamed through a ring of as
//     many slots as the block's room holds (3 to kWdMaxRing: the bytes in
//     flight from L2 are what a latency-bound stream's rate grows with);
//   * h_prev through the ring: each chunk's copy carries the R rows of h_prev
//     at its 32 k beside its W_hᵀ tile (one 64-byte TMA copy a row), in place
//     of the R × (H + 8) tile;
//   * the dh partials through L2: each block writes its partial of every
//     unit for the R rows into the owner's slots of a scratch buffer in
//     global memory ([owner][source block][Hb][R] f32 a cluster, two buffers
//     by step parity), and after the step's one cluster barrier, whose
//     release / acquire at cluster scope orders global memory too, every
//     compute thread of the owner adds a share of its U slots in block order
//     (read past L1, ld.global.cg) into the block's carry tile, which the
//     gate phase reads;
//   * warps that loop over unit groups: a compute warp takes PPW consecutive
//     (unit group, 8-row tile) pairs of the block, unit-group-major, each A
//     fragment read once for the pairs of its group;
//   * the dh product's items one 16-unit m-tile each (two a chunk), over
//     K = the block's NC packed rows in order, rotating over the 15 compute
//     warps from chunk to chunk.
// One cluster a direction and tile of rows, as the 64-k layout: no wait
// across clusters. The sums are replayed by
// ops/wide_mma_layout.py::replay_stream_recompute / replay_stream_dh.

constexpr int kWdChunk = 32;            // k a chunk of the deep layout
constexpr int kWdHs = kWdChunk + 8;     // row stride of a slot's h_prev rows: 80 bytes
// the widest H, ops/wide_layout.py::MAX_H: at 8 rows 15 compute warps × 4
// pairs hold the LSTM's 32 unit groups, × 2 the GRU's 16
constexpr int kWdMaxH = 4096;
constexpr int kWdMaxRing = 8;           // ring slots at most
// pairs a compute warp at most: the kernels instantiated (the GRU's cells
// hold more registers across the pass)
__host__ __device__ constexpr int wd_max_ppw(int gates) { return gates == 4 ? 4 : 2; }
// dh partials a compute thread loads at once when it sums them: the most the
// registers of its pairs' accumulators leave (ptxas: with 8 at a time the
// LSTM's one-tile 4-pair kernel spilled, with 4 the GRU's 2-pair ones)
__host__ __device__ constexpr int wd_part_loads(int gates) { return gates == 4 ? 4 : 2; }

__host__ __device__ inline size_t wd_tile_bytes(int NC) { return (size_t)NC * kWdChunk * 2; }

// Shared memory of a deep block: s_ring (ring chunk tiles) | s_hr (ring × R
// rows of kWdHs bf16) | s_dg (R × DS bf16) | s_carry (Hb × R f32: the
// summed dh partials) | the ring's full and empty mbarriers: wd_slot_bytes
// a slot beside the dz and carry tiles.
__host__ __device__ inline size_t wd_slot_bytes(int NC, int R) {
  return wd_tile_bytes(NC) + (size_t)R * kWdHs * 2 + 2 * 8;
}
__host__ __device__ inline size_t wd_smem(int NC, int Hb, int R, int ring) {
  return align16((size_t)R * wm_ds(NC) * 2) + (size_t)Hb * R * 4 +
         (size_t)ring * wd_slot_bytes(NC, R);
}

// bytes of dh partials a cluster: two buffers of [owner][source][Hb][R] f32
__host__ __device__ inline size_t wd_scratch_bytes(int U, int Hb, int R) {
  return (size_t)2 * U * U * Hb * R * 4;
}

// The deep layout's step estimate in picoseconds, in the 64-k layout's form:
// a fixed part, the streamed chunks' packed rows (64 bytes each from L2) and
// the products' R·NC·H multiply-adds, fitted to 10 steps timed on an H100
// SXM (tools/bwd_step_breakdown.py --deep-fit; ops/wide_mma_layout.py::
// deep_step_ps replays it, PERF.md).
constexpr long long kWdStepPs = 8107936, kWdRowPs = 631, kWdMacPs = 2466;
__host__ __device__ inline long long wd_step_ps(int H, int NC, int R) {
  return kWdStepPs + kWdRowPs * (long long)(H / kWdChunk) * NC +
         kWdMacPs * ((long long)R * NC * H / 1024);
}

// The kernel a plan launches: kernel_for(R / 8) in the 64-k layout,
// deep_for(R / 8, PPW) in the deep one (null where none is instantiated).
template <class KernelFor, class DeepFor>
const void* ws_kernel_of(const WideStreamPlan& p, KernelFor kernel_for, DeepFor deep_for) {
  return p.chunk == kWsChunk ? kernel_for(p.R / 8) : deep_for(p.R / 8, p.ppw);
}

// ugs: units a unit group (8 LSTM, 16 GRU). Where the 64-k layout fits at 8
// rows (its cells within the 15 compute warps, its block with the ring and no
// resident chunk within shared memory), rows R = 8, 16, 24 whose cells and
// block fit; at each, a second buffer of partial slots where it fits (one
// cluster barrier a step, not two), then as many chunks resident as fit (at
// most all but one). Past it, the deep layout up to kWdMaxH: rows R = 8,
// 16, 24 at the fewest pairs a compute warp, up to wd_max_ppw, whose kernel
// is instantiated (at least the pairs over the 15 compute warps) and whose
// block fits with kWsRing slots; at each, as many slots as fit, up to
// kWdMaxRing. Among them the least waves × step
// estimate, then the smallest R.
template <class KernelFor, class DeepFor>
cudaError_t wide_stream_plan(int B, int H, int Hb, int U, int gates, int ugs,
                             KernelFor kernel_for, DeepFor deep_for, WideStreamPlan* plan) {
  if (B < 1 || H < kWmK || H % kWmK || Hb < ugs || Hb % ugs || U < 1 || U > kWideMaxCluster ||
      (U - 1) * Hb >= H || U * Hb < H)
    return cudaErrorInvalidValue;
  const int NC = gates * Hb, NUG = Hb / ugs, nch = ws_chunks(H);
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  const bool deep =
      ws_cells(gates, NUG, 1) > kWsWarps || ws_smem(H, U, Hb, NC, 8, 0, 1) > (size_t)optin;
  if (deep && H > kWdMaxH) return cudaErrorInvalidValue;
  WideStreamPlan best{};
  long long best_cost = 0;
  bool found = false;
  for (int R = 8; R <= kWsMaxRows; R += 8) {
    WideStreamPlan p{};
    long long step = 0;
    if (!deep) {
      const size_t base = ws_smem(H, U, Hb, NC, R, 0, 1);
      if (ws_cells(gates, NUG, R / 8) > kWsWarps || base > (size_t)optin) continue;
      const int dbuf = ws_smem(H, U, Hb, NC, R, 0, 2) <= (size_t)optin;
      const size_t room =
          ((size_t)optin - ws_smem(H, U, Hb, NC, R, 0, 1 + dbuf)) / ws_tile_bytes(NC);
      const int nres = room < (size_t)(nch - 1) ? (int)room : nch - 1;
      const size_t smem = ws_smem(H, U, Hb, NC, R, nres, 1 + dbuf);
      p = WideStreamPlan{U, Hb, NC, R, nres, nch - nres, 0, 0, dbuf, (int)smem, kWsChunk, 0, 0,
                         kWsRing};
      step = ws_step_ps(H, NC, R, p.nstr);
      if (kernel_for(R / 8) == nullptr) return cudaErrorInvalidValue;
    } else {
      int ppw = (NUG * (R / 8) + kWsWarps - 1) / kWsWarps;  // pairs a warp at least
      while (ppw <= wd_max_ppw(gates) && deep_for(R / 8, ppw) == nullptr) ++ppw;
      if (ppw > wd_max_ppw(gates) || wd_smem(NC, Hb, R, kWsRing) > (size_t)optin) continue;
      const size_t room = ((size_t)optin - wd_smem(NC, Hb, R, 0)) / wd_slot_bytes(NC, R);
      const int ring = room < (size_t)kWdMaxRing ? (int)room : kWdMaxRing;
      p = WideStreamPlan{U,        Hb, NC, R, 0, H / kWdChunk, 0,  0,
                         0,        (int)wd_smem(NC, Hb, R, ring), kWdChunk, ppw,
                         (int)wd_scratch_bytes(U, Hb, R), ring};
      step = wd_step_ps(H, NC, R);
    }
    const void* kernel = ws_kernel_of(p, kernel_for, deep_for);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = ws_config(U, R, p.smem, B, attr);
    err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    const long long cost = p.waves * step;
    if (!found || cost < best_cost) best = p, best_cost = cost;
    found = true;
  }
  if (!found) return cudaErrorInvalidConfiguration;
  // the attribute of the last plan tried with that kernel stands: set the chosen one's
  err = cudaFuncSetAttribute(ws_kernel_of(best, kernel_for, deep_for),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, best.smem);
  if (err != cudaSuccess) return err;
  *plan = best;
  return cudaSuccess;
}

template <class KernelFor, class DeepFor>
cudaError_t wide_stream_launch(const WideStreamPlan& plan, int B, KernelFor kernel_for,
                               DeepFor deep_for, void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = ws_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(&cfg, ws_kernel_of(plan, kernel_for, deep_for), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_stream_plan_out(const WideStreamPlan& p, int* out) {
  const int v[14] = {p.U,    p.Hb,   p.NC,    p.R,   p.nres,    p.nstr,  p.clusters,
                     p.waves, p.dbuf, p.smem, p.chunk, p.ppw, p.scratch, p.ring};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
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

// The producer's issue of streamed chunks: chunk g of the sequence (chunk
// g % nstr of a pass) into ring slot g % kWsRing once every compute warp has
// released that slot's previous chunk (g − kWsRing), one TMA copy by lane 0.
struct WsIssuer {
  const __nv_bfloat16* wp;  // the block's (chunks, NC, 64) tiles
  __nv_bfloat16* s_ring;
  uint64_t *full, *empty;
  int tile, bytes, nstr, total, lane;
  int g = 0;  // the next streamed chunk of the sequence
  // issue every chunk before min(lim, total)
  __device__ __forceinline__ void upto(int lim) {
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
  }
};

__device__ __forceinline__ WsIssuer ws_issuer(const __nv_bfloat16* wp, __nv_bfloat16* s_ring,
                                              uint64_t* full, uint64_t* empty, int NC,
                                              int nstr, int n_passes, int lane) {
  return WsIssuer{wp,   s_ring,           full, empty, NC * kWsChunk, (int)ws_tile_bytes(NC),
                  nstr, n_passes * nstr, lane};
}

// The BPTT's producer warp: every pass (the prologue's recompute, then one a
// step but the last) walks the nstr streamed chunks of the block's slice (wp:
// its (chunks, NC, 64) tiles) in order through the ring. It joins the compute
// warps' cluster barriers (barrier.cluster counts every thread), each at a
// point where the chunks the compute warps need before they arrive are in
// flight, and runs ahead by the ring (as far as the slots the compute warps
// release before they arrive).
__device__ __forceinline__ void ws_produce(const __nv_bfloat16* __restrict__ wp,
                                           __nv_bfloat16* s_ring, uint64_t* full,
                                           uint64_t* empty, int NC, int nstr, int n_steps,
                                           int dbuf, int lane) {
  WsIssuer issue = ws_issuer(wp, s_ring, full, empty, NC, nstr, n_steps, lane);
  issue.upto(nstr + kWsRing);  // the prologue's pass, and the ring's worth of the next
  cluster_arrive();
  cluster_wait();
  for (int s = 0; s + 1 < n_steps; ++s) {
    if (!dbuf) {  // the compute warps arrive after the gate phase, wait after chunk 0
      cluster_arrive();
      cluster_wait();
    }
    issue.upto((s + 2) * nstr + kWsRing);  // step s's pass, and the ring's worth of the next
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

// ---- the deep layout's pieces ------------------------------------------------

// Where unit u (16 bytes) of a chunk tile's packed row p lies in the row, by
// the row's r8 = p % 8: u ^ r8 in a 64-k row of 128 bytes, u ^ (r8 >> 1) in a
// 32-k row of 64 bytes (its eight rows span two 128-byte lines), so that the
// eight rows an ldmatrix (plain or .trans) reads at one unit fall in eight
// different 16-byte bank groups either way.
template <int CK>
__device__ __forceinline__ int ws_unit(int u, int r8) {
  return CK == kWsChunk ? u ^ r8 : u ^ (r8 >> 1);
}

// The deep layout's producer warp: every pass (the prologue's recompute, then
// one a step but the last) walks the block's nch chunks in order through the
// ring's slots. A chunk's copy is its W_hᵀ tile (one TMA copy of NC × 64
// bytes, wp: the block's (chunks, NC, 32) tiles) and the R rows of h_prev at its 32 k
// (one 64-byte TMA copy a row, by lanes 0 … R − 1, into the slot's rows of
// kWdHs; rows past B read row B − 1, which no stored value reads), counted
// on the slot's "full" mbarrier. It joins the compute warps' one cluster
// barrier a step once every chunk of the pass they end there is in flight,
// and runs ahead by the ring (as far as the slots the compute warps release
// before they arrive). step_frame(p): the frame pass p recomputes.
template <class StepFrame>
__device__ __forceinline__ void wd_produce(const __nv_bfloat16* __restrict__ wp,
                                           const __nv_bfloat16* __restrict__ hp,
                                           __nv_bfloat16* s_ring, __nv_bfloat16* s_hr,
                                           uint64_t* full, uint64_t* empty, int NC, int R,
                                           int ring, int n_steps, int B, int H, int row0,
                                           StepFrame step_frame, int lane) {
  const int tile = NC * kWdChunk, nch = H / kWdChunk, total = n_steps * nch;
  const int tile_bytes = (int)wd_tile_bytes(NC), row_bytes = kWdChunk * 2;
  const int row = (row0 + lane < B ? row0 + lane : B - 1);  // this lane's h_prev row
  // the next chunk of the sequence: g, chunk c of pass "pass", into a slot
  // filled "use" times before (counted on, not divided: ring is no constant)
  int g = 0, pass = 0, c = 0, slot = 0, use = 0;
  auto upto = [&](int lim) {
    for (lim = lim < total ? lim : total; g < lim; ++g) {
      if (use > 0) ws_mbar_wait(&empty[slot], (use - 1) & 1);  // released by every compute warp
      if (lane == 0) ws_mbar_expect_tx(&full[slot], tile_bytes + R * row_bytes);
      __syncwarp();
      if (lane == 0)
        ws_bulk_load(s_ring + (size_t)slot * tile, wp + (size_t)c * tile, tile_bytes, &full[slot]);
      if (lane < R)
        ws_bulk_load(s_hr + (size_t)(slot * R + lane) * kWdHs,
                     hp + ((size_t)step_frame(pass) * B + row) * H + c * kWdChunk, row_bytes,
                     &full[slot]);
      __syncwarp();
      if (++c == nch) c = 0, ++pass;
      if (++slot == ring) slot = 0, ++use;
    }
  };
  for (int s = 0; s + 1 < n_steps; ++s) {
    upto((s + 2) * nch + ring);  // passes up to s + 1, and the ring's worth beyond
    cluster_arrive();
    cluster_wait();
  }
  upto(total);
}

// One chunk of the deep layout's recompute for a compute warp: z[i] += the
// m16 tiles of pair i's unit group (packed rows gr·ug …) · h_prevᵀ of its
// 8-row tile (hb: the slot's h rows at the lane's row and column ld_mat·8,
// tile t 8·kWdHs rows on) over the chunk's two k-steps, in order, for the
// pairs i < np of the warp (pair p0 + i = ug·NT8 + t, unit-group-major); each
// A fragment of a k-step is read once for the pairs of its group (one
// k-step's fragments held at a time: the registers of the warp's pairs'
// accumulators leave no more).
template <int MT, int PPW, int NT8>
__device__ __forceinline__ void wd_recompute(float (&z)[PPW][MT][4], const __nv_bfloat16* tile,
                                             const __nv_bfloat16* hb, int np, int p0, int gr,
                                             int ld_row, int ld_mat) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int u = 2 * kk + (ld_mat >> 1);  // the lane's 16-byte unit of the row
    uint32_t a[MT][4];                     // the current group's A fragments of k-step kk
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const int p = p0 + i, ug = p / NT8, t = p - ug * NT8;
      if (i == 0 || t == 0) {  // a new unit group (warp-uniform)
        const __nv_bfloat16* arow = tile + (ug * gr + ld_row + 8 * (ld_mat & 1)) * kWdChunk +
                                    (ws_unit<kWdChunk>(u, ld_row) << 3);
#pragma unroll
        for (int j = 0; j < MT; ++j)
          ldmatrix_x4(arow + 16 * j * kWdChunk, a[j][0], a[j][1], a[j][2], a[j][3]);
      }
      uint32_t bb[2];  // k-step kk of the tile's rows (lanes 0–15's addresses: k 0–7, 8–15)
      ldmatrix_x2(hb + t * 8 * kWdHs + kk * 16, bb[0], bb[1]);
#pragma unroll
      for (int j = 0; j < MT; ++j) mma_bf16_16816(z[i][j], a[j], bb);
    }
  }
}

// One chunk of the deep layout's chained product: its two 16-unit m-tiles
// of dhᵀ · the dz tile, one item each, K = the block's NC packed rows in
// k-steps in order (A by ldmatrix.trans from the chunk, B from s_dg); item i
// of chunk c on compute warp (2c + i) % kWsWarps. Each lane's (unit, 2 rows)
// partials go as float2 to this block's slot of the unit's owner in part
// (the step's buffer of the cluster's [owner][source][Hb][R] partials).
template <int NT8>
__device__ __forceinline__ void wd_dh_chunk(const __nv_bfloat16* tile,
                                            const __nv_bfloat16* s_dg, float* part, int c,
                                            int U, int Hb, int NC, int rank, int warp,
                                            int lane) {
  constexpr int R = 8 * NT8, items = kWdChunk / 16;
  const int i = ((warp - c * items) % kWsWarps + kWsWarps) % kWsWarps;
  if (i >= items) return;
  const int g = lane >> 2, q = lane & 3, ld_row = lane & 7, ld_mat = lane >> 3;
  const int DS = wm_ds(NC);
  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.0f;
  const __nv_bfloat16* a_row = tile + (8 * (ld_mat >> 1) + ld_row) * kWdChunk +
                               (ws_unit<kWdChunk>(2 * i + (ld_mat & 1), ld_row) << 3);
  const __nv_bfloat16* b_row = s_dg + ld_row * DS + 8 * (ld_mat & 1);
#pragma unroll 2
  for (int kk = 0; kk < NC / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4_trans(a_row + kk * 16 * kWdChunk, a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      uint32_t b[2];
      ldmatrix_x2(b_row + n * 8 * DS + kk * 16, b[0], b[1]);
      mma_bf16_16816(acc[n], a, b);
    }
  }
  // lane rows: units k = 32c + 16i + g and k + 8, batch rows 8n + 2q, +1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = c * kWdChunk + 16 * i + g + 8 * h;
    const int owner = k / Hb;
    float* dst = part + ((size_t)(owner * U + rank) * Hb + (k - owner * Hb)) * R + 2 * q;
#pragma unroll
    for (int n = 0; n < NT8; ++n)
      __stcg(reinterpret_cast<float2*>(dst + 8 * n), make_float2(acc[n][2 * h], acc[n][2 * h + 1]));
  }
}

// Every block's dh partials of this block's units (part: the step's buffer
// of the cluster's [owner][source][Hb][R] partials) added in block order
// into s_carry [Hb][R], a float2 (unit, 2 rows) a compute thread at a time
// (tid over the kWsWarps compute warps), LOADS of the sources' loads in
// flight at a time (wd_part_loads), read past L1 (other SMs wrote them
// before the cluster barrier).
template <int R, int LOADS>
__device__ __forceinline__ void wd_sum_partials(const float* part, float* s_carry, int U, int Hb,
                                                int rank, int tid) {
  constexpr int kPart = LOADS;
  const float2* own = reinterpret_cast<const float2*>(part + (size_t)rank * U * Hb * R);
  const int n = Hb * R / 2, stride = Hb * R / 2;  // float2s of a source's slab
  for (int i = tid; i < n; i += 32 * kWsWarps) {
    float2 sum = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < kWideMaxCluster / kPart; ++h) {
      float2 v[kPart];
#pragma unroll
      for (int j = 0; j < kPart; ++j)
        if (h * kPart + j < U) v[j] = __ldcg(own + (size_t)(h * kPart + j) * stride + i);
#pragma unroll
      for (int j = 0; j < kPart; ++j) {
        if (h * kPart + j >= U) break;
        sum.x += v[j].x;
        sum.y += v[j].y;
      }
    }
    reinterpret_cast<float2*>(s_carry)[i] = sum;
  }
}

// A compiler fence: the gate phase's loads of one pair stay after the
// previous pair's stores (hoisting every pair's loads ahead would hold them
// all in registers at once)
__device__ __forceinline__ void wd_pair_fence() { asm volatile("" ::: "memory"); }

// ---- the forwards ------------------------------------------------------------
//
// The forward's step is one product, zᵀ (NC × R) = W_hᵀ slice · round(h)ᵀ,
// over the same chunk tiles as the BPTT's recompute, then the gate math in
// the registers the accumulators land in and the all-gather of bf16 round(h)
// (bilstm_fwd_wide_mma.cu's structure). With no dz tile and no partial slots
// a block holds more rows than the BPTT's: up to kWsfMaxRows. A compute warp
// takes PPW consecutive (unit group, 8-row tile) pairs of the block in
// unit-group-major order, so that its pairs share one unit group, or two
// (PPW <= NT8: a warp's run crosses at most one group's end), and each A
// fragment it reads from a chunk serves every pair of its group; B
// fragments come from the h tile. With 15 compute warps the unit groups
// (8 LSTM, 4 GRU at H = 1024) do not divide them: the pairs do.

constexpr int kWsfMaxRows = 64;  // batch rows a cluster
// pairs a compute warp at most (the kernels instantiated; more would leave
// the accumulators, carries and gate operands short of 128 registers)
__host__ __device__ constexpr int wsf_max_ppw(int gates) { return gates == 4 ? 4 : 3; }

// (unit group, 8-row tile) pairs a compute warp: the fewest that 15 warps cover
__host__ __device__ inline int wsf_ppw(int NUG, int NT8) {
  return (NUG * NT8 + kWsWarps - 1) / kWsWarps;
}

struct WideStreamFwdPlan {
  int U, Hb, NC;   // the split (ops/wide_mma_layout.py::plan)
  int R;           // batch rows a cluster
  int PPW;         // (unit group, 8-row tile) pairs a compute warp
  int nres, nstr;  // chunks resident, chunks streamed every step
  int clusters;    // clusters the card holds at once
  int waves;       // ceil(2·ceil(B / R) / clusters)
  int dbuf;        // 1: two h buffers (one cluster barrier a step)
  int smem;        // dynamic shared memory a block, bytes
};

// Shared memory of a forward block: s_ring (kWsRing chunk tiles) | s_res
// (nres chunk tiles) | bufs × s_h (R × WS bf16) | s_stage (15 warps × PPW
// pairs × 8 rows × ugs units bf16: each warp's round(h), the exchange's
// source) | the ring's full and empty mbarriers.
__host__ __device__ inline size_t wsf_stage_bytes(int ugs, int ppw) {
  return (size_t)kWsWarps * ppw * 8 * ugs * 2;
}
__host__ __device__ inline size_t wsf_smem(int H, int NC, int R, int nres, int bufs, int ugs,
                                           int ppw) {
  return (size_t)(kWsRing + nres) * ws_tile_bytes(NC) + (size_t)bufs * wm_h_bytes(H, R) +
         wsf_stage_bytes(ugs, ppw) + 2 * kWsRing * 8;
}

// The forward's step estimate in picoseconds: a fixed part (the gate phase,
// the exchange, the cluster barrier), a second cluster barrier where one h
// buffer splits it, the streamed chunks' packed rows (128 bytes each from
// L2) and the product's R·NC·H multiply-adds; fitted by least squares to 112
// steps timed on an H100 SXM (H = 640–1792, R = 8–64, rings of 3–8 slots,
// a row's term over the ring's depth: 1970 ps / 3 at the kWsRing slots the
// kernels take; rms 1.4 µs; tools/fwd_step_breakdown.py --wide --stream
// --sweep; ops/wide_mma_layout.py::stream_fwd_step_ps replays it, PERF.md).
constexpr long long kWsfStepPs = 5329000, kWsfSyncPs = 1396000, kWsfRowPs = 657,
                    kWsfMacPs = 1807;
__host__ __device__ inline long long wsf_step_ps(int H, int NC, int R, int nstr, int dbuf) {
  return kWsfStepPs + (dbuf ? 0 : kWsfSyncPs) + kWsfRowPs * nstr * NC +
         kWsfMacPs * ((long long)R * NC * H / 1024);
}

// ugs: units a unit group (8 LSTM, 16 GRU). Rows R = 8, 16, … 64 whose pairs
// fall at most wsf_max_ppw to a compute warp and whose block fits shared
// memory with the ring, one h buffer and no resident chunk; at each, a
// second h buffer where it fits (one cluster barrier a step, not two), then
// as many chunks resident as the room holds (at most all but one: a deeper
// ring streams more bytes a step and measured slower at every (H, B) timed,
// fwd_step_breakdown.py --wide --stream --sweep, PERF.md); among them the
// least waves × wsf_step_ps, then the smallest R (rows > 0: that R alone, a
// measurement's override). kernel_for(PPW) → the kernel instantiated for
// PPW pairs a warp.
template <class KernelFor>
cudaError_t wide_stream_fwd_plan(int B, int H, int Hb, int U, int gates, int ugs, int rows,
                                 KernelFor kernel_for, WideStreamFwdPlan* plan) {
  if (B < 1 || H < kWmK || H % kWmK || Hb < ugs || Hb % ugs || U < 1 || U > kWideMaxCluster ||
      (U - 1) * Hb >= H || U * Hb < H || Hb / ugs > kWsWarps || rows < 0)
    return cudaErrorInvalidValue;
  const int NC = gates * Hb, NUG = Hb / ugs, nch = ws_chunks(H);
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideStreamFwdPlan best{};
  long long best_cost = 0;
  bool found = false;
  for (int R = 8; R <= kWsfMaxRows; R += 8) {
    if (rows && R != rows) continue;
    const int ppw = wsf_ppw(NUG, R / 8);
    if (ppw > wsf_max_ppw(gates) || wsf_smem(H, NC, R, 0, 1, ugs, ppw) > (size_t)optin) continue;
    const int dbuf = wsf_smem(H, NC, R, 0, 2, ugs, ppw) <= (size_t)optin;
    const int room =
        (int)(((size_t)optin - wsf_smem(H, NC, R, 0, 1 + dbuf, ugs, ppw)) / ws_tile_bytes(NC));
    const int nres = room < nch - 1 ? room : nch - 1;
    const size_t smem = wsf_smem(H, NC, R, nres, 1 + dbuf, ugs, ppw);
    const void* kernel = kernel_for(ppw);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    WideStreamFwdPlan p{U, Hb, NC, R, ppw, nres, nch - nres, 0, 0, dbuf, (int)smem};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = ws_config(U, R, p.smem, B, attr);
    err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    const long long cost = p.waves * wsf_step_ps(H, NC, R, p.nstr, dbuf);
    if (!found || cost < best_cost) best = p, best_cost = cost;
    found = true;
  }
  if (!found) return cudaErrorInvalidConfiguration;
  // the attribute of the last plan tried with that kernel stands: set the chosen one's
  err = cudaFuncSetAttribute(kernel_for(best.PPW), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             best.smem);
  if (err != cudaSuccess) return err;
  *plan = best;
  return cudaSuccess;
}

// The last kWsfCached forward plans by their arguments and the current card
// (a plan's occupancy is the card's): a plan queries the occupancy of every
// R it weighs (tens of µs of host time a launch). Each kernel file keeps its
// own (a static of its anonymous namespace, so that no two libraries loaded
// in one process share one); launches come from one host thread (the Python
// wrapper's).
constexpr int kWsfCached = 32;
struct WsfPlanCache {
  int key[kWsfCached][6];
  WideStreamFwdPlan plan[kWsfCached];
  int used = 0, next = 0;

  // wide_stream_fwd_plan, or the cached plan of the same arguments with its
  // kernel's attributes set again (another plan may have set them since)
  template <class KernelFor>
  cudaError_t get(int B, int H, int Hb, int U, int gates, int ugs, int rows,
                  KernelFor kernel_for, WideStreamFwdPlan* out) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const int k[6] = {device, B, H, Hb, U, rows};
    for (int i = 0; i < used; ++i) {
      bool same = true;
      for (int j = 0; j < 6; ++j) same = same && key[i][j] == k[j];
      if (!same) continue;
      *out = plan[i];
      const void* kernel = kernel_for(out->PPW);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out->smem);
      if (err != cudaSuccess) return err;
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    err = wide_stream_fwd_plan(B, H, Hb, U, gates, ugs, rows, kernel_for, out);
    if (err != cudaSuccess) return err;
    for (int j = 0; j < 6; ++j) key[next][j] = k[j];
    plan[next] = *out;
    next = (next + 1) % kWsfCached;
    used = used < kWsfCached ? used + 1 : used;
    return cudaSuccess;
  }
};

template <class KernelFor>
cudaError_t wide_stream_fwd_launch(const WideStreamFwdPlan& plan, int B, KernelFor kernel_for,
                                   void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = ws_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel_for(plan.PPW), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_stream_fwd_plan_out(const WideStreamFwdPlan& p, int* out) {
  const int v[11] = {p.U,    p.Hb,       p.NC,    p.R,    p.PPW, p.nres,
                     p.nstr, p.clusters, p.waves, p.dbuf, p.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

// The forward's producer warp: step s's nstr streamed chunks in order
// through the ring. The compute warps consume all of a step's chunks before
// they reach its cluster barriers (one, or with one h buffer two), so before
// joining them the producer issues the rest of step s and the ring's worth
// of step s + 1, whose chunks do not depend on h: they stream while the gate
// phase, the exchange and the barriers run.
__device__ __forceinline__ void ws_produce_fwd(const __nv_bfloat16* __restrict__ wp,
                                               __nv_bfloat16* s_ring, uint64_t* full,
                                               uint64_t* empty, int NC, int nstr, int n_steps,
                                               int dbuf, int lane) {
  WsIssuer issue = ws_issuer(wp, s_ring, full, empty, NC, nstr, n_steps, lane);
  issue.upto(kWsRing);  // step 0's first chunks
  cluster_arrive();  // the prologue's barrier
  cluster_wait();
  for (int s = 0; s + 1 < n_steps; ++s) {
    issue.upto((s + 1) * nstr + kWsRing);
    if (!dbuf) {  // the compute warps arrive after the product, wait before the exchange
      cluster_arrive();
      cluster_wait();
    }
    cluster_arrive();  // h of step s + 1 landed
    cluster_wait();
  }
  issue.upto(n_steps * nstr);  // the last step's
}

// One chunk of a forward's product for a compute warp: z[i] += the m16 tiles
// of pair i's unit group (arow: the lane's ldmatrix row of tile 0 of the
// warp's first group; pairs i >= na lie in the next group, gr packed rows
// on) · round(h)ᵀ of pair i's 8-row tile (hb: the h buffer at the lane's row
// and column ld_mat·8; pair i's tile t0 + i, or i − na past the group's end,
// 8·WS rows apart) over the chunk's k-steps (ksteps: 4, or 2 for the last
// chunk of an H ≡ 32 mod 64), in order, for pairs i < np; each A fragment
// is read once for the pairs of its group. With one pair a warp the odd
// k-steps go into zo (added to z after the last chunk: two chains of
// dependent products, not one); up to two pairs, each pair's B fragments
// of two k-steps come in one ldmatrix.x4 ahead of their products; from
// three on, one ldmatrix.x2 a k-step just before them (the registers of
// the accumulators leave no more).
template <int MT, int PPW>
__device__ __forceinline__ void wsf_product(float (&z)[PPW][MT][4], float (&zo)[PPW][MT][4],
                                            const __nv_bfloat16* tile, const __nv_bfloat16* hb,
                                            int WS, int np, int na, int t0, int k0, int ksteps,
                                            int arow, int gr, int ld_row, int ld_mat) {
  auto hrow = [&](int i) { return hb + (i < na ? t0 + i : i - na) * 8 * WS + k0; };
  auto load_a = [&](uint32_t(&a)[MT][4], int i, int kk) {
    const int ar = arow + (i == 0 ? 0 : gr);
    const int u = 2 * kk + (ld_mat >> 1);  // the lane's 16-byte unit of the row
#pragma unroll
    for (int j = 0; j < MT; ++j)
      ldmatrix_x4(tile + (ar + 16 * j) * kWsChunk + ((u ^ ld_row) << 3), a[j][0], a[j][1],
                  a[j][2], a[j][3]);
  };
  if constexpr (PPW <= 2) {
    for (int kp = 0; kp < ksteps; kp += 2) {
      uint32_t b[PPW][4];  // k-steps kp (b[i][0..1]) and kp + 1 (b[i][2..3]) of pair i's tile
#pragma unroll
      for (int i = 0; i < PPW; ++i)
        if (i < np) ldmatrix_x4(hrow(i) + kp * 16, b[i][0], b[i][1], b[i][2], b[i][3]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < PPW; ++i) {
          if (i >= np) break;
          if (i == 0 || i == na) load_a(a, i, kp + h);  // warp-uniform
          const uint32_t bb[2] = {b[i][2 * h], b[i][2 * h + 1]};
#pragma unroll
          for (int j = 0; j < MT; ++j) mma_bf16_16816(PPW == 1 && h ? zo[i][j] : z[i][j], a[j], bb);
        }
      }
    }
  } else {
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        if (i >= np) break;
        if (i == 0 || i == na) load_a(a, i, kk);  // warp-uniform
        uint32_t bb[2];
        ldmatrix_x2(hrow(i) + kk * 16, bb[0], bb[1]);  // lanes 0–15's addresses: k 0–7, 8–15
#pragma unroll
        for (int j = 0; j < MT; ++j) mma_bf16_16816(z[i][j], a[j], bb);
      }
    }
  }
}

// Hint the lines of the next step's gate operands into L2 (the kernels whose
// warps hold three or more pairs load them at the gate phase: their
// registers hold no prefetch)
__device__ __forceinline__ void wsf_prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// z += zo where one pair a warp split its k-steps (wsf_product), in that order
template <int MT, int PPW>
__device__ __forceinline__ void wsf_join(float (&z)[PPW][MT][4], const float (&zo)[PPW][MT][4]) {
  if constexpr (PPW == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) z[0][j][k] += zo[0][j][k];
  }
}

}  // namespace percival
