// The f32 cluster forward shared by bilstm_fwd_wide_f32.cu and
// bigru_fwd_wide_f32.cu (route "wide_f32", ops/wide_f32_layout.py): its launch
// plan, its shared-memory layout, and the kernel body, which the two cells
// specialise with their gate phase (f32_cells.cuh: F32LstmFwdCell,
// F32GruFwdCell).
//
// The split is the "wide" route's (ops/wide_layout.py::plan, the per-block
// packing pack_wh, (U, H, NC) a direction), which the BPTT of the route
// shares: one thread-block cluster of U <= 16 blocks a direction and tile of
// R = 8 or 4 batch rows (the plan's choice by a step estimate), block b
// owning units b·Hb … with all gates of each,
// NC = gates·Hb <= 128 gate columns. Each block's f32 slice of W_h (H × NC:
// 256 KiB for the LSTM at H = 512, 192 KiB for the GRU) is cut into chunks
// of 64 rows of k, as the BPTT's (rows padded to NC + 4 words): the last
// `nres` chunks stay in shared memory for the whole sequence beside two
// buffers of the R rows of h; the first `nreg` (<= 3), which do not fit
// there, stay in registers (the one lane that reads an element of the slice
// holds it: 16·CQ words a chunk a thread). Nothing of W_h is read from L2 after
// the prologue, and each step reads the slice once for all R rows.
//
// The product z = h · W_h[:, the block's columns] runs on all warps: warp
// (co, kw) owns a column group and k-quad group kw (kWffGroups of them); its
// lane (j = lane >> 3, p = lane & 7) CQ column quads 8·CQ·co + p + 8c
// (c < CQ: 8 columns on 8 warps at NC = 128, 4 on 12 warps at NC = 96) and,
// in every chunk, the k-quad q = 4kw + j (rows of k 64·ch + 4q … +3), for
// all R rows: 4·CQ·R sums in registers, each float4 of W feeding R rows. The
// four j lanes reduce-scatter theirs with two xor shuffles (0.75 a sum, where
// an all-reduce takes 2: a warp shuffle is one a clock an SM), so lane j
// ends with rows j and j + 4 as (s_j + s_j^2) + (s_j^1 + s_j^3), and stores
// them into the partials of group kw; the gate phase adds the four groups,
// ((p0 + p1) + p2) + p3. A quarter-warp reads 8 neighbouring float4s of one
// row of a chunk and one broadcast float4 of h: no bank conflicts. The rows
// of h lie k-quad-major, [H/4][R + 1][4] (the R rows' float4s of a k-quad
// side by side, padded so the four k lanes' quads lie on distinct banks),
// so that a lane's 8 h loads a k-quad are one address and constant offsets;
// NC is a template argument for the same reason (the chunk's rows at
// constant offsets): registers, not addresses, hold W_h.
//
// The exchange needs no cluster barrier: each block's h of a step goes
// into the other buffer of h of every block by st.async, whose bytes count
// down that block's mbarrier of the buffer; a block waits for its own
// mbarrier (all 4·R·H bytes of the step) before its next product. A block
// writes into a buffer only after it received the h that the buffer's
// reader sent after it last read it, so two buffers and two mbarriers
// suffice, and no block runs more than a step ahead of another.
//
// Per step s (frames t(s): 0 … T−1 for the forward direction, T−1 … 0 for
// the backward one):
//   1. wait for h of step s−1 (its mbarrier); the product from that buffer;
//      its partials; one __syncthreads;
//   2. the gate phase of each (row, unit) pair (one a thread), from the
//      partials and the input gates it loaded a step ahead: its new c / h in
//      registers; the h of 4 neighbouring units gathered by shuffles and
//      sent as one float4 into the other buffer of every block of the
//      cluster (distributed shared memory), each of the 4 lanes a quarter of
//      the blocks (nothing after the last step);
//   3. the loads of step s+1's input gates into registers and step s's
//      stores of y (and c), while the h of step s travels;
//   4. one __syncthreads (every partial read); thread 0 arms the mbarrier
//      of step s's h with its bytes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_common.cuh"
#include "wide_f32_common.cuh"
#include "wide_mma_common.cuh"

namespace percival {

constexpr int kWffRows[2] = {8, 4};  // batch rows a cluster the plan weighs
constexpr int kWffGroups = 4;        // k-quad groups: warps a column group
constexpr int kWffMaxReg = 3;        // chunks held in registers, 16·CQ words each a thread
constexpr int kWffStaticSmem = 16;   // the two mbarriers, beside the dynamic shared memory
// the plan's step estimate, ns: a fixed part (gate phase, exchange, the
// k lanes' reduce-scatter) and the product's R·NC·H FMAs a block at a rate,
// both fitted to tools/fwd_step_breakdown.py --wide --f32 on an H100 (PERF.md)
constexpr long long kWffStepNs = 1500;
constexpr long long kWffFmaPerNs = 165;

// floats of a k-quad of the h rows: the R rows' float4s, padded by one
__host__ __device__ constexpr int wff_quad(int R) { return 4 * (R + 1); }

struct WideF32FwdPlan {
  int U, Hb, NC;   // the split (ops/wide_layout.py::plan)
  int R;           // batch rows a cluster
  int nres, nreg;  // chunks resident in shared memory (the last ones), in registers (the first)
  int clusters;    // clusters the card holds at once
  int waves;       // ceil(2·ceil(B / R) / clusters)
  int smem;        // dynamic shared memory a block, bytes
};

// A product lane's column quads: 2 (8 columns) at NC = 128, 1 at 96 (a
// block's sums fit 255 registers a thread at 8 warps, 128 at 12); a warp
// covers 32·CQ columns of one k-quad group, so a block has
// kWffGroups · NC / (32·CQ) warps: 8 at NC = 128, 12 at 96.
__host__ __device__ constexpr int wff_quads(int NC) { return NC == 128 ? 2 : 1; }
__host__ __device__ constexpr int wff_threads(int NC) { return kWffGroups * NC / wff_quads(NC); }

// Shared memory: resident chunks [nres][64][NC + 4] | h rows [2][H/4][R + 1][4]
// | partials [kWffGroups][R][NC], all f32.
__host__ __device__ inline size_t wff_smem(int H, int NC, int nres, int R) {
  return (size_t)nres * wf_slot_bytes(NC) +
         sizeof(float) * (2 * (size_t)(H / 4) * wff_quad(R) + (size_t)kWffGroups * R * NC);
}

// The clusters of `kernel` (U blocks of `threads` threads, `smem` bytes)
// the current card holds at once. The attributes (all of the card's
// opt-in of shared memory beside the kernel's static mbarriers, non-portable
// cluster sizes) are set and the occupancy asked once a kernel, card, size
// and U: both cost host time that every launch would otherwise pay.
inline cudaError_t wff_clusters(const void* kernel, int smem, int U, int threads, int optin,
                                int* clusters) {
  struct Entry {
    int dev;
    const void* kernel;
    int smem, U, clusters;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (cache[i].dev == dev && cache[i].kernel == kernel && cache[i].smem == smem &&
        cache[i].U == U) {
      *clusters = cache[i].clusters;
      return cudaSuccess;
    }
  cudaFuncAttributes fa{};
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);  // beside the static mbarriers
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wm_config(U, kWffRows[0], smem, 1, attr);
  cfg.blockDim = dim3((unsigned)threads);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 64) cache[n++] = Entry{dev, kernel, smem, U, *clusters};
  return cudaSuccess;
}

// kernel_for(NC, nreg, nch, R) → the kernel's address (null where none is
// built; nch: the slice's chunks, a template argument so that the chunk loop
// unrolls). For R = 8 and 4 rows a cluster, the most chunks that fit stay in
// shared memory, the others (at most kWffMaxReg) in registers; the plan is
// the R of least waves × (kWffStepNs + R·NC·H / kWffFmaPerNs), 8 on a tie.
template <class KernelFor>
cudaError_t wide_f32_fwd_plan(int B, int H, int Hb, int U, int gates, KernelFor kernel_for,
                              WideF32FwdPlan* plan) {
  const int NC = gates * Hb, NCH = wf_chunks(H);
  if (B < 1 || NCH < 3 || H % kWfK || Hb < 1 || NC % 32 || NC > kWfMaxNC || U < 1 ||
      U > kWideMaxCluster || (U - 1) * Hb >= H || U * Hb < H)
    return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideF32FwdPlan best{};
  long long best_cost = -1;
  for (int R : kWffRows) {
    int nres = NCH;
    while (nres > 0 && wff_smem(H, NC, nres, R) + kWffStaticSmem > (size_t)optin) --nres;
    const int nreg = NCH - nres;
    if (nreg > kWffMaxReg || wff_smem(H, NC, nres, R) + kWffStaticSmem > (size_t)optin) continue;
    const void* kernel = kernel_for(NC, nreg, NCH, R);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    WideF32FwdPlan p{U, Hb, NC, R, nres, nreg, 0, 0, (int)wff_smem(H, NC, nres, R)};
    err = wff_clusters(kernel, p.smem, U, wff_threads(NC), optin, &p.clusters);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    const long long cost = p.waves * (kWffStepNs + (long long)R * NC * H / kWffFmaPerNs);
    if (best_cost < 0 || cost < best_cost) best = p, best_cost = cost;
  }
  if (best_cost < 0) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

// grid (U · ceil(B / R), 2 directions) of wff_threads(NC)-thread blocks in
// clusters of U
template <class KernelFor>
cudaError_t wide_f32_fwd_launch(const WideF32FwdPlan& plan, int B, KernelFor kernel_for,
                                void** args, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wm_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.blockDim = dim3((unsigned)wff_threads(plan.NC));
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(
      &cfg, kernel_for(plan.NC, plan.nreg, plan.nres + plan.nreg, plan.R), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_f32_fwd_plan_out(const WideF32FwdPlan& p, int* out) {
  const int v[9] = {p.U, p.Hb, p.NC, p.R, p.nres, p.nreg, p.clusters, p.waves, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// ---- the exchange: st.async into every block, counted by its mbarrier ----

__device__ __forceinline__ uint32_t cluster_addr(uint32_t cta_addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(cta_addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// 16 bytes into the shared memory of a block of the cluster (address and
// mbarrier both shared::cluster), completing 16 bytes of its transaction
__device__ __forceinline__ void st_async16(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// ---- the kernel body -------------------------------------------------------
//
// wp: the direction's packed W_h (U, H, NC), 16-byte aligned; H a multiple
// of 32 in NCH chunks (the last of 32 or 64 rows); NC = gates·Hb; NREG: the
// first chunks, held in registers.
template <class Cell, int NC, int NREG, int NCH, int R>
__device__ __forceinline__ void wide_f32_fwd(Cell& cell, const float* __restrict__ wp,
                                             int n_steps, int B, int H, bool backward) {
  namespace cg = cooperative_groups;
  constexpr int G = Cell::kGates, Hb = NC / G, WS = NC + 4, Q = wff_quad(R);
  constexpr int CQ = wff_quads(NC), CO = NC / (32 * CQ), NT = wff_threads(NC);
  constexpr int SLOT = kWfChunk * WS, PAIRS = (R * Hb + NT - 1) / NT;
  static_assert(R % 4 == 0, "the k lanes' reduce-scatter leaves rows j + 4m with lane j");
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * R;
  const int HB = (H / 4) * Q;  // floats of a buffer of h
  const int u0 = rank * Hb, nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  wp += (size_t)rank * H * NC;
  auto frame = [=](int s) { return backward ? n_steps - 1 - s : s; };
  auto chunk_rows = [&](int ch) { return min(kWfChunk, H - ch * kWfChunk); };

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_bar[2];  // s_bar[b]: the h of a step landed in buffer b
  float* const s_res = reinterpret_cast<float*>(smem);  // chunks NREG … NCH−1
  float* const s_h = s_res + (NCH - NREG) * SLOT;         // [2][H/4][R + 1][4]
  float* const s_part = s_h + 2 * HB;                     // [kWffGroups][R][NC]

  // the product's lane: column quads q0 + 8c (c < CQ), rows of k x0 … x0+3
  // of each chunk
  const int co = warp % CO, kw = warp / CO, j = lane >> 3;
  const int q0 = 8 * CQ * co + (lane & 7), x0 = 4 * (4 * kw + j);

  // the gate phase: pair i of thread tid is q = tid + NT·i, (row q / Hb,
  // unit q % Hb); whole warps of pairs (R·Hb and NT multiples of 32), so a
  // warp's lanes 4m … 4m+3 hold 4 neighbouring units of one row
  typename Cell::Op op[PAIRS];
  float hv[PAIRS];
  auto pair_at = [&](int i, int& r, int& u) {
    const int q = tid + NT * i;
    r = q / Hb;
    u = q - r * Hb;
    return r < R;
  };
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      int r, u;
      if (pair_at(i, r, u) && u < nu) cell.load(op[i], frame(s), row0 + r, u0 + u, row0 + r < B);
    }
  };

  // ---- prologue: the resident chunks, the lane's register chunks, h of
  // step −1 zero, the mbarriers, the input gates of step 0
  for (int ch = NREG; ch < NCH; ++ch) {
    const int kr = chunk_rows(ch);
    float* dst = s_res + (ch - NREG) * SLOT;
    const float* src = wp + (size_t)ch * kWfChunk * NC;
    for (int i = tid; i < kr * (NC / 4); i += NT) {
      const int x = i / (NC / 4), c = 4 * (i - x * (NC / 4));
      cp_async16(dst + x * WS + c, src + (size_t)x * NC + c, true);
    }
  }
  cp_async_commit();
  float4 wr[NREG > 0 ? NREG : 1][4][CQ];
#pragma unroll
  for (int i = 0; i < NREG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CQ; ++c)
        wr[i][e][c] = *reinterpret_cast<const float4*>(
            wp + (size_t)(i * kWfChunk + x0 + e) * NC + 4 * (q0 + 8 * c));
  for (int i = tid; i < 2 * HB; i += NT) s_h[i] = 0.0f;
  if (tid == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    int r, u;
    hv[i] = 0.0f;
    if (pair_at(i, r, u) && u < nu) cell.init(op[i], u0 + u);
  }
  prefetch(0);
  // the blocks lane 4m + d sends to, d + 4n < U: their buffers of h and
  // mbarriers as shared::cluster addresses
  uint32_t dst_h[kWideMaxCluster / 4], dst_bar[kWideMaxCluster / 4];
#pragma unroll
  for (int n = 0; n < kWideMaxCluster / 4; ++n) {
    const int d = min((lane & 3) + 4 * n, U - 1);
    dst_h[n] = cluster_addr(smem_addr(s_h), d);
    dst_bar[n] = cluster_addr(smem_addr(&s_bar[0]), d);
  }
  cp_async_wait<0>();
  cluster.sync();  // every block running, its mbarriers set, its chunks landed

  for (int s = 0; s < n_steps; ++s) {
    // h of step s−1 landed in buffer s & 1 (its mbarrier's use (s − 1) / 2)
    if (s > 0) mbar_wait(&s_bar[s & 1], ((s - 1) >> 1) & 1);
    const float* hb = s_h + (s & 1) * HB;
    float* const next = s_h + ((s + 1) & 1) * HB;
    float acc[R][CQ][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CQ; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.0f;
    // rows k … k+3 of W (w[e][c]: row k + e, column quad c) times the R rows
    // of h there
    auto quad = [&](const float4 (&w)[4][CQ], int k) {
      const float* hq = hb + (k / 4) * Q;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hq + 4 * r);
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          acc[r][c][0] = dot4(h4, make_float4(w[0][c].x, w[1][c].x, w[2][c].x, w[3][c].x),
                              acc[r][c][0]);
          acc[r][c][1] = dot4(h4, make_float4(w[0][c].y, w[1][c].y, w[2][c].y, w[3][c].y),
                              acc[r][c][1]);
          acc[r][c][2] = dot4(h4, make_float4(w[0][c].z, w[1][c].z, w[2][c].z, w[3][c].z),
                              acc[r][c][2]);
          acc[r][c][3] = dot4(h4, make_float4(w[0][c].w, w[1][c].w, w[2][c].w, w[3][c].w),
                              acc[r][c][3]);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NREG; ++i) quad(wr[i], i * kWfChunk + x0);
#pragma unroll
    for (int ch = NREG; ch < NCH; ++ch) {
      if (x0 >= chunk_rows(ch)) continue;
      const float* wc = s_res + (ch - NREG) * SLOT + x0 * WS + 4 * q0;
      float4 w[4][CQ];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < CQ; ++c)
          w[e][c] = *reinterpret_cast<const float4*>(wc + e * WS + 32 * c);
      quad(w, ch * kWfChunk + x0);
    }
    // the four j lanes' sums, reduce-scattered: lane j keeps the rows with
    // bit 1 of j (xor 16), then bit 0 (xor 8), ending with rows j + 4m as
    // (s_j + s_j^2) + (s_j^1 + s_j^3)
    const bool hi = (j & 2) != 0, lo = (j & 1) != 0;
    float half[R / 2][CQ][4];  // rows {0, 1, 4, 5, …} ^ 2·hi
#pragma unroll
    for (int m = 0; m < R / 2; ++m) {
      const int r = (m & 1) + 4 * (m >> 1);
#pragma unroll
      for (int c = 0; c < CQ; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = hi ? acc[r][c][e] : acc[r ^ 2][c][e];
          const float keep = hi ? acc[r ^ 2][c][e] : acc[r][c][e];
          half[m][c][e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
    }
#pragma unroll
    for (int m = 0; m < R / 4; ++m) {  // rows j + 4m
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = lo ? half[2 * m][c][e] : half[2 * m + 1][c][e];
          const float keep = lo ? half[2 * m + 1][c][e] : half[2 * m][c][e];
          v[e] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        *reinterpret_cast<float4*>(s_part + (kw * R + j + 4 * m) * NC + 4 * (q0 + 8 * c)) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();  // the partials complete

    // the gate phase; then the quad of lanes 4m … 4m+3 gathers its 4 units'
    // h (shuffles), and lane 4m + d sends the float4 to blocks d, d+4, …
    // (none after the last step)
    const bool send = s + 1 < n_steps;
    const uint32_t next_off = 4 * ((s + 1) & 1) * HB, bar_off = 8 * ((s + 1) & 1);
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      int r, u;
      if (!pair_at(i, r, u)) continue;  // whole warps
      if (u < nu) {
        float z[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* part = s_part + r * NC + g * Hb + u;
          z[g] = ((part[0] + part[R * NC]) + part[2 * R * NC]) + part[3 * R * NC];
        }
        hv[i] = cell.step(op[i], z);
      }
      const int qb = lane & ~3;
      const float4 h4 = make_float4(__shfl_sync(0xffffffffu, hv[i], qb),
                                    __shfl_sync(0xffffffffu, hv[i], qb + 1),
                                    __shfl_sync(0xffffffffu, hv[i], qb + 2),
                                    __shfl_sync(0xffffffffu, hv[i], qb + 3));
      const int uq = u0 + (u & ~3);  // the quad's first unit; nu is a multiple of 8
      if (send && uq < H) {
        const uint32_t off = next_off + 4 * ((uq / 4) * Q + 4 * r);
#pragma unroll
        for (int n = 0; n < kWideMaxCluster / 4; ++n)
          if ((lane & 3) + 4 * n < U) st_async16(dst_h[n] + off, h4, dst_bar[n] + bar_off);
      }
    }
    if (send) prefetch(s + 1);
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      int r, u;
      if (pair_at(i, r, u) && u < nu && row0 + r < B)
        cell.store(op[i], frame(s), row0 + r, u0 + u, hv[i]);
    }
    __syncthreads();  // every partial of step s read
    if (send && tid == 0) mbar_expect_tx(&s_bar[(s + 1) & 1], 4 * R * H);
  }
}

}  // namespace percival
