// The few-row plan of the f32 cluster BPTT (route "wide_f32",
// ops/wide_f32_layout.py): the kernel body that bilstm_bwd_wide_f32.cu and
// bigru_bwd_wide_f32.cu instantiate beside the chunked one
// (wide_f32_common.cuh) for batches of at most kWfrMaxB rows, and its launch
// plan.
//
// The split and packing are the route's ("wide": one cluster of U <= 16
// blocks a direction, block b owning units b·Hb … with all gates of each,
// NC = gates·Hb gate columns, W_h packed (U, H, NC)). At R = 1, 2 or 4 batch
// rows a cluster the rows are small enough that each block holds its whole
// f32 slice of W_h (H × NC) in shared memory for the whole sequence beside
// them: no ring of streamed chunks and no barrier a chunk. The slice's rows
// are NC words apart, the 16-word halves of a row swapped on every other
// k-quad (column c of row k at c ^ 16·((k >> 2) & 1)), so that both
// products read it without bank conflicts and without padding.
//
// 4·NC threads a block (384 at NC = 96, 512 at 128), each with one lane of
// both products:
//   (a) the recompute z = h_prev · W_h[:, the block's columns] for the next
//       step, laid out as the route's forward (wide_f32_fwd.cuh): warp
//       (co, kw), lane (j = lane >> 3, p = lane & 7) takes column quad
//       8co + p and, of every 64 rows of k, the k-quad 4kw + j, for all R
//       rows; the four j lanes reduce-scatter the 4 columns (lane j keeps
//       column j as (s0 + s2) + (s1 + s3)) and the gate phase adds the four
//       groups kw, ((p0 + p1) + p2) + p3;
//   (b) the step's dh partial over the block's columns, dh[r][k] = Σ_c
//       dz[r][c]·W[k][c]: tile g (lane >> 2 of 8 a warp) takes the 4/R
//       k-quads g + NG·a (NG = H·R/16), 16 sums over R rows, lane i = lane & 3
//       the columns 16m + 4i … +3; the four lanes reduce-scatter so that lane
//       i keeps k-quad a = i / R of row r = i % R as (a0 + a2) + (a1 + a3),
//       and sends it as one float4 by st.async into the receiving slots of
//       the block that owns those units, counting down that block's mbarrier
//       of the step's parity. The owner adds the U partials in block order in
//       its next gate phase.
// The fewer the rows, the more k-quads a dh lane takes, so the threads that
// rows leave free go to k. No cluster barrier runs in the loop: a block
// sends step s's partials into buffer s & 1 of their owner only after it
// received the owner's partials of step s − 1, which the owner sent after
// its gate phase had read buffer s & 1 (step s − 2): two buffers and two
// mbarriers suffice.
//
// Per step s (frames t(s): T−1 … 0 for the forward direction, 0 … T−1 for
// the backward one):
//   1. the h_prev rows of step s+1 start loading (cp.async); wait for the
//      partials of step s−1 (the mbarrier of buffer (s−1) & 1);
//   2. the gate phase of each (row, unit) pair (one a thread) from z (the
//      four groups' partials), the carry (the U slots in block order) and
//      the operands it loaded a step ahead: dgx (and dnr) to memory, dz to
//      shared memory; then the operands of step s+1 start loading;
//   3. one __syncthreads (dz complete, h_prev of step s+1 landed);
//   4. (b) and its sends, then (a) for step s+1, while the partials travel;
//   5. one __syncthreads (z complete); thread 0 arms the mbarrier of step
//      s+1's partials with their bytes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_common.cuh"
#include "wide_f32_common.cuh"
#include "wide_f32_fwd.cuh"
#include "wide_mma_common.cuh"

namespace percival {

constexpr int kWfrRows[3] = {4, 2, 1};  // batch rows a cluster the plan weighs
constexpr int kWfrMaxB = 8;             // the plan's batch rows at most (rows = 0)
constexpr int kWfrGroups = 4;           // the recompute's k-quad groups
constexpr int kWfrStaticSmem = 16;      // the two mbarriers, beside the dynamic shared memory
// the plan's step estimate: a fixed part, picoseconds a word of the block's
// W_h slice (read from shared memory by both products at any R) and a word
// and row (the products' FMAs), fitted to tools/bwd_step_breakdown.py --wide
// --f32 --few --grid on an H100 (PERF.md)
constexpr long long kWfrStepNs = 1450;
constexpr long long kWfrWordPs = 21;
constexpr long long kWfrRowWordPs = 17;

__host__ __device__ constexpr int wfr_threads(int NC) { return 4 * NC; }

// Shared memory: W_h slice [H][NC] | h_prev rows [R][H] | z partials
// [kWfrGroups][R][NC] | dz [R][NC] | receiving slots [2][U][R][Hb], all f32.
__host__ __device__ inline size_t wfr_smem(int H, int U, int Hb, int NC, int R) {
  return sizeof(float) * ((size_t)H * NC + (size_t)R * H + (size_t)kWfrGroups * R * NC +
                          (size_t)R * NC + 2 * (size_t)U * R * Hb);
}

// The step estimate at R rows a cluster, ns.
inline long long wfr_step_ns(int H, int NC, int R) {
  return kWfrStepNs + (long long)H * NC * (kWfrWordPs + kWfrRowWordPs * R) / 1000;
}

// The few-row plan into *plan: for R = 4, 2, 1 (or `rows` alone) whose block
// fits, the clusters the card holds at once and the waves of 2·ceil(B / R)
// clusters; the R of least waves × wfr_step_ns (the larger R on a tie).
// few_for(NC, R) → the kernel's address, null where none is built.
// cudaErrorInvalidConfiguration when no R fits.
template <class FewFor>
cudaError_t wide_f32_few_plan(int B, int H, int Hb, int U, int gates, int rows, FewFor few_for,
                              WideF32Plan* plan) {
  const int NC = gates * Hb;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideF32Plan best{};
  long long best_cost = -1;
  for (int R : kWfrRows) {
    if (rows && R != rows) continue;
    const size_t smem = wfr_smem(H, U, Hb, NC, R);
    const void* kernel = few_for(NC, R);
    if (kernel == nullptr || smem + kWfrStaticSmem > (size_t)optin) continue;
    WideF32Plan p{U, Hb, NC, R, wf_chunks(H), 0, 0, 0, (int)smem};
    err = wff_clusters(kernel, p.smem, U, wfr_threads(NC), optin, &p.clusters);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    const long long cost = p.waves * wfr_step_ns(H, NC, R);
    if (best_cost < 0 || cost < best_cost) best = p, best_cost = cost;
  }
  if (best_cost < 0) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

// grid (U · ceil(B / R), 2 directions) of 4·NC-thread blocks in clusters of U
template <class FewFor>
cudaError_t wide_f32_few_launch(const WideF32Plan& plan, int B, FewFor few_for, void** args,
                                cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wm_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.blockDim = dim3((unsigned)wfr_threads(plan.NC));
  cfg.stream = stream;
  cudaError_t err = cudaLaunchKernelExC(&cfg, few_for(plan.NC, plan.R), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The route's BPTT plan for (B, H, Hb, U): at B <= kWfrMaxB the few-row
// plan where one of its R fits, else the chunked one (wide_f32_plan).
// `rows` forces R: 1, 2 or 4 the few-row kernel, 8, 16 or 24 the chunked
// one (0: the plan's choice). kernel_for(NT), few_for(NC, R): the kernels.
template <class KernelFor, class FewFor>
cudaError_t wide_f32_bwd_plan(int B, int H, int Hb, int U, int gates, int rows,
                              KernelFor kernel_for, FewFor few_for, WideF32Plan* plan) {
  if (!wf_split_ok(B, H, Hb, U, gates)) return cudaErrorInvalidValue;
  if (rows ? rows <= 4 : B <= kWfrMaxB) {
    const cudaError_t err = wide_f32_few_plan(B, H, Hb, U, gates, rows, few_for, plan);
    if (rows || err != cudaErrorInvalidConfiguration) return err;
  }
  return wide_f32_plan(B, H, Hb, U, gates, rows, kernel_for, plan);
}

// Launch the plan's kernel: the few-row one at R <= 4, else the chunked one.
// args: the kernels' common arguments (the few-row kernel ignores nres).
template <class KernelFor, class FewFor>
cudaError_t wide_f32_bwd_launch(const WideF32Plan& plan, int B, KernelFor kernel_for,
                                FewFor few_for, void** args, cudaStream_t stream) {
  return plan.R <= 4 ? wide_f32_few_launch(plan, B, few_for, args, stream)
                     : wide_f32_launch(plan, B, kernel_for, args, stream);
}

// ---- the kernel body -------------------------------------------------------
//
// wp: the direction's packed W_h (U, H, NC), 16-byte aligned; hp: its h_prev
// (T, B, H), 16-byte aligned; H a multiple of 32.
template <class Cell, int NC, int R>
__device__ __forceinline__ void wide_f32_few(Cell& cell, const float* __restrict__ wp,
                                             const float* __restrict__ hp, int n_steps, int B,
                                             int H, int Hb, bool backward) {
  namespace cg = cooperative_groups;
  constexpr int G = Cell::kGates, NT = wfr_threads(NC), KQ = 4 / R, CO = NC / 32;
  static_assert(R == 1 || R == 2 || R == 4, "1, 2 or 4 rows a cluster");
  static_assert(NC % 32 == 0 && NT / 32 == kWfrGroups * CO, "a recompute lane a thread");
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * R;
  const int u0 = rank * Hb, nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  wp += (size_t)rank * H * NC;
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };
  // column c of row k of the slice, its 16-word halves swapped on odd k-quads
  auto w_at = [](int k, int c) { return k * NC + (c ^ (((k >> 2) & 1) << 4)); };

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_bar[2];  // s_bar[b]: the partials of a step of parity b landed
  float* const s_w = reinterpret_cast<float*>(smem);  // [H][NC], swizzled
  float* const s_h = s_w + H * NC;                     // [R][H]
  float* const s_zp = s_h + R * H;                     // [kWfrGroups][R][NC]
  float* const s_dz = s_zp + kWfrGroups * R * NC;      // [R][NC]
  float* const s_recv = s_dz + R * NC;                 // [2][U][R][Hb]
  const int slots = U * R * Hb;

  auto load_h = [&](int t) {  // h_prev[t] rows; rows past B zero
    for (int i = tid; i < R * (H / 4); i += NT) {
      const int r = i / (H / 4), k = 4 * (i - r * (H / 4));
      const bool ok = row0 + r < B;
      cp_async16(s_h + r * H + k, ok ? hp + ((size_t)t * B + row0 + r) * H + k : hp, ok);
    }
  };

  // (a) the recompute into the partials of group kw
  const int co = warp % CO, kw = warp / CO, j = lane >> 3, cq = 8 * co + (lane & 7);
  auto recompute = [&]() {
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
    for (int x = 4 * (4 * kw + j); x < H; x += 64) {  // the lane's k-quads
      float4 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const float4*>(s_w + w_at(x + e, 4 * cq));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(s_h + r * H + x);
        acc[r][0] = dot4(h4, make_float4(w[0].x, w[1].x, w[2].x, w[3].x), acc[r][0]);
        acc[r][1] = dot4(h4, make_float4(w[0].y, w[1].y, w[2].y, w[3].y), acc[r][1]);
        acc[r][2] = dot4(h4, make_float4(w[0].z, w[1].z, w[2].z, w[3].z), acc[r][2]);
        acc[r][3] = dot4(h4, make_float4(w[0].w, w[1].w, w[2].w, w[3].w), acc[r][3]);
      }
    }
    // lane j keeps column j: columns {2, 3} ^ … by bit 1 of j (xor 16), then
    // by bit 0 (xor 8), as (s_j + s_j^2) + (s_j^1 + s_j^3)
    const bool hi = (j & 2) != 0, lo = (j & 1) != 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float half[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float send = hi ? acc[r][e] : acc[r][e + 2];
        const float keep = hi ? acc[r][e + 2] : acc[r][e];
        half[e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
      const float send = lo ? half[0] : half[1];
      const float keep = lo ? half[1] : half[0];
      s_zp[(kw * R + r) * NC + 4 * cq + j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  };

  // (b) the dh partials of the step, sent to their owners' slots of parity b
  const uint32_t recv_addr = smem_addr(s_recv), bar_addr = smem_addr(&s_bar[0]);
  const int NG = H * R / 16, NI = 4 * NG;  // tiles, lanes of the product
  auto dh_product = [&](int b) {
    // whole warps (their lanes meet in shuffles); a warp's lanes past NI are
    // whole tiles, which read and send nothing
    for (int q = tid; q - lane < NI; q += NT) {
      const int g = q >> 2, i = q & 3;
      float acc[KQ][4][R];
#pragma unroll
      for (int a = 0; a < KQ; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r) acc[a][e][r] = 0.0f;
#pragma unroll 2
      for (int m = 0; m < (q < NI ? NC : 0); m += 16) {
        float4 d[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          d[r] = *reinterpret_cast<const float4*>(s_dz + r * NC + m + 4 * i);
#pragma unroll
        for (int a = 0; a < KQ; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * (g + NG * a) + e;
            const float4 w = *reinterpret_cast<const float4*>(s_w + w_at(k, m + 4 * i));
#pragma unroll
            for (int r = 0; r < R; ++r) acc[a][e][r] = dot4(d[r], w, acc[a][e][r]);
          }
      }
      // reduce-scatter over the four lanes of the tile (xor 2, then 1): lane
      // i keeps x = a·R + r = i, the 4 k of k-quad a, row r
      const bool hi = (i & 2) != 0, lo = (i & 1) != 0;
      float half[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int xs = x + (hi ? 0 : 2), xk = x + (hi ? 2 : 0);
          const float send = acc[xs / R][e][xs % R];
          const float keep = acc[xk / R][e][xk % R];
          half[x][e] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float send = lo ? half[0][e] : half[1][e];
        const float keep = lo ? half[1][e] : half[0][e];
        out[e] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
      if (q >= NI) continue;
      const int k0 = 4 * (g + NG * (i / R)), r = i % R, owner = k0 / Hb;
      const uint32_t off = 4 * ((b * slots) + (rank * R + r) * Hb + k0 - owner * Hb);
      st_async16(cluster_addr(recv_addr, owner) + off, make_float4(out[0], out[1], out[2], out[3]),
                 cluster_addr(bar_addr, owner) + 8 * b);
    }
  };

  // the gate phase: the pair (row q / Hb, unit q % Hb) of thread q < R·Hb
  const int pr = tid / Hb, pu = tid - pr * Hb;
  const bool pair = pr < R && pu < nu;
  typename Cell::Op op;
  // the bytes of a step's partials this block receives: every block's R rows
  // of its units
  const int step_bytes = 4 * U * R * nu;
  auto gate_phase = [&](int s) {
    if (pr >= R) return;
    const bool ok = pair && row0 + pr < B;
    float z[G], d[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float* zp = s_zp + pr * NC + gi * Hb + pu;
      z[gi] = ((zp[0] + zp[R * NC]) + zp[2 * R * NC]) + zp[3 * R * NC];
    }
    float carry = cell.carry0(op);
    if (s > 0) {
      const float* recv = s_recv + ((s - 1) & 1) * slots + pr * Hb + pu;
      for (int src = 0; src < U; ++src) carry += recv[src * R * Hb];
    }
    cell.step(op, z, carry, d, frame(s), row0 + pr, u0 + pu, ok);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s_dz[pr * NC + gi * Hb + pu] = ok ? d[gi] : 0.0f;
  };
  auto prefetch = [&](int s) {
    if (pair) cell.load(op, frame(s), row0 + pr, u0 + pu, row0 + pr < B);
  };

  // ---- prologue: the slice, h_prev of step 0, the mbarriers, z of step 0
  for (int i = tid; i < H * (NC / 4); i += NT) {
    const int k = i / (NC / 4), c = 4 * (i - k * (NC / 4));
    cp_async16(s_w + w_at(k, c), wp + (size_t)k * NC + c, true);
  }
  load_h(frame(0));
  cp_async_commit();
  if (tid == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  prefetch(0);
  cp_async_wait<0>();
  __syncthreads();
  recompute();  // z of step 0
  if (tid == 0 && n_steps > 1) mbar_expect_tx(&s_bar[0], step_bytes);
  cluster.sync();  // every block running, its mbarriers set; z stored

  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load_h(frame(s + 1));
      cp_async_commit();
    }
    if (s > 0) mbar_wait(&s_bar[(s - 1) & 1], ((s - 1) >> 1) & 1);
    gate_phase(s);
    if (s + 1 == n_steps) break;
    prefetch(s + 1);
    cp_async_wait<0>();
    __syncthreads();  // dz complete; h_prev of step s+1 landed; z and the slots read
    dh_product(s & 1);
    recompute();  // z of step s+1
    __syncthreads();  // z complete
    if (tid == 0 && s + 2 < n_steps) mbar_expect_tx(&s_bar[(s + 1) & 1], step_bytes);
  }
}

}  // namespace percival
