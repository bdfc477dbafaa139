// The f32 BPTT for the widths one block held before (route "narrow_f32",
// ops/narrow_f32_layout.py), shared by bilstm_bwd_narrow_f32.cu and
// bigru_bwd_narrow_f32.cu: its launch plan, its shared-memory layout, and the
// kernel body, which the two cells specialise with their gate phase
// (f32_cells.cuh). The forwards of the route (narrow_f32_fwd.cuh) take its
// split, its plan (with fwd set: their own shared memory and step estimate)
// and its product (nf_product).
//
// One thread-block cluster of U <= 16 blocks a direction and tile of R batch
// rows; block b owns units b·Hb … (Hb a multiple of 8; the last block may
// hold fewer) with all of their gates, NC = gates·Hb gate columns padded to
// NCP, a multiple of 32 (zero columns). Its f32 slice of W_h (H × NCP,
// packed by ops/narrow_f32_layout.py::pack_wh) stays in shared memory for the
// whole sequence beside the rows, so each step reads it once for all R rows
// of the cluster, for both products. Per step s:
//   1. gate phase: each (row, unit) pair turns z (recomputed last step), the
//      carry (the U partial slots of the unit, added in block order) and the
//      operands it loaded a step ahead into its dgates, kept in the dz rows in
//      shared memory (the GRU's dn_pre beside them);
//   2. one __syncthreads;
//   3. the dh partials of step s, p[r][k] = Σ_c dz[r][c] · W[k][c] over the
//      block's columns, for every k < H, on all warps: a lane holds a tile of
//      4 rows of k × RT = min(R, 4) batch rows over the columns c with
//      (c % 16) / 4 == its column lane (lane & 3); the four column lanes
//      reduce-scatter the tile, ((a0 + a1) + (a2 + a3)), and each stores its
//      RT contiguous values of one batch row into the slot (block, row, k) of
//      the block that owns unit k (distributed shared memory; two buffers of
//      slots, so one cluster barrier a step);
//   4. cluster arrive (release);
//   5. under the barrier's latency: the loads of step s+1's gate operands
//      into registers, step s's dgates written from shared memory to dgx
//      (and dnr), and the recompute of step s+1's gate sums, z[r][c] =
//      Σ_k h_prev[r][k] · W[k][c], on all warps (dealt from the last warp
//      down: those with no item of (3) start it while (3) runs): a lane
//      holds 4 columns × RT rows over the k with (k % 16) / 4 == its k lane
//      (lane >> 3), summed ((s0 + s1) + (s2 + s3)) by a reduce-scatter; one
//      __syncthreads;
//   6. cluster wait (acquire).
// The release of step 4 waits for this block's earlier memory operations, so
// the global loads and stores of a step are issued after it, a step before
// the next release. The h_prev rows of step s+2 stream into a second buffer
// by cp.async while the step runs. A quarter-warp of (3) reads two rows of W 4 apart (row stride
// NCP + 4 words: 16 banks apart) and a broadcast run of dz; of (5), one row
// of W (8 float4s) and a broadcast float4 of h_prev: no bank conflicts.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_mma_common.cuh"

namespace percival {

constexpr int kNfWarps = 16;
constexpr int kNfThreads = 32 * kNfWarps;
constexpr int kNfMaxPairs = 2;                    // (row, unit) pairs a thread in the gate phase
constexpr int kNfMaxHb = 256;                     // units a block
constexpr int kNfK = 8;                           // H and Hb are whole numbers of these
constexpr int kNfCols = 32;                       // NC is padded to a multiple of these (NCP)
constexpr int kNfBlocks[4] = {1, 2, 4, 8};        // cluster sizes the plan tries
constexpr int kNfRows[4] = {2, 4, 8, 16};         // batch rows a cluster
// The plan's estimate of a step, in cycles (fitted to steps timed on the
// H100 over every split and R at H = 64, 128 and 256 / 320; PERF.md):
// kNfStep for the gate phase and the barriers, kNfPerBlock·U for the partial
// slots a pair adds, H·NCP·ceil(R / 4) / 16 for the reads of the W_h slice
// (once a tile of 4 rows) and R·H·NCP / 64 for both products' FMAs
constexpr long long kNfStep = 3100;
constexpr long long kNfPerBlock = 60;

struct NarrowF32Plan {
  int U, Hb, NC, NCP;  // the split (ops/narrow_f32_layout.py::split)
  int R;               // batch rows a cluster
  int clusters;        // clusters of U blocks the card holds at once
  int waves;           // ceil(2·ceil(B / R) / clusters)
  int smem;            // dynamic shared memory a block, bytes
  int resident = 0;    // the forward's: 1 when W_h stays in registers (narrow_f32_fwd.cuh)
};

// Row strides (words) of the W_h slice and of the z and dz rows: NCP + 4.
__host__ __device__ inline int nf_ws(int NCP) { return NCP + 4; }

// The split of H units over a cluster of at most `blocks` blocks: Hb units a
// block (a multiple of 8), U = ceil(H / Hb) blocks.
inline void nf_split(int H, int blocks, int gates, int* U, int* Hb, int* NC, int* NCP) {
  const int hb = ((H + blocks - 1) / blocks + kNfK - 1) / kNfK * kNfK;
  *Hb = hb;
  *U = (H + hb - 1) / hb;
  *NC = gates * hb;
  *NCP = (*NC + kNfCols - 1) / kNfCols * kNfCols;
}

// Shared memory: W_h slice [H][NCP + 4] | h_prev rows [2][R][H] | z [R][NCP + 4]
// | dz [R][NCP + 4] | partial slots [2][U][R][Hb] | the GRU's dn_pre [R][Hb]
// (extra = 1), all f32.
__host__ __device__ inline size_t nf_smem(int H, int U, int Hb, int NCP, int R, int extra) {
  return sizeof(float) * ((size_t)H * nf_ws(NCP) + 2 * (size_t)R * H +
                          2 * (size_t)R * nf_ws(NCP) + (2 * (size_t)U + extra) * R * Hb);
}

// The forward's (narrow_f32_fwd.cuh): W_h slice [H][NCP + 4] | h rows
// [2][R][H] | z [R][NCP + 4], all f32.
__host__ __device__ inline size_t nf_fwd_smem(int H, int NCP, int R) {
  return sizeof(float) * ((size_t)H * nf_ws(NCP) + 2 * (size_t)R * H + (size_t)R * nf_ws(NCP));
}

inline long long nf_cost(int H, int U, int NCP, int R, int waves) {
  const long long w = (long long)H * NCP;
  return waves * (kNfStep + kNfPerBlock * U + w * ((R + 3) / 4) / 16 + R * w / 64);
}

// The forward's estimate of a step, in cycles (fitted to steps timed on the
// H100 over every split and R at H = 64, 96, 128 and 256 / 320; PERF.md):
// kNfFwdStep for the gate phase and the loop, kNfFwdCluster for the cluster
// barrier and the h writes into other blocks (none at U = 1), and
// R·H·NCP / 65 for the product (the W_h reads cost no more beside it)
constexpr long long kNfFwdStep = 1756;
constexpr long long kNfFwdCluster = 764;

inline long long nf_fwd_cost(int H, int U, int NCP, int R, int waves) {
  return waves * (kNfFwdStep + (U > 1 ? kNfFwdCluster : 0) + (long long)R * H * NCP / 65);
}

inline cudaLaunchConfig_t nf_config(int U, int R, int smem, int B, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = wm_config(U, R, smem, B, attr);
  cfg.blockDim = dim3((unsigned)kNfThreads);
  return cfg;
}

// One candidate (U from `blocks`, R): whether it fits, with its clusters and
// waves. kernel_for(R) → the kernel's address.
template <class KernelFor>
cudaError_t nf_candidate(int B, int H, int gates, int blocks, int R, int optin, bool fwd,
                         KernelFor kernel_for, NarrowF32Plan* p, bool* fits) {
  *fits = false;
  int U, Hb, NC, NCP;
  nf_split(H, blocks, gates, &U, &Hb, &NC, &NCP);
  const size_t smem = fwd ? nf_fwd_smem(H, NCP, R) : nf_smem(H, U, Hb, NCP, R, gates == 3);
  if (U > kWideMaxCluster || Hb > kNfMaxHb || R * Hb > kNfMaxPairs * kNfThreads ||
      smem > (size_t)optin)
    return cudaSuccess;
  const void* kernel = kernel_for(R);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *p = NarrowF32Plan{U, Hb, NC, NCP, R, 0, 0, (int)smem};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = nf_config(U, R, p->smem, B, attr);
  err = cudaOccupancyMaxActiveClusters(&p->clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (p->clusters < 1) return cudaSuccess;
  p->waves = (2 * ((B + R - 1) / R) + p->clusters - 1) / p->clusters;
  *fits = true;
  return cudaSuccess;
}

// The plan of B rows at width H (a multiple of 8): every split of kNfBlocks
// (each distinct Hb once) and R of kNfRows that fits, the least nf_cost
// (waves × the estimated step; the forward's, fwd: nf_fwd_cost on its own
// shared memory), the first such in that order on a tie. blocks > 0 splits
// over at most that many blocks instead (a launch passes its plan's U; a
// measurement may force a split), rows > 0 takes only those rows;
// cudaErrorInvalidConfiguration when nothing fits.
template <class KernelFor>
cudaError_t narrow_f32_plan(int B, int H, int gates, int blocks, int rows, KernelFor kernel_for,
                            NarrowF32Plan* plan, bool fwd = false) {
  if (B < 1 || H < kNfK || H % kNfK || blocks < 0 || rows < 0) return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  NarrowF32Plan best{};
  long long best_cost = -1;
  int last_hb = 0;
  const int n_splits = blocks ? 1 : (int)(sizeof(kNfBlocks) / sizeof(kNfBlocks[0]));
  for (int i = 0; i < n_splits; ++i) {
    const int b = blocks ? blocks : kNfBlocks[i];
    int U, Hb, NC, NCP;
    nf_split(H, b, gates, &U, &Hb, &NC, &NCP);
    if (Hb == last_hb) continue;
    last_hb = Hb;
    for (int R : kNfRows) {
      if (rows && R != rows) continue;
      NarrowF32Plan p{};
      bool fits = false;
      err = nf_candidate(B, H, gates, b, R, optin, fwd, kernel_for, &p, &fits);
      if (err != cudaSuccess) return err;
      if (!fits) continue;
      const long long cost = fwd ? nf_fwd_cost(H, p.U, p.NCP, R, p.waves)
                                 : nf_cost(H, p.U, p.NCP, R, p.waves);
      if (best_cost < 0 || cost < best_cost) best = p, best_cost = cost;
    }
  }
  if (best_cost < 0) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

// grid (U · ceil(B / R), 2 directions) of kNfThreads-thread blocks in clusters of U
template <class KernelFor>
cudaError_t narrow_f32_launch(const NarrowF32Plan& plan, int B, KernelFor kernel_for,
                              void** args, cudaStream_t stream) {
  const void* kernel = kernel_for(plan.R);
  // every candidate's attribute was set while planning; set the chosen one's
  // again in case another plan of this kernel ran in between
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = nf_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.stream = stream;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void narrow_f32_plan_out(const NarrowF32Plan& p, int* out) {
  const int v[8] = {p.U, p.Hb, p.NC, p.NCP, p.R, p.clusters, p.waves, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// The plan of a launch's (B, H, Hb, U, R), checked against the split that the
// plan gives U blocks: what the wrapper packed W_h for.
template <class KernelFor>
cudaError_t narrow_f32_checked_plan(int B, int H, int Hb, int U, int R, int gates,
                                    KernelFor kernel_for, NarrowF32Plan* plan) {
  cudaError_t err = narrow_f32_plan(B, H, gates, U, R, kernel_for, plan);
  if (err != cudaSuccess) return err;
  return plan->U == U && plan->Hb == Hb ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N (1, 2 or 4) contiguous floats of v, 4·N-byte aligned.
template <int N>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// The four lanes xor 1 and xor 2 apart (m1 = 1, m2 = 2) or xor 8 and xor 16
// apart (m1 = 8, m2 = 16) each hold a[4·RT]; each ends with RT values, the
// sums ((x0 + x1) + (x2 + x3)) over the four lanes of indices
// [(2·b1 + b2)·RT, … + RT), where b1 / b2 say whether the lane's m1 / m2 bit is set.
template <int RT>
__device__ __forceinline__ void reduce_scatter4(const float (&a)[4 * RT], bool b1, bool b2,
                                                int m1, int m2, float (&out)[RT]) {
  float h[2 * RT];
#pragma unroll
  for (int j = 0; j < 2 * RT; ++j) {
    const float keep = b1 ? a[2 * RT + j] : a[j];
    const float send = b1 ? a[j] : a[2 * RT + j];
    h[j] = keep + __shfl_xor_sync(0xffffffffu, send, m1);
  }
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const float keep = b2 ? h[RT + j] : h[j];
    const float send = b2 ? h[j] : h[RT + j];
    out[j] = keep + __shfl_xor_sync(0xffffffffu, send, m2);
  }
}

// z[r][c] = Σ_k h[r][k] · W[k][c] for the R rows of hb ([R][H]) and the
// block's NCP columns of s_w ([H][NCP + 4]), into s_z ([R][NCP + 4]), on
// CUDA cores in f32: warp item (32 gate columns, row tile of RT = min(R, 4)
// rows), items dealt to warp `first`, first + kNfWarps, …; a lane holds 4
// columns × RT rows over the k with (k % 16) / 4 == its k lane (lane >> 3),
// summed ((s0 + s1) + (s2 + s3)) by a reduce-scatter
// (ops/narrow_f32_layout.py::replay_recompute). A quarter-warp reads one row
// of W (8 float4s) and a broadcast float4 of h: no bank conflicts.
template <int R>
__device__ __forceinline__ void nf_product(const float* s_w, const float* hb, float* s_z, int H,
                                           int NCP, int first) {
  constexpr int RT = R < 4 ? R : 4, NRT = R / RT;
  const int WS = nf_ws(NCP), lane = threadIdx.x & 31, j = lane >> 3;
  const int n_cg = NCP / 32;
  for (int wi = first; wi < n_cg * NRT; wi += kNfWarps) {
    const int rt = wi / n_cg, c0 = 32 * (wi - rt * n_cg) + 4 * (lane & 7);
    const float* wcol = s_w + c0;
    const float* hrow = hb + rt * RT * H;
    float za[RT * 4];  // [r][column]
#pragma unroll
    for (int v = 0; v < RT * 4; ++v) za[v] = 0.0f;
    for (int x = 4 * j; x < H; x += 16) {  // this lane's k-quads
      const float4 w0 = ld4(wcol + x * WS), w1 = ld4(wcol + (x + 1) * WS);
      const float4 w2 = ld4(wcol + (x + 2) * WS), w3 = ld4(wcol + (x + 3) * WS);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 hv = ld4(hrow + r * H + x);
        za[r * 4 + 0] = dot4(hv, make_float4(w0.x, w1.x, w2.x, w3.x), za[r * 4 + 0]);
        za[r * 4 + 1] = dot4(hv, make_float4(w0.y, w1.y, w2.y, w3.y), za[r * 4 + 1]);
        za[r * 4 + 2] = dot4(hv, make_float4(w0.z, w1.z, w2.z, w3.z), za[r * 4 + 2]);
        za[r * 4 + 3] = dot4(hv, make_float4(w0.w, w1.w, w2.w, w3.w), za[r * 4 + 3]);
      }
    }
    float out[RT];
    reduce_scatter4<RT>(za, j & 1, j & 2, 8, 16, out);
    const int v0 = (2 * (j & 1) + (j >> 1)) * RT;
    store_run<RT>(s_z + (rt * RT + v0 / 4) * WS + c0 + v0 % 4, out);
  }
}

// ---- the kernel body -------------------------------------------------------
//
// Step s visits frame t(s): T−1 … 0 for the forward direction, 0 … T−1 for the
// backward one. wp: the direction's packed W_h (U, H, NCP); hp: its h_prev
// (T, B, H), 16-byte aligned.
template <class Cell, int R>
__device__ __forceinline__ void narrow_f32_bptt(Cell& cell, const float* __restrict__ wp,
                                                const float* __restrict__ hp, int n_steps, int B,
                                                int H, int Hb, int NCP, bool backward) {
  namespace cg = cooperative_groups;
  constexpr int RT = R < 4 ? R : 4, NRT = R / RT;
  constexpr int G = Cell::kGates;
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * R;
  const int WS = nf_ws(NCP);
  const int u0 = rank * Hb, nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  wp += (size_t)rank * H * NCP;
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* const s_w = reinterpret_cast<float*>(smem);  // [H][WS]
  float* const s_h = s_w + H * WS;                     // [2][R][H]
  float* const s_z = s_h + 2 * R * H;                  // [R][WS]
  float* const s_dz = s_z + R * WS;                    // [R][WS]
  float* const s_recv = s_dz + R * WS;                 // [2][U][R][Hb]
  const int slots = U * R * Hb;
  float* const s_x = s_recv + 2 * slots;  // [R][Hb] if Cell::kExtra

  auto load_h = [&](int s, float* dst) {  // h_prev rows of step s; rows past B zero
    const int t = frame(s), q4 = H / 4;
    for (int i = tid; i < R * q4; i += kNfThreads) {
      const int r = i / q4, k = 4 * (i - r * q4);
      const bool ok = row0 + r < B;
      cp_async16(dst + r * H + k, ok ? hp + ((size_t)t * B + row0 + r) * H + k : hp, ok);
    }
  };

  // (3) the dh partials: warp item (k block of 32 rows, row tile)
  const int n_kb = (H + 31) / 32;
  auto dh_product = [&](float* recv) {
    const int ci = lane & 3;
    for (int wi = warp; wi < n_kb * NRT; wi += kNfWarps) {
      const int rt = wi / n_kb, k0 = 32 * (wi - rt * n_kb) + 4 * (lane >> 2);
      const bool kok = k0 < H;  // the same for a tile's four lanes
      float acc[RT * 4];        // [r][k]
#pragma unroll
      for (int v = 0; v < RT * 4; ++v) acc[v] = 0.0f;
      if (kok) {
        const float* wrow = s_w + k0 * WS + 4 * ci;
        const float* dzr = s_dz + rt * RT * WS + 4 * ci;
        for (int m = 0; m < NCP; m += 16) {
          float4 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = ld4(wrow + i * WS + m);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 d = ld4(dzr + r * WS + m);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r * 4 + i] = dot4(d, w[i], acc[r * 4 + i]);
          }
        }
      }
      float out[RT];
      reduce_scatter4<RT>(acc, ci & 1, ci & 2, 1, 2, out);
      if (!kok) continue;
      const int v0 = (2 * (ci & 1) + (ci >> 1)) * RT;
      const int r = rt * RT + v0 / 4, k = k0 + v0 % 4, owner = k / Hb;
      float* slot = cluster.map_shared_rank(recv, owner) + (rank * R + r) * Hb + (k - owner * Hb);
      store_run<RT>(slot, out);
    }
  };

  // (5) the recompute (nf_product), dealt from the last warp down, so that
  // the warps with no dh item start it at once
  auto recompute = [&](const float* hb) {
    nf_product<R>(s_w, hb, s_z, H, NCP, kNfWarps - 1 - warp);
  };

  // (1) the gate phase: pair i of thread tid is q = tid + kNfThreads·i, unit
  // q % Hb, row q / Hb (consecutive threads on consecutive units); R·Hb
  // pairs, Hb <= kNfMaxHb
  constexpr int kNeed = (R * kNfMaxHb + kNfThreads - 1) / kNfThreads;
  constexpr int kPairs = kNeed < kNfMaxPairs ? kNeed : kNfMaxPairs;
  typename Cell::Op op[kPairs];
  int pu[kPairs], pr[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int q = tid + kNfThreads * i;
    pu[i] = q % Hb;
    pr[i] = q / Hb;
  }
  auto pair_ok = [&](int i) { return pu[i] < nu && row0 + pr[i] < B; };
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
      if (pr[i] < R) cell.load(op[i], frame(s), row0 + pr[i], u0 + pu[i], pair_ok(i));
  };
  auto gate_phase = [&](int s, const float* recv) {
    const int t = frame(s);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (pr[i] >= R) continue;
      const int u = pu[i], r = pr[i];
      const bool ok = pair_ok(i);
      float z[G], d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) z[g] = s_z[r * WS + g * Hb + u];
      float carry = cell.carry0(op[i]), x;
      for (int src = 0; src < U; ++src) carry += recv[(src * R + r) * Hb + u];
      cell.grads(op[i], z, carry, d, x, ok);
#pragma unroll
      for (int g = 0; g < G; ++g) s_dz[r * WS + g * Hb + u] = ok ? d[g] : 0.0f;
      if (Cell::kExtra) s_x[r * Hb + u] = x;
    }
  };
  // a pair's dgates to dgx (and dnr): read back by the thread that wrote them
  auto store_pass = [&](int s) {
    const int t = frame(s);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (pr[i] >= R || !pair_ok(i)) continue;
      const int u = pu[i], r = pr[i];
      cell.store(s_dz + r * WS + u, Hb, Cell::kExtra ? s_x[r * Hb + u] : 0.0f, t, row0 + r,
                 u0 + u);
    }
  };

  // ---- prologue: the W_h slice and h_prev of steps 0 and 1; slots and dz zero
  for (int i = tid; i < H * (NCP / 4); i += kNfThreads) {
    const int k = i / (NCP / 4), c = 4 * (i - k * (NCP / 4));
    cp_async16(s_w + k * WS + c, wp + (size_t)k * NCP + c, true);
  }
  load_h(0, s_h);
  cp_async_commit();
  if (n_steps > 1) load_h(1, s_h + R * H);
  cp_async_commit();
  for (int i = tid; i < 2 * slots; i += kNfThreads) s_recv[i] = 0.0f;  // dh_carry of step 0
  for (int i = tid; i < R * WS; i += kNfThreads) s_dz[i] = 0.0f;       // the padding columns
  prefetch(0);
  cp_async_wait<0>();
  __syncthreads();
  recompute(s_h);  // z of step 0
  cluster.sync();  // every block running, its slots zeroed; z stored

  for (int s = 0; s < n_steps; ++s) {
    // h_prev of step s+2 into the buffer that step s's recompute read
    if (s + 2 < n_steps) load_h(s + 2, s_h + (s & 1) * R * H);
    cp_async_commit();
    gate_phase(s, s_recv + ((s + 1) & 1) * slots);
    if (s + 1 == n_steps) break;
    cp_async_wait<1>();  // h_prev of step s+1 landed (issued a step ago)
    __syncthreads();     // dz complete, and h_prev of step s+1, for every thread
    dh_product(s_recv + (s & 1) * slots);
    cluster_arrive();  // this block's partials stored
    prefetch(s + 1);
    store_pass(s);
    recompute(s_h + ((s + 1) & 1) * R * H);
    __syncthreads();  // z of step s+1 stored, h_prev of step s+1 read
    cluster_wait();   // every partial of step s stored
  }
  store_pass(n_steps - 1);
  cp_async_wait<0>();
}

}  // namespace percival
