// The f32 cluster BPTT shared by bilstm_bwd_wide_f32.cu and
// bigru_bwd_wide_f32.cu (route "wide_f32", ops/wide_f32_layout.py): its launch
// plan, its shared-memory layout, and the kernel body, which the two cells
// specialise with their gate math (a Cell policy: kGates, the operands a
// (row, unit) pair loads a step ahead, the gate phase).
//
// The split is the "wide" route's (ops/wide_layout.py::plan, the per-block
// packing pack_wh, (U, H, NC) a direction): one thread-block cluster of
// U <= 16 blocks a direction and tile of R batch rows, block b owning units
// b·Hb … with all gates of each, NC = gates·Hb <= 128 gate columns. Each
// block's f32 slice of W_h (H × NC: 256 KiB for the LSTM at H = 512, 192 KiB
// for the GRU) does not fit its shared memory beside the rows, so the slice
// is cut into chunks of 64 rows of k: the last `nres` chunks stay resident in
// shared memory for the whole sequence, the others are streamed every step by
// cp.async through a ring of three slots, each issued two chunks ahead.
// Each chunk, resident or streamed, feeds both products of a step, on CUDA
// cores in f32, each on its own warps (12 a block, at most 168 registers a thread);
// a lane holds a tile of 2·R sums, so that every float4 it reads from shared
// memory feeds 16 FMAs:
//   (a) the recompute for step s+1, z[r][c] += h_prev[r][k] · W[k][c] over
//       the chunk's k, on warps 0–7: warp (co, rh) owns gate columns
//       32co … 32co+31 and the batch rows of half rh; its lane (j = lane >> 3,
//       p = lane & 7) 4 columns × R/2 rows over the k-quads j, j+4, … of each
//       chunk; the sums stay in registers for the whole pass and the four
//       k-quad lanes add theirs with shuffles once a step;
//   (b) step s's dh partial, dh[r][k] = Σ_c dz[r][c] · W[k][c] over the
//       block's columns, for the chunk's k, on warps 8–11: warp 8 + v owns
//       the rows of k 4kg … 4kg+3 (kg = 8·(v & 1) + lane >> 2) of half
//       v >> 1 of the batch rows; its lane (i = lane & 3) the columns
//       16m + 4i … +3; the four lanes of a tile reduce-scatter their sums
//       (lane i ends with row of k 4kg + i) and each stores them as float4s
//       into the slot (block, k) of the block that owns unit k (distributed
//       shared memory), which adds the U partials in block order in its
//       next gate phase.
// A quarter-warp of (a) reads one row of the chunk (8 float4s in a row) and a
// broadcast float4 of h_prev; of (b), two rows of the chunk 4 apart (the row
// stride is NC + 4 words, so they lie 16 banks apart) and a broadcast float4
// run of dz: no bank conflicts.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_common.cuh"
#include "wide_mma_common.cuh"

namespace percival {

constexpr int kWfWarps = 12;              // 8 for the recompute, 4 for the dh product
constexpr int kWfThreads = 32 * kWfWarps;
constexpr int kWfChunk = 64;               // rows of k a chunk of the W_h slice
constexpr int kWfRing = 3;                 // ring slots of streamed chunks: each issued 2 chunks ahead
constexpr int kWfMaxNC = 128;              // gate columns a block: 32 a recompute warp, 4 warps a half
constexpr int kWfK = 32;                   // H is a whole number of these
constexpr int kWfRowTiles[3] = {1, 2, 3};  // R = 8·NT rows a cluster
constexpr int kWfMaxTiles = 2;             // gate-phase tiles (8 units × 4 rows) a warp
constexpr int kWfRecomputeWarps = 8;

struct WideF32Plan {
  int U, Hb, NC;   // the split (ops/wide_layout.py::plan)
  int R;           // batch rows a cluster
  int nres, nstr;  // chunks resident in shared memory, chunks streamed a step
  int clusters;    // clusters the card holds at once
  int waves;       // ceil(2·ceil(B / R) / clusters)
  int smem;        // dynamic shared memory a block, bytes
};

// Row strides (words): a chunk's NC + 4 (rows 4 apart lie 16 banks apart);
// the h_prev rows' H; the dz and z rows' NC + 8 (the gate phase's 4 rows × 8
// units a warp lie on 32 banks).
__host__ __device__ inline int wf_ws(int NC) { return NC + 4; }
__host__ __device__ inline int wf_ds(int NC) { return NC + 8; }
__host__ __device__ inline int wf_chunks(int H) { return (H + kWfChunk - 1) / kWfChunk; }
__host__ __device__ inline size_t wf_slot_bytes(int NC) {
  return (size_t)kWfChunk * wf_ws(NC) * sizeof(float);
}

// Shared memory: ring (kWfRing slots, none when every chunk is resident) |
// resident chunks | h_prev rows [R][H] | dz [R][NC + 8] | z [R][NC + 8] |
// partial slots [U][Hb][R], all f32.
__host__ __device__ inline size_t wf_smem(int H, int U, int Hb, int NC, int R, int nres) {
  const int slots = nres + (nres < wf_chunks(H) ? kWfRing : 0);
  return (size_t)slots * wf_slot_bytes(NC) +
         sizeof(float) * ((size_t)R * H + 2 * (size_t)R * wf_ds(NC) + (size_t)U * Hb * R);
}

// The most chunks that stay resident at R rows within `optin` bytes, or −1
// when not even a fully streamed block fits.
inline int wf_resident(int H, int U, int Hb, int NC, int R, int optin) {
  for (int n = wf_chunks(H); n >= 0; --n)
    if (wf_smem(H, U, Hb, NC, R, n) <= (size_t)optin) return n;
  return -1;
}

// Whether the route's kernels take the split (B, H, Hb, U) of a cell of
// `gates` gates.
inline bool wf_split_ok(int B, int H, int Hb, int U, int gates) {
  const int NC = gates * Hb;
  return !(B < 1 || wf_chunks(H) < 3 || H % kWfK || Hb < 1 || NC % 32 || NC > kWfMaxNC ||
           U < 1 || U > kWideMaxCluster || (U - 1) * Hb >= H || U * Hb < H || Hb % 8 ||
           (Hb / 8) * 2 * kWfRowTiles[2] > kWfWarps * kWfMaxTiles ||
           2 * (NC / 32) > kWfRecomputeWarps);
}

// kernel_for(NT) → the kernel's address. Rows R = 8, 16, 24 (or `rows`
// alone) whose block fits with no resident chunk; each R keeps as many
// chunks resident as fit beside it. Among them the fewest waves of
// 2·ceil(B/R) clusters, then the smallest R (the shortest step).
template <class KernelFor>
cudaError_t wide_f32_plan(int B, int H, int Hb, int U, int gates, int rows, KernelFor kernel_for,
                          WideF32Plan* plan) {
  const int NC = gates * Hb;
  if (!wf_split_ok(B, H, Hb, U, gates)) return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin_bytes(&optin);
  if (err != cudaSuccess) return err;
  WideF32Plan best{};
  bool found = false;
  for (int NT : kWfRowTiles) {
    if (rows && 8 * NT != rows) continue;
    const int R = 8 * NT, nres = wf_resident(H, U, Hb, NC, R, optin);
    if (nres < 0) continue;
    const size_t smem = wf_smem(H, U, Hb, NC, R, nres);
    const void* kernel = kernel_for(NT);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    WideF32Plan p{U, Hb, NC, R, nres, wf_chunks(H) - nres, 0, 0, (int)smem};
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = wm_config(U, R, p.smem, B, attr);
    cfg.blockDim = dim3((unsigned)kWfThreads);
    err = cudaOccupancyMaxActiveClusters(&p.clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (p.clusters < 1) continue;
    p.waves = (2 * ((B + R - 1) / R) + p.clusters - 1) / p.clusters;
    if (!found || p.waves < best.waves) best = p;
    found = true;
  }
  if (!found) return cudaErrorInvalidConfiguration;
  *plan = best;
  return cudaSuccess;
}

// grid (U · ceil(B / R), 2 directions) of kWfThreads-thread blocks in clusters of U
template <class KernelFor>
cudaError_t wide_f32_launch(const WideF32Plan& plan, int B, KernelFor kernel_for, void** args,
                            cudaStream_t stream) {
  const void* kernel = kernel_for(plan.R / 8);
  // each R's attribute was set while planning; set the chosen one's again in
  // case another plan of this kernel ran in between
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         plan.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wm_config(plan.U, plan.R, plan.smem, B, attr);
  cfg.blockDim = dim3((unsigned)kWfThreads);
  cfg.stream = stream;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline void wide_f32_plan_out(const WideF32Plan& p, int* out) {
  const int v[9] = {p.U, p.Hb, p.NC, p.R, p.nres, p.nstr, p.clusters, p.waves, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// ---- the kernel body -------------------------------------------------------
//
// Per step s (frames t(s): T−1 … 0 for the forward direction, 0 … T−1 for the
// backward one): the gate phase turns z (recomputed last step), the carry
// (the U partial slots of each unit, block order) and the step's operands
// into dz, written to dgx and to the dz rows; then one pass over the chunks
// runs (a) for step s+1 and (b) for step s; a cluster barrier in two halves
// frees the partial slots (arrive after the gate phase read them, wait before
// the first remote store) and another publishes them (after the pass). A
// prologue pass computes z of step 0. Every chunk of a pass opens with a
// block barrier that every warp reaches, whichever product it runs.
template <class Cell, int NT>
__device__ __forceinline__ void wide_f32_bptt(Cell& cell, const float* __restrict__ wp,
                                              const float* __restrict__ hp, int n_steps, int B,
                                              int H, int Hb, int nres, bool backward) {
  namespace cg = cooperative_groups;
  constexpr int R = 8 * NT, RH = R / 2, RQ = R / 4;
  constexpr int G = Cell::kGates;
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / U) * R;
  const int NC = G * Hb, NCH = wf_chunks(H), nstr = NCH - nres;
  const int WS = wf_ws(NC), DS = wf_ds(NC);
  const int u0 = rank * Hb, nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  wp += (size_t)rank * H * NC;
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  const int SLOT = kWfChunk * WS;
  float* const s_ring = reinterpret_cast<float*>(smem);
  float* const s_res = s_ring + (nstr > 0 ? kWfRing : 0) * SLOT;  // chunks nstr … NCH−1
  float* const s_h = s_res + nres * SLOT;                            // h_prev rows [R][H]
  float* const s_dz = s_h + R * H;                                   // [R][DS]
  float* const s_z = s_dz + R * DS;                                  // [R][DS]
  float* const s_recv = s_z + R * DS;                                // [U][Hb][R]

  auto chunk_rows = [&](int ch) { return min(kWfChunk, H - ch * kWfChunk); };
  // a chunk's rows by warp: warp w copies rows w, w + 12, …, lane l the
  // 16 bytes of columns 4l … (NC / 4 <= 32 pieces a row)
  auto load_w = [&](float* dst, int ch) {  // chunk ch of the slice, rows of NC + 4
    const int kr = chunk_rows(ch);
    const float* src = wp + (size_t)ch * kWfChunk * NC;
    if (4 * lane >= NC) return;
    for (int x = warp; x < kr; x += kWfWarps)
      cp_async16(dst + x * WS + 4 * lane, src + (size_t)x * NC + 4 * lane, true);
  };
  auto load_h = [&](int t, int ch) {  // h_prev[t] rows, the k of chunk ch; rows past B zero
    const int k0 = ch * kWfChunk, q4 = chunk_rows(ch) / 4;
    for (int i = tid; i < R * (kWfChunk / 4); i += kWfThreads) {
      const int r = i / (kWfChunk / 4), k4 = i % (kWfChunk / 4);
      if (k4 >= q4) continue;
      const bool ok = row0 + r < B;
      const int k = k0 + 4 * k4;
      cp_async16(s_h + r * H + k, ok ? hp + ((size_t)t * B + row0 + r) * H + k : hp, ok);
    }
  };
  // streamed item n is chunk n % nstr in ring slot n % kWfRing; every thread
  // counts the same items, so the counts are block-uniform
  int issued = 0, consumed = 0;
  auto issue = [&]() {
    while (nstr > 0 && issued < consumed + kWfRing) {
      load_w(s_ring + (issued % kWfRing) * SLOT, issued % nstr);
      ++issued;
    }
  };
  // the opening of chunk ch of pass(s): its loads landed, the next issued;
  // returns the chunk's W_h rows
  auto open_chunk = [&](int s, int ch) -> const float* {
    // every load but the last chunk's landed: this chunk's W_h rows (issued
    // at least two chunks ago) and its h_prev (at least NCH − 1 >= 2 ago)
    cp_async_wait<1>();
    __syncthreads();  // … for every thread; every read of chunk ch−1 done
    issue();
    if (ch == 0 && s >= 0) load_h(frame(s + 1), NCH - 1);
    if (ch > 0 && s + 2 < n_steps) load_h(frame(s + 2), ch - 1);
    cp_async_commit();
    return ch < nstr ? s_ring + (consumed % kWfRing) * SLOT : s_res + (ch - nstr) * SLOT;
  };
  auto close_chunk = [&](int ch) {
    if (ch < nstr) ++consumed;
  };

  // (a) the recompute, on warps 0–7: warp (co = w % (NC/32), rh = w / (NC/32))
  const int CO = NC / 32;
  const bool a_role = warp < kWfRecomputeWarps;
  const bool a_warp = warp < 2 * CO;
  const int a_co = warp % CO, a_rh = warp / CO, aj = lane >> 3, ap = lane & 7;
  auto recompute_pass = [&](int s) {
    float za[RH][4];
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) za[r][e] = 0.0f;
    const float* hrow = s_h + a_rh * RH * H;
    for (int ch = 0; ch < NCH; ++ch) {
      const float* wc = open_chunk(s, ch);
      if (a_warp) {
        const int kr = chunk_rows(ch), k0 = ch * kWfChunk;
        const float* wcol = wc + 32 * a_co + 4 * ap;
        for (int x = 4 * aj; x < kr; x += 16) {  // this lane's k-quads of the chunk
          const float4 w0 = *reinterpret_cast<const float4*>(wcol + x * WS);
          const float4 w1 = *reinterpret_cast<const float4*>(wcol + (x + 1) * WS);
          const float4 w2 = *reinterpret_cast<const float4*>(wcol + (x + 2) * WS);
          const float4 w3 = *reinterpret_cast<const float4*>(wcol + (x + 3) * WS);
#pragma unroll
          for (int r = 0; r < RH; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(hrow + r * H + k0 + x);
            za[r][0] = dot4(hv, make_float4(w0.x, w1.x, w2.x, w3.x), za[r][0]);
            za[r][1] = dot4(hv, make_float4(w0.y, w1.y, w2.y, w3.y), za[r][1]);
            za[r][2] = dot4(hv, make_float4(w0.z, w1.z, w2.z, w3.z), za[r][2]);
            za[r][3] = dot4(hv, make_float4(w0.w, w1.w, w2.w, w3.w), za[r][3]);
          }
        }
      }
      if (s >= 0 && ch == 0) cluster_wait();  // (b)'s warps store into the slots after it
      close_chunk(ch);
    }
    if (!a_warp) return;
    // the four k-quad lanes' sums, ((s0 + s1) + (s2 + s3)) in every lane; lane
    // j stores the rows r ≡ j (mod 4) of its 4 columns
#pragma unroll
    for (int r = 0; r < RH; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        za[r][e] += __shfl_xor_sync(0xffffffffu, za[r][e], 8);
        za[r][e] += __shfl_xor_sync(0xffffffffu, za[r][e], 16);
      }
#pragma unroll
    for (int r = 0; r < RH; ++r)
      if ((r & 3) == aj)
        *reinterpret_cast<float4*>(s_z + (a_rh * RH + r) * DS + 32 * a_co + 4 * ap) =
            make_float4(za[r][0], za[r][1], za[r][2], za[r][3]);
  };

  // (b) the dh partial, on warps 8–11: warp 8 + v, tile (kg, rh) of lane
  // (lane >> 2): rows of k 4kg … 4kg+3, batch rows of half rh = v >> 1; lane
  // i = lane & 3 takes the columns 16m + 4i … +3
  const int bv = warp - kWfRecomputeWarps, bi = lane & 3;
  const int b_kg = 8 * (bv & 1) + (lane >> 2), b_rh = bv >> 1;
  auto dh_chunk = [&](const float* wc, int ch) {
    if (32 * (bv & 1) >= chunk_rows(ch)) return;
    const float* wrow = wc + 4 * b_kg * WS + 4 * bi;
    const float* dzr = s_dz + b_rh * RH * DS + 4 * bi;
    float acc[4][RH];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < RH; ++r) acc[i][r] = 0.0f;
    for (int m = 0; m < NC; m += 16) {
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const float4*>(wrow + i * WS + m);
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(dzr + r * DS + m);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][r] = dot4(d, w[i], acc[i][r]);
      }
    }
    // reduce-scatter over the tile's four lanes (xor 2, then 1): lane i ends
    // with row of k 4kg + i, as (a_i + a_i^2) + (a_i^1 + a_i^3)
    const bool hi2 = (bi & 2) != 0, hi1 = (bi & 1) != 0;
    float v[2][RH];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const float send = hi2 ? acc[h][r] : acc[h + 2][r];
        const float keep = hi2 ? acc[h + 2][r] : acc[h][r];
        v[h][r] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
    float out[RH];
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      const float send = hi1 ? v[0][r] : v[1][r];
      const float keep = hi1 ? v[1][r] : v[0][r];
      out[r] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
    const int k = ch * kWfChunk + 4 * b_kg + bi, owner = k / Hb;
    float* slot = cluster.map_shared_rank(s_recv, owner) + (rank * Hb + k - owner * Hb) * R +
                  b_rh * RH;
#pragma unroll
    for (int j = 0; j < RH / 4; ++j)
      *reinterpret_cast<float4*>(slot + 4 * j) =
          make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
  };
  auto dh_pass = [&](int s) {
    for (int ch = 0; ch < NCH; ++ch) {
      const float* wc = open_chunk(s, ch);
      if (s >= 0) {
        if (ch == 0) cluster_wait();  // every block has read its partial slots
        dh_chunk(wc, ch);
      }
      close_chunk(ch);
    }
  };
  // one pass: (a) of step s+1 from h_prev[t(s+1)]; (b) of step s (s >= 0)
  auto pass = [&](int s) {
    if (a_role)
      recompute_pass(s);
    else
      dh_pass(s);
  };

  // gate phase: tile i of warp w is (units 8·uo …, rows 4·rq …), τ = w + 12i
  const int UO = Hb / 8, tiles = UO * RQ;
  typename Cell::Op op[kWfMaxTiles];
  auto tile = [&](int i, int& u, int& r) {
    const int tau = warp + kWfWarps * i;
    u = 8 * (tau % UO) + (lane & 7);
    r = 4 * (tau / UO) + (lane >> 3);
    return tau < tiles;
  };
  auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < kWfMaxTiles; ++i) {
      int u, r;
      if (tile(i, u, r)) cell.load(op[i], t, row0 + r, u0 + u, u < nu && row0 + r < B);
    }
  };
  auto gate_phase = [&](int s) {
    const int t = frame(s);
#pragma unroll
    for (int i = 0; i < kWfMaxTiles; ++i) {
      int u, r;
      if (!tile(i, u, r)) continue;
      const bool ok = u < nu && row0 + r < B;
      float z[G], d[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) z[gi] = s_z[r * DS + gi * Hb + u];
      float carry = cell.carry0(op[i]);
      for (int src = 0; src < U; ++src) carry += s_recv[(src * Hb + u) * R + r];
      cell.step(op[i], z, carry, d, t, row0 + r, u0 + u, ok);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) s_dz[r * DS + gi * Hb + u] = ok ? d[gi] : 0.0f;
    }
  };

  // ---- prologue: the resident chunks, the first streamed ones, h_prev of step 0
  for (int ch = nstr; ch < NCH; ++ch) load_w(s_res + (ch - nstr) * SLOT, ch);
  issue();
  for (int ch = 0; ch < NCH; ++ch) load_h(frame(0), ch);
  cp_async_commit();
  cp_async_wait<0>();  // the pass's first chunk waits only for older groups
  for (int i = tid; i < U * Hb * R; i += kWfThreads) s_recv[i] = 0.0f;  // dh_carry of step 0
  prefetch(frame(0));
  pass(-1);        // z of step 0
  cluster.sync();  // every block running, its slots zeroed; z stored

  for (int s = 0; s < n_steps; ++s) {
    gate_phase(s);
    if (s + 1 == n_steps) break;
    prefetch(frame(s + 1));
    cluster_arrive();  // this block's partial slots read
    pass(s);
    cluster_arrive();  // this block's partials stored; z stored
    cluster_wait();
  }
  cp_async_wait<0>();  // chunks streamed for a pass that does not come
}

}  // namespace percival
