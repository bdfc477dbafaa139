// Fused bidirectional GRU forward on the tensor cores for widths whose W_hᵀ
// slice one SM cannot hold (sm_90a, bf16).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas, :521) on the route "wide_mma_stream"
// (ops/mma_layout.py::fwd_route): bf16 past H = 672, where the slice of
// "wide_mma" (bigru_fwd_wide_mma.cu) leaves shared memory, up to the width
// the streamed BPTT takes (ops/wide_mma_layout.py::stream_max_h). Before it
// those widths ran bigru_fwd_wide.cu on CUDA cores. The contract is
// bigru_fwd_wide.cu's: gx (T, B, 3H), b_hn (H), y (T, B, H), gate order r,
// z, n, an f32 carry, round_bf16(h) feeding the product, the backward
// direction walking t = T-1 … 0 over the same arrays:
//
//   gh = round_bf16(h) · W_h ;  r = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n  = tanh(gx_n + r·(gh_n + b_hn)) ;  h = (1 − z)·n + z·h ;  y[t] = round_bf16(h)
//
// H a multiple of 32 (the wrapper zero-pads the others, which is exact);
// W_hᵀ packed per block and chunk (ops/wide_mma_layout.py::pack_wh_stream):
// the packing the streamed BPTT bigru_bwd_wide_mma_stream.cu reads.
//
// What bounds it on the card, and the design: bilstm_fwd_wide_mma_stream.cu's
// (its header says why each piece is there), with three gates a unit:
//   * 15 compute warps and the producer warp that streams the slice's chunks
//     from L2 through a 3-slot TMA ring, the rest of the room holding
//     resident chunks;
//   * up to 64 rows a cluster (at H = 1024 B = 160 in one wave of 6
//     clusters); a compute warp takes PPW (unit group of 16, 8-row tile)
//     pairs, each A fragment read once for the pairs of its group (at one
//     pair a warp its odd k-steps in a second accumulator);
//   * the accumulators land on lane l as r, z, gh_n of two units (16g + l/4
//     and + 8) for two rows, where the gate math runs; the f32 carry h stays
//     in registers, b_hn is read once a pair;
//   * the exchange: each warp stages its (16 units × 8 rows) tiles and writes
//     each row as two 16-byte chunks into y and into every block's next h
//     buffer (distributed shared memory), rows past B never written; two h
//     buffers and one cluster barrier a step where they fit, else one buffer
//     and the barrier split around the gate phase;
//   * gx of the next step loaded into registers behind the gate phase (from
//     three pairs a warp at the gate phase, hinted into L2 a step ahead); no
//     atomics, no allocation, PyTorch's stream; the launcher returns
//     cudaGetLastError().

#include <cooperative_groups.h>

#include <cstddef>
#include <cstdint>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_mma_common.cuh"
#include "wide_mma_stream.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using percival::cluster_arrive;
using percival::cluster_wait;
using percival::cp_async16;
using percival::cp_async_commit;
using percival::cp_async_wait;
using percival::kWsChunk;
using percival::kWsRing;
using percival::kWsThreads;
using percival::kWsWarps;
using percival::sigmoid_f32;
using percival::wm_h_bytes;
using percival::wm_ws;
using percival::ws_chunks;
using percival::ws_mbar_arrive;
using percival::ws_mbar_init;
using percival::ws_mbar_wait;
using percival::WideStreamFwdPlan;

constexpr int kUnits = 16;      // units a unit group: m-tiles r|z, r|z, n|n
constexpr int kGroupRows = 48;  // packed W_hᵀ rows a unit group

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads;
// PPW (unit group, 8-row tile) pairs a compute warp.
template <int PPW>
__global__ void __launch_bounds__(kWsThreads, 1) bigru_fwd_wide_mma_stream_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ bn_f, const bf16* __restrict__ bn_b,
    bf16* __restrict__ y_f, bf16* __restrict__ y_b,
    int n_steps, int B, int H, int Hb, int R, int nres, int dbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 3 * Hb, G = 3 * H, WS = wm_ws(H);
  const int NT8 = R / 8, NUG = Hb / kUnits, nch = ws_chunks(H), nstr = nch - nres;
  const int tile = NC * kWsChunk;  // elements a chunk tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * nch * tile;
  const bf16* __restrict__ bn = backward ? bn_b : bn_f;
  bf16* __restrict__ y = backward ? y_b : y_f;

  // step s visits frame t(s): ascending for the forward direction
  auto frame = [=](int s) { return backward ? n_steps - 1 - s : s; };

  // ---- pairs: warp w takes pairs p0 … p0 + np − 1 of the block's NUG × NT8
  // (unit group p / NT8, 8-row tile p % NT8); na of them in its first group ----
  const int pairs = NUG * NT8, nw = (pairs + PPW - 1) / PPW;  // warps that hold pairs
  const int p0 = warp * PPW;
  const int np = warp < kWsWarps && p0 < pairs ? min(PPW, pairs - p0) : 0;
  const int ug0 = p0 / NT8, t0 = p0 - ug0 * NT8;
  const int na = min(np, NT8 - t0);
  auto ug_of = [&](int i) { return i < na ? ug0 : ug0 + 1; };
  auto tile_of = [&](int i) { return i < na ? t0 + i : i - na; };

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const s_ring = reinterpret_cast<bf16*>(smem);  // ring chunk tiles
  bf16* const s_res = s_ring + (size_t)kWsRing * tile;  // the resident chunks
  bf16* const s_h = s_res + (size_t)nres * tile;         // h rows [1 + dbuf][R][WS]
  const int hbuf = (int)(wm_h_bytes(H, R) / sizeof(bf16));
  bf16* const s_stage0 = s_h + (1 + dbuf) * hbuf;        // the warps' staging tiles
  bf16* const s_stage = s_stage0 + warp * PPW * 8 * kUnits;  // this warp's [PPW][8][kUnits]
  uint64_t* const s_full = reinterpret_cast<uint64_t*>(s_stage0 + kWsWarps * PPW * 8 * kUnits);
  uint64_t* const s_empty = s_full + kWsRing;

  // ---- prologue: the ring's mbarriers, the resident chunks, h_0 = 0 ----
  if (tid == 0) {
    for (int i = 0; i < kWsRing; ++i) {
      ws_mbar_init(&s_full[i], 1);
      ws_mbar_init(&s_empty[i], nw);  // released by every warp that holds pairs
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < kWsWarps) {
    for (int i = tid; i < nres * tile / 8; i += 32 * kWsWarps)
      cp_async16(s_res + i * 8, wp + (size_t)nstr * tile + i * 8, true);
    cp_async_commit();
    uint4* z = reinterpret_cast<uint4*>(s_h);
    for (int i = tid; i < (1 + dbuf) * hbuf / 8; i += 32 * kWsWarps) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();  // the mbarriers set

  if (warp == kWsWarps) {  // the producer
    percival::ws_produce_fwd(wp, s_ring, s_full, s_empty, NC, nstr, n_steps, dbuf, lane);
    return;
  }

  // gx of the lane's cells (3 gates × 2 units a pair, the two rows as one bf16 pair)
  __nv_bfloat162 pgx[PPW][2][3];
  auto load_gx = [&](int t) {
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      bf16 v[2][2][3];
      const int unit0 = rank * Hb + ug_of(i) * kUnits;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_of(i) * 8 + 2 * q + e;
        const bool ok = i < np && unit0 < H && row < B;
        const bf16* src = gx + ((size_t)t * B + row) * G + unit0 + g;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int gi = 0; gi < 3; ++gi)
            v[e][u][gi] = ok ? src[gi * H + 8 * u] : __float2bfloat16(0.0f);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int gi = 0; gi < 3; ++gi) pgx[i][u][gi] = __halves2bfloat162(v[0][u][gi], v[1][u][gi]);
    }
  };
  auto gx_of = [&](int i, int u, int e, int gi) {
    return e ? __high2float(pgx[i][u][gi]) : __low2float(pgx[i][u][gi]);
  };
  // warps of three or more pairs load gx at the gate phase (their registers
  // hold no prefetch): the next step's lines are hinted into L2 instead
  constexpr bool kHeld = PPW <= 2;
  auto prefetch_gx = [&](int t) {
    if (g != 0) return;  // lanes 4q … 4q + 3 read one 32-byte run of units
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int unit0 = rank * Hb + ug_of(i) * kUnits;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_of(i) * 8 + 2 * q + e;
        if (i < np && unit0 < H && row < B)
#pragma unroll
          for (int gi = 0; gi < 3; ++gi)
            percival::wsf_prefetch_l2(gx + ((size_t)t * B + row) * G + gi * H + unit0);
      }
    }
  };

  // the chunks of a step in order: streamed ones from the ring, then the resident ones
  int streamed = 0;  // streamed chunks consumed so far
  auto chunk_at = [&](int c, int& slot) -> const bf16* {
    if (c >= nstr) {
      slot = -1;
      return s_res + (size_t)(c - nstr) * tile;
    }
    slot = streamed % kWsRing;
    ws_mbar_wait(&s_full[slot], (streamed / kWsRing) & 1);
    return s_ring + (size_t)slot * tile;
  };
  auto release = [&](int slot) {
    if (slot < 0) return;
    __syncwarp();
    if (lane == 0) ws_mbar_arrive(&s_empty[slot]);
    ++streamed;
  };

  // zᵀ of the warp's pairs: z[i][0] = r|z of units 0–7 of pair i's unit
  // group, z[i][1] = r|z of units 8–15, z[i][2] = gh_n of units 0–7 | 8–15,
  // for the rows of its tile
  float z[PPW][3][4], zo[PPW][3][4];  // zo: the odd k-steps' sums at one pair a warp
  const int arow = ug0 * kGroupRows + ld_row + 8 * (ld_mat & 1);
  float hreg[PPW][2][2];  // the f32 carry h of the lane's (unit, row) cells
  float bias[PPW][2];     // b_hn of the lane's two units of each pair
#pragma unroll
  for (int i = 0; i < PPW; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int unit0 = rank * Hb + ug_of(i) * kUnits;
      hreg[i][u][0] = hreg[i][u][1] = 0.0f;
      bias[i][u] = i < np && unit0 < H ? __bfloat162float(bn[unit0 + 8 * u + g]) : 0.0f;
    }

  if constexpr (kHeld) load_gx(frame(0));
  cp_async_wait<0>();
  cluster_arrive();  // every block running, its resident chunks landed and its h buffers zeroed
  cluster_wait();

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bool last = s + 1 == n_steps;
    const bf16* const hb = s_h + (dbuf & s) * hbuf + ld_row * WS + ld_mat * 8;
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) z[i][j][k] = zo[i][j][k] = 0.0f;
    if (np > 0) {
      for (int c = 0; c < nch; ++c) {
        int slot;
        const bf16* w = chunk_at(c, slot);
        const int rest = H - c * kWsChunk;
        percival::wsf_product<3, PPW>(z, zo, w, hb, WS, np, na, t0, c * kWsChunk,
                                      (rest < kWsChunk ? rest : kWsChunk) / 16, arow,
                                      kGroupRows, ld_row, ld_mat);
        release(slot);
      }
      percival::wsf_join<3, PPW>(z, zo);
    }
    if (!dbuf && !last) cluster_arrive();  // this block's reads of the h buffer done
    if constexpr (!kHeld) load_gx(t);

    // ---- gate phase: h of the lane's cells; round(h) into the warp's stage ----
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const bool group_ok = rank * Hb + ug_of(i) * kUnits < H;  // whole groups past H
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rl = 2 * q + e;  // row in the tile
        const bool ok = group_ok && row0 + tile_of(i) * 8 + rl < B;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float rg = sigmoid_f32(gx_of(i, u, e, 0) + z[i][u][e]);
          const float zg = sigmoid_f32(gx_of(i, u, e, 1) + z[i][u][2 + e]);
          const float ng = tanhf(gx_of(i, u, e, 2) + rg * (z[i][2][2 * u + e] + bias[i][u]));
          const float h = ok ? (1.0f - zg) * ng + zg * hreg[i][u][e] : 0.0f;
          hreg[i][u][e] = h;
          s_stage[(i * 8 + rl) * kUnits + 8 * u + g] = __float2bfloat16(h);
        }
      }
    }
    __syncwarp();
    if (!last) {
      if constexpr (kHeld) load_gx(frame(s + 1));
      else prefetch_gx(frame(s + 1));
    }
    if (!dbuf && !last) cluster_wait();  // every block has read its h buffer: it may be written

    // ---- the exchange: each staged row (16 units, two 16-byte chunks) into y
    // and into the next h buffer of every block; lane l takes row l % 8, chunk
    // (l / 8) % 2, for blocks l / 16, + 2, …
    bf16* const next = s_h + (dbuf & (s + 1)) * hbuf;
    const int half = (lane >> 3) & 1;
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const int unit0 = rank * Hb + ug_of(i) * kUnits;  // the group's first unit
      const int rl = lane & 7, rowc = tile_of(i) * 8 + rl, row = row0 + rowc;
      if (unit0 < H && row < B) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(s_stage + (i * 8 + rl) * kUnits + 8 * half);
        const int col = unit0 + 8 * half;
        if (lane < 16) *reinterpret_cast<uint4*>(y + ((size_t)t * B + row) * H + col) = v;
        if (!last)
          for (int dst = lane >> 4; dst < U; dst += 2)
            *reinterpret_cast<uint4*>(cluster.map_shared_rank(next, dst) + rowc * WS + col) = v;
      }
    }
    if (last) break;
    cluster_arrive();  // h of step s+1 landed in every block
    cluster_wait();
  }
}

const void* kernel_for(int PPW) {
  switch (PPW) {
    case 1: return (const void*)&bigru_fwd_wide_mma_stream_kernel<1>;
    case 2: return (const void*)&bigru_fwd_wide_mma_stream_kernel<2>;
    case 3: return (const void*)&bigru_fwd_wide_mma_stream_kernel<3>;
    default: return nullptr;
  }
}

percival::WsfPlanCache plans;  // this kernel file's

cudaError_t plan_for(int B, int H, int Hb, int U, int rows, WideStreamFwdPlan* plan) {
  return plans.get(B, H, Hb, U, 3, kUnits, rows, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes (rows > 0: with that many rows a
// cluster), into out[11], as percival_bilstm_fwd_wide_mma_stream_plan.
extern "C" int percival_bigru_fwd_wide_mma_stream_plan(int B, int H, int Hb, int U, int rows,
                                                       int* out) {
  WideStreamFwdPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err == cudaSuccess) percival::wide_stream_fwd_plan_out(plan, out);
  return err;
}

// bf16 only, H a multiple of 32. gx (T, B, 3H), W_hᵀ packed per block and
// chunk (ops/wide_mma_layout.py::pack_wh_stream) and b_hn (H), each as
// (forward direction, backward direction); then y (T, B, H) of each. rows:
// 0 for the plan's choice of rows a cluster, else that many (a
// measurement's override). gx, W_hᵀ and y 16-byte aligned, no pointer null.
// Returns a cudaError_t.
extern "C" int percival_bigru_fwd_wide_mma_stream(const void* gx_f, const void* gx_b,
                                                  const void* wp_f, const void* wp_b,
                                                  const void* bn_f, const void* bn_b,
                                                  void* y_f, void* y_b,
                                                  int n_steps, int B, int H, int Hb, int U,
                                                  int rows, void* stream) {
  if (n_steps < 1 || bn_f == nullptr || bn_b == nullptr) return cudaErrorInvalidValue;
  const void* ptrs[6] = {gx_f, gx_b, wp_f, wp_b, y_f, y_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideStreamFwdPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err != cudaSuccess) return err;
  int R = plan.R, nres = plan.nres, dbuf = plan.dbuf;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&y_f,  (void*)&y_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&R, (void*)&nres,
                  (void*)&dbuf};
  return percival::wide_stream_fwd_launch(plan, B, kernel_for, args,
                                          static_cast<cudaStream_t>(stream));
}
