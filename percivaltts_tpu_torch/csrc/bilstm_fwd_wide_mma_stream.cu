// Fused bidirectional LSTM forward on the tensor cores for widths whose W_hᵀ
// slice one SM cannot hold (sm_90a, bf16).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_fwd_kernel
// (launched by _bilstm_fwd_pallas, :202) on the route "wide_mma_stream"
// (ops/mma_layout.py::fwd_route): bf16 past H = 608, where the slice of
// "wide_mma" (bilstm_fwd_wide_mma.cu) leaves shared memory, up to the width
// the streamed BPTT takes (ops/wide_mma_layout.py::stream_max_h). Before it
// those widths ran bilstm_fwd_wide.cu, the product on CUDA cores with the
// slice read through L2 by plain loads. The contract is bilstm_fwd_wide.cu's:
// gx (T, B, 4H), y / c_out (T, B, H), f32 carries, round_bf16(h) feeding the
// product, the backward direction walking t = T-1 … 0 over the same arrays:
//
//   z = gx[t] + round_bf16(h) · W_h ;  i,f,g,o = σ, σ, tanh, σ
//   c = f·c + i·g ;  h = o·tanh(c) ;  y[t] = round_bf16(h) ; c_out[t] = round_bf16(c)
//
// H a multiple of 32 (the wrapper zero-pads the others, which is exact);
// W_hᵀ packed per block and chunk (ops/wide_mma_layout.py::pack_wh_stream,
// (U, chunks, NC, 64) a direction): the packing the streamed BPTT
// bilstm_bwd_wide_mma_stream.cu reads, so a layer's two passes share it.
//
// What bounds it on the card: each step reads the block's whole slice (at
// H = 1024, 16 blocks of 512 KB a cluster) for R·NC·H multiply-adds, against
// the chain from one step's h to the next through the cluster. The slice
// cannot stay on chip, so it streams from L2 once a step a cluster for all R
// rows of the cluster: L2 traffic is clusters × streamed bytes a step, and R
// divides it. bilstm_fwd_wide.cu read it on CUDA cores for at most 8 rows a
// cluster (6 waves of clusters at B = 160) and exchanged h as f32. Here
// (the ring, the plan and the product: wide_mma_stream.cuh):
//   * 15 compute warps and one producer warp (512 threads: 128 registers a
//     thread); the producer keeps the ring of 3 slots filled by TMA
//     (cp.async.bulk, one copy of NC × 128 bytes a chunk) and runs ahead
//     into the next step's first chunks while the gate phase, the exchange
//     and the cluster barrier run; the last nres chunks, as many as the room
//     beside the h tile holds, stay resident (a deeper ring measured slower:
//     it streams more bytes a step);
//   * up to 64 rows a cluster, as many as shared memory holds beside the
//     ring (56 at H = 1024: B = 160 in one wave of 6 clusters); a compute
//     warp takes PPW (unit group, 8-row tile) pairs, each A fragment read
//     from a chunk once for the pairs of its unit group; at one pair a warp
//     (R = 8) its odd k-steps sum in a second accumulator, two chains of
//     dependent products, not one;
//   * the accumulators land on lane l as i, f, g, o of one unit for two
//     rows, where the gate math runs and the cell carry c stays; gx of the
//     next step is loaded into registers behind the gate phase (from three
//     pairs a warp, whose accumulators leave no room, at the gate phase,
//     its lines hinted into L2 a step ahead);
//   * the exchange is "wide_mma"'s all-gather of bf16 round(h) through
//     distributed shared memory, rows past B never written; two h buffers
//     and one cluster barrier a step where they fit, else one buffer and
//     the barrier split around the gate phase;
//   * no atomics, no allocation, PyTorch's stream; the launcher returns
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

constexpr int kUnits = 8;       // units a unit group: m-tiles i|f, g|o
constexpr int kGroupRows = 32;  // packed W_hᵀ rows a unit group

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads;
// PPW (unit group, 8-row tile) pairs a compute warp.
template <int PPW>
__global__ void __launch_bounds__(kWsThreads, 1) bilstm_fwd_wide_mma_stream_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    bf16* __restrict__ y_f, bf16* __restrict__ y_b,
    bf16* __restrict__ c_f, bf16* __restrict__ c_b,
    int n_steps, int B, int H, int Hb, int R, int nres, int dbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 4 * Hb, G = 4 * H, WS = wm_ws(H);
  const int NT8 = R / 8, NUG = Hb / kUnits, nch = ws_chunks(H), nstr = nch - nres;
  const int tile = NC * kWsChunk;  // elements a chunk tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * nch * tile;
  bf16* __restrict__ y = backward ? y_b : y_f;
  bf16* __restrict__ cs = backward ? c_b : c_f;  // null: cells not wanted

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

  // gx of the lane's cells (4 gates a pair, the two rows as one bf16 pair)
  __nv_bfloat162 pgx[PPW][4];
  auto load_gx = [&](int t) {
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      bf16 v[2][4];
      const int unit = rank * Hb + ug_of(i) * kUnits + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_of(i) * 8 + 2 * q + e;
        const bool ok = i < np && unit < H && row < B;
        const bf16* src = gx + ((size_t)t * B + row) * G + unit;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) v[e][gi] = ok ? src[gi * H] : __float2bfloat16(0.0f);
      }
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) pgx[i][gi] = __halves2bfloat162(v[0][gi], v[1][gi]);
    }
  };
  auto gx_of = [&](int i, int e, int gi) {
    return e ? __high2float(pgx[i][gi]) : __low2float(pgx[i][gi]);
  };
  // warps of three or more pairs load gx at the gate phase (their registers
  // hold no prefetch): the next step's lines are hinted into L2 instead
  constexpr bool kHeld = PPW <= 2;
  auto prefetch_gx = [&](int t) {
    if (g != 0) return;  // lanes 4q … 4q + 3 read one 16-byte run of units
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int unit = rank * Hb + ug_of(i) * kUnits;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_of(i) * 8 + 2 * q + e;
        if (i < np && unit < H && row < B)
#pragma unroll
          for (int gi = 0; gi < 4; ++gi)
            percival::wsf_prefetch_l2(gx + ((size_t)t * B + row) * G + gi * H + unit);
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

  // zᵀ of the warp's pairs: z[i][0] = i|f, z[i][1] = g|o of pair i's unit
  // group for the rows of its tile
  float z[PPW][2][4], zo[PPW][2][4];  // zo: the odd k-steps' sums at one pair a warp
  const int arow = ug0 * kGroupRows + ld_row + 8 * (ld_mat & 1);
  float creg[PPW][2];  // the cell carry c of the lane's (unit, row) cells
#pragma unroll
  for (int i = 0; i < PPW; ++i) creg[i][0] = creg[i][1] = 0.0f;

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
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) z[i][j][k] = zo[i][j][k] = 0.0f;
    if (np > 0) {
      for (int c = 0; c < nch; ++c) {
        int slot;
        const bf16* w = chunk_at(c, slot);
        const int rest = H - c * kWsChunk;
        percival::wsf_product<2, PPW>(z, zo, w, hb, WS, np, na, t0, c * kWsChunk,
                                      (rest < kWsChunk ? rest : kWsChunk) / 16, arow,
                                      kGroupRows, ld_row, ld_mat);
        release(slot);
      }
      percival::wsf_join<2, PPW>(z, zo);
    }
    if (!dbuf && !last) cluster_arrive();  // this block's reads of the h buffer done
    if constexpr (!kHeld) load_gx(t);

    // ---- gate phase: c and h of the lane's cells; round(h) into the warp's stage ----
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const int unit = rank * Hb + ug_of(i) * kUnits + g;
      const bool group_ok = rank * Hb + ug_of(i) * kUnits < H;  // whole groups past H
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rl = 2 * q + e;  // row in the tile
        const int row = row0 + tile_of(i) * 8 + rl;
        const bool ok = group_ok && row < B;
        const float ig = sigmoid_f32(gx_of(i, e, 0) + z[i][0][e]);
        const float fg = sigmoid_f32(gx_of(i, e, 1) + z[i][0][2 + e]);
        const float gg = tanhf(gx_of(i, e, 2) + z[i][1][e]);
        const float og = sigmoid_f32(gx_of(i, e, 3) + z[i][1][2 + e]);
        const float c = fg * creg[i][e] + ig * gg;
        creg[i][e] = ok ? c : 0.0f;
        s_stage[(i * 8 + rl) * kUnits + g] = __float2bfloat16(ok ? og * tanhf(c) : 0.0f);
        if (ok && cs != nullptr) cs[((size_t)t * B + row) * H + unit] = __float2bfloat16(c);
      }
    }
    __syncwarp();
    if (!last) {
      if constexpr (kHeld) load_gx(frame(s + 1));
      else prefetch_gx(frame(s + 1));
    }
    if (!dbuf && !last) cluster_wait();  // every block has read its h buffer: it may be written

    // ---- the exchange: each staged row (8 units, 16 bytes) into y and into
    // the next h buffer of every block; lane l takes row l % 8 for blocks l / 8, + 4, …
    bf16* const next = s_h + (dbuf & (s + 1)) * hbuf;
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const int unit0 = rank * Hb + ug_of(i) * kUnits;  // the group's first unit
      const int rl = lane & 7, rowc = tile_of(i) * 8 + rl, row = row0 + rowc;
      if (unit0 < H && row < B) {
        const uint4 v = *reinterpret_cast<const uint4*>(s_stage + (i * 8 + rl) * kUnits);
        if (lane < 8) *reinterpret_cast<uint4*>(y + ((size_t)t * B + row) * H + unit0) = v;
        if (!last)
          for (int dst = lane >> 3; dst < U; dst += 4)
            *reinterpret_cast<uint4*>(cluster.map_shared_rank(next, dst) + rowc * WS + unit0) = v;
      }
    }
    if (last) break;
    cluster_arrive();  // h of step s+1 landed in every block
    cluster_wait();
  }
}

const void* kernel_for(int PPW) {
  switch (PPW) {
    case 1: return (const void*)&bilstm_fwd_wide_mma_stream_kernel<1>;
    case 2: return (const void*)&bilstm_fwd_wide_mma_stream_kernel<2>;
    case 3: return (const void*)&bilstm_fwd_wide_mma_stream_kernel<3>;
    case 4: return (const void*)&bilstm_fwd_wide_mma_stream_kernel<4>;
    default: return nullptr;
  }
}

percival::WsfPlanCache plans;  // this kernel file's

cudaError_t plan_for(int B, int H, int Hb, int U, int rows, WideStreamFwdPlan* plan) {
  return plans.get(B, H, Hb, U, 4, kUnits, rows, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes (rows > 0: with that many rows a
// cluster), into out[11]: U, Hb, NC, R, pairs a compute warp, chunks
// resident, chunks streamed, clusters at once, waves, two h buffers or one,
// shared memory a block.
extern "C" int percival_bilstm_fwd_wide_mma_stream_plan(int B, int H, int Hb, int U, int rows,
                                                        int* out) {
  WideStreamFwdPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err == cudaSuccess) percival::wide_stream_fwd_plan_out(plan, out);
  return err;
}

// bf16 only, H a multiple of 32. gx (T, B, 4H) and W_hᵀ packed per block and
// chunk (ops/wide_mma_layout.py::pack_wh_stream), each as (forward direction,
// backward direction); y (T, B, H) and, unless both null (serving), c
// (T, B, H). rows: 0 for the plan's choice of rows a cluster, else that many
// (a measurement's override). Every pointer 16-byte aligned. Returns a
// cudaError_t.
extern "C" int percival_bilstm_fwd_wide_mma_stream(const void* gx_f, const void* gx_b,
                                                   const void* wp_f, const void* wp_b,
                                                   void* y_f, void* y_b, void* c_f, void* c_b,
                                                   int n_steps, int B, int H, int Hb, int U,
                                                   int rows, void* stream) {
  if (n_steps < 1 || (c_f == nullptr) != (c_b == nullptr)) return cudaErrorInvalidValue;
  const void* ptrs[8] = {gx_f, gx_b, wp_f, wp_b, y_f, y_b, c_f ? c_f : y_f, c_b ? c_b : y_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideStreamFwdPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err != cudaSuccess) return err;
  int R = plan.R, nres = plan.nres, dbuf = plan.dbuf;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&y_f,  (void*)&y_b,  (void*)&c_f,  (void*)&c_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&R, (void*)&nres,
                  (void*)&dbuf};
  return percival::wide_stream_fwd_launch(plan, B, kernel_for, args,
                                          static_cast<cudaStream_t>(stream));
}
