// Fused bidirectional LSTM backward (BPTT) on the tensor cores for widths
// whose W_hᵀ slice one SM cannot hold beside its tiles (sm_90a, bf16).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas, :321) on the route "wide_mma_stream"
// (ops/mma_layout.py::bwd_route): bf16 past H = 608, where the slice of
// "wide_mma" (bilstm_bwd_wide_mma.cu) leaves shared memory, up to the width
// H = 4096 (ops/wide_mma_layout.py::stream_bwd_max_h): past
// stream_max_h (1536 LSTM, 1792 GRU) on the deep layout (the kernel below
// the 64-k one; wide_mma_stream.cuh says how it cuts the block). Before it
// those widths ran bilstm_bwd_wide.cu, both products on CUDA cores with the
// slice read through L2 by plain loads. The contract is bilstm_bwd_wide_mma.cu's:
//
//   z    = gx[t] + h_prev[t] · W_h                  (gates recomputed)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = round_bf16(dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o))
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ (f32) ;  dc_carry = dc·f
//
// the forward direction's BPTT walking t = T-1 … 0, the backward one's
// t = 0 … T-1. Layouts: gx / dgx (T, B, 4H); h_prev / c_prev / c / dy
// (T, B, H), all bf16, H a multiple of 32 (the wrapper zero-pads the others,
// which is exact); W_hᵀ packed per block and chunk
// (ops/wide_mma_layout.py::pack_wh_stream, (U, chunks, NC, 64) a direction:
// "wide_mma"'s packed rows, 64 k a chunk, each row's 16-byte units swizzled).
//
// What bounds it on the card: each step reads the block's whole slice (at
// H = 1024, 16 blocks of 512 KB a cluster) and runs 2·R·NC·H multiply-adds on
// it, against the chain from one step's dz to the next step's dh through the
// cluster. The slice cannot stay on chip, so it streams from L2 once a step a
// cluster, and each chunk that arrives feeds both products (the next step's
// recompute over its k, this step's dh over its units) on mma.sync, for all
// R rows of the cluster: L2 traffic is clusters × streamed bytes a step, and
// R (8, 16 or 24: the least waves × step estimate) is what divides it. Inside
// the SM the bound is shared memory: every A fragment of either product is an
// ldmatrix of 512 bytes from a chunk, so each is read once for as many row
// tiles as the registers allow.
// The pieces (wide_mma_stream.cuh):
//   * 15 compute warps and one producer warp (512 threads: 128 registers a
//     thread); the producer keeps the ring of 3 slots filled by TMA
//     (cp.async.bulk, one copy of NC × 128 bytes a chunk) on "full"
//     mbarriers, the compute warps release each slot on its "empty" one; the
//     last nres chunks stay resident;
//   * cell warps: a unit group and up to 2 8-row tiles each, the recompute's
//     A fragments read once for both tiles, its accumulators landing on i, f,
//     g, o of one unit for two rows, where the gate math runs (the gate
//     operands held as bf16 pairs); the dh product's items (two 16-unit
//     tiles and every row tile, each B fragment read once for both) rotate
//     over all 15 compute warps from chunk to chunk;
//   * the dh partials go to their owners' slots through distributed shared
//     memory as in "wide_mma" (two buffers and one cluster barrier a step
//     where they fit, else one buffer and the barrier split around the first
//     chunk of the pass), added in block order by the owner;
//   * h_prev of the next pass staged by cp.async during the barrier, the gate
//     operands of the next step loaded behind the gate phase; no atomics, no
//     allocation, PyTorch's stream; the launcher returns cudaGetLastError().

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
using percival::kWdChunk;
using percival::kWdHs;
using percival::kWsWarps;
using percival::sigmoid_f32;
using percival::wm_ds;
using percival::wm_h_bytes;
using percival::wm_recv_bytes;
using percival::wm_ws;
using percival::ws_chunks;
using percival::ws_compute_sync;
using percival::ws_mbar_arrive;
using percival::ws_mbar_init;
using percival::ws_mbar_wait;
using percival::WideStreamPlan;

constexpr int kUnits = 8;         // units a unit group: m-tiles i|f, g|o
constexpr int kGroupRows = 32;    // packed W_hᵀ rows a unit group
constexpr int kDhM = 2;          // 16-unit m-tiles a dh item (wide_mma_stream.cuh::ws_dh_chunk)

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads;
// R = 8·NT8 rows a cluster.
template <int NT8>
__global__ void __launch_bounds__(kWsThreads, 1) bilstm_bwd_wide_mma_stream_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ hp_f, const bf16* __restrict__ hp_b,
    const bf16* __restrict__ cp_f, const bf16* __restrict__ cp_b,
    const bf16* __restrict__ c_f, const bf16* __restrict__ c_b,
    const bf16* __restrict__ dy_f, const bf16* __restrict__ dy_b,
    bf16* __restrict__ dgx_f, bf16* __restrict__ dgx_b,
    int n_steps, int B, int H, int Hb, int nres, int dbuf) {
  constexpr int R = 8 * NT8, TPW = percival::ws_tpw(4, NT8);
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 4 * Hb, G = 4 * H, WS = wm_ws(H), DS = wm_ds(NC);
  const int NUG = Hb / kUnits, nch = ws_chunks(H), nstr = nch - nres;
  const int tile = NC * kWsChunk;  // elements a chunk tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * nch * tile;
  const bf16* __restrict__ hp = backward ? hp_b : hp_f;
  const bf16* __restrict__ cpv = backward ? cp_b : cp_f;
  const bf16* __restrict__ cs = backward ? c_b : c_f;
  const bf16* __restrict__ dy = backward ? dy_b : dy_f;
  bf16* __restrict__ dgx = backward ? dgx_b : dgx_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const s_ring = reinterpret_cast<bf16*>(smem);           // kWsRing chunk tiles
  bf16* const s_res = s_ring + (size_t)kWsRing * tile;          // the resident chunks
  bf16* const s_h = s_res + (size_t)nres * tile;                // h_prev rows [R][WS]
  float* const s_recv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_h) +
                                                 wm_h_bytes(H, R));  // partials [U][Hb][R]
  bf16* const s_dg = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s_recv) +
                                             wm_recv_bytes(U, Hb, R, 1 + dbuf));  // dz [R][DS]
  uint64_t* const s_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(s_dg) + percival::align16((size_t)R * DS * 2));
  uint64_t* const s_empty = s_full + kWsRing;

  // ---- prologue: the ring's mbarriers, the resident chunks, h_prev of step 0 ----
  const int HCH = H / 8;
  auto load_h = [&](int t) {  // rows past B zero-filled; one commit group
    for (int i = tid; i < R * HCH; i += 32 * kWsWarps) {
      const int r = i / HCH, ch = i - r * HCH;
      const bool ok = row0 + r < B;
      cp_async16(s_h + r * WS + ch * 8, ok ? hp + ((size_t)t * B + row0 + r) * H + ch * 8 : hp,
                 ok);
    }
    cp_async_commit();
  };
  const int slots = U * Hb * R;  // partial slots of a buffer
  if (tid == 0) {
    for (int i = 0; i < kWsRing; ++i) {
      ws_mbar_init(&s_full[i], 1);
      ws_mbar_init(&s_empty[i], kWsWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < kWsWarps) {
    for (int i = tid; i < nres * tile / 8; i += 32 * kWsWarps)
      cp_async16(s_res + i * 8, wp + (size_t)nstr * tile + i * 8, true);
    load_h(frame(0));
    for (int i = tid; i < (1 + dbuf) * slots; i += 32 * kWsWarps) s_recv[i] = 0.0f;  // dh_carry of step 0
  }
  __syncthreads();  // the mbarriers set

  if (warp == kWsWarps) {  // the producer
    percival::ws_produce(wp, s_ring, s_full, s_empty, NC, nstr, n_steps, dbuf, lane);
    return;
  }

  // ---- cells: warp w < cells takes unit group w / NTG and the 8-row tiles
  // TPW·(w % NTG) … (at most TPW); every warp takes dh items ----
  constexpr int NTG = (NT8 + TPW - 1) / TPW;
  const int cells = percival::ws_cells(4, NUG, NT8);
  const int ug = warp / NTG, nt0 = TPW * (warp - ug * NTG);
  const bool cell_on = warp < cells;
  const int ntiles = cell_on ? (NT8 - nt0 < TPW ? NT8 - nt0 : TPW) : 0;
  const int ul = ug * kUnits + g;  // the lane's unit in the block
  const bool unit_ok = cell_on && rank * Hb + ul < H;
  const int unit = rank * Hb + ul;
  const bf16* const hrow = s_h + (nt0 * 8 + ld_row) * WS + ld_mat * 8;
  const int arow = ug * kGroupRows + ld_row + 8 * (ld_mat & 1);

  float z[TPW][2][4];  // per tile: m-tile 0 = i|f, 1 = g|o of the unit group, 8 rows
  auto zero_z = [&]() {
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) z[tt][j][k] = 0.0f;
  };

  // the chunks of a pass in order: streamed ones from the ring, then the resident ones
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
  auto recompute = [&](const bf16* w, int c) {
    if (!cell_on) return;
    const int rest = H - c * kWsChunk;
    percival::ws_recompute<2, TPW>(z, w, hrow, WS, ntiles, c * kWsChunk,
                              (rest < kWsChunk ? rest : kWsChunk) / 16, arow, ld_row, ld_mat);
  };

  // the gate operands of a step: gx (4 gates), c_prev, c, dy of the lane's
  // unit for its two rows of each of the warp's tiles, as bf16 pairs (row e
  // in half e)
  __nv_bfloat162 pgx[TPW][4], pcp[TPW], pc[TPW], pdy[TPW];
  auto load_cell = [&](int t) {
    const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt) {
      bf16 v[7][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + (nt0 + tt) * 8 + 2 * q + e;
        const bool ok = unit_ok && tt < ntiles && row < B;
        const size_t base = (size_t)t * B + row;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) v[gi][e] = ok ? gx[base * G + gi * H + unit] : zero;
        v[4][e] = ok ? cpv[base * H + unit] : zero;
        v[5][e] = ok ? cs[base * H + unit] : zero;
        v[6][e] = ok ? dy[base * H + unit] : zero;
      }
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) pgx[tt][gi] = __halves2bfloat162(v[gi][0], v[gi][1]);
      pcp[tt] = __halves2bfloat162(v[4][0], v[4][1]);
      pc[tt] = __halves2bfloat162(v[5][0], v[5][1]);
      pdy[tt] = __halves2bfloat162(v[6][0], v[6][1]);
    }
  };
  auto pick = [](__nv_bfloat162 p, int e) { return e ? __high2float(p) : __low2float(p); };

  cp_async_wait<0>();
  ws_compute_sync();  // the resident chunks and step 0's h_prev rows landed
  zero_z();
  for (int c = 0; c < nch; ++c) {  // z of step 0
    int slot;
    const bf16* w = chunk_at(c, slot);
    recompute(w, c);
    release(slot);
  }
  ws_compute_sync();  // every read of s_h done
  if (n_steps > 1) load_h(frame(1));
  load_cell(frame(0));
  float dcr[TPW][2] = {};  // dc_carry of the lane's two rows of each tile
  cluster_arrive();  // every block running, its partial slots zeroed
  cluster_wait();

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);

    // ---- gate phase: dz of this step from z, the carries and the operands ----
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt) {
      if (tt >= ntiles) break;
      const int r0 = (nt0 + tt) * 8 + 2 * q;  // the lane's rows r0, r0 + 1 of the tile
      float2 carry = make_float2(0.0f, 0.0f);
      const float* red = s_recv + (dbuf & s) * slots + ul * R + r0;
      for (int src = 0; src < U; ++src) {
        const float2 v = *reinterpret_cast<const float2*>(red + src * Hb * R);
        carry.x += v.x;
        carry.y += v.y;
      }
      bf16* dgr = s_dg + ug * kGroupRows + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + r0 + e;
        const bool ok = unit_ok && row < B;
        const float ig = sigmoid_f32(pick(pgx[tt][0], e) + z[tt][0][e]);
        const float fg = sigmoid_f32(pick(pgx[tt][1], e) + z[tt][0][2 + e]);
        const float gg = tanhf(pick(pgx[tt][2], e) + z[tt][1][e]);
        const float og = sigmoid_f32(pick(pgx[tt][3], e) + z[tt][1][2 + e]);
        const float tc = tanhf(pick(pc[tt], e));
        const float dh = pick(pdy[tt], e) + (e ? carry.y : carry.x);
        const float dc = dcr[tt][e] + dh * og * (1.0f - tc * tc);
        const bf16 zero = __float2bfloat16(0.0f);
        const bf16 d[4] = {ok ? __float2bfloat16(dc * gg * ig * (1.0f - ig)) : zero,
                           ok ? __float2bfloat16(dc * pick(pcp[tt], e) * fg * (1.0f - fg)) : zero,
                           ok ? __float2bfloat16(dc * ig * (1.0f - gg * gg)) : zero,
                           ok ? __float2bfloat16(dh * tc * og * (1.0f - og)) : zero};
        bf16* dgt = dgr + (r0 + e) * DS;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) dgt[8 * gi] = d[gi];  // rows i, f | g, o of the group
        if (ok) {
          bf16* out = dgx + ((size_t)t * B + row) * G + unit;
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) out[gi * H] = d[gi];
        }
        dcr[tt][e] = ok ? dc * fg : 0.0f;
      }
    }
    if (s + 1 == n_steps) break;

    if (!dbuf) cluster_arrive();  // this block's partials of step s read
    cp_async_wait<0>();
    ws_compute_sync();  // s_dg complete; s_h holds h_prev of step s+1
    load_cell(frame(s + 1));
    zero_z();
    float* recv = s_recv + (dbuf & (s + 1)) * slots;
    for (int c = 0; c < nch; ++c) {  // step s+1's recompute and step s's dh, a chunk at a time
      int slot;
      const bf16* w = chunk_at(c, slot);
      recompute(w, c);
      if (c == 0 && !dbuf) cluster_wait();  // every block has read its partials: the slots are free
      percival::ws_dh_chunk<kDhM, NT8>(cluster, w, s_dg, recv, c, H, Hb, NC, rank, warp, lane);
      release(slot);
    }
    cluster_arrive();   // step s's partials stored
    ws_compute_sync();  // every read of s_h and s_dg done
    if (s + 2 < n_steps) load_h(frame(s + 2));
    cluster_wait();     // every partial of step s landed
  }
  cp_async_wait<0>();
}

// The deep layout (wide_mma_stream.cuh): past the widths the 64-k layout
// fits, up to H = 4096. The same contract and step on 32-k chunks whose copy
// carries h_prev's rows, the dh partials through the cluster's scratch in
// global memory, PPW (unit group, 8-row tile) pairs a compute warp (their gate
// operands loaded at the gate phase); grid as above, R = 8·NT8 rows a cluster.
template <int NT8, int PPW>
__global__ void __launch_bounds__(kWsThreads, 1) bilstm_bwd_wide_mma_stream_deep_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ hp_f, const bf16* __restrict__ hp_b,
    const bf16* __restrict__ cp_f, const bf16* __restrict__ cp_b,
    const bf16* __restrict__ c_f, const bf16* __restrict__ c_b,
    const bf16* __restrict__ dy_f, const bf16* __restrict__ dy_b,
    bf16* __restrict__ dgx_f, bf16* __restrict__ dgx_b,
    float* __restrict__ scratch, int n_steps, int B, int H, int Hb, int ring) {
  constexpr int R = 8 * NT8;
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row_tile = blockIdx.x / U, row0 = row_tile * R;
  const int NC = 4 * Hb, G = 4 * H, DS = wm_ds(NC);
  const int NUG = Hb / kUnits, nch = H / kWdChunk;
  const int tile = NC * kWdChunk;  // elements a chunk tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * nch * tile;
  const bf16* __restrict__ hp = backward ? hp_b : hp_f;
  const bf16* __restrict__ cpv = backward ? cp_b : cp_f;
  const bf16* __restrict__ cs = backward ? c_b : c_f;
  const bf16* __restrict__ dy = backward ? dy_b : dy_f;
  bf16* __restrict__ dgx = backward ? dgx_b : dgx_f;
  // this cluster's two buffers of dh partials, [owner][source][Hb][R] each
  const size_t part_elems = (size_t)U * U * Hb * R;
  float* const parts =
      scratch + ((size_t)blockIdx.y * (gridDim.x / U) + row_tile) * 2 * part_elems;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const s_ring = reinterpret_cast<bf16*>(smem);              // ring chunk tiles
  bf16* const s_hr = s_ring + (size_t)ring * tile;                 // their h_prev rows [R][kWdHs]
  bf16* const s_dg = s_hr + (size_t)ring * R * kWdHs;              // dz [R][DS]
  float* const s_carry = reinterpret_cast<float*>(                 // summed dh partials [Hb][R]
      reinterpret_cast<unsigned char*>(s_dg) + percival::align16((size_t)R * DS * 2));
  uint64_t* const s_full = reinterpret_cast<uint64_t*>(s_carry + (size_t)Hb * R);
  uint64_t* const s_empty = s_full + ring;
  if (tid == 0) {
    for (int i = 0; i < ring; ++i) {
      ws_mbar_init(&s_full[i], 1);
      ws_mbar_init(&s_empty[i], kWsWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the mbarriers set

  if (warp == kWsWarps) {  // the producer
    percival::wd_produce(wp, hp, s_ring, s_hr, s_full, s_empty, NC, R, ring, n_steps, B, H, row0,
                         frame, lane);
    return;
  }

  // ---- pairs: warp w takes pairs p0 … p0 + np − 1 of the block's NUG × NT8
  // (unit group p / NT8, 8-row tile p % NT8); every warp takes dh items ----
  const int pairs = NUG * NT8, p0 = warp * PPW;
  const int np = p0 < pairs ? min(PPW, pairs - p0) : 0;

  float z[PPW][2][4];  // per pair: m-tile 0 = i|f, 1 = g|o of the unit group, 8 rows
  float dcr[PPW][2];   // dc_carry of the lane's two rows of each pair
#pragma unroll
  for (int i = 0; i < PPW; ++i) dcr[i][0] = dcr[i][1] = 0.0f;

  int slot = 0, phase = 0;  // the ring slot of the next chunk, and its fill's parity
  // a pass over the chunks: the recompute of the pairs' z, and where s_dh >= 0
  // the dh of step s_dh into its buffer of partials
  auto run_pass = [&](int s_dh) {
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) z[i][j][k] = 0.0f;
    float* const part = parts + (s_dh & 1) * part_elems;
    for (int c = 0; c < nch; ++c) {
      ws_mbar_wait(&s_full[slot], phase);
      const bf16* w = s_ring + (size_t)slot * tile;
      if (np > 0)
        percival::wd_recompute<2, PPW, NT8>(
            z, w, s_hr + (size_t)slot * R * kWdHs + ld_row * kWdHs + ld_mat * 8, np, p0,
            kGroupRows, ld_row, ld_mat);
      if (s_dh >= 0)
        percival::wd_dh_chunk<NT8>(w, s_dg, part, c, U, Hb, NC, rank, warp, lane);
      __syncwarp();
      if (lane == 0) ws_mbar_arrive(&s_empty[slot]);
      if (++slot == ring) slot = 0, phase ^= 1;
    }
  };

  // the lines of frame t's gate operands hinted into L2 while a pass runs
  // (the gate phase loads them; lanes 4q … 4q + 3 read one 16-byte run of a
  // group's 8 units)
  auto prefetch_cell = [&](int t) {
    if (g != 0) return;
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const int p = p0 + i, ug = p / NT8, unit0 = rank * Hb + ug * kUnits;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + (p - ug * NT8) * 8 + 2 * q + e;
        if (unit0 >= H || row >= B) continue;
        const size_t grow = (size_t)t * B + row;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) percival::wsf_prefetch_l2(gx + grow * G + gi * H + unit0);
        percival::wsf_prefetch_l2(cpv + grow * H + unit0);
        percival::wsf_prefetch_l2(cs + grow * H + unit0);
        percival::wsf_prefetch_l2(dy + grow * H + unit0);
      }
    }
  };

  prefetch_cell(frame(0));
  run_pass(-1);  // z of step 0
  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    if (s > 0) {  // every block's dh partials of step s − 1, summed in block order
      percival::wd_sum_partials<R, percival::wd_part_loads(4)>(
          parts + ((s + 1) & 1) * part_elems, s_carry, U, Hb, rank, tid);
      ws_compute_sync();
    }

    // ---- gate phase: dz of this step from z, the carries and the operands ----
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      if (i >= np) break;
      const int p = p0 + i, ug = p / NT8;
      const int r0 = (p - ug * NT8) * 8 + 2 * q;  // the lane's rows r0, r0 + 1 of the tile
      const int ul = ug * kUnits + g, unit = rank * Hb + ul;  // the lane's unit
      const bool unit_ok = unit < H;
      const float2 carry = s > 0 ? *reinterpret_cast<const float2*>(s_carry + ul * R + r0)
                                 : make_float2(0.0f, 0.0f);
      bf16* dgr = s_dg + ug * kGroupRows + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + r0 + e;
        const bool ok = unit_ok && row < B;
        const size_t grow = (size_t)t * B + row;
        const bf16 zero = __float2bfloat16(0.0f);
        const bf16* gxr = gx + grow * G + unit;
        float x[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) x[gi] = __bfloat162float(ok ? gxr[gi * H] : zero);
        const float cprev = __bfloat162float(ok ? cpv[grow * H + unit] : zero);
        const float cv = __bfloat162float(ok ? cs[grow * H + unit] : zero);
        const float dyv = __bfloat162float(ok ? dy[grow * H + unit] : zero);
        const float ig = sigmoid_f32(x[0] + z[i][0][e]);
        const float fg = sigmoid_f32(x[1] + z[i][0][2 + e]);
        const float gg = tanhf(x[2] + z[i][1][e]);
        const float og = sigmoid_f32(x[3] + z[i][1][2 + e]);
        const float tc = tanhf(cv);
        const float dh = dyv + (e ? carry.y : carry.x);
        const float dc = dcr[i][e] + dh * og * (1.0f - tc * tc);
        const bf16 d[4] = {ok ? __float2bfloat16(dc * gg * ig * (1.0f - ig)) : zero,
                           ok ? __float2bfloat16(dc * cprev * fg * (1.0f - fg)) : zero,
                           ok ? __float2bfloat16(dc * ig * (1.0f - gg * gg)) : zero,
                           ok ? __float2bfloat16(dh * tc * og * (1.0f - og)) : zero};
        bf16* dgt = dgr + (r0 + e) * DS;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) dgt[8 * gi] = d[gi];  // rows i, f | g, o of the group
        if (ok) {
          bf16* out = dgx + grow * G + unit;
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) out[gi * H] = d[gi];
        }
        dcr[i][e] = ok ? dc * fg : 0.0f;
      }
      percival::wd_pair_fence();
    }
    if (s + 1 == n_steps) break;
    ws_compute_sync();  // s_dg complete
    prefetch_cell(frame(s + 1));
    run_pass(s);        // step s+1's recompute and step s's dh, a chunk at a time
    cluster_arrive();   // step s's partials written to the scratch
    cluster_wait();     // every block's partials of step s written
  }
}

const void* kernel_for(int NT8) {
  switch (NT8) {
    case 1: return (const void*)&bilstm_bwd_wide_mma_stream_kernel<1>;
    case 2: return (const void*)&bilstm_bwd_wide_mma_stream_kernel<2>;
    case 3: return (const void*)&bilstm_bwd_wide_mma_stream_kernel<3>;
    default: return nullptr;
  }
}

// the deep kernels instantiated: the (rows, pairs a compute warp) that the
// LSTM's deep widths take (H 1568–4096: 13–32 unit groups a block) and that
// fit 128 registers with no spill (ptxas; the one-tile 3-pair and the
// two- and three-tile 4-pair kernels spilled 16–36 B: not instantiated, so
// 31–32 unit groups at 8 rows take the 4-pair one; ops/wide_mma_layout.py::
// STREAM_DEEP_KERNELS)
const void* deep_for(int NT8, int PPW) {
  switch (NT8 * 8 + PPW) {
    case 9: return (const void*)&bilstm_bwd_wide_mma_stream_deep_kernel<1, 1>;
    case 10: return (const void*)&bilstm_bwd_wide_mma_stream_deep_kernel<1, 2>;
    case 12: return (const void*)&bilstm_bwd_wide_mma_stream_deep_kernel<1, 4>;
    case 18: return (const void*)&bilstm_bwd_wide_mma_stream_deep_kernel<2, 2>;
    case 19: return (const void*)&bilstm_bwd_wide_mma_stream_deep_kernel<2, 3>;
    case 27: return (const void*)&bilstm_bwd_wide_mma_stream_deep_kernel<3, 3>;
    default: return nullptr;
  }
}

cudaError_t plan_for(int B, int H, int Hb, int U, WideStreamPlan* plan) {
  return percival::wide_stream_plan(B, H, Hb, U, 4, kUnits, kernel_for, deep_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes, into out[14]: U, Hb, NC, R,
// chunks resident, chunks streamed, clusters at once, waves, two partial
// buffers or one, shared memory a block, k a chunk (64, or 32 in the deep
// layout), pairs a compute warp (deep; else 0), bytes of dh partials a
// cluster in global memory (deep; else 0), ring slots.
extern "C" int percival_bilstm_bwd_wide_mma_stream_plan(int B, int H, int Hb, int U, int* out) {
  WideStreamPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_stream_plan_out(plan, out);
  return err;
}

// bf16 only, H a multiple of 32. Inputs in the order of _bilstm_bwd_pallas:
// gx, W_hᵀ (packed per block and chunk, ops/wide_mma_layout.py::pack_wh_stream
// at the plan's chunk), h_prev, c_prev, c, dy, each as (forward direction,
// backward direction); then dgx; then the deep layout's scratch for the dh
// partials (2·ceil(B / R) clusters × the plan's scratch bytes; unread, and
// may be null, in the 64-k layout). Every other pointer 16-byte aligned, none
// null. Returns a cudaError_t.
extern "C" int percival_bilstm_bwd_wide_mma_stream(const void* gx_f, const void* gx_b,
                                                   const void* wp_f, const void* wp_b,
                                                   const void* hp_f, const void* hp_b,
                                                   const void* cp_f, const void* cp_b,
                                                   const void* c_f, const void* c_b,
                                                   const void* dy_f, const void* dy_b,
                                                   void* dgx_f, void* dgx_b, void* scratch,
                                                   int n_steps, int B, int H, int Hb, int U,
                                                   void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b,
                          dy_f, dy_b, dgx_f, dgx_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideStreamPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  int nres = plan.nres, dbuf = plan.dbuf, ring = plan.ring;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&hp_f, (void*)&hp_b, (void*)&cp_f, (void*)&cp_b,
                  (void*)&c_f,  (void*)&c_b,  (void*)&dy_f, (void*)&dy_b,
                  (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&nres, (void*)&dbuf};
  void* deep_args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                       (void*)&hp_f, (void*)&hp_b, (void*)&cp_f, (void*)&cp_b,
                       (void*)&c_f,  (void*)&c_b,  (void*)&dy_f, (void*)&dy_b,
                       (void*)&dgx_f, (void*)&dgx_b, (void*)&scratch,
                       (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&ring};
  const bool deep = plan.chunk == percival::kWdChunk;
  if (deep && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16))
    return cudaErrorInvalidValue;
  return percival::wide_stream_launch(plan, B, kernel_for, deep_for, deep ? deep_args : args,
                                      static_cast<cudaStream_t>(stream));
}
