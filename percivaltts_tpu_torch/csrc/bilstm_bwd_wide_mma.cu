// Fused bidirectional LSTM backward (BPTT) on the tensor cores for widths one
// SM cannot hold (sm_90a, bf16).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas, :321) on the route "wide_mma"
// (ops/mma_layout.py::bwd_route): bf16 past H = 128 wherever a block's W_h
// slice fits its shared memory (H <= 608, ops/wide_mma_layout.py::fits);
// bilstm_bwd_wide.cu keeps f32 and the wider bf16 widths. Same contract as
// bilstm_bwd_wide.cu:
//
//   z    = gx[t] + h_prev[t] · W_h                  (gates recomputed)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = round_bf16(dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o))
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ (f32) ;  dc_carry = dc·f
//
// the forward direction's BPTT walking t = T-1 … 0, the backward one's
// t = 0 … T-1. Layouts: gx / dgx (T, B, 4H); h_prev / c_prev / c / dy
// (T, B, H), all bf16, H a multiple of 32 (the wrapper zero-pads the others,
// which is exact); W_hᵀ packed per block (ops/wide_mma_layout.py::pack_wh,
// (U, NC, H) a direction: block b's NC = 4·Hb gate columns in the order of
// csrc/bilstm_fwd_mma.cu's rows, tiles i|f and g|o of 8 units).
//
// What bounds it on the card: a step's two products, h_prev·W_h over the
// block's columns and dz·W_hᵀ over its rows, for every batch row of the
// tile, against the chain from one step's dz to the next step's dh through
// the whole cluster. bilstm_bwd_wide.cu ran both on CUDA cores, 8 rows a
// cluster (6 waves of clusters at B = 160), and spilled. Here:
//   * both products run on mma.sync m16n8k16 (bf16 in, f32 accumulate), batch
//     rows as N in 8-row tiles. The recompute zᵀ (NC × R) = W_hᵀ slice ·
//     h_prevᵀ takes its A fragments from the block's W_hᵀ slice in shared
//     memory with ldmatrix; the chained dhᵀ (H × R) = W_h slice · dzᵀ takes
//     its A fragments from the SAME slice with ldmatrix.trans, so W_h is in
//     shared memory once (128 KB at H = 512). Holding one product's
//     fragments in registers instead would cost H·NC/2 words a block, 64 a
//     thread at 512 threads (95 at H = 608), on top of the accumulators: the
//     registers spill before R reaches 16;
//   * up to 64 rows a cluster (the plan: the fewest waves, then the fewest
//     rows). The recompute's accumulators land on lane l as i, f, g, o of
//     one unit for two batch rows, so the gate math runs in the registers
//     they land in: warp w owns one (unit group, 8-row tile) cell, so R is at
    //     most 16 tiles of 8 rows over the block's unit groups;
//   * the dh partials (R × H f32 a block) are reduce-scattered through
//     distributed shared memory: block b's warp w computes 16-unit tiles
//     w, w + 16, … of its partial for every row and stores each lane's two
//     rows as one float2 into the slot (b, unit) of the block that owns the
//     unit, which adds the U slots in block order in the next gate phase.
//     Where a second buffer of slots fits (R <= 16 at H = 512) the step
//     alternates buffers and ends in one cluster barrier; else it splits the
//     barrier in two halves (arrive / wait) twice, "every partial read"
//     before the stores and "every partial stored" after them, and the
//     recompute of the next step, which needs no carry, runs in both gaps.
//     Measured on an H100 SXM (tools/bwd_step_breakdown.py --wide, H = 512):
//     the exchange's writes cost 0.4 µs of a 5.8 µs step at B = 8 and
//     2.2 µs of a 10.8 µs step at R = 24, the barriers 0.7 and 1.6 µs; the
//     GRU's all-gather of bf16 dgates would receive more bytes a step at
//     these R (bigru_bwd_wide_mma.cu), so both keep the reduce-scatter;
//   * h_prev of the next step's recompute is staged in shared memory by
//     cp.async a step ahead (rows past B zero-filled); the gate operands of
//     the next step are loaded into registers behind the second barrier;
//   * no atomics, no allocation, PyTorch's stream; the launcher returns
//     cudaGetLastError().

#include <cooperative_groups.h>

#include <cstddef>
#include <cstdint>

#include "lstm_common.cuh"
#include "mma_common.cuh"
#include "wide_mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using percival::cluster_arrive;
using percival::cluster_wait;
using percival::cp_async16;
using percival::cp_async_commit;
using percival::cp_async_wait;
using percival::kWmThreads;
using percival::kWmWarps;
using percival::ldmatrix_x2;
using percival::ldmatrix_x4;
using percival::ldmatrix_x4_trans;
using percival::mma_bf16_16816;
using percival::sigmoid_f32;
using percival::wm_ds;
using percival::wm_h_bytes;
using percival::wm_recv_bytes;
using percival::wm_w_bytes;
using percival::wm_ws;
using percival::WideMmaPlan;

constexpr int kUnits = 8;         // units a unit group: m-tiles i|f, g|o
constexpr int kGroupRows = 32;    // packed W_hᵀ rows a unit group
constexpr int kDhTiles = 4;       // 8-row tiles the chained product takes at a time

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int MPW>
__global__ void __launch_bounds__(kWmThreads, 1) bilstm_bwd_wide_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ hp_f, const bf16* __restrict__ hp_b,
    const bf16* __restrict__ cp_f, const bf16* __restrict__ cp_b,
    const bf16* __restrict__ c_f, const bf16* __restrict__ c_b,
    const bf16* __restrict__ dy_f, const bf16* __restrict__ dy_b,
    bf16* __restrict__ dgx_f, bf16* __restrict__ dgx_b,
    int n_steps, int B, int H, int Hb, int R, int dbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 4 * Hb, G = 4 * H, WS = wm_ws(H), DS = wm_ds(NC);
  const int NT8 = R / 8, NUG = Hb / kUnits, MT = H / 16, KS = H / 16, KH = 2 * (H / 64);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * NC * H;
  const bf16* __restrict__ hp = backward ? hp_b : hp_f;
  const bf16* __restrict__ cpv = backward ? cp_b : cp_f;
  const bf16* __restrict__ cs = backward ? c_b : c_f;
  const bf16* __restrict__ dy = backward ? dy_b : dy_f;
  bf16* __restrict__ dgx = backward ? dgx_b : dgx_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const s_w = reinterpret_cast<bf16*>(smem);  // W_hᵀ slice [NC][WS]
  bf16* const s_h = reinterpret_cast<bf16*>(smem + wm_w_bytes(H, NC));  // h_prev rows [R][WS]
  float* const s_recv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_h) +
                                                 wm_h_bytes(H, R));  // partials [U][Hb][R]
  bf16* const s_dg = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s_recv) +
                                             wm_recv_bytes(U, Hb, R, 1 + dbuf));  // dz [R][DS]

  // ---- the W_hᵀ slice, and h_prev rows of a frame, by 16-byte cp.async ----
  const int HCH = H / 8;
  for (int i = tid; i < NC * HCH; i += kWmThreads) {
    const int p = i / HCH, ch = i - p * HCH;
    cp_async16(s_w + p * WS + ch * 8, wp + (size_t)p * H + ch * 8, true);
  }
  auto load_h = [&](int t) {  // rows past B zero-filled; one commit group
    for (int i = tid; i < R * HCH; i += kWmThreads) {
      const int r = i / HCH, ch = i - r * HCH;
      const bool ok = row0 + r < B;
      cp_async16(s_h + r * WS + ch * 8, ok ? hp + ((size_t)t * B + row0 + r) * H + ch * 8 : hp,
                 ok);
    }
    cp_async_commit();
  };
  load_h(frame(0));
  const int slots = U * Hb * R;  // partial slots of a buffer
  for (int i = tid; i < (1 + dbuf) * slots; i += kWmThreads) s_recv[i] = 0.0f;  // dh_carry of step 0

  // ---- cells: warp w takes unit group w / NT8, 8-row tile w % NT8 ----
  const int ug = warp / NT8, wj = warp - ug * NT8;
  const bool gate_warp = ug < NUG;
  const int ul = ug * kUnits + g;  // the lane's unit in the block
  const bool unit_ok = gate_warp && rank * Hb + ul < H;
  const int unit = rank * Hb + ul;
  const int nt = wj;  // the warp's 8-row tile
  const bool cell_on = gate_warp && nt < NT8;

  // recompute: z[tile] += W_hᵀ rows of the unit group · h_prevᵀ of the warp's
  // tile over k-steps [k0, k1) (k1 − k0 even); tile 0 = i|f, tile 1 = g|o
  float z[2][4];
  const bf16* const a_rec = s_w + (ug * kGroupRows + ld_row + 8 * (ld_mat & 1)) * WS + 8 * (ld_mat >> 1);
  auto recompute = [&](int k0, int k1) {
    if (!cell_on) return;
    for (int kk = k0; kk < k1; kk += 2) {
      uint32_t b[4];
      ldmatrix_x4(s_h + (nt * 8 + ld_row) * WS + kk * 16 + ld_mat * 8, b[0], b[1], b[2], b[3]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4(a_rec + j * 16 * WS + (kk + h) * 16, a[j][0], a[j][1], a[j][2], a[j][3]);
        const uint32_t bb[2] = {b[2 * h], b[2 * h + 1]};
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16_16816(z[j], a[j], bb);
      }
    }
  };
  auto zero_z = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) z[j][k] = 0.0f;
  };

  // the gate operands of a step: gx (4 gates), c_prev, c, dy of (unit, row)
  float pgx[2][4], pcp[2], pc[2], pdy[2];
  auto load_cell = [&](int t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + nt * 8 + 2 * q + e;
      const bool ok = cell_on && unit_ok && row < B;
      const size_t base = (size_t)t * B + row;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        pgx[e][gi] = ok ? __bfloat162float(gx[base * G + gi * H + unit]) : 0.0f;
      pcp[e] = ok ? __bfloat162float(cpv[base * H + unit]) : 0.0f;
      pc[e] = ok ? __bfloat162float(cs[base * H + unit]) : 0.0f;
      pdy[e] = ok ? __bfloat162float(dy[base * H + unit]) : 0.0f;
    }
  };

  // the chained product: dhᵀ tiles mt = w + 16·mi (16 units k each) · the
  // tile's rows, 4 tiles of 8 rows at a time, K = the block's NC columns. A
  // by ldmatrix.trans from the same W_hᵀ slice, each B fragment (dz) read
  // once for the warp's MPW tiles, so MPW·4 accumulator chains run side by
  // side; each lane's (k, 2 rows) partials go to the owner of k as a float2
  auto dh_product = [&](float* recv) {
    const int nm = (MT - warp + kWmWarps - 1) / kWmWarps;  // the warp's tiles
    const bf16* a_dh = s_w + (8 * (ld_mat >> 1) + ld_row) * WS + warp * 16 + 8 * (ld_mat & 1);
    const bf16* b_dh = s_dg + ld_row * DS + 8 * (ld_mat & 1);
    for (int n0 = 0; n0 < NT8; n0 += kDhTiles) {
      float acc[MPW][kDhTiles][4];
#pragma unroll
      for (int mi = 0; mi < MPW; ++mi)
#pragma unroll
        for (int j = 0; j < kDhTiles; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mi][j][k] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < NC / 16; ++kk) {
        uint32_t a[MPW][4];
#pragma unroll
        for (int mi = 0; mi < MPW; ++mi)
          if (mi < nm)
            ldmatrix_x4_trans(a_dh + kk * 16 * WS + mi * kWmWarps * 16, a[mi][0], a[mi][1],
                              a[mi][2], a[mi][3]);
#pragma unroll
        for (int j = 0; j < kDhTiles; ++j) {
          if (n0 + j >= NT8) break;
          uint32_t b[2];
          ldmatrix_x2(b_dh + (n0 + j) * 8 * DS + kk * 16, b[0], b[1]);
#pragma unroll
          for (int mi = 0; mi < MPW; ++mi)
            if (mi < nm) mma_bf16_16816(acc[mi][j], a[mi], b);
        }
      }
      // lane rows: units k = 16·mt + g and k + 8, batch rows 8n + 2q, +1
#pragma unroll
      for (int mi = 0; mi < MPW; ++mi) {
        if (mi >= nm) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = (warp + kWmWarps * mi) * 16 + g + 8 * h;
          const int owner = k / Hb;
          float* dst = cluster.map_shared_rank(recv, owner) + (rank * Hb + (k - owner * Hb)) * R +
                       2 * q + n0 * 8;
#pragma unroll
          for (int j = 0; j < kDhTiles; ++j) {
            if (n0 + j >= NT8) break;
            *reinterpret_cast<float2*>(dst + j * 8) =
                make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
          }
        }
      }
    }
  };

  cp_async_wait<0>();
  __syncthreads();  // W_hᵀ slice and step 0's h_prev rows landed
  zero_z();
  recompute(0, KS);  // z of step 0
  __syncthreads();   // every read of s_h done
  if (n_steps > 1) load_h(frame(1));
  load_cell(frame(0));
  float dcr[2] = {0.0f, 0.0f};  // dc_carry of the lane's two rows
  cluster.sync();  // every block running, its partial slots zeroed

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);

    // ---- gate phase: dz of this step from z, the carries and the operands ----
    if (cell_on) {
      const int r0 = nt * 8 + 2 * q;  // the lane's rows r0, r0 + 1 of the tile
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
        const float ig = sigmoid_f32(pgx[e][0] + z[0][e]);
        const float fg = sigmoid_f32(pgx[e][1] + z[0][2 + e]);
        const float gg = tanhf(pgx[e][2] + z[1][e]);
        const float og = sigmoid_f32(pgx[e][3] + z[1][2 + e]);
        const float tc = tanhf(pc[e]);
        const float dh = pdy[e] + (e ? carry.y : carry.x);
        const float dc = dcr[e] + dh * og * (1.0f - tc * tc);
        const bf16 zero = __float2bfloat16(0.0f);
        const bf16 d[4] = {ok ? __float2bfloat16(dc * gg * ig * (1.0f - ig)) : zero,
                           ok ? __float2bfloat16(dc * pcp[e] * fg * (1.0f - fg)) : zero,
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
        dcr[e] = ok ? dc * fg : 0.0f;
      }
    }
    if (s + 1 == n_steps) break;

    if (!dbuf) cluster_arrive();  // this block's partials of step s read
    cp_async_wait<0>();
    __syncthreads();    // s_dg complete; s_h holds h_prev of step s+1
    zero_z();
    recompute(0, KH);   // step s+1, first half
    if (!dbuf) cluster_wait();  // every block has read its partials: the slots are free
    dh_product(s_recv + (dbuf & (s + 1)) * slots);  // step s's partials into their owners' slots
    cluster_arrive();   // ... stored
    recompute(KH, KS);  // step s+1, second half
    load_cell(frame(s + 1));
    __syncthreads();    // every read of s_h done
    if (s + 2 < n_steps) load_h(frame(s + 2));
    cluster_wait();     // every partial of step s landed
  }
  cp_async_wait<0>();
}

const void* kernel_for(int MPW) {
  switch (MPW) {
    case 1: return (const void*)&bilstm_bwd_wide_mma_kernel<1>;
    case 2: return (const void*)&bilstm_bwd_wide_mma_kernel<2>;
    case 3: return (const void*)&bilstm_bwd_wide_mma_kernel<3>;
    default: return nullptr;
  }
}

cudaError_t plan_for(int B, int H, int Hb, int U, WideMmaPlan* plan) {
  return percival::wide_mma_plan(B, H, Hb, U, 4, kUnits, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes, into out[9]: U, Hb, NC, R, MPW,
// clusters at once, waves, two partial buffers or one, shared memory a block.
extern "C" int percival_bilstm_bwd_wide_mma_plan(int B, int H, int Hb, int U, int* out) {
  WideMmaPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_mma_plan_out(plan, out);
  return err;
}

// bf16 only, H a multiple of 32. Inputs in the order of _bilstm_bwd_pallas:
// gx, W_hᵀ (packed per block, ops/wide_mma_layout.py::pack_wh), h_prev,
// c_prev, c, dy, each as (forward direction, backward direction); then dgx.
// Every pointer 16-byte aligned, none null. Returns a cudaError_t.
extern "C" int percival_bilstm_bwd_wide_mma(const void* gx_f, const void* gx_b,
                                            const void* wp_f, const void* wp_b,
                                            const void* hp_f, const void* hp_b,
                                            const void* cp_f, const void* cp_b,
                                            const void* c_f, const void* c_b,
                                            const void* dy_f, const void* dy_b,
                                            void* dgx_f, void* dgx_b,
                                            int n_steps, int B, int H, int Hb, int U,
                                            void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b,
                          dy_f, dy_b, dgx_f, dgx_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideMmaPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  int R = plan.R, dbuf = plan.dbuf;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&hp_f, (void*)&hp_b, (void*)&cp_f, (void*)&cp_b,
                  (void*)&c_f,  (void*)&c_b,  (void*)&dy_f, (void*)&dy_b,
                  (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&R, (void*)&dbuf};
  return percival::wide_mma_launch(plan, B, kernel_for, args, static_cast<cudaStream_t>(stream));
}
