// Fused bidirectional GRU backward (BPTT) on the tensor cores for widths one
// SM cannot hold (sm_90a, bf16).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_bwd_kernel
// (launched by _bigru_bwd_pallas, :616) on the route "wide_mma"
// (ops/mma_layout.py::bwd_route): bf16 past H = 128 wherever a block's W_h
// slice fits its shared memory (H <= 672, ops/wide_mma_layout.py::fits);
// bigru_bwd_wide.cu keeps f32 and the wider bf16 widths. Same contract as
// bigru_bwd_wide.cu:
//
//   gh   = h_prev[t] · W_h                       (gates recomputed)
//   r, z = σ(gx_r + gh_r), σ(gx_z + gh_z) ;  ghn = gh_n + b_hn ;  n = tanh(gx_n + r·ghn)
//   dh   = dy[t] + dh_carry
//   dn_pre = dh·(1 − z)·(1 − n²) ;  dr_pre = dn_pre·ghn·r(1 − r)
//   dz_pre = dh·(h_prev − n)·z(1 − z) ;  dnr = dn_pre·r
//   dgx[t] = round_bf16(dr_pre | dz_pre | dn_pre) ;  dnr_out[t] = round_bf16(dnr)
//   dh_carry = dh·z + round_bf16(dr_pre | dz_pre | dnr) · W_hᵀ   (f32)
//
// h_prev is the forward pass's bf16 output (t−1 for the forward direction,
// t+1 for the backward one). The forward direction's BPTT walks
// t = T-1 … 0, the backward one's t = 0 … T-1. Layouts: gx / dgx (T, B, 3H);
// h_prev / dy / dnr (T, B, H); b_hn (H), all bf16, H a multiple of 32 (the
// wrapper zero-pads the others, which is exact); W_hᵀ packed per block
// (ops/wide_mma_layout.py::pack_wh, (U, NC, H) a direction: block b's
// NC = 3·Hb gate columns in the order of csrc/bigru_fwd_mma.cu's rows, tiles
// r|z, r|z, n|n of 16 units).
//
// What bounds it on the card, and the design: bilstm_bwd_wide_mma.cu's, with
// three gates a unit (its header says why each piece is there):
//   * both products on mma.sync m16n8k16, batch rows as N in 8-row tiles, A
//     fragments of the recompute by ldmatrix and of the chained product by
//     ldmatrix.trans from the block's one W_hᵀ slice in shared memory (96 KB
//     at H = 512);
//   * the recompute's accumulators land on lane l as r, z, gh_n of two units
//     (16w + l/4 and + 8) for two batch rows, where the gate math runs;
//   * up to 64 rows a cluster; the dh partials reduce-scattered through
//     distributed shared memory as float2 slots (unit, 2 rows), each owner
//     adding its dh·z and the U slots in block order; two buffers of slots
//     and one cluster barrier a step where they fit (R <= 24 at H = 512),
//     else one buffer and the barrier split into arrive / wait twice a step,
//     the next step's recompute in both gaps (measured on an H100 SXM,
//     tools/bwd_step_breakdown.py --wide, H = 512: the exchange's writes
//     0.3 µs of a 5.7 µs step at B = 8, the barrier 0.8 µs);
//   * h_prev of the next recompute staged by cp.async a step ahead; the gate
//     operands (gx, h_prev, dy of the lane's cells) loaded into registers
//     behind the second barrier; no atomics, no allocation, PyTorch's
//     stream; the launcher returns cudaGetLastError().
// The GRU alone could all-gather its bf16 dgates instead (R·NC·2 bytes a
// block to each of U blocks, W_h's row slice held too): at H = 512 a block
// then receives R·3H·2 = 3 KB a row and a step against the reduce-scatter's
// R·H·4 = 2 KB, and the two slices take 192 KB of shared memory, so it keeps
// the reduce-scatter.

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

constexpr int kUnits = 16;       // units a unit group: m-tiles r|z, r|z, n|n
constexpr int kGroupRows = 48;   // packed W_hᵀ rows a unit group
constexpr int kDhTiles = 4;      // 8-row tiles the chained product takes at a time

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int MPW>
__global__ void __launch_bounds__(kWmThreads, 1) bigru_bwd_wide_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ bn_f, const bf16* __restrict__ bn_b,
    const bf16* __restrict__ hp_f, const bf16* __restrict__ hp_b,
    const bf16* __restrict__ dy_f, const bf16* __restrict__ dy_b,
    bf16* __restrict__ dgx_f, bf16* __restrict__ dgx_b,
    bf16* __restrict__ dnr_f, bf16* __restrict__ dnr_b,
    int n_steps, int B, int H, int Hb, int R, int dbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 3 * Hb, G = 3 * H, WS = wm_ws(H), DS = wm_ds(NC);
  const int NT8 = R / 8, NUG = Hb / kUnits, MT = H / 16, KS = H / 16, KH = 2 * (H / 64);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * NC * H;
  const bf16* __restrict__ bn = backward ? bn_b : bn_f;
  const bf16* __restrict__ hp = backward ? hp_b : hp_f;
  const bf16* __restrict__ dy = backward ? dy_b : dy_f;
  bf16* __restrict__ dgx = backward ? dgx_b : dgx_f;
  bf16* __restrict__ dnr_out = backward ? dnr_b : dnr_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const s_w = reinterpret_cast<bf16*>(smem);  // W_hᵀ slice [NC][WS]
  bf16* const s_h = reinterpret_cast<bf16*>(smem + wm_w_bytes(H, NC));  // h_prev rows [R][WS]
  float* const s_recv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_h) +
                                                 wm_h_bytes(H, R));  // partials [U][Hb][R]
  bf16* const s_dg = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s_recv) +
                                             wm_recv_bytes(U, Hb, R, 1 + dbuf));  // dr|dz|dnr [R][DS]

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
  int ul[2], unit[2];  // the lane's two units, in the block and in the layer
  bool unit_ok[2];
  float bias[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    ul[u] = ug * kUnits + 8 * u + g;
    unit[u] = rank * Hb + ul[u];
    unit_ok[u] = gate_warp && unit[u] < H;
    bias[u] = unit_ok[u] ? __bfloat162float(bn[unit[u]]) : 0.0f;
  }
  const int nt = wj;  // the warp's 8-row tile
  const bool cell_on = gate_warp && nt < NT8;

  // recompute: z[tile] += W_hᵀ rows of the unit group · h_prevᵀ of the warp's
  // tile over k-steps [k0, k1) (k1 − k0 even); tiles r|z (units 0–7), r|z
  // (units 8–15), n (0–7) | n (8–15)
  float z[3][4];
  const bf16* const a_rec = s_w + (ug * kGroupRows + ld_row + 8 * (ld_mat & 1)) * WS + 8 * (ld_mat >> 1);
  auto recompute = [&](int k0, int k1) {
    if (!cell_on) return;
    for (int kk = k0; kk < k1; kk += 2) {
      uint32_t b[4];
      ldmatrix_x4(s_h + (nt * 8 + ld_row) * WS + kk * 16 + ld_mat * 8, b[0], b[1], b[2], b[3]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          ldmatrix_x4(a_rec + j * 16 * WS + (kk + h) * 16, a[j][0], a[j][1], a[j][2], a[j][3]);
        const uint32_t bb[2] = {b[2 * h], b[2 * h + 1]};
#pragma unroll
        for (int j = 0; j < 3; ++j) mma_bf16_16816(z[j], a[j], bb);
      }
    }
  };
  auto zero_z = [&]() {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) z[j][k] = 0.0f;
  };

  // the gate operands of a step: gx (3 gates), h_prev, dy of (unit u, row e)
  float pgx[2][2][3], php[2][2], pdy[2][2];
  auto load_cell = [&](int t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + nt * 8 + 2 * q + e;
      const size_t base = (size_t)t * B + row;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool ok = cell_on && unit_ok[u] && row < B;
#pragma unroll
        for (int gi = 0; gi < 3; ++gi)
          pgx[u][e][gi] = ok ? __bfloat162float(gx[base * G + gi * H + unit[u]]) : 0.0f;
        php[u][e] = ok ? __bfloat162float(hp[base * H + unit[u]]) : 0.0f;
        pdy[u][e] = ok ? __bfloat162float(dy[base * H + unit[u]]) : 0.0f;
      }
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
  recompute(0, KS);  // gh of step 0
  __syncthreads();   // every read of s_h done
  if (n_steps > 1) load_h(frame(1));
  load_cell(frame(0));
  float dhz[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // dh·z of the previous step: the carry's direct path
  cluster.sync();  // every block running, its partial slots zeroed

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);

    // ---- gate phase: d(gates) of this step from gh, the carries and the operands ----
    if (cell_on) {
      const int r0 = nt * 8 + 2 * q;  // the lane's rows r0, r0 + 1 of the tile
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float2 carry = make_float2(dhz[u][0], dhz[u][1]);
        const float* red = s_recv + (dbuf & s) * slots + ul[u] * R + r0;
        for (int src = 0; src < U; ++src) {
          const float2 v = *reinterpret_cast<const float2*>(red + src * Hb * R);
          carry.x += v.x;
          carry.y += v.y;
        }
        // packed rows of the group: r | z of units 0–7 (0, 8), of 8–15 (16, 24), n (32, 40)
        bf16* dgr = s_dg + ug * kGroupRows + 16 * u + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = row0 + r0 + e;
          const bool ok = unit_ok[u] && row < B;
          const float rg = sigmoid_f32(pgx[u][e][0] + z[u][e]);
          const float zg = sigmoid_f32(pgx[u][e][1] + z[u][2 + e]);
          const float ghn = z[2][2 * u + e] + bias[u];
          const float ng = tanhf(pgx[u][e][2] + rg * ghn);
          const float dh = pdy[u][e] + (e ? carry.y : carry.x);
          const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
          const bf16 zero = __float2bfloat16(0.0f);
          const bf16 dr = ok ? __float2bfloat16(dn_pre * ghn * rg * (1.0f - rg)) : zero;
          const bf16 dz = ok ? __float2bfloat16(dh * (php[u][e] - ng) * zg * (1.0f - zg)) : zero;
          const bf16 dnr = ok ? __float2bfloat16(dn_pre * rg) : zero;
          bf16* dgt = dgr + (r0 + e) * DS;
          dgt[0] = dr;
          dgt[8] = dz;
          dgt[32 - 8 * u] = dnr;  // n rows: 32 + g (units 0–7), 40 + g (8–15)
          if (ok) {
            const size_t grow = (size_t)t * B + row;
            bf16* out = dgx + grow * G + unit[u];
            out[0] = dr;
            out[H] = dz;
            out[2 * H] = __float2bfloat16(dn_pre);
            dnr_out[grow * H + unit[u]] = dnr;
          }
          dhz[u][e] = ok ? dh * zg : 0.0f;
        }
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
    case 1: return (const void*)&bigru_bwd_wide_mma_kernel<1>;
    case 2: return (const void*)&bigru_bwd_wide_mma_kernel<2>;
    case 3: return (const void*)&bigru_bwd_wide_mma_kernel<3>;
    default: return nullptr;
  }
}

cudaError_t plan_for(int B, int H, int Hb, int U, WideMmaPlan* plan) {
  return percival::wide_mma_plan(B, H, Hb, U, 3, kUnits, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes, into out[9], as
// percival_bilstm_bwd_wide_mma_plan.
extern "C" int percival_bigru_bwd_wide_mma_plan(int B, int H, int Hb, int U, int* out) {
  WideMmaPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_mma_plan_out(plan, out);
  return err;
}

// bf16 only, H a multiple of 32. Inputs in the order of _bigru_bwd_pallas:
// gx, W_hᵀ (packed per block, ops/wide_mma_layout.py::pack_wh), b_hn,
// h_prev, dy; then the outputs dgx and dnr; each as (forward direction,
// backward direction). Every pointer 16-byte aligned, none null. Returns a
// cudaError_t.
extern "C" int percival_bigru_bwd_wide_mma(const void* gx_f, const void* gx_b,
                                           const void* wp_f, const void* wp_b,
                                           const void* bn_f, const void* bn_b,
                                           const void* hp_f, const void* hp_b,
                                           const void* dy_f, const void* dy_b,
                                           void* dgx_f, void* dgx_b,
                                           void* dnr_f, void* dnr_b,
                                           int n_steps, int B, int H, int Hb, int U,
                                           void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b,
                          dgx_f, dgx_b, dnr_f, dnr_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideMmaPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  int R = plan.R, dbuf = plan.dbuf;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&hp_f, (void*)&hp_b,
                  (void*)&dy_f, (void*)&dy_b, (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&dnr_f, (void*)&dnr_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&R, (void*)&dbuf};
  return percival::wide_mma_launch(plan, B, kernel_for, args, static_cast<cudaStream_t>(stream));
}
