// Fused bidirectional GRU forward on the tensor cores for widths one SM
// cannot hold (sm_90a, bf16).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas, :521) on the route "wide_mma"
// (ops/mma_layout.py::fwd_route): bf16 past H = 128 wherever a block's W_h
// slice fits its shared memory (H <= 672, ops/wide_mma_layout.py::fits);
// bigru_fwd_wide.cu keeps f32 and the wider bf16 widths. Same contract as
// bigru_fwd_wide.cu: gx (T, B, 3H), b_hn (H), y (T, B, H), gate order r, z,
// n, an f32 carry, round_dt(h) feeding the product, the backward direction
// walking t = T-1 … 0 over the same arrays:
//
//   gh = round_bf16(h) · W_h ;  r = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n  = tanh(gx_n + r·(gh_n + b_hn)) ;  h = (1 − z)·n + z·h ;  y[t] = round_bf16(h)
//
// H a multiple of 32 (the wrapper zero-pads the others, which is exact);
// W_hᵀ packed per block (ops/wide_mma_layout.py::pack_wh, (U, NC, H) a
// direction: block b's NC = 3·Hb gate columns in the order of
// csrc/bigru_fwd_mma.cu's rows, tiles r|z, r|z, n|n of 16 units), the
// packing the BPTT bigru_bwd_wide_mma.cu reads.
//
// What bounds it on the card, and the design: bilstm_fwd_wide_mma.cu's
// (its header says why each piece is there), with three gates a unit:
//   * one cluster of U <= 16 blocks a direction and tile of up to 64 rows,
//     block b's W_hᵀ slice (NC × H, 98 KB at H = 512) in shared memory for
//     the whole sequence;
//   * each step's product zᵀ = W_hᵀ slice · hᵀ on mma.sync m16n8k16, batch
//     rows as N in 8-row tiles, A and B fragments by ldmatrix; a cell warp
//     takes a unit group and TPW 8-row tiles, each A fragment feeding TPW
//     products; where fewer than 4 warps hold a cell (at R = 8 and H = 512,
//     2 of 16) the idle warps take parts of K, whose sums meet in shared
//     memory behind a block barrier (16% off a step at B = 8);
//   * the accumulators land on lane l as r, z, gh_n of two units (16g + l/4
//     and + 8) for two rows, where the gate math runs; the f32 carry h stays
//     in registers, b_hn is read once;
//   * the exchange: each warp stages its (16 units × 8 rows) tiles and writes
//     each row as two 16-byte chunks into y and into every block's next h
//     buffer (distributed shared memory), rows past B never written; two h
//     buffers and one cluster barrier a step where they fit (R <= 56 at
//     H = 512, so B = 160 runs in one wave of R = 56), else one buffer and
//     the barrier split around the gate math;
//   * gx of the next step loaded into registers behind the gate math; no
//     atomics, no allocation, PyTorch's stream; the launcher returns
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
using percival::kWmFwdMaxTpw;
using percival::kWmThreads;
using percival::kWmWarps;
using percival::ldmatrix_x4;
using percival::mma_bf16_16816;
using percival::sigmoid_f32;
using percival::wm_h_bytes;
using percival::wm_w_bytes;
using percival::wm_ws;
using percival::WideMmaFwdPlan;

constexpr int kUnits = 16;      // units a unit group: m-tiles r|z, r|z, n|n
constexpr int kGroupRows = 48;  // packed W_hᵀ rows a unit group

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int TPW>
__global__ void __launch_bounds__(kWmThreads, 1) bigru_fwd_wide_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ bn_f, const bf16* __restrict__ bn_b,
    bf16* __restrict__ y_f, bf16* __restrict__ y_b,
    int n_steps, int B, int H, int Hb, int R, int wpg, int ksp, int dbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 3 * Hb, G = 3 * H, WS = wm_ws(H);
  const int NT8 = R / 8, NUG = Hb / kUnits, KS = H / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ld_row = lane & 7, ld_mat = lane >> 3;

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * NC * H;
  const bf16* __restrict__ bn = backward ? bn_b : bn_f;
  bf16* __restrict__ y = backward ? y_b : y_f;

  // step s visits frame t(s): ascending for the forward direction
  auto frame = [=](int s) { return backward ? n_steps - 1 - s : s; };

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const s_w = reinterpret_cast<bf16*>(smem);  // W_hᵀ slice [NC][WS]
  bf16* const s_h = reinterpret_cast<bf16*>(smem + wm_w_bytes(H, NC));  // h rows [1 + dbuf][R][WS]
  const int hbuf = (int)(wm_h_bytes(H, R) / sizeof(bf16));
  bf16* const s_stage0 = s_h + (1 + dbuf) * hbuf;  // the warps' staging tiles
  bf16* const s_stage = s_stage0 + warp * kWmFwdMaxTpw * 8 * kUnits;  // this warp's [TPW][8][kUnits]
  // the K parts' partial sums [ksp − 1][CW][TPW][3 tiles][4][32 lanes]
  float* const s_red = reinterpret_cast<float*>(s_stage0 + kWmWarps * kWmFwdMaxTpw * 8 * kUnits);

  // ---- the W_hᵀ slice by 16-byte cp.async; both h buffers zeroed (h_0 = 0) ----
  const int HCH = H / 8;
  for (int i = tid; i < NC * HCH; i += kWmThreads) {
    const int p = i / HCH, ch = i - p * HCH;
    cp_async16(s_w + p * WS + ch * 8, wp + (size_t)p * H + ch * 8, true);
  }
  cp_async_commit();
  {
    uint4* z = reinterpret_cast<uint4*>(s_h);
    for (int i = tid; i < (1 + dbuf) * hbuf / 8; i += kWmThreads) z[i] = make_uint4(0, 0, 0, 0);
  }

  // ---- cells: warp w takes K part kp = w / CW of cell warp cw = w % CW's
  // product: unit group cw / wpg, 8-row tiles cw % wpg + i·wpg; part 0's
  // warps (the cell warps) run the gates and the exchange ----
  if (TPW > 1) ksp = 1;  // the plan splits K only with few one-tile cells: no reduction here
  const int CW = NUG * wpg;
  const int kp = warp / CW, cw = warp - kp * CW;
  const int ug = cw / wpg, wj = cw - ug * wpg;
  const int ntiles = kp < ksp && ug < NUG && wj < NT8 ? min(TPW, (NT8 - 1 - wj) / wpg + 1) : 0;
  const int gtiles = kp == 0 ? ntiles : 0;  // tiles whose gates this warp runs
  const int unit0 = rank * Hb + ug * kUnits;  // the group's first unit
  const bool group_ok = gtiles > 0 && unit0 < H;  // units come in whole groups of 16 past H
  int unit[2];  // the lane's two units in the layer: 16ug + g and + 8
  float bias[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    unit[u] = unit0 + 8 * u + g;
    bias[u] = group_ok ? __bfloat162float(bn[unit[u]]) : 0.0f;
  }
  auto tile_row = [&](int i) { return (wj + i * wpg) * 8; };  // first row of tile i
  // this warp's K part: k-step pairs [kp·KP / ksp, (kp + 1)·KP / ksp)
  const int KP = KS / 2, kk0 = 2 * (kp * KP / ksp), kk1 = 2 * ((kp + 1) * KP / ksp);

  // gx of the lane's cells (3 gates × 2 units a tile, the two rows as one bf16 pair)
  __nv_bfloat162 pgx[TPW][2][3];
  auto load_gx = [&](int t) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      bf16 v[2][2][3];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + tile_row(i) + 2 * q + e;
        const bool ok = i < gtiles && group_ok && row < B;
        const bf16* src = gx + ((size_t)t * B + row) * G;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int gi = 0; gi < 3; ++gi)
            v[e][u][gi] = ok ? src[gi * H + unit[u]] : __float2bfloat16(0.0f);
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

  // zᵀ of the warp's tiles: acc[i][0] = r|z of units 0–7 of the group,
  // acc[i][1] = r|z of units 8–15, acc[i][2] = gh_n of units 0–7 | 8–15,
  // for the rows of tile i, its K part in 16-wide k-steps in order
  float acc[TPW][3][4];
  const bf16* const a_rec = s_w + (ug * kGroupRows + ld_row + 8 * (ld_mat & 1)) * WS + 8 * (ld_mat >> 1);
  auto product = [&](const bf16* hb) {
#pragma unroll
    for (int i = 0; i < TPW; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;
    if (ntiles == 0) return;
    for (int kk = kk0; kk < kk1; kk += 2) {
      uint32_t b[TPW][4];  // k-steps kk (b[i][0..1]) and kk + 1 (b[i][2..3]) of tile i
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        if (i < ntiles)
          ldmatrix_x4(hb + (tile_row(i) + ld_row) * WS + kk * 16 + ld_mat * 8, b[i][0], b[i][1],
                      b[i][2], b[i][3]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          ldmatrix_x4(a_rec + j * 16 * WS + (kk + h) * 16, a[j][0], a[j][1], a[j][2], a[j][3]);
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          if (i >= ntiles) break;
          const uint32_t bb[2] = {b[i][2 * h], b[i][2 * h + 1]};
#pragma unroll
          for (int j = 0; j < 3; ++j) mma_bf16_16816(acc[i][j], a[j], bb);
        }
      }
    }
  };
  // the K parts' sums into part 0's accumulators, added in part order
  auto reduce = [&]() {
    if (ksp == 1) return;
    auto red = [&](int part, int i, int j, int k) {
      return s_red + (((((part - 1) * CW + cw) * TPW + i) * 3 + j) * 4 + k) * 32 + lane;
    };
    if (kp > 0 && ntiles > 0)
#pragma unroll
      for (int i = 0; i < TPW; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) *red(kp, i, j, k) = acc[i][j][k];
    __syncthreads();
    if (gtiles > 0)
      for (int part = 1; part < ksp; ++part)
#pragma unroll
        for (int i = 0; i < TPW; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[i][j][k] += *red(part, i, j, k);
  };

  float hreg[TPW][2][2];  // the f32 carry h of the lane's (unit, row) cells
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) hreg[i][u][0] = hreg[i][u][1] = 0.0f;

  load_gx(frame(0));
  cp_async_wait<0>();
  cluster.sync();  // every block running, its W_hᵀ slice landed and its h buffers zeroed

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bool last = s + 1 == n_steps;
    product(s_h + (dbuf & s) * hbuf);
    if (!dbuf && !last) cluster_arrive();  // this block's reads of the h buffer done
    reduce();

    // ---- gate phase: h of the lane's cells; round(h) into the warp's stage ----
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (i >= gtiles) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rl = 2 * q + e;  // row in the tile
        const bool ok = group_ok && row0 + tile_row(i) + rl < B;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float rg = sigmoid_f32(gx_of(i, u, e, 0) + acc[i][u][e]);
          const float zg = sigmoid_f32(gx_of(i, u, e, 1) + acc[i][u][2 + e]);
          const float ng = tanhf(gx_of(i, u, e, 2) + rg * (acc[i][2][2 * u + e] + bias[u]));
          const float h = ok ? (1.0f - zg) * ng + zg * hreg[i][u][e] : 0.0f;
          hreg[i][u][e] = h;
          s_stage[(i * 8 + rl) * kUnits + 8 * u + g] = __float2bfloat16(h);
        }
      }
    }
    __syncwarp();
    if (!last) load_gx(frame(s + 1));
    if (!dbuf && !last) cluster_wait();  // every block has read its h buffer: it may be written

    // ---- the exchange: each staged row (16 units, two 16-byte chunks) into y
    // and into the next h buffer of every block; lane l takes row l % 8, chunk
    // (l / 8) % 2, for blocks l / 16, + 2, …
    if (group_ok) {
      bf16* const next = s_h + (dbuf & (s + 1)) * hbuf;
      const int half = (lane >> 3) & 1;
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        if (i >= gtiles) break;
        const int rl = lane & 7, rowc = tile_row(i) + rl, row = row0 + rowc;
        if (row < B) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(s_stage + (i * 8 + rl) * kUnits + 8 * half);
          const int col = unit0 + 8 * half;
          if (lane < 16) *reinterpret_cast<uint4*>(y + ((size_t)t * B + row) * H + col) = v;
          if (!last)
            for (int dst = lane >> 4; dst < U; dst += 2)
              *reinterpret_cast<uint4*>(cluster.map_shared_rank(next, dst) + rowc * WS + col) = v;
        }
      }
    }
    if (last) break;
    cluster.sync();  // h of step s+1 landed in every block
  }
}

const void* kernel_for(int TPW) {
  switch (TPW) {
    case 1: return (const void*)&bigru_fwd_wide_mma_kernel<1>;
    case 2: return (const void*)&bigru_fwd_wide_mma_kernel<2>;
    default: return nullptr;
  }
}

cudaError_t plan_for(int B, int H, int Hb, int U, int rows, WideMmaFwdPlan* plan) {
  return percival::wide_mma_fwd_plan(B, H, Hb, U, 3, kUnits, rows, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes (rows > 0: with that many rows a
// cluster), into out[11], as percival_bilstm_fwd_wide_mma_plan.
extern "C" int percival_bigru_fwd_wide_mma_plan(int B, int H, int Hb, int U, int rows,
                                                int* out) {
  WideMmaFwdPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err == cudaSuccess) percival::wide_mma_fwd_plan_out(plan, out);
  return err;
}

// bf16 only, H a multiple of 32. gx (T, B, 3H), W_hᵀ packed per block
// (ops/wide_mma_layout.py::pack_wh) and b_hn (H), each as (forward
// direction, backward direction); then y (T, B, H) of each. rows: 0 for the
// plan's choice of rows a cluster, else that many (a measurement's
// override). gx, W_hᵀ and y 16-byte aligned, no pointer null. Returns a
// cudaError_t.
extern "C" int percival_bigru_fwd_wide_mma(const void* gx_f, const void* gx_b,
                                           const void* wp_f, const void* wp_b,
                                           const void* bn_f, const void* bn_b,
                                           void* y_f, void* y_b,
                                           int n_steps, int B, int H, int Hb, int U,
                                           int rows, void* stream) {
  if (n_steps < 1 || bn_f == nullptr || bn_b == nullptr) return cudaErrorInvalidValue;
  const void* ptrs[6] = {gx_f, gx_b, wp_f, wp_b, y_f, y_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideMmaFwdPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err != cudaSuccess) return err;
  int R = plan.R, wpg = plan.WPG, ksp = plan.KSP, dbuf = plan.dbuf;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&y_f,  (void*)&y_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&R, (void*)&wpg,
                  (void*)&ksp, (void*)&dbuf};
  return percival::wide_mma_fwd_launch(plan, B, kernel_for, args,
                                       static_cast<cudaStream_t>(stream));
}
