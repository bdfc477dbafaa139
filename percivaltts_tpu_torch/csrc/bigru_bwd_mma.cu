// Bidirectional GRU backward (BPTT) on the tensor cores (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_bwd_kernel
// (launched by _bigru_bwd_pallas) on the bf16 route with H a multiple of 16
// up to 128, which covers the models' H=128 (ops/mma_layout.py::bwd_route);
// bigru_bwd.cu keeps f32 and the other widths. Same contract and math:
//
//   gh   = h_prev[t] · W_h                       (f32 accumulate; gates
//   r, z = σ(gx_r + gh_r), σ(gx_z + gh_z)          recomputed, not saved)
//   ghn  = gh_n + b_hn ;  n = tanh(gx_n + r·ghn)
//   dh   = dy[t] + dh_carry
//   dn_pre = dh·(1 − z)·(1 − n²) ;  dr_pre = dn_pre·ghn·r(1 − r)
//   dz_pre = dh·(h_prev − n)·z(1 − z) ;  dnr = dn_pre·r
//   dgx[t] = round_bf16(dr_pre | dz_pre | dn_pre) ;  dnr_out[t] = round_bf16(dnr)
//   dh_carry = dh·z + round_bf16(dr_pre | dz_pre | dnr) · W_hᵀ   (f32 accumulate)
//
// h_prev is the forward pass's bf16 output (t−1 for the forward direction,
// t+1 for the backward one). The forward direction walks t = T-1 … 0, the
// backward one t = 0 … T-1. Layouts: gx / dgx (T, B, 3H), W_h (H, 3H)
// row-major, W_hᵀ packed (3H, H) (ops/mma_layout.py::pack_wh), b_hn (H),
// h_prev / dy / dnr (T, B, H), all contiguous bf16.
//
// What bounds it on the card: latency. A step holds two (8 × H)·(H × 3H)-
// sized products for a tile of 8 batch rows, and the second depends on the
// step before through dh. The design is bilstm_fwd_mma.cu's, with a second
// product:
//   * warp w (of H/16) owns units 16w … 16w+15; lane l holds units
//     u0 = 16w + l/4 and u1 = u0 + 8 for batch rows 2(l%4), 2(l%4)+1, and
//     the gate math, dh and the carries of those 4 cells run in registers;
//   * the chained product dhᵀ (H × 8) = W_h (H × 3H) · dgᵀ (3H × 8) runs on
//     the tensor cores (mma.sync m16n8k16): warp w takes M-tile w (its own
//     16 units), K = 3H. The m16n8 accumulator then lands on lane l as
//     units u0, u1 × its 2 batch rows: exactly the cells the lane's gate
//     phase reads. W_h's A fragments stay in registers for the whole
//     sequence (3H/16 k-steps × 4 registers: 96 at H=128). K is split into
//     3 independent accumulator chains (one per gate block r, z, n), summed
//     at the end;
//   * dg (bf16: dr_pre | dz_pre | dnr | dn_pre) goes to a double-buffered
//     8 × 4H shared tile (rows padded 16 bytes: conflict-free ldmatrix);
//     after the step's one block barrier the B fragments are read from it
//     with ldmatrix, and dgx[t], dnr[t] are written from it with 16-byte
//     coalesced stores;
//   * the recompute zᵀ (3H × 8) = W_hᵀ (3H × H) · h_prevᵀ (H × 8) and the
//     gates r, z, n do not depend on the carry, so they run two steps ahead:
//     step s issues, beside its chained product, the gates of step s+1
//     (from the pre-activations recomputed in step s-1) and the recompute
//     of step s+2, and only dh's FMAs sit between the chained product and
//     the barrier. The recompute reads the packed W_hᵀ from shared memory
//     (ldmatrix A fragments, the forward's row order: tiles r|z, r|z, n|n of
//     the warp's 16 units, so the accumulators hand each lane r, z, gh_n of
//     u0, u1). Both copies of W_h do not fit in the register file;
//   * gx, h_prev and dy stream in through a 4-stage cp.async ring, 16-byte
//     coalesced copies issued 3 steps ahead: no global load sits on the
//     step-to-step chain;
//   * grid = 2 directions × ⌈B/8⌉ blocks, one 8-row batch tile each; rows ≥ B
//     are zero-filled, never stored, and their dg and carry are zero.
// Shared memory (dynamic, bf16): W_hᵀ 3H × (H+8), ring 4 × 8 × (3H+8 + 2·(H+8)),
// dg tiles 2 × 8 × (4H+8): at H=128 104,448 + 42,496 + 16,640 = 163,584
// bytes (159.8 KB) of the 227 KB a block may use.
// No atomics, no allocation, PyTorch's stream; the launcher returns
// cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include "lstm_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using percival::cp_async16;
using percival::cp_async_commit;
using percival::cp_async_wait;
using percival::ld_pair;
using percival::ldmatrix_x2;
using percival::ldmatrix_x4;
using percival::mma_bf16_16816;
using percival::sigmoid_f32;

constexpr int STAGES = 4;  // ring depth: copies run STAGES-1 steps ahead
constexpr int ROWS = 8;    // batch rows a block: the mma's N

template <int KT>
struct Layout {
  static constexpr int H = 16 * KT;
  static constexpr int G = 3 * H;
  static constexpr int WS = H + 8;      // packed W_hᵀ row stride (elements)
  static constexpr int GS = G + 8;      // gx tile row stride
  static constexpr int HS = H + 8;      // h_prev, dy tile row stride
  static constexpr int DS = 4 * H + 8;  // dg tile row stride: dr | dz | dnr | dn
  static constexpr int STAGE = ROWS * (GS + 2 * HS);
  static constexpr size_t BYTES =
      sizeof(bf16) * ((size_t)G * WS + (size_t)STAGES * STAGE + 2 * ROWS * DS);
};

// grid = (⌈B/8⌉, 2 directions), block = 2H threads (H/16 warps), H = 16·KT.
template <int KT>
__global__ void __launch_bounds__(256, 1) bigru_bwd_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wh_f, const bf16* __restrict__ wh_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ bn_f, const bf16* __restrict__ bn_b,
    const bf16* __restrict__ hp_f, const bf16* __restrict__ hp_b,
    const bf16* __restrict__ dy_f, const bf16* __restrict__ dy_b,
    bf16* __restrict__ dgx_f, bf16* __restrict__ dgx_b,
    bf16* __restrict__ dnr_f, bf16* __restrict__ dnr_b, int n_steps, int B) {
  using L = Layout<KT>;
  constexpr int H = L::H, G = L::G, WS = L::WS, GS = L::GS, HS = L::HS, DS = L::DS;
  constexpr int NTHREADS = 2 * H;
  constexpr int HCH = H / 8, GCH = G / 8;  // 16-byte chunks of a row

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const s_w = reinterpret_cast<bf16*>(smem);  // packed W_hᵀ [G][WS]
  bf16* const s_ring = s_w + G * WS;                // [STAGES]: gx [8][GS] | hp [8][HS] | dy [8][HS]
  bf16* const s_dg = s_ring + STAGES * L::STAGE;    // [2][8][DS]

  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2;       // accumulator rows gq, gq + 8 of each tile
  const int r0 = 2 * (lane & 3);  // the thread's batch rows r0, r0 + 1
  const int units[2] = {warp * 16 + gq, warp * 16 + 8 + gq};
  const bool valid[2] = {row0 + r0 < B, row0 + r0 + 1 < B};

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ hp = backward ? hp_b : hp_f;
  const bf16* __restrict__ dy = backward ? dy_b : dy_f;
  const bf16* __restrict__ wp = backward ? wp_b : wp_f;
  bf16* __restrict__ dgx = backward ? dgx_b : dgx_f;
  bf16* __restrict__ dnr = backward ? dnr_b : dnr_f;
  const bf16* __restrict__ bn = backward ? bn_b : bn_f;
  const float bias[2] = {__bfloat162float(bn[units[0]]), __bfloat162float(bn[units[1]])};

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  // W_h's A fragments for the chained product, once: k-step kk of K = 3H
  constexpr int KG = 3 * KT;
  uint32_t wa[KG][4];
  {
    const bf16* w = (backward ? wh_b : wh_f) + (size_t)units[0] * G + 2 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      const bf16* p = w + kk * 16;
      wa[kk][0] = ld_pair(p);
      wa[kk][1] = ld_pair(p + 8 * G);
      wa[kk][2] = ld_pair(p + 8);
      wa[kk][3] = ld_pair(p + 8 * G + 8);
    }
  }

  // step s's gx, h_prev and dy tiles → ring stage s % STAGES (one commit
  // group a call, empty past the end, so the group count stays uniform)
  auto load_step = [&](int s) {
    if (s < n_steps) {
      const int t = frame(s);
      bf16* st = s_ring + (s % STAGES) * L::STAGE;
      for (int c = tid; c < ROWS * (GCH + 2 * HCH); c += NTHREADS) {
        const int r = c / (GCH + 2 * HCH), q = c % (GCH + 2 * HCH);
        const bool ok = row0 + r < B;
        const size_t grow = (size_t)t * B + row0 + r;
        const bf16* src;
        bf16* dst;
        if (q < GCH) {
          src = gx + grow * G + q * 8;
          dst = st + r * GS + q * 8;
        } else if (q < GCH + HCH) {
          src = hp + grow * H + (q - GCH) * 8;
          dst = st + ROWS * GS + r * HS + (q - GCH) * 8;
        } else {
          src = dy + grow * H + (q - GCH - HCH) * 8;
          dst = st + ROWS * (GS + HS) + r * HS + (q - GCH - HCH) * 8;
        }
        cp_async16(dst, ok ? src : gx, ok);
      }
    }
    cp_async_commit();
  };

  // the packed W_hᵀ joins step 0's commit group
  for (int c = tid; c < G * HCH; c += NTHREADS) {
    const int row = c / HCH, q = c % HCH;
    cp_async16(s_w + row * WS + q * 8, wp + (size_t)row * H + q * 8, true);
  }
#pragma unroll
  for (int s = 0; s < STAGES; ++s) load_step(s);

  // ldmatrix: lane gives row (lane & 7) of matrix (lane >> 3)
  const int ld_row = lane & 7, ld_mat = lane >> 3;
  // recompute A fragments: rows 48w + 16j + a_row of the packed W_hᵀ, columns +a_col
  const bf16* const wa_s = s_w + (warp * 48 + ld_row + 8 * (ld_mat & 1)) * WS + 8 * (ld_mat >> 1);

  // the recompute for step s, k-step i: z[j] += W_hᵀ tile j · h_prevᵀ
  auto recompute_k = [&](int i, const bf16* hps, float (&z)[3][4]) {
    uint32_t b[2];
    ldmatrix_x2(hps + ld_row * HS + i * 16 + (ld_mat & 1) * 8, b[0], b[1]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uint32_t a[4];
      ldmatrix_x4(wa_s + j * 16 * WS + i * 16, a[0], a[1], a[2], a[3]);
      mma_bf16_16816(z[j], a, b);
    }
  };
  // its accumulators start from gx_r, gx_z (tiles 0, 1) and b_hn (tile 2)
  auto recompute_init = [&](const bf16* gxs, float (&z)[3][4]) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        z[u][e] = __bfloat162float(gxs[(r0 + e) * GS + units[u]]);          // r
        z[u][2 + e] = __bfloat162float(gxs[(r0 + e) * GS + H + units[u]]);  // z
        z[2][2 * u + e] = bias[u];                                          // gh_n + b_hn
      }
  };

  // the gates of a step from its recomputed pre-activations and gx_n:
  // a[2u + e] = (r, z, gh_n + b_hn, n) of cell (units[u], r0 + e)
  auto activate = [&](const float (&z)[3][4], const bf16* gxs, float (&a)[4][4]) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float rg = sigmoid_f32(z[u][e]);
        const float ghn = z[2][2 * u + e];
        a[2 * u + e][0] = rg;
        a[2 * u + e][1] = sigmoid_f32(z[u][2 + e]);
        a[2 * u + e][2] = ghn;
        a[2 * u + e][3] = tanhf(__bfloat162float(gxs[(r0 + e) * GS + 2 * H + units[u]]) + rg * ghn);
      }
  };
  auto stage = [&](int s) { return s_ring + (s % STAGES) * L::STAGE; };

  // two steps ahead: entering step s, act holds step s's gates and zacc
  // step s+1's pre-activations, so the σ/tanh of step s+1 run in step s
  // beside the chained product instead of after it
  float zacc[3][4];
  float act[4][4];
  float dhc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dh carry, element 2u + e
  cp_async_wait<STAGES - 2>();  // W_hᵀ, steps 0 and 1 have landed (this thread's part)
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s == 1) activate(zacc, stage(0), act);
    recompute_init(stage(s), zacc);
#pragma unroll
    for (int i = 0; i < KT; ++i) recompute_k(i, stage(s) + ROWS * GS, zacc);
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bf16* hps = stage(s) + ROWS * GS;
    const bf16* dys = hps + ROWS * HS;
    bf16* dgt = s_dg + (s & 1) * ROWS * DS;

    // ---- gate phase: dg of step s into the tile; dh·z starts the carry ----
    float cin[4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + e, un = units[u];
        const float rg = act[2 * u + e][0], zg = act[2 * u + e][1];
        const float ghn = act[2 * u + e][2], ng = act[2 * u + e][3];
        const float dh = __bfloat162float(dys[r * HS + un]) + dhc[2 * u + e];
        const float hprev = __bfloat162float(hps[r * HS + un]);
        const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
        const bf16 zero = __float2bfloat16(0.0f);
        const bool ok = valid[e];
        bf16* row = dgt + r * DS + un;
        row[0] = ok ? __float2bfloat16(dn_pre * ghn * rg * (1.0f - rg)) : zero;      // dr_pre
        row[H] = ok ? __float2bfloat16(dh * (hprev - ng) * zg * (1.0f - zg)) : zero;  // dz_pre
        row[2 * H] = ok ? __float2bfloat16(dn_pre * rg) : zero;                       // dnr
        row[3 * H] = ok ? __float2bfloat16(dn_pre) : zero;                            // dn_pre
        cin[2 * u + e] = ok ? dh * zg : 0.0f;
      }

    cp_async_wait<STAGES - 3>();  // step s+2's tiles have landed
    __syncthreads();              // …for every thread, and the dg tile is complete
    load_step(s + STAGES);        // into the stage step s read before the barrier

    // ---- the chained product (3 chains: gate blocks r, z, n of K), and
    //      beside it the gates of step s+1 and the recompute of step s+2 ----
    float d[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[0][k] = cin[k];
      d[1][k] = 0.0f;
      d[2][k] = 0.0f;
    }
    const bf16* stn = stage(s + 2);
    const bf16* dgr = dgt + ld_row * DS + (ld_mat & 1) * 8;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      uint32_t b0[2], b1[2], b2[2];  // matrices: chain 0 (lo, hi), chain 1 (lo, hi)
      ldmatrix_x4(dgr + (ld_mat < 2 ? i : KT + i) * 16, b0[0], b0[1], b1[0], b1[1]);
      ldmatrix_x2(dgr + (2 * KT + i) * 16, b2[0], b2[1]);
      mma_bf16_16816(d[0], wa[i], b0);
      mma_bf16_16816(d[1], wa[KT + i], b1);
      mma_bf16_16816(d[2], wa[2 * KT + i], b2);
      if (i == 0) {  // once the chain is under way
        activate(zacc, stage(s + 1), act);
        recompute_init(stn, zacc);
      }
      recompute_k(i, stn + ROWS * GS, zacc);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) dhc[k] = d[0][k] + d[1][k] + d[2][k];

    // ---- dgx[t], dnr[t] from the tile: 16-byte coalesced stores ----
    for (int c = tid; c < ROWS * 4 * HCH; c += NTHREADS) {
      const int r = c / (4 * HCH), col = (c % (4 * HCH)) * 8;
      if (row0 + r >= B) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(dgt + r * DS + col);
      const size_t grow = (size_t)t * B + row0 + r;
      bf16* dst = col < 2 * H   ? dgx + grow * G + col
                  : col < 3 * H ? dnr + grow * H + (col - 2 * H)
                                : dgx + grow * G + (col - H);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  cp_async_wait<0>();
}

template <int KT>
cudaError_t launch(const void* const* in, void* const* out, int n_steps, int B,
                   cudaStream_t stream) {
  const size_t smem = Layout<KT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(&bigru_bwd_mma_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto p = [&](int i) { return static_cast<const bf16*>(in[i]); };
  auto o = [&](int i) { return static_cast<bf16*>(out[i]); };
  const dim3 grid((unsigned)((B + ROWS - 1) / ROWS), 2);
  const dim3 block((unsigned)(2 * 16 * KT));
  bigru_bwd_mma_kernel<KT><<<grid, block, smem, stream>>>(
      p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11),
      o(0), o(1), o(2), o(3), n_steps, B);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; H a multiple of 16 up to 128. Inputs gx, W_h (H, 3H), the
// packed W_hᵀ (3H, H), b_hn, h_prev, dy; then the outputs dgx and dnr; each
// as (forward, backward direction). gx, wp, h_prev, dy, dgx and dnr 16-byte
// aligned, W_h 4-byte aligned. No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bigru_bwd_mma(const void* gx_f, const void* gx_b,
                                      const void* wh_f, const void* wh_b,
                                      const void* wp_f, const void* wp_b,
                                      const void* bn_f, const void* bn_b,
                                      const void* hp_f, const void* hp_b,
                                      const void* dy_f, const void* dy_b,
                                      void* dgx_f, void* dgx_b, void* dnr_f, void* dnr_b,
                                      int n_steps, int B, int H, void* stream) {
  if (n_steps < 1 || B < 1 || H < 16 || H > 128 || H % 16) return cudaErrorInvalidValue;
  const void* in[12] = {gx_f, gx_b, wh_f, wh_b, wp_f, wp_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b};
  void* const out[4] = {dgx_f, dgx_b, dnr_f, dnr_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : out)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERCIVAL_CASE(KT) \
  case KT: return launch<KT>(in, out, n_steps, B, st);
  switch (H / 16) {
    PERCIVAL_CASE(1) PERCIVAL_CASE(2) PERCIVAL_CASE(3) PERCIVAL_CASE(4)
    PERCIVAL_CASE(5) PERCIVAL_CASE(6) PERCIVAL_CASE(7) PERCIVAL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef PERCIVAL_CASE
}
