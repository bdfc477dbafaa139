// Bidirectional LSTM backward (BPTT) on the tensor cores (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas) on the bf16 route with H a multiple of 16
// up to 128, which covers the models' H=128 (ops/mma_layout.py::bwd_route);
// bilstm_bwd.cu keeps f32 and the other widths. Same contract and math:
//
//   z    = gx[t] + h_prev[t] · W_h                  (f32 accumulate; gates
//   i,f,g,o = σ(z_i), σ(z_f), tanh(z_g), σ(z_o)      recomputed, not saved)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = round_bf16(dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o))
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ (f32 accumulate) ;  dc_carry = dc·f
//
// dh/dc carries are f32; c and c_prev are the forward pass's bf16 cells. The
// forward direction walks t = T-1 … 0, the backward one t = 0 … T-1.
// Layouts: gx / dgx (T, B, 4H), W_h (H, 4H) row-major, W_hᵀ packed (4H, H)
// (ops/mma_layout.py::pack_wh), h_prev / c_prev / c / dy (T, B, H), all
// contiguous bf16.
//
// What bounds it on the card: latency, as in bigru_bwd_mma.cu, whose design
// this is with 4H gate columns. The one choice the LSTM forces: the forward
// kernel gives a warp 8 units, half the m16 tile of the chained product
// dhᵀ (H × 8) = W_h (H × 4H) · dzᵀ (4H × 8). Built here: 8 warps of 16 units
// (H/16 warps, 2H threads), not 16 warps of 8 units whose pairs split K and
// swap halves through shared memory under a 64-thread named barrier. It
// keeps the product and the gate phase in one warp with no second barrier,
// and needs no BPTT-specific row order: warp w's 64 packed rows are the
// forward's rows of its two 8-unit groups (tiles i|f, g|o of units
// 16w…16w+7, then of 16w+8…16w+15), so the recompute's accumulators hand
// lane l the i, f, g, o of u0 = 16w + l/4 and u1 = u0 + 8 for batch rows
// 2(l%4), 2(l%4)+1, and the chained product's M-tile w lands on the same
// lane as the same 4 cells. Its cost: W_h's A fragments for the chained
// product take 4H/16 k-steps × 4 = 128 registers a thread at H=128 (ptxas's
// registers and spills are printed by chip_smoke.py).
//   * K = 4H is split into 4 independent accumulator chains (one per gate
//     block i, f, g, o), summed at the end;
//   * dz (bf16) goes to a double-buffered 8 × 4H shared tile (rows padded 16
//     bytes); after the step's one block barrier the chained product's B
//     fragments are read from it with ldmatrix, and dgx[t] is written from it
//     with 16-byte coalesced stores;
//   * the recompute (A fragments of the packed W_hᵀ read from shared
//     memory with ldmatrix), the gates and tanh(c[t]) do not depend on the
//     carries, so they run two steps ahead: step s issues, beside its
//     chained product, the gates of step s+1 (from the pre-activations
//     recomputed in step s-1) and the recompute of step s+2, and only dh's
//     and dc's FMAs sit between the chained product and the barrier; gx,
//     h_prev, c_prev, c and dy stream in through a 4-stage cp.async ring
//     issued 3 steps ahead;
//   * grid = 2 directions × ⌈B/8⌉ blocks, one 8-row batch tile each; rows ≥ B
//     are zero-filled, never stored, and their dz and carries are zero.
// Shared memory (dynamic, bf16): W_hᵀ 4H × (H+8), ring 4 × 8 × (4H+8 + 4·(H+8)),
// dz tiles 2 × 8 × (4H+8): at H=128 139,264 + 68,096 + 16,640 = 224,000
// bytes (218.75 KB) of the 227 KB a block may use.
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
  static constexpr int G = 4 * H;
  static constexpr int WS = H + 8;  // packed W_hᵀ row stride (elements)
  static constexpr int GS = G + 8;  // gx and dz tile row stride
  static constexpr int HS = H + 8;  // h_prev, c_prev, c, dy tile row stride
  static constexpr int STAGE = ROWS * (GS + 4 * HS);
  static constexpr size_t BYTES =
      sizeof(bf16) * ((size_t)G * WS + (size_t)STAGES * STAGE + 2 * ROWS * GS);
};

// grid = (⌈B/8⌉, 2 directions), block = 2H threads (H/16 warps), H = 16·KT.
template <int KT>
__global__ void __launch_bounds__(256, 1) bilstm_bwd_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wh_f, const bf16* __restrict__ wh_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ hp_f, const bf16* __restrict__ hp_b,
    const bf16* __restrict__ cp_f, const bf16* __restrict__ cp_b,
    const bf16* __restrict__ c_f, const bf16* __restrict__ c_b,
    const bf16* __restrict__ dy_f, const bf16* __restrict__ dy_b,
    bf16* __restrict__ dgx_f, bf16* __restrict__ dgx_b, int n_steps, int B) {
  using L = Layout<KT>;
  constexpr int H = L::H, G = L::G, WS = L::WS, GS = L::GS, HS = L::HS;
  constexpr int NTHREADS = 2 * H;
  constexpr int HCH = H / 8, GCH = G / 8;  // 16-byte chunks of a row

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const s_w = reinterpret_cast<bf16*>(smem);  // packed W_hᵀ [G][WS]
  bf16* const s_ring = s_w + G * WS;  // [STAGES]: gx [8][GS] | hp | cp | c | dy [8][HS]
  bf16* const s_dz = s_ring + STAGES * L::STAGE;  // [2][8][GS]

  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2;       // accumulator rows gq, gq + 8 of each tile
  const int r0 = 2 * (lane & 3);  // the thread's batch rows r0, r0 + 1
  const int units[2] = {warp * 16 + gq, warp * 16 + 8 + gq};
  const bool valid[2] = {row0 + r0 < B, row0 + r0 + 1 < B};

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  const bf16* __restrict__ wp = backward ? wp_b : wp_f;
  const bf16* __restrict__ hp = backward ? hp_b : hp_f;
  const bf16* __restrict__ cp = backward ? cp_b : cp_f;
  const bf16* __restrict__ cc = backward ? c_b : c_f;
  const bf16* __restrict__ dy = backward ? dy_b : dy_f;
  bf16* __restrict__ dgx = backward ? dgx_b : dgx_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  // W_h's A fragments for the chained product, once: k-step kk of K = 4H
  constexpr int KG = 4 * KT;
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

  // step s's gx, h_prev, c_prev, c and dy tiles → ring stage s % STAGES (one
  // commit group a call, empty past the end, so the group count stays uniform)
  auto load_step = [&](int s) {
    if (s < n_steps) {
      const int t = frame(s);
      bf16* st = s_ring + (s % STAGES) * L::STAGE;
      for (int c = tid; c < ROWS * (GCH + 4 * HCH); c += NTHREADS) {
        const int r = c / (GCH + 4 * HCH), q = c % (GCH + 4 * HCH);
        const bool ok = row0 + r < B;
        const size_t grow = (size_t)t * B + row0 + r;
        const bf16* src;
        bf16* dst;
        if (q < GCH) {
          src = gx + grow * G + q * 8;
          dst = st + r * GS + q * 8;
        } else {
          const int a = (q - GCH) / HCH, col = ((q - GCH) % HCH) * 8;
          src = (a == 0 ? hp : a == 1 ? cp : a == 2 ? cc : dy) + grow * H + col;
          dst = st + ROWS * GS + (a * ROWS + r) * HS + col;
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
  // recompute A fragments: rows 64w + 16j + a_row of the packed W_hᵀ, columns +a_col
  const bf16* const wa_s = s_w + (warp * 64 + ld_row + 8 * (ld_mat & 1)) * WS + 8 * (ld_mat >> 1);

  // the recompute, k-step i: z[j] += W_hᵀ tile j · h_prevᵀ; tile 2u is i|f
  // and tile 2u+1 g|o of unit u
  auto recompute_k = [&](int i, const bf16* hps, float (&z)[4][4]) {
    uint32_t b[2];
    ldmatrix_x2(hps + ld_row * HS + i * 16 + (ld_mat & 1) * 8, b[0], b[1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      ldmatrix_x4(wa_s + j * 16 * WS + i * 16, a[0], a[1], a[2], a[3]);
      mma_bf16_16816(z[j], a, b);
    }
  };
  auto recompute_init = [&](const bf16* gxs, float (&z)[4][4]) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bf16* g = gxs + (r0 + e) * GS + units[u];
        z[2 * u][e] = __bfloat162float(g[0]);              // i
        z[2 * u][2 + e] = __bfloat162float(g[H]);          // f
        z[2 * u + 1][e] = __bfloat162float(g[2 * H]);      // g
        z[2 * u + 1][2 + e] = __bfloat162float(g[3 * H]);  // o
      }
  };

  // the gates of a step from its recomputed pre-activations, and tanh of
  // its saved cells: a[2u + e] = (i, f, g, o, tanh c) of cell (units[u], r0 + e)
  auto activate = [&](const float (&z)[4][4], const bf16* st, float (&a)[4][5]) {
    const bf16* cs = st + ROWS * GS + 2 * ROWS * HS;  // the c tile
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        a[2 * u + e][0] = sigmoid_f32(z[2 * u][e]);
        a[2 * u + e][1] = sigmoid_f32(z[2 * u][2 + e]);
        a[2 * u + e][2] = tanhf(z[2 * u + 1][e]);
        a[2 * u + e][3] = sigmoid_f32(z[2 * u + 1][2 + e]);
        a[2 * u + e][4] = tanhf(__bfloat162float(cs[(r0 + e) * HS + units[u]]));
      }
  };
  auto stage = [&](int s) { return s_ring + (s % STAGES) * L::STAGE; };

  // two steps ahead: entering step s, act holds step s's gates and zacc
  // step s+1's pre-activations, so the σ/tanh of step s+1 run in step s
  // beside the chained product instead of after it
  float zacc[4][4];
  float act[4][5];
  float dhc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dh carry, element 2u + e
  float dcc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dc carry
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
    const bf16* cps = stage(s) + ROWS * GS + ROWS * HS;
    const bf16* dys = cps + 2 * ROWS * HS;
    bf16* dzt = s_dz + (s & 1) * ROWS * GS;

    // ---- gate phase: dz of step s into the tile ----
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + e, un = units[u], k = 2 * u + e;
        const float ig = act[k][0], fg = act[k][1], gg = act[k][2], og = act[k][3];
        const float tc = act[k][4];
        const float cprev = __bfloat162float(cps[r * HS + un]);
        const float dh = __bfloat162float(dys[r * HS + un]) + dhc[k];
        const float dc = dcc[k] + dh * og * (1.0f - tc * tc);
        const bf16 zero = __float2bfloat16(0.0f);
        const bool ok = valid[e];
        bf16* row = dzt + r * GS + un;
        row[0] = ok ? __float2bfloat16(dc * gg * ig * (1.0f - ig)) : zero;
        row[H] = ok ? __float2bfloat16(dc * cprev * fg * (1.0f - fg)) : zero;
        row[2 * H] = ok ? __float2bfloat16(dc * ig * (1.0f - gg * gg)) : zero;
        row[3 * H] = ok ? __float2bfloat16(dh * tc * og * (1.0f - og)) : zero;
        dcc[k] = ok ? dc * fg : 0.0f;
      }

    cp_async_wait<STAGES - 3>();  // step s+2's tiles have landed
    __syncthreads();              // …for every thread, and the dz tile is complete
    load_step(s + STAGES);        // into the stage step s read before the barrier

    // ---- the chained product (4 chains: gate blocks i, f, g, o of K), and
    //      beside it the gates of step s+1 and the recompute of step s+2 ----
    float d[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[c][k] = 0.0f;
    const bf16* stn = stage(s + 2);
    const bf16* dzr = dzt + ld_row * GS + (ld_mat & 1) * 8;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      uint32_t b[4][2];  // matrices: chain 2c (lo, hi), chain 2c+1 (lo, hi)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ldmatrix_x4(dzr + ((ld_mat < 2 ? 2 * c : 2 * c + 1) * KT + i) * 16, b[2 * c][0],
                    b[2 * c][1], b[2 * c + 1][0], b[2 * c + 1][1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) mma_bf16_16816(d[c], wa[c * KT + i], b[c]);
      if (i == 0) {  // once the chain is under way
        activate(zacc, stage(s + 1), act);
        recompute_init(stn, zacc);
      }
      recompute_k(i, stn + ROWS * GS, zacc);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) dhc[k] = (d[0][k] + d[1][k]) + (d[2][k] + d[3][k]);

    // ---- dgx[t] from the tile: 16-byte coalesced stores ----
    for (int c = tid; c < ROWS * GCH; c += NTHREADS) {
      const int r = c / GCH, col = (c % GCH) * 8;
      if (row0 + r >= B) continue;
      *reinterpret_cast<uint4*>(dgx + ((size_t)t * B + row0 + r) * G + col) =
          *reinterpret_cast<const uint4*>(dzt + r * GS + col);
    }
  }
  cp_async_wait<0>();
}

template <int KT>
cudaError_t launch(const void* const* in, void* dgx_f, void* dgx_b, int n_steps, int B,
                   cudaStream_t stream) {
  const size_t smem = Layout<KT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(&bilstm_bwd_mma_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  auto p = [&](int i) { return static_cast<const bf16*>(in[i]); };
  const dim3 grid((unsigned)((B + ROWS - 1) / ROWS), 2);
  const dim3 block((unsigned)(2 * 16 * KT));
  bilstm_bwd_mma_kernel<KT><<<grid, block, smem, stream>>>(
      p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11), p(12), p(13),
      static_cast<bf16*>(dgx_f), static_cast<bf16*>(dgx_b), n_steps, B);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; H a multiple of 16 up to 128. Inputs gx, W_h (H, 4H), the
// packed W_hᵀ (4H, H), h_prev, c_prev, c, dy; then the output dgx; each as
// (forward, backward direction). gx, wp, the states and dgx 16-byte
// aligned, W_h 4-byte aligned. No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bilstm_bwd_mma(const void* gx_f, const void* gx_b,
                                       const void* wh_f, const void* wh_b,
                                       const void* wp_f, const void* wp_b,
                                       const void* hp_f, const void* hp_b,
                                       const void* cp_f, const void* cp_b,
                                       const void* c_f, const void* c_b,
                                       const void* dy_f, const void* dy_b,
                                       void* dgx_f, void* dgx_b,
                                       int n_steps, int B, int H, void* stream) {
  if (n_steps < 1 || B < 1 || H < 16 || H > 128 || H % 16) return cudaErrorInvalidValue;
  const void* in[14] = {gx_f, gx_b, wh_f, wh_b, wp_f, wp_b, hp_f, hp_b,
                        cp_f, cp_b, c_f, c_b, dy_f, dy_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if (dgx_f == nullptr || dgx_b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERCIVAL_CASE(KT) \
  case KT: return launch<KT>(in, dgx_f, dgx_b, n_steps, B, st);
  switch (H / 16) {
    PERCIVAL_CASE(1) PERCIVAL_CASE(2) PERCIVAL_CASE(3) PERCIVAL_CASE(4)
    PERCIVAL_CASE(5) PERCIVAL_CASE(6) PERCIVAL_CASE(7) PERCIVAL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef PERCIVAL_CASE
}
