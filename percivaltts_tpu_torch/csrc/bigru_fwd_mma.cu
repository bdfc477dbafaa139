// Bidirectional GRU forward recurrence on the tensor cores (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas) on the bf16 route with H a multiple of 16
// up to 128, which covers the models' H=128 (ops/mma_layout.py::fwd_route);
// bigru_fwd.cu keeps f32 and the other widths. Same contract and math
// (flax GRUCell, gate order r, z, n):
//
//   gh  = round_bf16(h) · W_h                   (f32 accumulate)
//   r   = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n   = tanh(gx_n + r·(gh_n + b_hn))
//   h   = (1 − z)·n + z·h                       (h carried in f32)
//   y[t] = round_bf16(h)
//
// The backward direction walks t = T-1 … 0 over the same arrays. Layouts:
// gx (T, B, 3H), b_hn (H), y (T, B, H) contiguous bf16; W_h arrives packed
// as W_hᵀ (3H, H) with its gate rows permuted (ops/mma_layout.py::pack_wh).
//
// What bounds it on the card: latency, as in bilstm_fwd_mma.cu, whose
// design this is with 3H gate rows:
//   * zᵀ (3H × 8) = W_hᵀ (3H × H) · hᵀ (H × 8) on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate; M = gate rows, N = the
//     block's 8 batch rows, K = H);
//   * W_hᵀ stays in registers as A fragments: warp w (of H/16) holds the 48
//     gate rows of units 16w…16w+15, 96 registers a thread at H=128, as
//     tiles r|z of units 16w…16w+7, r|z of 16w+8…16w+15 and n of both
//     halves, so each thread holds r, z, n of two units for 2 batch rows and
//     the gate math and the h carry run in registers;
//   * the r and z accumulators start from gx_r, gx_z; gh_n stays apart (its
//     accumulator starts from b_hn) because r multiplies it before gx_n is
//     added;
//   * one barrier a step (h through a double-buffered 8 × H shared tile read
//     with ldmatrix), K split into two independent accumulator chains, gx
//     through a 4-stage cp.async ring issued 3 steps ahead;
//   * grid = 2 directions × ⌈B/8⌉ blocks, one 8-row batch tile each; rows ≥ B
//     are never stored and their h is zero. With one block an SM, B > 528
//     rows (132 SMs / 2 directions × 8) takes a second wave.
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

constexpr int STAGES = 4;  // gx ring depth: copies run STAGES-1 steps ahead
constexpr int ROWS = 8;    // batch rows a block: the mma's N

// grid = (⌈B/8⌉, 2 directions), block = 2H threads (H/16 warps), H = 16·KT.
template <int KT>
__global__ void __launch_bounds__(256, 1) bigru_fwd_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    const bf16* __restrict__ bn_f, const bf16* __restrict__ bn_b,
    bf16* __restrict__ y_f, bf16* __restrict__ y_b, int n_steps, int B) {
  constexpr int H = 16 * KT;
  constexpr int G = 3 * H;
  constexpr int NTHREADS = 2 * H;
  constexpr int GS = G + 8;  // padded row strides: consecutive rows 4 banks apart
  constexpr int HS = H + 8;
  constexpr int CHUNKS = ROWS * G / 8;  // 16-byte copies of one step's gx tile
  constexpr int K0 = (KT + 1) / 2;      // chain 0: k-steps [0, K0); chain 1: [K0, KT)
  constexpr int K1 = KT / 2;

  __shared__ __align__(16) bf16 s_gx[STAGES][ROWS][GS];
  __shared__ __align__(16) bf16 s_h[2][ROWS][HS];

  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2;       // accumulator rows gq, gq + 8 of each tile
  const int r0 = 2 * (lane & 3);  // the thread's batch rows r0, r0 + 1
  const int units[2] = {warp * 16 + gq, warp * 16 + 8 + gq};
  const bool valid[2] = {row0 + r0 < B, row0 + r0 + 1 < B};

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  bf16* __restrict__ y = backward ? y_b : y_f;
  const bf16* __restrict__ bn = backward ? bn_b : bn_f;
  const float bias[2] = {__bfloat162float(bn[units[0]]), __bfloat162float(bn[units[1]])};

  // W_hᵀ's A fragments, once: tile j, k-step kk
  uint32_t a[3][KT][4];
  {
    const bf16* w = (backward ? wp_b : wp_f) + (size_t)(warp * 48 + gq) * H + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const bf16* p = w + j * 16 * H + kk * 16;
        a[j][kk][0] = ld_pair(p);
        a[j][kk][1] = ld_pair(p + 8 * H);
        a[j][kk][2] = ld_pair(p + 8);
        a[j][kk][3] = ld_pair(p + 8 * H + 8);
      }
  }

  // step s's gx tile → ring stage s % STAGES (one commit group a call, empty
  // past the end, so the group count stays uniform)
  auto load_gx = [&](int s) {
    if (s < n_steps) {
      const int t = backward ? n_steps - 1 - s : s;
      bf16(*dst)[GS] = s_gx[s % STAGES];
      for (int c = tid; c < CHUNKS; c += NTHREADS) {
        const int r = c / (G / 8), col = (c % (G / 8)) * 8;
        const bool ok = row0 + r < B;
        cp_async16(&dst[r][col], ok ? gx + ((size_t)t * B + row0 + r) * G + col : gx, ok);
      }
    }
    cp_async_commit();
  };

  for (int k = tid; k < 2 * ROWS * HS; k += NTHREADS) (&s_h[0][0][0])[k] = __float2bfloat16(0.0f);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_gx(s);
  cp_async_wait<STAGES - 2>();  // step 0's tile has landed (this thread's part)
  __syncthreads();

  // ldmatrix: lane gives row (lane & 7) of matrix (lane >> 3)
  const int ld_row = lane & 7, ld_mat = lane >> 3;
  float h[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [unit][row]

  for (int s = 0; s < n_steps; ++s) {
    const int t = backward ? n_steps - 1 - s : s;
    load_gx(s + STAGES - 1);  // into the stage step s-1 read before the last barrier

    const bf16(*gxs)[GS] = s_gx[s % STAGES];
    float acc[3][2][4];  // [tile][chain][element]
    float xn[2][2];      // gx_n [unit][row]
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[u][0][e] = __bfloat162float(gxs[r0 + e][units[u]]);          // r
        acc[u][0][2 + e] = __bfloat162float(gxs[r0 + e][H + units[u]]);  // z
        acc[2][0][2 * u + e] = bias[u];                                  // gh_n + b_hn
        xn[u][e] = __bfloat162float(gxs[r0 + e][2 * H + units[u]]);
      }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][1][e] = 0.0f;

    const bf16* hs = &s_h[s & 1][ld_row][0];
#pragma unroll
    for (int i = 0; i < K0; ++i) {
      uint32_t b0[2], b1[2];
      if (i < K1) {  // matrices: k-step i (lo, hi), k-step K0 + i (lo, hi)
        const int k = (ld_mat < 2 ? i : K0 + i) * 16 + (ld_mat & 1) * 8;
        ldmatrix_x4(hs + k, b0[0], b0[1], b1[0], b1[1]);
      } else {
        ldmatrix_x2(hs + i * 16 + (ld_mat & 1) * 8, b0[0], b0[1]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) mma_bf16_16816(acc[j][0], a[j][i], b0);
      if (i < K1) {
#pragma unroll
        for (int j = 0; j < 3; ++j) mma_bf16_16816(acc[j][1], a[j][K0 + i], b1);
      }
    }

    bf16(*hn)[HS] = s_h[(s + 1) & 1];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float rg = sigmoid_f32(acc[u][0][e] + acc[u][1][e]);
        const float zg = sigmoid_f32(acc[u][0][2 + e] + acc[u][1][2 + e]);
        const float ng = tanhf(xn[u][e] + rg * (acc[2][0][2 * u + e] + acc[2][1][2 * u + e]));
        h[u][e] = valid[e] ? (1.0f - zg) * ng + zg * h[u][e] : 0.0f;
        const bf16 hd = __float2bfloat16(h[u][e]);
        hn[r0 + e][units[u]] = hd;
        if (valid[e]) y[((size_t)t * B + row0 + r0 + e) * H + units[u]] = hd;
      }
    cp_async_wait<STAGES - 2>();  // step s+1's tile has landed
    __syncthreads();              // …for every thread, and h is complete
  }
  cp_async_wait<0>();
}

template <int KT>
cudaError_t launch(const void* const* in, void* y_f, void* y_b, int n_steps, int B,
                   cudaStream_t stream) {
  auto p = [&](int i) { return static_cast<const bf16*>(in[i]); };
  const dim3 grid((unsigned)((B + ROWS - 1) / ROWS), 2);
  const dim3 block((unsigned)(2 * 16 * KT));
  bigru_fwd_mma_kernel<KT><<<grid, block, 0, stream>>>(
      p(0), p(1), p(2), p(3), p(4), p(5), static_cast<bf16*>(y_f), static_cast<bf16*>(y_b),
      n_steps, B);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; H a multiple of 16 up to 128. Inputs gx, the packed W_hᵀ
// (3H, H) and b_hn, each as (forward, backward direction); gx and wp 16-byte
// aligned. No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bigru_fwd_mma(const void* gx_f, const void* gx_b,
                                      const void* wp_f, const void* wp_b,
                                      const void* bn_f, const void* bn_b,
                                      void* y_f, void* y_b, int n_steps, int B, int H,
                                      void* stream) {
  if (n_steps < 1 || B < 1 || H < 16 || H > 128 || H % 16) return cudaErrorInvalidValue;
  const void* in[6] = {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if (y_f == nullptr || y_b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERCIVAL_CASE(KT) \
  case KT: return launch<KT>(in, y_f, y_b, n_steps, B, st);
  switch (H / 16) {
    PERCIVAL_CASE(1) PERCIVAL_CASE(2) PERCIVAL_CASE(3) PERCIVAL_CASE(4)
    PERCIVAL_CASE(5) PERCIVAL_CASE(6) PERCIVAL_CASE(7) PERCIVAL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef PERCIVAL_CASE
}
