// Bidirectional LSTM forward recurrence on the tensor cores (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_fwd_kernel
// (launched by _bilstm_fwd_pallas) on the bf16 route with H a multiple of 16
// up to 128, which covers the models' H=128 (ops/mma_layout.py::fwd_route);
// bilstm_fwd.cu keeps f32 and the other widths. Same contract and math:
//
//   z   = gx[t] + round_bf16(h) · W_h        (f32 accumulate)
//   i,f,g,o = σ(z_i), σ(z_f), tanh(z_g), σ(z_o)
//   c   = f·c + i·g ;  h = o·tanh(c)         (h, c carried in f32)
//   y[t] = round_bf16(h) ;  c_out[t] = round_bf16(c)  (c_out only when asked)
//
// The backward direction walks t = T-1 … 0 over the same arrays. Layouts:
// gx (T, B, 4H), y / c_out (T, B, H) contiguous bf16; W_h arrives packed as
// W_hᵀ (4H, H) with its gate rows permuted (ops/mma_layout.py::pack_wh).
//
// What bounds it on the card: latency. The T steps depend on each other, and
// a step is an (8 × H)·(H × 4H) product for a tile of 8 batch rows, 0.5 MFLOP
// at H=128: nothing for the tensor cores' throughput. gx and y are read and
// written once (the byte bound is some 3 µs at T=512, B=8). So the step's
// dependent chain is what the design shortens:
//   * the product runs transposed on the tensor cores, zᵀ (4H × 8) =
//     W_hᵀ (4H × H) · hᵀ (H × 8), with mma.sync m16n8k16 (bf16 in, f32
//     accumulate): M = gate rows, N = the block's 8 batch rows, K = H. The
//     tile is too small for wgmma's 64-row asynchronous form to pay;
//   * W_hᵀ stays in registers as A fragments for the whole sequence: warp w
//     (of H/8) holds the 32 gate rows of units 8w…8w+7, 64 registers a thread
//     at H=128. Its tile 0 is i|f and tile 1 g|o of those units, so the m16n8
//     accumulator gives each thread i, f, g, o of one unit for 2 batch rows:
//     the nonlinearities and the c/h carries run in registers, and the
//     pre-activations never go through shared memory;
//   * one barrier a step: h (bf16) goes to a double-buffered 8 × H shared
//     tile, from which the next step's B fragments are read with ldmatrix;
//   * K is split into two independent accumulator chains, summed at the end,
//     which halves the dependent mma chain;
//   * gx reaches shared memory through a 4-stage cp.async ring, 16-byte
//     coalesced copies issued 3 steps ahead, so no global load sits on the
//     step-to-step chain; the first chain's accumulators start from it;
//   * grid = 2 directions × ⌈B/8⌉ blocks, one 8-row batch tile each; rows ≥ B
//     are zero-filled, never stored, and their h is zero. A step costs the
//     same at any B up to one wave: with one block an SM (the register file
//     holds one), B > 528 rows (132 SMs / 2 directions × 8) takes a second.
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

// grid = (⌈B/8⌉, 2 directions), block = 4H threads (H/8 warps), H = 16·KT.
template <int KT, bool CELLS>
__global__ void __launch_bounds__(512, 1) bilstm_fwd_mma_kernel(
    const bf16* __restrict__ gx_f, const bf16* __restrict__ gx_b,
    const bf16* __restrict__ wp_f, const bf16* __restrict__ wp_b,
    bf16* __restrict__ y_f, bf16* __restrict__ y_b,
    bf16* __restrict__ c_f, bf16* __restrict__ c_b, int n_steps, int B) {
  constexpr int H = 16 * KT;
  constexpr int G = 4 * H;
  constexpr int NTHREADS = G;
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
  const int gq = lane >> 2;     // accumulator rows gq, gq + 8 of each tile
  const int r0 = 2 * (lane & 3);  // the thread's batch rows r0, r0 + 1
  const int unit = warp * 8 + gq;
  const bool valid[2] = {row0 + r0 < B, row0 + r0 + 1 < B};

  const bf16* __restrict__ gx = backward ? gx_b : gx_f;
  bf16* __restrict__ y = backward ? y_b : y_f;
  bf16* __restrict__ cs = backward ? c_b : c_f;

  // W_hᵀ's A fragments, once: tile j, k-step kk
  uint32_t a[2][KT][4];
  {
    const bf16* w = (backward ? wp_b : wp_f) + (size_t)(warp * 32 + gq) * H + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j)
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
  float c[2] = {0.0f, 0.0f};  // cells of (unit, r0) and (unit, r0 + 1)

  for (int s = 0; s < n_steps; ++s) {
    const int t = backward ? n_steps - 1 - s : s;
    load_gx(s + STAGES - 1);  // into the stage step s-1 read before the last barrier

    const bf16(*gxs)[GS] = s_gx[s % STAGES];
    float acc[2][2][4];  // [tile][chain][element]
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      acc[0][0][e] = __bfloat162float(gxs[r0 + e][unit]);              // i
      acc[0][0][2 + e] = __bfloat162float(gxs[r0 + e][H + unit]);      // f
      acc[1][0][e] = __bfloat162float(gxs[r0 + e][2 * H + unit]);      // g
      acc[1][0][2 + e] = __bfloat162float(gxs[r0 + e][3 * H + unit]);  // o
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
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
      for (int j = 0; j < 2; ++j) mma_bf16_16816(acc[j][0], a[j][i], b0);
      if (i < K1) {
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16_16816(acc[j][1], a[j][K0 + i], b1);
      }
    }

    bf16(*hn)[HS] = s_h[(s + 1) & 1];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ig = sigmoid_f32(acc[0][0][e] + acc[0][1][e]);
      const float fg = sigmoid_f32(acc[0][0][2 + e] + acc[0][1][2 + e]);
      const float gg = tanhf(acc[1][0][e] + acc[1][1][e]);
      const float og = sigmoid_f32(acc[1][0][2 + e] + acc[1][1][2 + e]);
      c[e] = fg * c[e] + ig * gg;
      const bf16 h = valid[e] ? __float2bfloat16(og * tanhf(c[e])) : __float2bfloat16(0.0f);
      hn[r0 + e][unit] = h;
      if (valid[e]) {
        const size_t off = ((size_t)t * B + row0 + r0 + e) * H + unit;
        y[off] = h;
        if constexpr (CELLS) cs[off] = __float2bfloat16(c[e]);
      }
    }
    cp_async_wait<STAGES - 2>();  // step s+1's tile has landed
    __syncthreads();              // …for every thread, and h is complete
  }
  cp_async_wait<0>();
}

template <int KT>
cudaError_t launch(const void* gx_f, const void* gx_b, const void* wp_f, const void* wp_b,
                   void* y_f, void* y_b, void* c_f, void* c_b, int n_steps, int B,
                   cudaStream_t stream) {
  using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*,
                          bf16*, bf16*, int, int);
  const Kernel kernel = c_f != nullptr ? &bilstm_fwd_mma_kernel<KT, true>
                                       : &bilstm_fwd_mma_kernel<KT, false>;
  const dim3 grid((unsigned)((B + ROWS - 1) / ROWS), 2);
  const dim3 block((unsigned)(4 * 16 * KT));
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const bf16*>(gx_f), static_cast<const bf16*>(gx_b),
      static_cast<const bf16*>(wp_f), static_cast<const bf16*>(wp_b),
      static_cast<bf16*>(y_f), static_cast<bf16*>(y_b),
      static_cast<bf16*>(c_f), static_cast<bf16*>(c_b), n_steps, B);
  return cudaGetLastError();
}

}  // namespace

// bf16 only; H a multiple of 16 up to 128. wp_f / wp_b: the packed W_hᵀ
// (4H, H). gx and wp 16-byte aligned. c_f / c_b may be null (serving), y_f /
// y_b may not. Returns a cudaError_t.
extern "C" int percival_bilstm_fwd_mma(const void* gx_f, const void* gx_b,
                                       const void* wp_f, const void* wp_b,
                                       void* y_f, void* y_b, void* c_f, void* c_b,
                                       int n_steps, int B, int H, void* stream) {
  if (n_steps < 1 || B < 1 || H < 16 || H > 128 || H % 16) return cudaErrorInvalidValue;
  if (gx_f == nullptr || gx_b == nullptr || wp_f == nullptr || wp_b == nullptr ||
      y_f == nullptr || y_b == nullptr || (c_f == nullptr) != (c_b == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PERCIVAL_CASE(KT) \
  case KT: return launch<KT>(gx_f, gx_b, wp_f, wp_b, y_f, y_b, c_f, c_b, n_steps, B, st);
  switch (H / 16) {
    PERCIVAL_CASE(1) PERCIVAL_CASE(2) PERCIVAL_CASE(3) PERCIVAL_CASE(4)
    PERCIVAL_CASE(5) PERCIVAL_CASE(6) PERCIVAL_CASE(7) PERCIVAL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef PERCIVAL_CASE
}
