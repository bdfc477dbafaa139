// Fused bidirectional GRU forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas). Same contract: the input projections
// gx = x·W_i + b are computed outside (one GEMM per direction); this kernel
// runs only the sequential part, both directions in one launch, with flax
// GRUCell's math (gate order r, z, n):
//
//   gh  = round_dt(h) · W_h                     (f32 accumulate)
//   r   = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n   = tanh(gx_n + r·(gh_n + b_hn))
//   h   = (1 − z)·n + z·h                       (h carried in f32)
//   y[t] = round_dt(h)
//
// The backward direction walks t = T-1 … 0 over the same (T, B, 3H) arrays.
// Layouts: gx (T, B, 3H), W_h (H, 3H) row-major, b_hn (H), y (T, B, H), all
// contiguous, dt = float or bfloat16.
//
// What bounds it on the card: latency, not FLOPs or bytes. Each step is a
// (rows × H)·(H × 3H) product that depends on the previous step, so T steps
// run one after another; at the serving shape (H=128, B=8) a step is
// 2·128·384 ≈ 0.1 MFLOP per row and direction, far too little to fill even
// one SM's tensor cores, and the gx stream (3H values per row and step) is
// read once.
// What the design does about it (the BiLSTM forward kernel's design, with
// 3H gate columns):
//   * each block owns one direction and a tile of R batch rows (R chosen by
//     the wrapper so that the grid fits in one wave: small R = short step)
//     and loops over t itself; no state crosses blocks;
//   * W_h stays resident in shared memory for the whole sequence: bf16 at
//     H=128 is 96 KB, f32 192 KB, both within a block's 227 KB after the
//     >48 KB opt-in; if it does not fit (large H or R), W_h is read through
//     L1/L2 instead;
//   * one thread per gate column (3H threads): thread j accumulates gh[r, j]
//     for its R rows in registers (h is a shared-memory broadcast), then
//     writes the r/z pre-activations, or gh_n + b_hn and gx_n, to shared
//     memory, where a thread owning (row, unit) updates h in a register;
//   * gx for step t+1 is loaded into registers while step t computes, so no
//     global-memory load sits on the step-to-step dependency chain;
//   * two __syncthreads per step, no atomics, no allocation, PyTorch's
//     stream, and the launcher returns cudaGetLastError().
// The route split (ops/mma_layout.py::fwd_route, chosen before the launch):
// this kernel runs f32 (the parity dtype) and bf16 widths outside the
// tensor-core route; bf16 with H a multiple of 16 up to 128 (the models'
// H=128) runs bigru_fwd_mma.cu, whose per-step product is mma.sync.

#include <cstddef>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::sigmoid_f32;
using percival::to_f32;

// grid = (ceil(B / R), 2 directions), block = 3H threads.
// Dynamic shared memory: s_h (R·H f32) | s_g (R·3H f32) | s_xn (R·H f32) |
// s_w (H·3H dt, if W_SMEM).
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(1024) bigru_fwd_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wh_f, const T* __restrict__ wh_b,
    const T* __restrict__ bn_f, const T* __restrict__ bn_b,
    T* __restrict__ y_f, T* __restrict__ y_b,
    int n_steps, int B, int H) {
  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * R;
  const int G = 3 * H;
  const int j = threadIdx.x;  // gate column owned in the product phase
  const bool n_col = j >= 2 * H;

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wh = backward ? wh_b : wh_f;
  T* __restrict__ y = backward ? y_b : y_f;
  const float bias = n_col ? to_f32((backward ? bn_b : bn_f)[j - 2 * H]) : 0.0f;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);  // h rounded to dt, as f32
  float* s_g = s_h + R * H;                     // r, z pre-activations | gh_n + b_hn
  float* s_xn = s_g + R * G;                    // gx_n
  T* s_w = reinterpret_cast<T*>(s_xn + R * H);  // resident W_h

  if constexpr (W_SMEM) {
    for (int k = j; k < H * G; k += blockDim.x) s_w[k] = wh[k];
  }
  for (int k = j; k < R * H; k += blockDim.x) s_h[k] = 0.0f;

  // gate phase: thread j owns the (row, unit) pairs q = j + p·3H < R·H
  constexpr int PAIRS = (R + 2) / 3;
  float h_reg[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) h_reg[p] = 0.0f;

  auto load_gx = [&](int t, int r) -> float {
    const int row = row0 + r;
    return row < B ? to_f32(gx[((size_t)t * B + row) * G + j]) : 0.0f;
  };
  float g_next[R];
#pragma unroll
  for (int r = 0; r < R; ++r) g_next[r] = load_gx(backward ? n_steps - 1 : 0, r);
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int t = backward ? n_steps - 1 - s : s;
    float g_cur[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g_cur[r] = g_next[r];
      if (s + 1 < n_steps) g_next[r] = load_gx(backward ? t - 1 : t + 1, r);
    }

    // gh[r, j] = Σ_k h[r, k] · W_h[k, j]
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float w = W_SMEM ? to_f32(s_w[k * G + j]) : to_f32(wh[(size_t)k * G + j]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_h[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (n_col) {
        s_g[r * G + j] = acc[r] + bias;
        s_xn[r * H + (j - 2 * H)] = g_cur[r];
      } else {
        s_g[r * G + j] = g_cur[r] + acc[r];
      }
    }
    __syncthreads();  // s_g, s_xn complete; every read of s_h for this step done

#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int q = j + p * G;
      if (q < R * H) {
        const int r = q / H;
        const int n = q - r * H;
        const float* g = s_g + r * G;
        const float rg = sigmoid_f32(g[n]);
        const float zg = sigmoid_f32(g[H + n]);
        const float ng = tanhf(s_xn[q] + rg * g[2 * H + n]);
        const float h = (1.0f - zg) * ng + zg * h_reg[p];
        const T hd = from_f32<T>(h);
        h_reg[p] = h;
        s_h[q] = to_f32(hd);
        const int row = row0 + r;
        if (row < B) y[((size_t)t * B + row) * H + n] = hd;
      }
    }
    __syncthreads();  // s_h holds this step's h before the next product
  }
}

template <typename T, int R>
cudaError_t launch(const void* const* in, void* y_f, void* y_b, int n_steps, int B,
                   int H, cudaStream_t stream) {
  int smem_optin = 0;
  cudaError_t err = percival::smem_optin_bytes(&smem_optin);
  if (err != cudaSuccess) return err;

  const size_t base = (size_t)(R * H + R * 3 * H + R * H) * sizeof(float);
  const size_t w_bytes = (size_t)H * 3 * H * sizeof(T);
  const bool w_smem = base + w_bytes <= (size_t)smem_optin;
  const size_t smem = base + (w_smem ? w_bytes : 0);
  if (smem > (size_t)smem_optin) return cudaErrorInvalidConfiguration;

  using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*,
                          T*, T*, int, int, int);
  Kernel kernel = w_smem ? &bigru_fwd_kernel<T, R, true> : &bigru_fwd_kernel<T, R, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  auto p = [&](int i) { return static_cast<const T*>(in[i]); };
  const dim3 grid((unsigned)((B + R - 1) / R), 2);
  const dim3 block((unsigned)(3 * H));
  kernel<<<grid, block, smem, stream>>>(p(0), p(1), p(2), p(3), p(4), p(5),
                                        static_cast<T*>(y_f), static_cast<T*>(y_b),
                                        n_steps, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int rows, const void* const* in, void* y_f, void* y_b,
                          int n_steps, int B, int H, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(in, y_f, y_b, n_steps, B, H, stream);
    case 2: return launch<T, 2>(in, y_f, y_b, n_steps, B, H, stream);
    case 4: return launch<T, 4>(in, y_f, y_b, n_steps, B, H, stream);
    case 8: return launch<T, 8>(in, y_f, y_b, n_steps, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows: batch rows per block (1, 2, 4, 8).
// Inputs in the order of _bigru_fwd_pallas: gx, W_h, b_hn, each as (forward
// direction, backward direction). No pointer may be null. Returns a
// cudaError_t.
extern "C" int percival_bigru_fwd(const void* gx_f, const void* gx_b,
                                  const void* wh_f, const void* wh_b,
                                  const void* bn_f, const void* bn_b,
                                  void* y_f, void* y_b,
                                  int n_steps, int B, int H, int dtype,
                                  int rows, void* stream) {
  if (n_steps < 1 || B < 1 || H < 1 || 3 * H > 1024) return cudaErrorInvalidValue;
  const void* in[6] = {gx_f, gx_b, wh_f, wh_b, bn_f, bn_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if (y_f == nullptr || y_b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rows<float>(rows, in, y_f, y_b, n_steps, B, H, st);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(rows, in, y_f, y_b, n_steps, B, H, st);
  return cudaErrorInvalidValue;
}
