// Fused bidirectional LSTM forward recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_fwd_kernel
// (launched by _bilstm_fwd_pallas). Same contract: the input projections
// gx = x·W_i + b are computed outside (one GEMM per direction); this kernel
// runs only the sequential part, both directions in one launch:
//
//   z   = gx[t] + round_dt(h) · W_h      (f32 accumulate)
//   i,f,g,o = σ(z_i), σ(z_f), tanh(z_g), σ(z_o)
//   c   = f·c + i·g ;  h = o·tanh(c)     (h, c carried in f32)
//   y[t] = round_dt(h) ;  c_out[t] = round_dt(c)  (c_out only when asked)
//
// The backward direction walks t = T-1 … 0 over the same (T, B, 4H) arrays;
// no reversed copy exists. Layouts: gx (T, B, 4H), W_h (H, 4H) row-major,
// y / c_out (T, B, H), all contiguous, dt = float or bfloat16.
//
// What bounds it on the card: latency, not FLOPs or bytes. Each step is a
// (rows × H) · (H × 4H) product that depends on the previous step, so T
// steps run one after another; at the serving shape (H=128, B=8) a step is
// 2·128·512 = 0.13 MFLOP per row and direction — far too little to fill
// even one SM's tensor cores.
// What the design does about it:
//   * the TPU's sequential grid over time blocks becomes a loop over t inside
//     each block; batch rows are independent, so each block owns one
//     direction and a tile of R rows, and no state crosses blocks. R is
//     chosen by the wrapper so that the grid still fits in one wave (small R
//     = shortest step);
//   * W_h stays resident in shared memory for the whole sequence when it
//     fits (bf16 at H=128: 128 KB, after the >48 KB opt-in). f32 at H=128
//     is 256 KB, above the 227 KB a block may use, so f32 reads W_h through
//     L1/L2 instead (f32 is the parity path, not the serving one);
//   * one thread per gate column (4H threads): thread j accumulates
//     z[r, j] for its R rows in registers (a plain FMA loop over k; h is a
//     shared-memory broadcast), then the 4 gates of unit n meet in shared
//     memory and a thread owning (r, n) updates c in a register;
//   * gx for step t+1 is loaded into registers while step t computes, so
//     no global-memory load sits on the step-to-step dependency chain;
//   * two __syncthreads per step, no atomics, no allocation, PyTorch's
//     stream, and the launcher returns cudaGetLastError().
// The route split (ops/mma_layout.py::fwd_route, chosen before the launch):
// this kernel runs f32 (the parity dtype) and bf16 widths outside the
// tensor-core route; bf16 with H a multiple of 16 up to 128 (the models'
// H=128) runs bilstm_fwd_mma.cu, whose per-step product is mma.sync.

#include <cstddef>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::sigmoid_f32;
using percival::to_f32;

// grid = (ceil(B / R), 2 directions), block = 4H threads.
// Dynamic shared memory: s_h (R·H f32) | s_z (R·4H f32) | s_w (H·4H dt, if W_SMEM).
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(1024) bilstm_fwd_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wh_f, const T* __restrict__ wh_b,
    T* __restrict__ y_f, T* __restrict__ y_b,
    T* __restrict__ c_f, T* __restrict__ c_b,
    int n_steps, int B, int H) {
  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * R;
  const int G = 4 * H;
  const int j = threadIdx.x;  // gate column owned in the product phase

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wh = backward ? wh_b : wh_f;
  T* __restrict__ y = backward ? y_b : y_f;
  T* __restrict__ cs = backward ? c_b : c_f;  // null: cells not wanted

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);  // h rounded to dt, as f32
  float* s_z = s_h + R * H;                     // pre-activations
  T* s_w = reinterpret_cast<T*>(s_z + R * G);   // resident W_h

  if constexpr (W_SMEM) {
    for (int k = j; k < H * G; k += blockDim.x) s_w[k] = wh[k];
  }
  for (int k = j; k < R * H; k += blockDim.x) s_h[k] = 0.0f;

  // gate phase: thread j owns the (row, unit) pairs q = j + p·4H < R·H
  constexpr int PAIRS = (R + 3) / 4;
  float c_reg[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) c_reg[p] = 0.0f;

  float g_next[R];
  {
    const int t = backward ? n_steps - 1 : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      g_next[r] = row < B ? to_f32(gx[((size_t)t * B + row) * G + j]) : 0.0f;
    }
  }
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int t = backward ? n_steps - 1 - s : s;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = g_next[r];
    if (s + 1 < n_steps) {  // prefetch the next step's input gates
      const int tn = backward ? t - 1 : t + 1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = row0 + r;
        g_next[r] = row < B ? to_f32(gx[((size_t)tn * B + row) * G + j]) : 0.0f;
      }
    }

    // z[r, j] += Σ_k h[r, k] · W_h[k, j]
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float w = W_SMEM ? to_f32(s_w[k * G + j]) : to_f32(wh[(size_t)k * G + j]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_h[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_z[r * G + j] = acc[r];
    __syncthreads();  // s_z complete; every read of s_h for this step done

#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int q = j + p * G;
      if (q < R * H) {
        const int r = q / H;
        const int n = q - r * H;
        const float* z = s_z + r * G;
        const float ig = sigmoid_f32(z[n]);
        const float fg = sigmoid_f32(z[H + n]);
        const float gg = tanhf(z[2 * H + n]);
        const float og = sigmoid_f32(z[3 * H + n]);
        const float c = fg * c_reg[p] + ig * gg;
        const T h = from_f32<T>(og * tanhf(c));
        c_reg[p] = c;
        s_h[r * H + n] = to_f32(h);
        const int row = row0 + r;
        if (row < B) {
          const size_t off = ((size_t)t * B + row) * H + n;
          y[off] = h;
          if (cs != nullptr) cs[off] = from_f32<T>(c);
        }
      }
    }
    __syncthreads();  // s_h holds this step's h before the next product
  }
}

template <typename T, int R>
cudaError_t launch(const void* gx_f, const void* gx_b, const void* wh_f,
                   const void* wh_b, void* y_f, void* y_b, void* c_f, void* c_b,
                   int n_steps, int B, int H, cudaStream_t stream) {
  int smem_optin = 0;
  cudaError_t err = percival::smem_optin_bytes(&smem_optin);
  if (err != cudaSuccess) return err;

  const size_t base = (size_t)(R * H + R * 4 * H) * sizeof(float);
  const size_t w_bytes = (size_t)H * 4 * H * sizeof(T);
  const bool w_smem = base + w_bytes <= (size_t)smem_optin;
  const size_t smem = base + (w_smem ? w_bytes : 0);
  if (smem > (size_t)smem_optin) return cudaErrorInvalidConfiguration;

  void (*kernel)(const T*, const T*, const T*, const T*, T*, T*, T*, T*, int, int, int) =
      w_smem ? &bilstm_fwd_kernel<T, R, true> : &bilstm_fwd_kernel<T, R, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const dim3 grid((unsigned)((B + R - 1) / R), 2);
  const dim3 block((unsigned)(4 * H));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(gx_f), static_cast<const T*>(gx_b),
      static_cast<const T*>(wh_f), static_cast<const T*>(wh_b),
      static_cast<T*>(y_f), static_cast<T*>(y_b),
      static_cast<T*>(c_f), static_cast<T*>(c_b), n_steps, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int rows, const void* gx_f, const void* gx_b,
                          const void* wh_f, const void* wh_b, void* y_f,
                          void* y_b, void* c_f, void* c_b, int n_steps, int B,
                          int H, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(gx_f, gx_b, wh_f, wh_b, y_f, y_b, c_f, c_b, n_steps, B, H, stream);
    case 2: return launch<T, 2>(gx_f, gx_b, wh_f, wh_b, y_f, y_b, c_f, c_b, n_steps, B, H, stream);
    case 4: return launch<T, 4>(gx_f, gx_b, wh_f, wh_b, y_f, y_b, c_f, c_b, n_steps, B, H, stream);
    case 8: return launch<T, 8>(gx_f, gx_b, wh_f, wh_b, y_f, y_b, c_f, c_b, n_steps, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows: batch rows per block (1, 2, 4, 8).
// c_f / c_b may be null (serving); y_f / y_b may not. Returns a cudaError_t.
extern "C" int percival_bilstm_fwd(const void* gx_f, const void* gx_b,
                                   const void* wh_f, const void* wh_b,
                                   void* y_f, void* y_b, void* c_f, void* c_b,
                                   int n_steps, int B, int H, int dtype,
                                   int rows, void* stream) {
  if (n_steps < 1 || B < 1 || H < 1 || 4 * H > 1024) return cudaErrorInvalidValue;
  if (gx_f == nullptr || gx_b == nullptr || wh_f == nullptr || wh_b == nullptr ||
      y_f == nullptr || y_b == nullptr || (c_f == nullptr) != (c_b == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_rows<float>(rows, gx_f, gx_b, wh_f, wh_b, y_f, y_b, c_f, c_b, n_steps, B, H, st);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(rows, gx_f, gx_b, wh_f, wh_b, y_f, y_b, c_f, c_b, n_steps, B, H, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* percival_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
