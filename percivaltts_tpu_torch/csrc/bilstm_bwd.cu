// Fused bidirectional LSTM backward (BPTT) for Hopper (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas). Same contract: given the forward pass's
// saved inputs, this kernel runs only the sequential part of the backward
// pass, both directions in one launch, and streams out d(gates); the weight,
// bias and input gradients are GEMMs outside (dW_h = Σ_t h_prevᵀ·dz):
//
//   z    = gx[t] + h_prev[t] · W_h                  (f32 accumulate; gates
//   i,f,g,o = σ(z_i), σ(z_f), tanh(z_g), σ(z_o)      recomputed, not saved)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = round_dt(dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o))
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ (f32 accumulate) ;  dc_carry = dc·f
//
// dh/dc carries are f32; dz is rounded to the compute dtype before it is
// stored and before the dz·W_hᵀ product; c and c_prev are the compute-dtype
// cells of the forward pass. The forward direction's BPTT walks
// t = T-1 … 0, the backward direction's t = 0 … T-1, over the same
// (T, B, ·) arrays. Layouts: gx / dgx (T, B, 4H), W_h (H, 4H) row-major,
// h_prev / c_prev / c / dy (T, B, H), all contiguous, dt = float or bfloat16.
//
// What bounds it on the card: latency, as in the forward kernel. Each step
// holds two (R × H)·(H × 4H)-sized products, and one of them (dz·W_hᵀ)
// depends on the previous step through dh, so T steps run one after another.
// What the design does about it:
//   * each block owns one direction and a tile of R batch rows (R from the
//     forward kernel's rows_per_block), and loops over t itself;
//   * ONE resident copy of W_h in shared memory serves both products: the
//     recompute reads it by columns (thread j owns gate column j), the
//     dz·W_hᵀ product by rows. The TPU kernel's second, pre-transposed
//     (4H, H) copy exists only for the MXU's layout; two bf16 copies at
//     H=128 would be 256 KB, over the 227 KB a block may use. f32 (256 KB
//     for one copy) reads W_h through L1/L2, as the forward kernel does;
//   * the row-wise read of W_h has a 4H-element stride between rows, which
//     would put every thread of a warp on one bank; so one WARP reduces one
//     row k: lane l reads W_h[k, l + 32m] (consecutive addresses, no bank
//     conflict) and the warp sums with shuffles;
//   * the recompute z for step s+1 does not depend on the carry: it is
//     computed in the same phase as step s's dz·W_hᵀ product, so the two
//     independent instruction streams interleave and the recompute stays off
//     the sequential chain; all global loads (gx, h_prev, c, c_prev, dy) are
//     prefetched into registers one step ahead;
//   * two __syncthreads per step, no atomics, no allocation, PyTorch's
//     stream, and the launcher returns cudaGetLastError().

#include <cstddef>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::sigmoid_f32;
using percival::to_f32;

// grid = (ceil(B / R), 2 directions), block = 4H threads.
// Dynamic shared memory: s_hp (R·H f32) | s_dh (R·H f32) | s_z (R·4H f32) |
// s_dz (R·4H f32) | s_w (H·4H dt, if W_SMEM).
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(1024) bilstm_bwd_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wh_f, const T* __restrict__ wh_b,
    const T* __restrict__ hp_f, const T* __restrict__ hp_b,
    const T* __restrict__ cp_f, const T* __restrict__ cp_b,
    const T* __restrict__ c_f, const T* __restrict__ c_b,
    const T* __restrict__ dy_f, const T* __restrict__ dy_b,
    T* __restrict__ dgx_f, T* __restrict__ dgx_b,
    int n_steps, int B, int H) {
  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * R;
  const int G = 4 * H;
  const int j = threadIdx.x;  // gate column owned in the recompute product
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wh = backward ? wh_b : wh_f;
  const T* __restrict__ hp = backward ? hp_b : hp_f;
  const T* __restrict__ cp = backward ? cp_b : cp_f;
  const T* __restrict__ cs = backward ? c_b : c_f;
  const T* __restrict__ dy = backward ? dy_b : dy_f;
  T* __restrict__ dgx = backward ? dgx_b : dgx_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_hp = reinterpret_cast<float*>(smem);  // h_prev of the next z, as f32
  float* s_dh = s_hp + R * H;                    // dh carry
  float* s_z = s_dh + R * H;                     // recomputed pre-activations
  float* s_dz = s_z + R * G;                     // dz rounded to dt, as f32
  T* s_w = reinterpret_cast<T*>(s_dz + R * G);   // resident W_h

  auto w_at = [&](int idx) -> float {
    return W_SMEM ? to_f32(s_w[idx]) : to_f32(wh[idx]);
  };

  if constexpr (W_SMEM) {
    for (int k = j; k < H * G; k += blockDim.x) s_w[k] = wh[k];
  }
  for (int k = j; k < R * H; k += blockDim.x) s_dh[k] = 0.0f;

  // gate phase: thread j owns the (row, unit) pairs q = j + p·4H < R·H
  constexpr int PAIRS = (R + 3) / 4;
  auto load_pair = [&](const T* __restrict__ a, int t, int p) -> float {
    const int q = j + p * G;
    if (q >= R * H) return 0.0f;
    const int r = q / H;
    const int row = row0 + r;
    return row < B ? to_f32(a[((size_t)t * B + row) * H + (q - r * H)]) : 0.0f;
  };
  auto load_gx = [&](int t, int r) -> float {
    const int row = row0 + r;
    return row < B ? to_f32(gx[((size_t)t * B + row) * G + j]) : 0.0f;
  };

  float dc_reg[PAIRS];
  float c_cur[PAIRS], cp_cur[PAIRS], dy_cur[PAIRS];  // this step's operands
  float hp_next[PAIRS];                              // h_prev of the next step
  float g_next[R];                                   // gx of the next step
  {
    const int t0 = frame(0);
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int q = j + p * G;
      if (q < R * H) s_hp[q] = load_pair(hp, t0, p);
      dc_reg[p] = 0.0f;
      c_cur[p] = load_pair(cs, t0, p);
      cp_cur[p] = load_pair(cp, t0, p);
      dy_cur[p] = load_pair(dy, t0, p);
      hp_next[p] = n_steps > 1 ? load_pair(hp, frame(1), p) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) g_next[r] = n_steps > 1 ? load_gx(frame(1), r) : 0.0f;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = load_gx(t0, r);
    __syncthreads();  // s_w, s_hp, s_dh ready
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float w = w_at(k * G + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_hp[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_z[r * G + j] = acc[r];
    __syncthreads();  // s_z holds step 0's z; every read of s_hp done
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bool more = s + 1 < n_steps;

    // prefetch the next step's gate operands
    float c_n[PAIRS], cp_n[PAIRS], dy_n[PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      c_n[p] = more ? load_pair(cs, frame(s + 1), p) : 0.0f;
      cp_n[p] = more ? load_pair(cp, frame(s + 1), p) : 0.0f;
      dy_n[p] = more ? load_pair(dy, frame(s + 1), p) : 0.0f;
    }

    // ---- gate phase: dz for this step; s_hp ← h_prev of step s+1 ----
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
        const float tc = tanhf(c_cur[p]);
        const float dh = dy_cur[p] + s_dh[q];
        const float dc = dc_reg[p] + dh * og * (1.0f - tc * tc);
        const T dzi = from_f32<T>(dc * gg * ig * (1.0f - ig));
        const T dzf = from_f32<T>(dc * cp_cur[p] * fg * (1.0f - fg));
        const T dzg = from_f32<T>(dc * ig * (1.0f - gg * gg));
        const T dzo = from_f32<T>(dh * tc * og * (1.0f - og));
        float* dzr = s_dz + r * G;
        dzr[n] = to_f32(dzi);
        dzr[H + n] = to_f32(dzf);
        dzr[2 * H + n] = to_f32(dzg);
        dzr[3 * H + n] = to_f32(dzo);
        const int row = row0 + r;
        if (row < B) {
          T* out = dgx + ((size_t)t * B + row) * G;
          out[n] = dzi;
          out[H + n] = dzf;
          out[2 * H + n] = dzg;
          out[3 * H + n] = dzo;
        }
        dc_reg[p] = dc * fg;
        s_hp[q] = hp_next[p];
      }
      c_cur[p] = c_n[p];
      cp_cur[p] = cp_n[p];
      dy_cur[p] = dy_n[p];
      hp_next[p] = s + 2 < n_steps ? load_pair(hp, frame(s + 2), p) : 0.0f;
    }
    __syncthreads();  // s_dz and s_hp complete; every read of s_z, s_dh done

    // ---- dh_carry[r, k] = Σ_j dz[r, j] · W_h[k, j]: one warp per row k ----
    for (int k = warp; k < H; k += n_warps) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int jj = lane; jj < G; jj += 32) {
        const float w = w_at(k * G + jj);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_dz[r * G + jj], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) s_dh[r * H + k] = acc[r];
      }
    }

    // ---- recompute z for step s+1 (independent of the carry) ----
    if (more) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = g_next[r];
        g_next[r] = s + 2 < n_steps ? load_gx(frame(s + 2), r) : 0.0f;
      }
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = w_at(k * G + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_hp[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s_z[r * G + j] = acc[r];
    }
    __syncthreads();  // s_dh and s_z hold what step s+1 reads
  }
}

template <typename T, int R>
cudaError_t launch(const void* const* in, void* dgx_f, void* dgx_b, int n_steps,
                   int B, int H, cudaStream_t stream) {
  int smem_optin = 0;
  cudaError_t err = percival::smem_optin_bytes(&smem_optin);
  if (err != cudaSuccess) return err;

  const size_t base = (size_t)(2 * R * H + 2 * R * 4 * H) * sizeof(float);
  const size_t w_bytes = (size_t)H * 4 * H * sizeof(T);
  const bool w_smem = base + w_bytes <= (size_t)smem_optin;
  const size_t smem = base + (w_smem ? w_bytes : 0);
  if (smem > (size_t)smem_optin) return cudaErrorInvalidConfiguration;

  using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                          const T*, const T*, const T*, const T*, const T*,
                          const T*, const T*, T*, T*, int, int, int);
  Kernel kernel = w_smem ? &bilstm_bwd_kernel<T, R, true> : &bilstm_bwd_kernel<T, R, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  auto p = [&](int i) { return static_cast<const T*>(in[i]); };
  const dim3 grid((unsigned)((B + R - 1) / R), 2);
  const dim3 block((unsigned)(4 * H));
  kernel<<<grid, block, smem, stream>>>(
      p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), p(10), p(11),
      static_cast<T*>(dgx_f), static_cast<T*>(dgx_b), n_steps, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int rows, const void* const* in, void* dgx_f, void* dgx_b,
                          int n_steps, int B, int H, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(in, dgx_f, dgx_b, n_steps, B, H, stream);
    case 2: return launch<T, 2>(in, dgx_f, dgx_b, n_steps, B, H, stream);
    case 4: return launch<T, 4>(in, dgx_f, dgx_b, n_steps, B, H, stream);
    case 8: return launch<T, 8>(in, dgx_f, dgx_b, n_steps, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows: batch rows per block (1, 2, 4, 8).
// Inputs in the order of _bilstm_bwd_pallas: gx, W_h, h_prev, c_prev, c, dy,
// each as (forward direction, backward direction). No pointer may be null.
// Returns a cudaError_t.
extern "C" int percival_bilstm_bwd(const void* gx_f, const void* gx_b,
                                   const void* wh_f, const void* wh_b,
                                   const void* hp_f, const void* hp_b,
                                   const void* cp_f, const void* cp_b,
                                   const void* c_f, const void* c_b,
                                   const void* dy_f, const void* dy_b,
                                   void* dgx_f, void* dgx_b,
                                   int n_steps, int B, int H, int dtype,
                                   int rows, void* stream) {
  // 4H threads in whole warps: the dz·W_hᵀ reduction shuffles over full warps
  if (n_steps < 1 || B < 1 || H < 8 || H % 8 != 0 || 4 * H > 1024) return cudaErrorInvalidValue;
  const void* in[12] = {gx_f, gx_b, wh_f, wh_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if (dgx_f == nullptr || dgx_b == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rows<float>(rows, in, dgx_f, dgx_b, n_steps, B, H, st);
  if (dtype == 1)
    return dispatch_rows<__nv_bfloat16>(rows, in, dgx_f, dgx_b, n_steps, B, H, st);
  return cudaErrorInvalidValue;
}
