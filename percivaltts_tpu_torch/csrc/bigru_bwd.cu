// Fused bidirectional GRU backward (BPTT) for Hopper (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_bwd_kernel
// (launched by _bigru_bwd_pallas). Same contract: given the forward pass's
// saved inputs, this kernel runs only the sequential part of the backward
// pass, both directions in one launch, and streams out d(gates) and
// dnr = dn_pre·r; the weight and bias gradients are reductions outside
// (dW_h = Σ_t h_prevᵀ·[dr_pre, dz_pre, dnr], db_hn = Σ dnr):
//
//   gh   = h_prev[t] · W_h                       (f32 accumulate; gates
//   r, z = σ(gx_r + gh_r), σ(gx_z + gh_z)          recomputed, not saved)
//   ghn  = gh_n + b_hn ;  n = tanh(gx_n + r·ghn)
//   dh   = dy[t] + dh_carry
//   dn_pre = dh·(1 − z)·(1 − n²) ;  dr_pre = dn_pre·ghn·r(1 − r)
//   dz_pre = dh·(h_prev − n)·z(1 − z) ;  dnr = dn_pre·r
//   dgx[t] = round_dt(dr_pre | dz_pre | dn_pre) ;  dnr_out[t] = round_dt(dnr)
//   dh_carry = dh·z + round_dt(dr_pre | dz_pre | dnr) · W_hᵀ   (f32 accumulate)
//
// h_prev is the forward pass's compute-dtype output y (t−1 for the forward
// direction, t+1 for the backward one), not its f32 carry, as the TPU kernel
// reads it. The forward direction's BPTT walks t = T-1 … 0, the backward
// direction's t = 0 … T-1, over the same (T, B, ·) arrays. Layouts: gx / dgx
// (T, B, 3H), W_h (H, 3H) row-major, b_hn (H), h_prev / dy / dnr (T, B, H),
// all contiguous, dt = float or bfloat16.
//
// What bounds it on the card: latency, as in the forward kernel. Each step
// holds two (R × H)·(H × 3H)-sized products, and one of them (dgh·W_hᵀ)
// depends on the previous step through dh, so T steps run one after another.
// What the design does about it (the BiLSTM BPTT kernel's design, with 3H
// gate columns):
//   * each block owns one direction and a tile of R batch rows (R from the
//     forward kernel's rows_per_block) and loops over t itself;
//   * ONE resident copy of W_h in shared memory serves both products: the
//     recompute reads it by columns (thread j owns gate column j), the
//     dgh·W_hᵀ product by rows. The TPU kernel's second, pre-transposed
//     (3H, H) copy exists only for the MXU's layout. bf16 at H=128 is 96 KB;
//     when W_h does not fit beside the scratch (f32 with R=8), it is read
//     through L1/L2;
//   * the row-wise read of W_h has a 3H-element stride between rows, which
//     would put a warp's threads on a few banks; so one WARP reduces one row
//     k: lane l reads W_h[k, l + 32m] (consecutive addresses) and the warp
//     sums with shuffles. The block is 3H threads in whole warps, so H is a
//     multiple of 32;
//   * the recompute for step s+1 does not depend on the carry: it is issued
//     in the same phase as step s's dgh·W_hᵀ product, so the two independent
//     instruction streams interleave and the recompute stays off the
//     sequential chain; the global loads (gx, h_prev, dy) are prefetched
//     into registers one step ahead;
//   * two __syncthreads per step, no atomics, no allocation, PyTorch's
//     stream, and the launcher returns cudaGetLastError().

#include <cstddef>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::sigmoid_f32;
using percival::to_f32;

// grid = (ceil(B / R), 2 directions), block = 3H threads.
// Dynamic shared memory: s_hp (R·H f32) | s_dh (R·H f32) | s_g (R·3H f32) |
// s_xn (R·H f32) | s_dg (R·3H f32) | s_w (H·3H dt, if W_SMEM).
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(1024) bigru_bwd_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wh_f, const T* __restrict__ wh_b,
    const T* __restrict__ bn_f, const T* __restrict__ bn_b,
    const T* __restrict__ hp_f, const T* __restrict__ hp_b,
    const T* __restrict__ dy_f, const T* __restrict__ dy_b,
    T* __restrict__ dgx_f, T* __restrict__ dgx_b,
    T* __restrict__ dnr_f, T* __restrict__ dnr_b,
    int n_steps, int B, int H) {
  const bool backward = blockIdx.y == 1;
  const int row0 = blockIdx.x * R;
  const int G = 3 * H;
  const int j = threadIdx.x;  // gate column owned in the recompute product
  const bool n_col = j >= 2 * H;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wh = backward ? wh_b : wh_f;
  const T* __restrict__ hp = backward ? hp_b : hp_f;
  const T* __restrict__ dy = backward ? dy_b : dy_f;
  T* __restrict__ dgx = backward ? dgx_b : dgx_f;
  T* __restrict__ dnr_out = backward ? dnr_b : dnr_f;
  const float bias = n_col ? to_f32((backward ? bn_b : bn_f)[j - 2 * H]) : 0.0f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_hp = reinterpret_cast<float*>(smem);  // h_prev of the recompute, as f32
  float* s_dh = s_hp + R * H;                    // dh carry
  float* s_g = s_dh + R * H;                     // r, z pre-activations | gh_n + b_hn
  float* s_xn = s_g + R * G;                     // gx_n
  float* s_dg = s_xn + R * H;                    // dgh rounded to dt, as f32
  T* s_w = reinterpret_cast<T*>(s_dg + R * G);   // resident W_h

  auto w_at = [&](int idx) -> float {
    return W_SMEM ? to_f32(s_w[idx]) : to_f32(wh[idx]);
  };

  if constexpr (W_SMEM) {
    for (int k = j; k < H * G; k += blockDim.x) s_w[k] = wh[k];
  }
  for (int k = j; k < R * H; k += blockDim.x) s_dh[k] = 0.0f;

  // gate phase: thread j owns the (row, unit) pairs q = j + p·3H < R·H
  constexpr int PAIRS = (R + 2) / 3;
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
  // gh for the rows of s_hp, then the gate inputs of one step into s_g, s_xn
  auto recompute = [&](const float (&g_in)[R]) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float w = w_at(k * G + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_hp[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (n_col) {
        s_g[r * G + j] = acc[r] + bias;
        s_xn[r * H + (j - 2 * H)] = g_in[r];
      } else {
        s_g[r * G + j] = g_in[r] + acc[r];
      }
    }
  };

  float dy_cur[PAIRS];   // this step's output gradient
  float hp_next[PAIRS];  // h_prev of the next step
  float g_next[R];       // gx of the next step
  {
    const int t0 = frame(0);
    float g0[R];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int q = j + p * G;
      if (q < R * H) s_hp[q] = load_pair(hp, t0, p);
      dy_cur[p] = load_pair(dy, t0, p);
      hp_next[p] = n_steps > 1 ? load_pair(hp, frame(1), p) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g0[r] = load_gx(t0, r);
      g_next[r] = n_steps > 1 ? load_gx(frame(1), r) : 0.0f;
    }
    __syncthreads();  // s_w, s_hp, s_dh ready
    recompute(g0);
    __syncthreads();  // s_g, s_xn hold step 0's gate inputs
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bool more = s + 1 < n_steps;

    float dy_n[PAIRS];  // prefetch the next step's output gradient
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) dy_n[p] = more ? load_pair(dy, frame(s + 1), p) : 0.0f;

    // ---- gate phase: d(gates) for this step; s_hp ← h_prev of step s+1 ----
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int q = j + p * G;
      if (q < R * H) {
        const int r = q / H;
        const int n = q - r * H;
        const float* g = s_g + r * G;
        const float hprev = s_hp[q];
        const float rg = sigmoid_f32(g[n]);
        const float zg = sigmoid_f32(g[H + n]);
        const float ghn = g[2 * H + n];
        const float ng = tanhf(s_xn[q] + rg * ghn);
        const float dh = dy_cur[p] + s_dh[q];
        const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
        const T dr = from_f32<T>(dn_pre * ghn * rg * (1.0f - rg));
        const T dz = from_f32<T>(dh * (hprev - ng) * zg * (1.0f - zg));
        const T dn = from_f32<T>(dn_pre);
        const T dnr = from_f32<T>(dn_pre * rg);
        float* dgr = s_dg + r * G;
        dgr[n] = to_f32(dr);
        dgr[H + n] = to_f32(dz);
        dgr[2 * H + n] = to_f32(dnr);
        const int row = row0 + r;
        if (row < B) {
          T* out = dgx + ((size_t)t * B + row) * G;
          out[n] = dr;
          out[H + n] = dz;
          out[2 * H + n] = dn;
          dnr_out[((size_t)t * B + row) * H + n] = dnr;
        }
        s_dh[q] = dh * zg;  // the direct path; the reduction adds dgh·W_hᵀ
        s_hp[q] = hp_next[p];
      }
      dy_cur[p] = dy_n[p];
      hp_next[p] = s + 2 < n_steps ? load_pair(hp, frame(s + 2), p) : 0.0f;
    }
    __syncthreads();  // s_dg, s_dh and s_hp complete; every read of s_g, s_xn done

    // ---- dh_carry[r, k] += Σ_j dgh[r, j] · W_h[k, j]: one warp per row k ----
    for (int k = warp; k < H; k += n_warps) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      for (int jj = lane; jj < G; jj += 32) {
        const float w = w_at(k * G + jj);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_dg[r * G + jj], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) s_dh[r * H + k] += acc[r];
      }
    }

    // ---- recompute the gate inputs of step s+1 (independent of the carry) ----
    if (more) {
      float g_in[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        g_in[r] = g_next[r];
        g_next[r] = s + 2 < n_steps ? load_gx(frame(s + 2), r) : 0.0f;
      }
      recompute(g_in);
    }
    __syncthreads();  // s_dh, s_g and s_xn hold what step s+1 reads
  }
}

template <typename T, int R>
cudaError_t launch(const void* const* in, void* const* out, int n_steps, int B, int H,
                   cudaStream_t stream) {
  int smem_optin = 0;
  cudaError_t err = percival::smem_optin_bytes(&smem_optin);
  if (err != cudaSuccess) return err;

  const size_t base = (size_t)(R * H * 3 + R * 3 * H * 2) * sizeof(float);
  const size_t w_bytes = (size_t)H * 3 * H * sizeof(T);
  const bool w_smem = base + w_bytes <= (size_t)smem_optin;
  const size_t smem = base + (w_smem ? w_bytes : 0);
  if (smem > (size_t)smem_optin) return cudaErrorInvalidConfiguration;

  using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*, const T*,
                          const T*, const T*, const T*, const T*, T*, T*, T*, T*,
                          int, int, int);
  Kernel kernel = w_smem ? &bigru_bwd_kernel<T, R, true> : &bigru_bwd_kernel<T, R, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  auto p = [&](int i) { return static_cast<const T*>(in[i]); };
  auto o = [&](int i) { return static_cast<T*>(out[i]); };
  const dim3 grid((unsigned)((B + R - 1) / R), 2);
  const dim3 block((unsigned)(3 * H));
  kernel<<<grid, block, smem, stream>>>(p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7),
                                        p(8), p(9), o(0), o(1), o(2), o(3), n_steps, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(int rows, const void* const* in, void* const* out, int n_steps,
                          int B, int H, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(in, out, n_steps, B, H, stream);
    case 2: return launch<T, 2>(in, out, n_steps, B, H, stream);
    case 4: return launch<T, 4>(in, out, n_steps, B, H, stream);
    case 8: return launch<T, 8>(in, out, n_steps, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. rows: batch rows per block (1, 2, 4, 8).
// Inputs in the order of _bigru_bwd_pallas: gx, W_h, b_hn, h_prev, dy; then
// the outputs dgx and dnr; each as (forward direction, backward direction).
// No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bigru_bwd(const void* gx_f, const void* gx_b,
                                  const void* wh_f, const void* wh_b,
                                  const void* bn_f, const void* bn_b,
                                  const void* hp_f, const void* hp_b,
                                  const void* dy_f, const void* dy_b,
                                  void* dgx_f, void* dgx_b,
                                  void* dnr_f, void* dnr_b,
                                  int n_steps, int B, int H, int dtype,
                                  int rows, void* stream) {
  // 3H threads in whole warps: the dgh·W_hᵀ reduction shuffles over full warps
  if (n_steps < 1 || B < 1 || H < 32 || H % 32 != 0 || 3 * H > 1024)
    return cudaErrorInvalidValue;
  const void* in[10] = {gx_f, gx_b, wh_f, wh_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b};
  void* const out[4] = {dgx_f, dgx_b, dnr_f, dnr_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : out)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rows<float>(rows, in, out, n_steps, B, H, st);
  if (dtype == 1) return dispatch_rows<__nv_bfloat16>(rows, in, out, n_steps, B, H, st);
  return cudaErrorInvalidValue;
}
