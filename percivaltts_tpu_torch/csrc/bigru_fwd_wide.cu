// Fused bidirectional GRU forward for widths one SM cannot hold (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas) where H is too wide for bigru_fwd.cu's one
// block per direction: the route "wide" (ops/mma_layout.py::fwd_route), up
// to H = 4096. Same contract as bigru_fwd.cu: gx (T, B, 3H), b_hn (H),
// y (T, B, H), gate order r, z, n, an f32 carry, round_dt(h) feeding the
// product, the backward direction walking t = T-1 … 0 over the same arrays:
//
//   gh = round_dt(h) · W_h ;  r = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n  = tanh(gx_n + r·(gh_n + b_hn)) ;  h = (1 − z)·n + z·h ;  y[t] = round_dt(h)
//
// W_h arrives packed per block (ops/wide_layout.py::pack_wh with gates = 3):
// (U, H, NC) per direction, block b's NC = 3·Hb gate columns gate-major, zero
// past H.
//
// What bounds it on the card: the recurrence's latency, and at these widths
// W_h's size (bf16, H = 512: 1.5 MiB a direction; a block may use 227 KB of
// shared memory). The design is bilstm_fwd_wide.cu's, with three gates:
//   * one thread-block cluster of U <= 16 blocks per direction and tile of R
//     batch rows; block b owns units b·Hb … (Hb a multiple of 32, so that
//     NC = 3·Hb is a whole number of warps) with all three gates, so the n
//     gate's r·(gh_n + b_hn) and the update stay in the block; its H × NC
//     slice of W_h stays in shared memory for the whole sequence when it
//     fits (bf16, H = 512: 98 KB), else is read through L2 (f32, the parity
//     path);
//   * the product on CUDA cores: NT = NC·KS <= 768 threads (the launch bound
//     leaves 80 registers a thread), one column and one of KS slices of k
//     each, R rows in registers, h read as f32 four k at a time, the slices'
//     partials meeting in shared memory;
//   * the exchange: each unit's owner writes round_dt(h) into every block's
//     shared memory (distributed shared memory), double buffered, and the
//     cluster synchronises once a step; a cluster's blocks are co-scheduled;
//   * b_hn is read once, by the unit's owner; gx for step t+1 is loaded into
//     registers while step t finishes;
//   * no atomics, no allocation, PyTorch's stream; the launcher returns
//     cudaGetLastError().
// The launcher chooses R and where W_h lies (wide_common.cuh::wide_plan).

#include <cooperative_groups.h>

#include <cstddef>

#include "lstm_common.cuh"
#include "wide_common.cuh"

namespace cg = cooperative_groups;

namespace {

using percival::align16;
using percival::from_f32;
using percival::sigmoid_f32;
using percival::to_f32;
using percival::wide_hs;
using percival::wide_kl;
using percival::wide_ws;
using percival::WidePlan;

constexpr int kGates = 3;
constexpr int kThreads = 768;  // ops/wide_layout.py::THREADS[3]

// Shared memory: s_h (2 × R × HS f32) | s_part (KS·R·NC f32) | s_w (H × WS dt).
__host__ __device__ inline size_t fwd_base_bytes(int R, int H, int NC, int KS) {
  return align16((size_t)2 * R * wide_hs(H) * sizeof(float)) +
         align16((size_t)KS * R * NC * sizeof(float));
}

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; block = NT threads.
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(kThreads, 1) bigru_fwd_wide_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wp_f, const T* __restrict__ wp_b,
    const T* __restrict__ bn_f, const T* __restrict__ bn_b,
    T* __restrict__ y_f, T* __restrict__ y_b,
    int n_steps, int B, int H, int Hb, int KS) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = kGates * Hb;
  const int WS = wide_ws(NC, (int)sizeof(T));
  const int G = kGates * H;
  const int HS = wide_hs(H);
  const int u0 = rank * Hb;
  const int nu = max(0, min(Hb, H - u0));  // units of this block
  const int tid = threadIdx.x;
  const int NT = blockDim.x;

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * H * NC;
  T* __restrict__ y = backward ? y_b : y_f;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);  // round_dt(h) as f32, 2 buffers of R × HS
  float* s_part = s_h + align16((size_t)2 * R * HS * sizeof(float)) / sizeof(float);
  T* s_w = reinterpret_cast<T*>(smem + fwd_base_bytes(R, H, NC, KS));

  if constexpr (W_SMEM) {
    for (int i = tid; i < H * NC; i += NT) {
      const int k = i / NC;
      s_w[k * WS + (i - k * NC)] = wp[i];
    }
  }
  for (int i = tid; i < R * HS; i += NT) s_h[i] = 0.0f;

  // product: thread tid owns column pc and k-slice ks
  const int pc = tid % NC;
  const int ks = tid / NC;
  const int KL = wide_kl(H, KS);
  const int k0 = min(H, ks * KL);
  const int k1 = min(H, k0 + KL);

  // gate phase: thread tid < R·Hb owns (row pr, unit u0 + pu)
  const int pr = tid / Hb;
  const int pu = tid - pr * Hb;
  const bool pair = pr < R && pu < nu;
  const int prow = row0 + pr;
  const float bias = pair ? to_f32((backward ? bn_b : bn_f)[u0 + pu]) : 0.0f;
  float h_reg = 0.0f;
  float gxr[kGates];
  auto load_gx = [&](int t) {
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      gxr[g] = pair && prow < B ? to_f32(gx[((size_t)t * B + prow) * G + g * H + u0 + pu]) : 0.0f;
  };
  load_gx(backward ? n_steps - 1 : 0);
  cluster.sync();  // every block of the cluster running, its s_h zeroed, s_w loaded

  for (int s = 0; s < n_steps; ++s) {
    const int t = backward ? n_steps - 1 - s : s;
    const float* hb = s_h + (s & 1) * R * HS;
    float* hn = s_h + ((s + 1) & 1) * R * HS;

    // partial gh[r, pc] over k0 … k1-1, in order of k
    auto w_at = [&](int k) -> float {
      return W_SMEM ? to_f32(s_w[k * WS + pc]) : to_f32(wp[(size_t)k * NC + pc]);
    };
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    int k = k0;
    for (; k + 4 <= k1; k += 4) {
      const float w0 = w_at(k), w1 = w_at(k + 1), w2 = w_at(k + 2), w3 = w_at(k + 3);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + r * HS + k);
        acc[r] = fmaf(hv.w, w3, fmaf(hv.z, w2, fmaf(hv.y, w1, fmaf(hv.x, w0, acc[r]))));
      }
    }
    for (; k < k1; ++k) {
      const float w = w_at(k);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(hb[r * HS + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_part[(ks * R + r) * NC + pc] = acc[r];
    __syncthreads();  // the partials complete

    if (pair) {
      float gh[kGates];
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        float v = 0.0f;
        for (int j = 0; j < KS; ++j) v += s_part[(j * R + pr) * NC + g * Hb + pu];
        gh[g] = v;
      }
      const float rg = sigmoid_f32(gxr[0] + gh[0]);
      const float zg = sigmoid_f32(gxr[1] + gh[1]);
      const float ng = tanhf(gxr[2] + rg * (gh[2] + bias));
      h_reg = (1.0f - zg) * ng + zg * h_reg;
      const T h = from_f32<T>(h_reg);
      if (prow < B) y[((size_t)t * B + prow) * H + u0 + pu] = h;
      const float hf = to_f32(h);
      for (int dst = 0; dst < U; ++dst) cluster.map_shared_rank(hn, dst)[pr * HS + u0 + pu] = hf;
    }
    if (s + 1 < n_steps) load_gx(backward ? t - 1 : t + 1);
    // every block's h of this step written into every block; every read of
    // this step's s_h and s_part done
    cluster.sync();
  }
}

template <typename T>
const void* kernel_for(int R, bool w_smem) {
#define PERCIVAL_GRU_FWD_WIDE(RR)                                           \
  case RR:                                                                  \
    return w_smem ? (const void*)&bigru_fwd_wide_kernel<T, RR, true>        \
                  : (const void*)&bigru_fwd_wide_kernel<T, RR, false>;
  switch (R) {
    PERCIVAL_GRU_FWD_WIDE(1)
    PERCIVAL_GRU_FWD_WIDE(2)
    PERCIVAL_GRU_FWD_WIDE(4)
    PERCIVAL_GRU_FWD_WIDE(8)
    default: return nullptr;
  }
#undef PERCIVAL_GRU_FWD_WIDE
}

template <typename T>
cudaError_t plan_for(int B, int H, int Hb, int U, WidePlan* plan) {
  return percival::wide_plan(
      B, H, Hb, U, kGates, kThreads, (int)sizeof(T), false, kernel_for<T>,
      [H](int R, int NC, int KS) { return fwd_base_bytes(R, H, NC, KS); }, plan);
}

cudaError_t plan_dtype(int dtype, int B, int H, int Hb, int U, WidePlan* plan) {
  if (dtype == 0) return plan_for<float>(B, H, Hb, U, plan);
  if (dtype == 1) return plan_for<__nv_bfloat16>(B, H, Hb, U, plan);
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan a launch of (B, H, Hb, U, dtype) takes, into out[9]: U, Hb, NC,
// KS, NT, R, w_smem, clusters the card holds at once, shared memory bytes.
extern "C" int percival_bigru_fwd_wide_plan(int B, int H, int Hb, int U, int dtype, int* out) {
  WidePlan plan{};
  const cudaError_t err = plan_dtype(dtype, B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_plan_out(plan, out);
  return err;
}

// dtype: 0 = float32, 1 = bfloat16. Inputs in the order of
// _bigru_fwd_pallas: gx, W_h (packed per block by ops/wide_layout.py::pack_wh,
// (U, H, 3·Hb) with U = ceil(H / Hb)), b_hn, each as (forward direction,
// backward direction). No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bigru_fwd_wide(const void* gx_f, const void* gx_b,
                                       const void* wp_f, const void* wp_b,
                                       const void* bn_f, const void* bn_b,
                                       void* y_f, void* y_b,
                                       int n_steps, int B, int H, int Hb, int U,
                                       int dtype, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* in[8] = {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, y_f, y_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  WidePlan plan{};
  cudaError_t err = plan_dtype(dtype, B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  int KS = plan.KS;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&y_f,  (void*)&y_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&KS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return percival::wide_launch(plan, B, kernel_for<float>, args, st);
  return percival::wide_launch(plan, B, kernel_for<__nv_bfloat16>, args, st);
}
