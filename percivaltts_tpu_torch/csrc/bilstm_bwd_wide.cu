// Fused bidirectional LSTM backward (BPTT) for widths one SM cannot hold
// (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas) where H is too wide for bilstm_bwd.cu's
// one block per direction: the route "wide" (ops/mma_layout.py::bwd_route),
// the route of the layer's forward. Same contract as bilstm_bwd.cu:
//
//   z    = gx[t] + h_prev[t] · W_h                  (gates recomputed)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = round_dt(dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o))
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ (f32) ;  dc_carry = dc·f
//
// the forward direction's BPTT walking t = T-1 … 0, the backward one's
// t = 0 … T-1. Layouts: gx / dgx (T, B, 4H); h_prev / c_prev / c / dy
// (T, B, H); W_h packed per block as for bilstm_fwd_wide.cu
// (ops/wide_layout.py::pack_wh, (U, H, 4·Hb) a direction).
//
// What bounds it on the card: the recurrence's latency and W_h's size, as
// in the forward. What the design does about it:
//   * the forward's cluster split (wide_common.cuh): one cluster of U <= 16
//     blocks per direction and tile of R rows, block b owning units b·Hb …
//     with all four gates and their H × NC slice of W_h, resident in shared
//     memory when it fits (bf16, H = 512: 128 KB), else read through L2;
//   * the ONE slice serves both products: the recompute reads it by columns
//     (thread = column × k-slice, as the forward), dz·W_hᵀ by rows (thread =
//     row k); its shared-memory row stride is an odd number of words, so
//     both reads are free of bank conflicts;
//   * dh_carry = dz · W_hᵀ sums over all 4H columns, which the blocks share
//     out, so every step ends in a reduce-scatter through distributed
//     shared memory: block b sums its NC columns for every k and writes row
//     k's partial into the slot (b, k) of the block that owns unit k; after
//     the cluster's one barrier a step, each block adds the U partials of its
//     own units (double buffered, so the next step's writes never meet this
//     step's reads);
//   * the recompute of z for step s+1 needs no carry, so it runs in the same
//     phase as step s's dz·W_hᵀ; h_prev of step s+1 and every gate operand
//     are loaded into registers a step ahead;
//   * no atomics, no allocation, PyTorch's stream; the launcher returns
//     cudaGetLastError().

#include <cooperative_groups.h>

#include <cstddef>

#include "lstm_common.cuh"
#include "wide_common.cuh"

namespace cg = cooperative_groups;

namespace {

using percival::align16;
using percival::from_f32;
using percival::kWideMaxCluster;
using percival::kWidePrefetch;
using percival::sigmoid_f32;
using percival::to_f32;
using percival::wide_hs;
using percival::wide_kl;
using percival::wide_ws;
using percival::WidePlan;

// Shared memory: s_hp (R × HS f32) | s_part (KS·R·NC f32) | s_dz (R·NC f32) |
// s_red (2 × U·R·Hb f32, U <= 16) | s_w (H × WS dt).
__host__ __device__ inline size_t bwd_hp_bytes(int R, int H) {
  return align16((size_t)R * wide_hs(H) * sizeof(float));
}
__host__ __device__ inline size_t bwd_part_bytes(int R, int NC, int KS) {
  return align16((size_t)KS * R * NC * sizeof(float));
}
__host__ __device__ inline size_t bwd_dz_bytes(int R, int NC) {
  return align16((size_t)R * NC * sizeof(float));
}
__host__ __device__ inline size_t bwd_base_bytes(int R, int H, int NC, int KS, int U) {
  return bwd_hp_bytes(R, H) + bwd_part_bytes(R, NC, KS) + bwd_dz_bytes(R, NC) +
         align16((size_t)2 * U * R * (NC / 4) * sizeof(float));
}

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; block = NT threads.
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(1024, 1) bilstm_bwd_wide_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wp_f, const T* __restrict__ wp_b,
    const T* __restrict__ hp_f, const T* __restrict__ hp_b,
    const T* __restrict__ cp_f, const T* __restrict__ cp_b,
    const T* __restrict__ c_f, const T* __restrict__ c_b,
    const T* __restrict__ dy_f, const T* __restrict__ dy_b,
    T* __restrict__ dgx_f, T* __restrict__ dgx_b,
    int n_steps, int B, int H, int Hb, int KS) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool backward = blockIdx.y == 1;
  const int row0 = (blockIdx.x / U) * R;
  const int NC = 4 * Hb;
  const int WS = wide_ws(NC, (int)sizeof(T));
  const int G = 4 * H;
  const int HS = wide_hs(H);
  const int u0 = rank * Hb;
  const int nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x;
  const int NT = blockDim.x;

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * H * NC;
  const T* __restrict__ hp = backward ? hp_b : hp_f;
  const T* __restrict__ cp = backward ? cp_b : cp_f;
  const T* __restrict__ cs = backward ? c_b : c_f;
  const T* __restrict__ dy = backward ? dy_b : dy_f;
  T* __restrict__ dgx = backward ? dgx_b : dgx_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_hp = reinterpret_cast<float*>(smem);  // h_prev of the z being recomputed, R × HS
  float* s_part = reinterpret_cast<float*>(smem + bwd_hp_bytes(R, H));
  float* s_dz = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_part) +
                                         bwd_part_bytes(R, NC, KS));
  float* s_red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_dz) +
                                          bwd_dz_bytes(R, NC));  // [2][U][R][Hb]
  T* s_w = reinterpret_cast<T*>(smem + bwd_base_bytes(R, H, NC, KS, U));
  const int red_size = U * R * Hb;

  auto w_at = [&](int k, int c) -> float {
    return W_SMEM ? to_f32(s_w[k * WS + c]) : to_f32(wp[(size_t)k * NC + c]);
  };

  if constexpr (W_SMEM) {
    for (int i = tid; i < H * NC; i += NT) {
      const int k = i / NC;
      s_w[k * WS + (i - k * NC)] = wp[i];
    }
  }
  for (int i = tid; i < red_size; i += NT) s_red[i] = 0.0f;  // dh_carry of step 0
  for (int i = tid; i < R * NC; i += NT) s_dz[i] = 0.0f;  // columns past H stay 0

  // recompute product: thread tid owns column pc and k-slice ks
  const int pc = tid % NC;
  const int ks = tid / NC;
  const int KL = wide_kl(H, KS);
  const int k0 = min(H, ks * KL);
  const int k1 = min(H, k0 + KL);
  auto recompute = [&]() {  // s_part ← partials of s_hp · W_h[:, slice], in order of k
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    int k = k0;
    for (; k + 4 <= k1; k += 4) {
      const float w0 = w_at(k, pc), w1 = w_at(k + 1, pc), w2 = w_at(k + 2, pc),
                  w3 = w_at(k + 3, pc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(s_hp + r * HS + k);
        acc[r] = fmaf(hv.w, w3, fmaf(hv.z, w2, fmaf(hv.y, w1, fmaf(hv.x, w0, acc[r]))));
      }
    }
    for (; k < k1; ++k) {
      const float w = w_at(k, pc);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_hp[r * HS + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_part[(ks * R + r) * NC + pc] = acc[r];
  };

  // h_prev rows of a frame: thread tid prefetches elements q = tid + i·NT < R·H
  auto load_hp = [&](int t, int i) -> float {
    const int q = tid + i * NT;
    const int r = q / H;
    const int row = row0 + r;
    return q < R * H && row < B ? to_f32(hp[((size_t)t * B + row) * H + (q - r * H)]) : 0.0f;
  };
  auto store_hp = [&](int i, float v) {
    const int q = tid + i * NT;
    if (q < R * H) s_hp[(q / H) * HS + q % H] = v;
  };

  // gate phase: thread tid < R·Hb owns (row pr, unit u0 + pu)
  const int pr = tid / Hb;
  const int pu = tid - pr * Hb;
  const bool pair = pr < R && pu < nu;
  const int prow = row0 + pr;
  const bool live = pair && prow < B;
  auto unit_at = [&](const T* __restrict__ a, int t) -> float {
    return live ? to_f32(a[((size_t)t * B + prow) * H + u0 + pu]) : 0.0f;
  };
  float gxr[4], c_cur, cp_cur, dy_cur;
  auto load_pair = [&](int t) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      gxr[g] = live ? to_f32(gx[((size_t)t * B + prow) * G + g * H + u0 + pu]) : 0.0f;
    c_cur = unit_at(cs, t);
    cp_cur = unit_at(cp, t);
    dy_cur = unit_at(dy, t);
  };
  float dc_reg = 0.0f;

  load_pair(frame(0));
  {
    const int t0 = frame(0);
#pragma unroll
    for (int i = 0; i < kWidePrefetch; ++i) store_hp(i, load_hp(t0, i));
  }
  float hp_next[kWidePrefetch];
#pragma unroll
  for (int i = 0; i < kWidePrefetch; ++i) hp_next[i] = n_steps > 1 ? load_hp(frame(1), i) : 0.0f;
  __syncthreads();  // s_w, s_hp ready
  recompute();      // z of step 0
  cluster.sync();   // every block running, its s_red zeroed; s_part complete

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bool more = s + 1 < n_steps;
    const float* red = s_red + (s & 1) * red_size;

    // ---- gate phase: dz of this step; s_hp ← h_prev of step s+1 ----
    if (pair) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v = gxr[g];
        for (int j = 0; j < KS; ++j) v += s_part[(j * R + pr) * NC + g * Hb + pu];
        z[g] = v;
      }
      float carry = 0.0f;
      for (int src = 0; src < U; ++src) carry += red[(src * R + pr) * Hb + pu];
      const float ig = sigmoid_f32(z[0]);
      const float fg = sigmoid_f32(z[1]);
      const float gg = tanhf(z[2]);
      const float og = sigmoid_f32(z[3]);
      const float tc = tanhf(c_cur);
      const float dh = dy_cur + carry;
      const float dc = dc_reg + dh * og * (1.0f - tc * tc);
      T dz[4];
      dz[0] = from_f32<T>(dc * gg * ig * (1.0f - ig));
      dz[1] = from_f32<T>(dc * cp_cur * fg * (1.0f - fg));
      dz[2] = from_f32<T>(dc * ig * (1.0f - gg * gg));
      dz[3] = from_f32<T>(dh * tc * og * (1.0f - og));
#pragma unroll
      for (int g = 0; g < 4; ++g) s_dz[pr * NC + g * Hb + pu] = to_f32(dz[g]);
      if (prow < B) {
        T* out = dgx + ((size_t)t * B + prow) * G + u0 + pu;
#pragma unroll
        for (int g = 0; g < 4; ++g) out[g * H] = dz[g];
      }
      dc_reg = dc * fg;
    }
    if (more) {
      load_pair(frame(s + 1));
#pragma unroll
      for (int i = 0; i < kWidePrefetch; ++i) {
        store_hp(i, hp_next[i]);
        hp_next[i] = s + 2 < n_steps ? load_hp(frame(s + 2), i) : 0.0f;
      }
    }
    __syncthreads();  // s_dz and s_hp complete; every read of s_part done

    if (more) {
      // ---- dh partials of this block's columns, written to the owner of k ----
      float* next = s_red + ((s + 1) & 1) * red_size;
      for (int k = tid; k < H; k += NT) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        for (int c = 0; c < NC; c += 4) {  // NC is a multiple of 32
          const float w0 = w_at(k, c), w1 = w_at(k, c + 1), w2 = w_at(k, c + 2),
                      w3 = w_at(k, c + 3);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 d = *reinterpret_cast<const float4*>(s_dz + r * NC + c);
            acc[r] = fmaf(d.w, w3, fmaf(d.z, w2, fmaf(d.y, w1, fmaf(d.x, w0, acc[r]))));
          }
        }
        const int dst = k / Hb;
        float* slot = cluster.map_shared_rank(next, dst) + rank * R * Hb + (k - dst * Hb);
#pragma unroll
        for (int r = 0; r < R; ++r) slot[r * Hb] = acc[r];
      }
      // ---- recompute z for step s+1 (independent of the carry) ----
      recompute();
    }
    // the partials of every block written into their owners; s_part holds
    // step s+1's z; every read of this step's s_red, s_dz and s_hp done
    cluster.sync();
  }
}

template <typename T>
const void* kernel_for(int R, bool w_smem) {
#define PERCIVAL_BWD_WIDE(RR)                                               \
  case RR:                                                                  \
    return w_smem ? (const void*)&bilstm_bwd_wide_kernel<T, RR, true>       \
                  : (const void*)&bilstm_bwd_wide_kernel<T, RR, false>;
  switch (R) {
    PERCIVAL_BWD_WIDE(1)
    PERCIVAL_BWD_WIDE(2)
    PERCIVAL_BWD_WIDE(4)
    PERCIVAL_BWD_WIDE(8)
    default: return nullptr;
  }
#undef PERCIVAL_BWD_WIDE
}

template <typename T>
cudaError_t plan_for(int B, int H, int Hb, int U, WidePlan* plan) {
  return percival::wide_plan(
      B, H, Hb, U, (int)sizeof(T), true, kernel_for<T>,
      [H, U](int R, int NC, int KS) { return bwd_base_bytes(R, H, NC, KS, U); },
      plan);
}

cudaError_t plan_dtype(int dtype, int B, int H, int Hb, int U, WidePlan* plan) {
  if (dtype == 0) return plan_for<float>(B, H, Hb, U, plan);
  if (dtype == 1) return plan_for<__nv_bfloat16>(B, H, Hb, U, plan);
  return cudaErrorInvalidValue;
}

}  // namespace

// The plan a launch of (B, H, Hb, U, dtype) takes, into out[9], as
// percival_bilstm_fwd_wide_plan.
extern "C" int percival_bilstm_bwd_wide_plan(int B, int H, int Hb, int U, int dtype, int* out) {
  WidePlan plan{};
  const cudaError_t err = plan_dtype(dtype, B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_plan_out(plan, out);
  return err;
}

// dtype: 0 = float32, 1 = bfloat16. Inputs in the order of
// _bilstm_bwd_pallas: gx, W_h (packed per block, as for the forward),
// h_prev, c_prev, c, dy, each as (forward direction, backward direction).
// No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bilstm_bwd_wide(const void* gx_f, const void* gx_b,
                                        const void* wp_f, const void* wp_b,
                                        const void* hp_f, const void* hp_b,
                                        const void* cp_f, const void* cp_b,
                                        const void* c_f, const void* c_b,
                                        const void* dy_f, const void* dy_b,
                                        void* dgx_f, void* dgx_b,
                                        int n_steps, int B, int H, int Hb, int U,
                                        int dtype, void* stream) {
  if (n_steps < 1 || U > kWideMaxCluster) return cudaErrorInvalidValue;
  const void* in[12] = {gx_f, gx_b, wp_f, wp_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b, dy_f, dy_b};
  for (const void* ptr : in)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if (dgx_f == nullptr || dgx_b == nullptr) return cudaErrorInvalidValue;
  WidePlan plan{};
  cudaError_t err = plan_dtype(dtype, B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  int KS = plan.KS;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&hp_f, (void*)&hp_b, (void*)&cp_f, (void*)&cp_b,
                  (void*)&c_f,  (void*)&c_b,  (void*)&dy_f, (void*)&dy_b,
                  (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&KS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return percival::wide_launch(plan, B, kernel_for<float>, args, st);
  return percival::wide_launch(plan, B, kernel_for<__nv_bfloat16>, args, st);
}
