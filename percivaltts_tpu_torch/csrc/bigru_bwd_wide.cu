// Fused bidirectional GRU backward (BPTT) for widths one SM cannot hold
// (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_bwd_kernel
// (launched by _bigru_bwd_pallas) where H is too wide for bigru_bwd.cu's one
// block per direction: the route "wide" (ops/mma_layout.py::bwd_route), the
// route of the layer's forward. Same contract as bigru_bwd.cu:
//
//   gh   = h_prev[t] · W_h                       (gates recomputed)
//   r, z = σ(gx_r + gh_r), σ(gx_z + gh_z) ;  ghn = gh_n + b_hn ;  n = tanh(gx_n + r·ghn)
//   dh   = dy[t] + dh_carry
//   dn_pre = dh·(1 − z)·(1 − n²) ;  dr_pre = dn_pre·ghn·r(1 − r)
//   dz_pre = dh·(h_prev − n)·z(1 − z) ;  dnr = dn_pre·r
//   dgx[t] = round_dt(dr_pre | dz_pre | dn_pre) ;  dnr_out[t] = round_dt(dnr)
//   dh_carry = dh·z + round_dt(dr_pre | dz_pre | dnr) · W_hᵀ   (f32)
//
// h_prev is the forward pass's compute-dtype output (t−1 for the forward
// direction, t+1 for the backward one), read from global memory, so the
// recompute needs no exchange. The forward direction's BPTT walks
// t = T-1 … 0, the backward one's t = 0 … T-1. Layouts: gx / dgx (T, B, 3H);
// h_prev / dy / dnr (T, B, H); b_hn (H); W_h packed per block as for
// bigru_fwd_wide.cu (ops/wide_layout.py::pack_wh, (U, H, 3·Hb) a direction).
//
// What bounds it on the card: the recurrence's latency and W_h's size, as in
// the forward. The design is bilstm_bwd_wide.cu's, with three gates:
//   * the forward's cluster split (wide_common.cuh): one cluster of U <= 16
//     blocks per direction and tile of R rows, block b owning units b·Hb …
//     with all three gates and their H × NC slice of W_h, resident in shared
//     memory when it fits, else read through L2;
//   * the ONE slice serves both products: the recompute reads it by columns
//     (thread = column × k-slice, as the forward), dgh·W_hᵀ by rows; its
//     shared-memory row stride is an odd number of words;
//   * dh_carry sums over all 3H columns, which the blocks share out, so every
//     step ends in a reduce-scatter through distributed shared memory: block
//     b sums its NC columns for every k and writes row k's partial into slot
//     (b, k) of the block that owns unit k; after the cluster's one barrier a
//     step, each owner adds the U partials and its own dh·z (double
//     buffered);
//   * that product runs as (row k, column slice) work items, CS slices a row
//     (wide_common.cuh::wide_cs) whose adjacent lanes add their partials
//     with shuffles, so that H < NT leaves no threads idle where a split
//     shortens the round; the 768-thread launch bound leaves 80 registers a
//     thread for the prefetched operands;
//   * the recompute of gh for step s+1 needs no carry, so it runs in the same
//     phase as step s's dgh·W_hᵀ; h_prev of step s+1 and every gate operand
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
using percival::wide_cs;
using percival::wide_hs;
using percival::wide_kl;
using percival::wide_ws;
using percival::WidePlan;

constexpr int kGates = 3;
constexpr int kThreads = 768;  // ops/wide_layout.py::THREADS[3]

// Shared memory: s_hp (R × HS f32) | s_part (KS·R·NC f32) | s_dg (R·NC f32) |
// s_red (2 × U·R·Hb f32, U <= 16) | s_w (H × WS dt).
__host__ __device__ inline size_t bwd_hp_bytes(int R, int H) {
  return align16((size_t)R * wide_hs(H) * sizeof(float));
}
__host__ __device__ inline size_t bwd_part_bytes(int R, int NC, int KS) {
  return align16((size_t)KS * R * NC * sizeof(float));
}
__host__ __device__ inline size_t bwd_dg_bytes(int R, int NC) {
  return align16((size_t)R * NC * sizeof(float));
}
__host__ __device__ inline size_t bwd_base_bytes(int R, int H, int NC, int KS, int U) {
  return bwd_hp_bytes(R, H) + bwd_part_bytes(R, NC, KS) + bwd_dg_bytes(R, NC) +
         align16((size_t)2 * U * R * (NC / kGates) * sizeof(float));
}

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; block = NT threads.
template <typename T, int R, bool W_SMEM>
__global__ void __launch_bounds__(kThreads, 1) bigru_bwd_wide_kernel(
    const T* __restrict__ gx_f, const T* __restrict__ gx_b,
    const T* __restrict__ wp_f, const T* __restrict__ wp_b,
    const T* __restrict__ bn_f, const T* __restrict__ bn_b,
    const T* __restrict__ hp_f, const T* __restrict__ hp_b,
    const T* __restrict__ dy_f, const T* __restrict__ dy_b,
    T* __restrict__ dgx_f, T* __restrict__ dgx_b,
    T* __restrict__ dnr_f, T* __restrict__ dnr_b,
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
  const int nu = max(0, min(Hb, H - u0));
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int lane = tid & 31;

  const T* __restrict__ gx = backward ? gx_b : gx_f;
  const T* __restrict__ wp = (backward ? wp_b : wp_f) + (size_t)rank * H * NC;
  const T* __restrict__ hp = backward ? hp_b : hp_f;
  const T* __restrict__ dy = backward ? dy_b : dy_f;
  T* __restrict__ dgx = backward ? dgx_b : dgx_f;
  T* __restrict__ dnr_out = backward ? dnr_b : dnr_f;

  // BPTT step s visits frame t(s): descending for the forward direction
  auto frame = [=](int s) { return backward ? s : n_steps - 1 - s; };

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_hp = reinterpret_cast<float*>(smem);  // h_prev of the gh being recomputed, R × HS
  float* s_part = reinterpret_cast<float*>(smem + bwd_hp_bytes(R, H));
  float* s_dg = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_part) +
                                         bwd_part_bytes(R, NC, KS));
  float* s_red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_dg) +
                                          bwd_dg_bytes(R, NC));  // [2][U][R][Hb]
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
  for (int i = tid; i < R * NC; i += NT) s_dg[i] = 0.0f;     // columns past H stay 0

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
  const float bias = pair ? to_f32((backward ? bn_b : bn_f)[u0 + pu]) : 0.0f;
  auto unit_at = [&](const T* __restrict__ a, int t) -> float {
    return live ? to_f32(a[((size_t)t * B + prow) * H + u0 + pu]) : 0.0f;
  };
  float gxr[kGates], hp_cur, dy_cur;
  auto load_pair = [&](int t) {
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      gxr[g] = live ? to_f32(gx[((size_t)t * B + prow) * G + g * H + u0 + pu]) : 0.0f;
    hp_cur = unit_at(hp, t);
    dy_cur = unit_at(dy, t);
  };
  float dhz = 0.0f;  // dh·z of the previous step: the carry's direct path

  // dgh·W_hᵀ work items: (row k, column slice cs), CS adjacent lanes a row
  const int CS = wide_cs(H, NT, NC);
  const int CW = NC / CS;  // columns a slice, a multiple of 4
  const int items = H * CS;

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
  recompute();      // gh of step 0
  cluster.sync();   // every block running, its s_red zeroed; s_part complete

  for (int s = 0; s < n_steps; ++s) {
    const int t = frame(s);
    const bool more = s + 1 < n_steps;
    const float* red = s_red + (s & 1) * red_size;

    // ---- gate phase: d(gates) of this step; s_hp ← h_prev of step s+1 ----
    if (pair) {
      float gh[kGates];
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        float v = 0.0f;
        for (int j = 0; j < KS; ++j) v += s_part[(j * R + pr) * NC + g * Hb + pu];
        gh[g] = v;
      }
      float carry = dhz;
      for (int src = 0; src < U; ++src) carry += red[(src * R + pr) * Hb + pu];
      const float rg = sigmoid_f32(gxr[0] + gh[0]);
      const float zg = sigmoid_f32(gxr[1] + gh[1]);
      const float ghn = gh[2] + bias;
      const float ng = tanhf(gxr[2] + rg * ghn);
      const float dh = dy_cur + carry;
      const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
      const T dr = from_f32<T>(dn_pre * ghn * rg * (1.0f - rg));
      const T dz = from_f32<T>(dh * (hp_cur - ng) * zg * (1.0f - zg));
      const T dn = from_f32<T>(dn_pre);
      const T dnr = from_f32<T>(dn_pre * rg);
      float* dgr = s_dg + pr * NC + pu;
      dgr[0] = to_f32(dr);
      dgr[Hb] = to_f32(dz);
      dgr[2 * Hb] = to_f32(dnr);
      if (prow < B) {
        T* out = dgx + ((size_t)t * B + prow) * G + u0 + pu;
        out[0] = dr;
        out[H] = dz;
        out[2 * H] = dn;
        dnr_out[((size_t)t * B + prow) * H + u0 + pu] = dnr;
      }
      dhz = dh * zg;
    }
    if (more) {
      load_pair(frame(s + 1));
#pragma unroll
      for (int i = 0; i < kWidePrefetch; ++i) {
        store_hp(i, hp_next[i]);
        hp_next[i] = s + 2 < n_steps ? load_hp(frame(s + 2), i) : 0.0f;
      }
    }
    __syncthreads();  // s_dg and s_hp complete; every read of s_part done

    if (more) {
      // ---- dh partials of this block's columns, written to the owner of k ----
      float* next = s_red + ((s + 1) & 1) * red_size;
      for (int q0 = 0; q0 < items; q0 += NT) {  // whole warps run every round
        const int q = q0 + tid;
        const bool ok = q < items;
        const int k = q / CS;
        const int c0 = (q & (CS - 1)) * CW;
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        if (ok) {
          for (int c = c0; c < c0 + CW; c += 4) {
            const float w0 = w_at(k, c), w1 = w_at(k, c + 1), w2 = w_at(k, c + 2),
                        w3 = w_at(k, c + 3);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 d = *reinterpret_cast<const float4*>(s_dg + r * NC + c);
              acc[r] = fmaf(d.w, w3, fmaf(d.z, w2, fmaf(d.y, w1, fmaf(d.x, w0, acc[r]))));
            }
          }
        }
        for (int off = CS >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
        if (ok && (lane & (CS - 1)) == 0) {
          const int dst = k / Hb;
          float* slot = cluster.map_shared_rank(next, dst) + rank * R * Hb + (k - dst * Hb);
#pragma unroll
          for (int r = 0; r < R; ++r) slot[r * Hb] = acc[r];
        }
      }
      // ---- recompute gh for step s+1 (independent of the carry) ----
      recompute();
    }
    // the partials of every block written into their owners; s_part holds
    // step s+1's gh; every read of this step's s_red, s_dg and s_hp done
    cluster.sync();
  }
}

template <typename T>
const void* kernel_for(int R, bool w_smem) {
#define PERCIVAL_GRU_BWD_WIDE(RR)                                           \
  case RR:                                                                  \
    return w_smem ? (const void*)&bigru_bwd_wide_kernel<T, RR, true>        \
                  : (const void*)&bigru_bwd_wide_kernel<T, RR, false>;
  switch (R) {
    PERCIVAL_GRU_BWD_WIDE(1)
    PERCIVAL_GRU_BWD_WIDE(2)
    PERCIVAL_GRU_BWD_WIDE(4)
    PERCIVAL_GRU_BWD_WIDE(8)
    default: return nullptr;
  }
#undef PERCIVAL_GRU_BWD_WIDE
}

template <typename T>
cudaError_t plan_for(int B, int H, int Hb, int U, WidePlan* plan) {
  return percival::wide_plan(
      B, H, Hb, U, kGates, kThreads, (int)sizeof(T), true, kernel_for<T>,
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
// percival_bigru_fwd_wide_plan.
extern "C" int percival_bigru_bwd_wide_plan(int B, int H, int Hb, int U, int dtype, int* out) {
  WidePlan plan{};
  const cudaError_t err = plan_dtype(dtype, B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_plan_out(plan, out);
  return err;
}

// dtype: 0 = float32, 1 = bfloat16. Inputs in the order of
// _bigru_bwd_pallas: gx, W_h (packed per block, as for the forward), b_hn,
// h_prev, dy; then the outputs dgx and dnr; each as (forward direction,
// backward direction). No pointer may be null. Returns a cudaError_t.
extern "C" int percival_bigru_bwd_wide(const void* gx_f, const void* gx_b,
                                       const void* wp_f, const void* wp_b,
                                       const void* bn_f, const void* bn_b,
                                       const void* hp_f, const void* hp_b,
                                       const void* dy_f, const void* dy_b,
                                       void* dgx_f, void* dgx_b,
                                       void* dnr_f, void* dnr_b,
                                       int n_steps, int B, int H, int Hb, int U,
                                       int dtype, void* stream) {
  if (n_steps < 1 || U > kWideMaxCluster) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b,
                          dgx_f, dgx_b, dnr_f, dnr_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  WidePlan plan{};
  cudaError_t err = plan_dtype(dtype, B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  int KS = plan.KS;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&hp_f, (void*)&hp_b,
                  (void*)&dy_f, (void*)&dy_b, (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&dnr_f, (void*)&dnr_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&KS};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return percival::wide_launch(plan, B, kernel_for<float>, args, st);
  return percival::wide_launch(plan, B, kernel_for<__nv_bfloat16>, args, st);
}
