// Fused bidirectional GRU backward (BPTT) in f32 for widths one SM cannot
// hold (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_bwd_kernel
// (launched by _bigru_bwd_pallas, :616) on the route "wide_f32"
// (ops/mma_layout.py::bwd_route): f32 past H = 320 up to 512
// (ops/wide_f32_layout.py::fits), where bigru_bwd_wide.cu ran before; that
// kernel keeps f32 past 512 and bf16 past 672. Same contract as
// bigru_bwd_wide.cu:
//
//   gh   = h_prev[t] · W_h                       (gates recomputed)
//   r, z = σ(gx_r + gh_r), σ(gx_z + gh_z) ;  ghn = gh_n + b_hn ;  n = tanh(gx_n + r·ghn)
//   dh   = dy[t] + dh_carry
//   dn_pre = dh·(1 − z)·(1 − n²) ;  dr_pre = dn_pre·ghn·r(1 − r)
//   dz_pre = dh·(h_prev − n)·z(1 − z) ;  dnr = dn_pre·r
//   dgx[t] = dr_pre | dz_pre | dn_pre ;  dnr_out[t] = dnr
//   dh_carry = dh·z + (dr_pre | dz_pre | dnr) · W_hᵀ
//
// h_prev is the forward pass's output (t−1 for the forward direction, t+1 for
// the backward one). The forward direction's BPTT walks t = T-1 … 0, the
// backward one's t = 0 … T-1. Layouts: gx / dgx (T, B, 3H); h_prev / dy / dnr
// (T, B, H); b_hn (H), all f32, H a multiple of 32 (the wrapper zero-pads the
// others); W_h packed per block (ops/wide_layout.py::pack_wh, (U, H, 3·Hb) a
// direction).
//
// What bounds it on the card: a step's two products over the block's W_h
// slice, 2·R·H·3Hb FMAs, on the chain through the cluster.
// bigru_bwd_wide.cu kept its f32 slice resident (194 KiB at H = 512), which
// left room for 2 batch rows a cluster: 23 waves of clusters at B = 160
// (PERF.md, its kernel table). Here the LSTM's design (wide_f32_common.cuh): 64-row
// chunks of the slice, as many resident as fit beside up to 24 rows, the
// rest streamed through three ring slots two chunks ahead; each chunk feeds both
// products, on CUDA cores in f32; the owner adds its own dh·z, then the U
// partial slots in block order, into the carry. At B <= 8 the launcher takes
// the few-row kernels instead (wide_f32_few.cuh, as the LSTM's).

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "wide_f32_common.cuh"
#include "wide_f32_few.cuh"

namespace {

using percival::F32GruCell;
using percival::kWfThreads;
using percival::WideF32Plan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 384 threads;
// R = 8·NT rows a cluster.
template <int NT>
__global__ void __launch_bounds__(kWfThreads, 1) bigru_bwd_wide_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ bn_f, const float* __restrict__ bn_b,
    const float* __restrict__ hp_f, const float* __restrict__ hp_b,
    const float* __restrict__ dy_f, const float* __restrict__ dy_b,
    float* __restrict__ dgx_f, float* __restrict__ dgx_b,
    float* __restrict__ dnr_f, float* __restrict__ dnr_b,
    int n_steps, int B, int H, int Hb, int nres) {
  const bool backward = blockIdx.y == 1;
  const float* hp = backward ? hp_b : hp_f;
  F32GruCell cell{backward ? gx_b : gx_f, backward ? bn_b : bn_f, hp, backward ? dy_b : dy_f,
               backward ? dgx_b : dgx_f, backward ? dnr_b : dnr_f, B, H};
  percival::wide_f32_bptt<F32GruCell, NT>(cell, backward ? wp_b : wp_f, hp, n_steps, B, H, Hb,
                                       nres, backward);
}

// The few-row plan's kernel (wide_f32_few.cuh): 4·NC threads, R rows a
// cluster; nres unused.
template <int NC, int R>
__global__ void __launch_bounds__(percival::wfr_threads(NC), 1) bigru_bwd_wide_f32_few_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ bn_f, const float* __restrict__ bn_b,
    const float* __restrict__ hp_f, const float* __restrict__ hp_b,
    const float* __restrict__ dy_f, const float* __restrict__ dy_b,
    float* __restrict__ dgx_f, float* __restrict__ dgx_b,
    float* __restrict__ dnr_f, float* __restrict__ dnr_b,
    int n_steps, int B, int H, int Hb, int) {
  const bool backward = blockIdx.y == 1;
  const float* hp = backward ? hp_b : hp_f;
  F32GruCell cell{backward ? gx_b : gx_f, backward ? bn_b : bn_f, hp, backward ? dy_b : dy_f,
               backward ? dgx_b : dgx_f, backward ? dnr_b : dnr_f, B, H};
  percival::wide_f32_few<F32GruCell, NC, R>(cell, backward ? wp_b : wp_f, hp, n_steps, B, H, Hb,
                                            backward);
}

const void* kernel_for(int NT) {
  switch (NT) {
    case 1: return (const void*)&bigru_bwd_wide_f32_kernel<1>;
    case 2: return (const void*)&bigru_bwd_wide_f32_kernel<2>;
    case 3: return (const void*)&bigru_bwd_wide_f32_kernel<3>;
    default: return nullptr;
  }
}

// NC = 96: every GRU width of the route (Hb = 32)
const void* few_for(int NC, int R) {
  switch (NC * 8 + R) {
    case 96 * 8 + 1: return (const void*)&bigru_bwd_wide_f32_few_kernel<96, 1>;
    case 96 * 8 + 2: return (const void*)&bigru_bwd_wide_f32_few_kernel<96, 2>;
    case 96 * 8 + 4: return (const void*)&bigru_bwd_wide_f32_few_kernel<96, 4>;
    default: return nullptr;
  }
}

cudaError_t plan_for(int B, int H, int Hb, int U, int rows, WideF32Plan* plan) {
  return percival::wide_f32_bwd_plan(B, H, Hb, U, 3, rows, kernel_for, few_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U, rows) takes, into out[9], as
// percival_bilstm_bwd_wide_f32_plan.
extern "C" int percival_bigru_bwd_wide_f32_plan(int B, int H, int Hb, int U, int rows,
                                                  int* out) {
  WideF32Plan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err == cudaSuccess) percival::wide_f32_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 32. Inputs in the order of _bigru_bwd_pallas: gx,
// W_h (packed per block, ops/wide_layout.py::pack_wh), b_hn, h_prev, dy; then
// the outputs dgx and dnr; each as (forward direction, backward direction).
// h_prev 16-byte aligned, no pointer null. Returns a cudaError_t.
extern "C" int percival_bigru_bwd_wide_f32(const void* gx_f, const void* gx_b,
                                           const void* wp_f, const void* wp_b,
                                           const void* bn_f, const void* bn_b,
                                           const void* hp_f, const void* hp_b,
                                           const void* dy_f, const void* dy_b,
                                           void* dgx_f, void* dgx_b,
                                           void* dnr_f, void* dnr_b,
                                           int n_steps, int B, int H, int Hb, int U,
                                           int rows, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b,
                          dgx_f, dgx_b, dnr_f, dnr_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b, hp_f, hp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideF32Plan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err != cudaSuccess) return err;
  int nres = plan.nres;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&hp_f, (void*)&hp_b,
                  (void*)&dy_f, (void*)&dy_b, (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&dnr_f, (void*)&dnr_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&nres};
  return percival::wide_f32_bwd_launch(plan, B, kernel_for, few_for, args,
                                       static_cast<cudaStream_t>(stream));
}
