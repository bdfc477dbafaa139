// Fused bidirectional GRU forward in f32 for widths one SM cannot hold
// (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas, :521) on the route "wide_f32"
// (ops/mma_layout.py::fwd_route): f32 past H = 320 up to 512
// (ops/wide_f32_layout.py::fits), where bigru_fwd_wide.cu ran before; that
// kernel keeps f32 past 512 and bf16 past 672. Same contract as
// bigru_fwd_wide.cu in f32 (flax GRUCell, gate order r, z, n):
//
//   gh  = h · W_h ;  r = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n   = tanh(gx_n + r·(gh_n + b_hn)) ;  h = (1 − z)·n + z·h   (h in f32)
//   y[t] = h
//
// the backward direction walking t = T-1 … 0 over the same arrays. Layouts:
// gx (T, B, 3H); b_hn (H); y (T, B, H), all f32, H a multiple of 32 (the
// wrapper zero-pads the others, which is exact); W_h packed per block
// (ops/wide_layout.py::pack_wh, (U, H, 3·Hb) a direction).
//
// What bounds it on the card: as the LSTM's (bilstm_fwd_wide_f32.cu), with
// 3·Hb gate columns a block: 393,216 FMAs a step at R = 8, H = 512. bigru_fwd_wide.cu
// read its f32 slice (192 KiB at H = 512) through L2 at every step for at
// most 8 rows: 5.5 µs a step at B = 8 (PERF.md). Here the LSTM's design
// (wide_f32_fwd.cuh) on 12 warps, a lane 4 columns × R rows: at H = 512 and
// R = 8, 7 of the 8 chunks of the slice in shared memory and one in
// registers; at R = 4 all 8 in shared memory.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "wide_f32_fwd.cuh"

namespace {

using percival::F32GruFwdCell;
using percival::wff_threads;
using percival::WideF32FwdPlan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x;
// wff_threads(NC) threads; R rows a cluster; the first NREG of the slice's
// NCH chunks in registers.
template <int NC, int NREG, int NCH, int R>
__global__ void __launch_bounds__(wff_threads(NC), 1) bigru_fwd_wide_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ bn_f, const float* __restrict__ bn_b,
    float* __restrict__ y_f, float* __restrict__ y_b,
    int n_steps, int B, int H) {
  const bool backward = blockIdx.y == 1;
  F32GruFwdCell cell{backward ? gx_b : gx_f, backward ? bn_b : bn_f, backward ? y_b : y_f, B, H};
  percival::wide_f32_fwd<F32GruFwdCell, NC, NREG, NCH, R>(cell, backward ? wp_b : wp_f, n_steps, B,
                                                    H, backward);
}

// NC = 3·Hb = 96: Hb is 32 at every width of the route
// the (NC = 3·Hb, chunks in registers, chunks, rows) of the route's widths
// (ops/wide_f32_layout.py::fwd_rows): Hb is 32, NC 96, at every width; every
// chunk in shared memory at H <= 448 (6 at 352 / 384, 7 at 416 / 448) and at
// R = 4, 1 of 8 in registers at H 480 / 512 and R = 8
const void* kernel_for(int NC, int nreg, int nch, int R) {
#define PERCIVAL_GRU_FWD_WIDE_F32(C, G, N, RR)                                    \
  if (NC == C && nreg == G && nch == N && R == RR)                                \
    return (const void*)&bigru_fwd_wide_f32_kernel<C, G, N, RR>;
  PERCIVAL_GRU_FWD_WIDE_F32(96, 0, 6, 8)
  PERCIVAL_GRU_FWD_WIDE_F32(96, 0, 7, 8)
  PERCIVAL_GRU_FWD_WIDE_F32(96, 1, 8, 8)
  PERCIVAL_GRU_FWD_WIDE_F32(96, 0, 6, 4)
  PERCIVAL_GRU_FWD_WIDE_F32(96, 0, 7, 4)
  PERCIVAL_GRU_FWD_WIDE_F32(96, 0, 8, 4)
#undef PERCIVAL_GRU_FWD_WIDE_F32
  return nullptr;
}

cudaError_t plan_for(int B, int H, int Hb, int U, WideF32FwdPlan* plan) {
  return percival::wide_f32_fwd_plan(B, H, Hb, U, 3, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes, into out[9], as
// percival_bilstm_fwd_wide_f32_plan.
extern "C" int percival_bigru_fwd_wide_f32_plan(int B, int H, int Hb, int U, int* out) {
  WideF32FwdPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_f32_fwd_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 32. Inputs in the order of _bigru_fwd_pallas:
// gx, W_h (packed per block, ops/wide_layout.py::pack_wh), b_hn, each as
// (forward direction, backward direction); then y. W_h 16-byte aligned, no
// pointer null. Returns a cudaError_t.
extern "C" int percival_bigru_fwd_wide_f32(const void* gx_f, const void* gx_b,
                                           const void* wp_f, const void* wp_b,
                                           const void* bn_f, const void* bn_b,
                                           void* y_f, void* y_b,
                                           int n_steps, int B, int H, int Hb, int U,
                                           void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  for (const void* ptr : {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, (const void*)y_f, (const void*)y_b})
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideF32FwdPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&y_f,  (void*)&y_b,
                  (void*)&n_steps, (void*)&B, (void*)&H};
  return percival::wide_f32_fwd_launch(plan, B, kernel_for, args,
                                       static_cast<cudaStream_t>(stream));
}
