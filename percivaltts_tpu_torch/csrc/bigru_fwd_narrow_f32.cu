// Fused bidirectional GRU forward in f32 at the widths one block held before
// (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_fwd_kernel
// (launched by _bigru_fwd_pallas, :521) on the route "narrow_f32"
// (ops/mma_layout.py::fwd_route): f32 up to H = 320, where bigru_fwd.cu ran
// before (it keeps bf16 widths off the tensor-core route). Same contract as
// bigru_fwd.cu in f32 (flax GRUCell, gate order r, z, n):
//
//   gh  = h · W_h ;  r = σ(gx_r + gh_r) ;  z = σ(gx_z + gh_z)
//   n   = tanh(gx_n + r·(gh_n + b_hn)) ;  h = (1 − z)·n + z·h   (h in f32)
//   y[t] = h
//
// the backward direction walking t = T-1 … 0 over the same arrays. Layouts:
// gx (T, B, 3H); b_hn (H); y (T, B, H), all f32, H a multiple of 8 (the
// wrapper zero-pads the others, which is exact); W_h packed per block
// (ops/narrow_f32_layout.py::pack_wh, (U, H, NCP) a direction).
//
// What bounds it on the card: as the LSTM's (bilstm_fwd_narrow_f32.cu), with
// 3H gate columns. bigru_fwd.cu held W_h (192 KiB at H = 128) in one block,
// but for one batch row, one thread a gate column with a serial k loop:
// 1.9 µs a step, ~1.4 of it the product (PERF.md). Here the LSTM's design
// (narrow_f32_fwd.cuh); at H = 128 the whole f32 W_h fits one block beside
// R <= 8 rows, and a cluster of one needs no cluster barrier.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "narrow_f32_fwd.cuh"

namespace {

using percival::F32GruFwdCell;
using percival::kNfThreads;
using percival::NarrowF32Plan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int R>
__global__ void __launch_bounds__(kNfThreads, 1) bigru_fwd_narrow_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ bn_f, const float* __restrict__ bn_b,
    float* __restrict__ y_f, float* __restrict__ y_b,
    int n_steps, int B, int H, int Hb, int NCP) {
  const bool backward = blockIdx.y == 1;
  F32GruFwdCell cell{backward ? gx_b : gx_f, backward ? bn_b : bn_f, backward ? y_b : y_f, B, H};
  percival::narrow_f32_fwd<F32GruFwdCell, R>(cell, backward ? wp_b : wp_f, n_steps, B, H, Hb,
                                             NCP, backward);
}

// W_h in registers: grid = (ceil(B / R), 2 directions), 4H threads, H = 16·KQ.
template <int KQ, int R>
__global__ void __launch_bounds__(kNfThreads, 1) bigru_fwd_narrow_f32_reg_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ bn_f, const float* __restrict__ bn_b,
    float* __restrict__ y_f, float* __restrict__ y_b,
    int n_steps, int B, int H, int Hb, int NCP) {
  const bool backward = blockIdx.y == 1;
  F32GruFwdCell cell{backward ? gx_b : gx_f, backward ? bn_b : bn_f, backward ? y_b : y_f, B, H};
  percival::narrow_f32_fwd_reg<F32GruFwdCell, KQ, R>(cell, backward ? wp_b : wp_f, n_steps, B,
                                                     NCP, backward);
}

const void* kernel_for(int R) {
  switch (R) {
    case 2: return (const void*)&bigru_fwd_narrow_f32_kernel<2>;
    case 4: return (const void*)&bigru_fwd_narrow_f32_kernel<4>;
    case 8: return (const void*)&bigru_fwd_narrow_f32_kernel<8>;
    case 16: return (const void*)&bigru_fwd_narrow_f32_kernel<16>;
    default: return nullptr;
  }
}

const void* reg_kernel_for(int H, int R) {
  if (H % 16 || (R != 1 && R != 2)) return nullptr;
  switch (H / 16) {
    case 1: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<1, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<1, 2>;
    case 2: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<2, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<2, 2>;
    case 3: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<3, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<3, 2>;
    case 4: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<4, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<4, 2>;
    case 5: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<5, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<5, 2>;
    case 6: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<6, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<6, 2>;
    case 7: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<7, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<7, 2>;
    case 8: return R == 1 ? (const void*)&bigru_fwd_narrow_f32_reg_kernel<8, 1> : (const void*)&bigru_fwd_narrow_f32_reg_kernel<8, 2>;
    default: return nullptr;
  }
}

}  // namespace

// The forward's plan of B rows at width H, into out[9], as
// percival_bilstm_fwd_narrow_f32_plan.
extern "C" int percival_bigru_fwd_narrow_f32_plan(int B, int H, int blocks, int rows,
                                                  int resident, int* out) {
  NarrowF32Plan plan{};
  const cudaError_t err = percival::narrow_f32_fwd_plan(B, H, 3, blocks, rows, resident,
                                                        kernel_for, reg_kernel_for, &plan);
  if (err == cudaSuccess) percival::narrow_f32_fwd_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 8. Inputs in the order of _bigru_fwd_pallas: gx,
// W_h (packed per block for the forward's plan of (B, H, U, R):
// ops/narrow_f32_layout.py::pack_wh; where it stays in registers, W_h
// itself, (H, 3H)), b_hn, each as (forward direction,
// backward direction); then y; then the plan's U, R and resident. W_h
// 16-byte aligned, no pointer null. Returns a cudaError_t.
extern "C" int percival_bigru_fwd_narrow_f32(const void* gx_f, const void* gx_b,
                                             const void* wp_f, const void* wp_b,
                                             const void* bn_f, const void* bn_b,
                                             void* y_f, void* y_b,
                                             int n_steps, int B, int H, int Hb, int U, int R,
                                             int resident, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  for (const void* ptr : {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, (const void*)y_f, (const void*)y_b})
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  // the resident kernel reads W_h itself: row stride 3H
  int NCP = resident ? 3 * Hb
                     : (3 * Hb + percival::kNfCols - 1) / percival::kNfCols * percival::kNfCols;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&y_f,  (void*)&y_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&NCP};
  return percival::narrow_f32_fwd_launch(B, H, Hb, U, R, resident, 3, kernel_for, reg_kernel_for,
                                         args, static_cast<cudaStream_t>(stream));
}
