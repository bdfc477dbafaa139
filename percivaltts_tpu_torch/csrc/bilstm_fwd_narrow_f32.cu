// Fused bidirectional LSTM forward in f32 at the widths one block held
// before (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_fwd_kernel
// (launched by _bilstm_fwd_pallas, :202) on the route "narrow_f32"
// (ops/mma_layout.py::fwd_route): f32 up to H = 256, where bilstm_fwd.cu ran
// before (it keeps bf16 widths off the tensor-core route). Same contract as
// bilstm_fwd.cu in f32:
//
//   z   = gx[t] + h · W_h ;  i, f, g, o = σ(z_i), σ(z_f), tanh(z_g), σ(z_o)
//   c   = f·c + i·g ;  h = o·tanh(c)        (h, c carried in f32)
//   y[t] = h ;  c_out[t] = c                 (c_out only when asked)
//
// the backward direction walking t = T-1 … 0 over the same arrays. Layouts:
// gx (T, B, 4H); y / c_out (T, B, H), all f32, H a multiple of 8 (the
// wrapper zero-pads the others, which is exact); W_h packed per block
// (ops/narrow_f32_layout.py::pack_wh, (U, H, NCP) a direction).
//
// What bounds it on the card: the chain of T dependent steps, each a
// (R × H) · (H × 4H) product on CUDA cores and the gate math, not FLOPs or
// bytes. bilstm_fwd.cu ran one block a direction and batch row; its f32 W_h
// (256 KiB at H = 128) was past a block's 227 KB, so every block read it
// through L1/L2 at every step for one row: 6.2 µs a step, 5.6 of it the
// product (PERF.md). Here (narrow_f32_fwd.cuh) W_h's slice stays in the
// shared memory of a cluster of U >= 2 blocks (at H = 128) and each step
// reads it once for the cluster's R rows; h meets in every block's shared
// memory through distributed shared memory behind one split cluster barrier
// a step.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "narrow_f32_fwd.cuh"

namespace {

using percival::F32LstmFwdCell;
using percival::kNfThreads;
using percival::NarrowF32Plan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int R>
__global__ void __launch_bounds__(kNfThreads, 1) bilstm_fwd_narrow_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    float* __restrict__ y_f, float* __restrict__ y_b,
    float* __restrict__ c_f, float* __restrict__ c_b,
    int n_steps, int B, int H, int Hb, int NCP) {
  const bool backward = blockIdx.y == 1;
  F32LstmFwdCell cell{backward ? gx_b : gx_f, backward ? y_b : y_f, backward ? c_b : c_f, B, H};
  percival::narrow_f32_fwd<F32LstmFwdCell, R>(cell, backward ? wp_b : wp_f, n_steps, B, H, Hb,
                                              NCP, backward);
}

// W_h in registers: grid = (ceil(B / R), 2 directions), 4H threads, H = 16·KQ.
template <int KQ, int R>
__global__ void __launch_bounds__(kNfThreads, 1) bilstm_fwd_narrow_f32_reg_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    float* __restrict__ y_f, float* __restrict__ y_b,
    float* __restrict__ c_f, float* __restrict__ c_b,
    int n_steps, int B, int H, int Hb, int NCP) {
  const bool backward = blockIdx.y == 1;
  F32LstmFwdCell cell{backward ? gx_b : gx_f, backward ? y_b : y_f, backward ? c_b : c_f, B, H};
  percival::narrow_f32_fwd_reg<F32LstmFwdCell, KQ, R>(cell, backward ? wp_b : wp_f, n_steps, B,
                                                      NCP, backward);
}

const void* kernel_for(int R) {
  switch (R) {
    case 2: return (const void*)&bilstm_fwd_narrow_f32_kernel<2>;
    case 4: return (const void*)&bilstm_fwd_narrow_f32_kernel<4>;
    case 8: return (const void*)&bilstm_fwd_narrow_f32_kernel<8>;
    case 16: return (const void*)&bilstm_fwd_narrow_f32_kernel<16>;
    default: return nullptr;
  }
}

const void* reg_kernel_for(int H, int R) {
  if (H % 16 || (R != 1 && R != 2)) return nullptr;
  switch (H / 16) {
    case 1: return R == 1 ? (const void*)&bilstm_fwd_narrow_f32_reg_kernel<1, 1> : (const void*)&bilstm_fwd_narrow_f32_reg_kernel<1, 2>;
    case 2: return R == 1 ? (const void*)&bilstm_fwd_narrow_f32_reg_kernel<2, 1> : (const void*)&bilstm_fwd_narrow_f32_reg_kernel<2, 2>;
    case 3: return R == 1 ? (const void*)&bilstm_fwd_narrow_f32_reg_kernel<3, 1> : (const void*)&bilstm_fwd_narrow_f32_reg_kernel<3, 2>;
    case 4: return R == 1 ? (const void*)&bilstm_fwd_narrow_f32_reg_kernel<4, 1> : (const void*)&bilstm_fwd_narrow_f32_reg_kernel<4, 2>;
    case 5: return R == 1 ? (const void*)&bilstm_fwd_narrow_f32_reg_kernel<5, 1> : (const void*)&bilstm_fwd_narrow_f32_reg_kernel<5, 2>;
    case 6: return R == 1 ? (const void*)&bilstm_fwd_narrow_f32_reg_kernel<6, 1> : (const void*)&bilstm_fwd_narrow_f32_reg_kernel<6, 2>;
    default: return nullptr;
  }
}

}  // namespace

// The forward's plan of B rows at width H (a multiple of 8), into out[9]:
// U, Hb, NC, NCP, R, clusters at once, waves, shared memory a block, and
// resident (1: W_h in registers). blocks / rows > 0 force that cluster size /
// those rows (0: the plan's choice), resident >= 0 that kind (-1: either).
extern "C" int percival_bilstm_fwd_narrow_f32_plan(int B, int H, int blocks, int rows,
                                                   int resident, int* out) {
  NarrowF32Plan plan{};
  const cudaError_t err = percival::narrow_f32_fwd_plan(B, H, 4, blocks, rows, resident,
                                                        kernel_for, reg_kernel_for, &plan);
  if (err == cudaSuccess) percival::narrow_f32_fwd_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 8. Inputs in the order of _bilstm_fwd_pallas:
// gx, W_h (packed per block for the forward's plan of (B, H, U, R):
// ops/narrow_f32_layout.py::pack_wh; where it stays in registers, W_h
// itself, (H, 4H)), each as (forward direction, backward direction); then y, and c (both null when the cells are not wanted); then
// the plan's U, R and resident. W_h 16-byte aligned. Returns a cudaError_t.
extern "C" int percival_bilstm_fwd_narrow_f32(const void* gx_f, const void* gx_b,
                                              const void* wp_f, const void* wp_b,
                                              void* y_f, void* y_b, void* c_f, void* c_b,
                                              int n_steps, int B, int H, int Hb, int U, int R,
                                              int resident, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  for (const void* ptr : {gx_f, gx_b, wp_f, wp_b, (const void*)y_f, (const void*)y_b})
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if ((c_f == nullptr) != (c_b == nullptr)) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  // the resident kernel reads W_h itself (one block's packing is the identity
  // but for the padding columns): row stride 4H
  int NCP = resident ? 4 * Hb
                     : (4 * Hb + percival::kNfCols - 1) / percival::kNfCols * percival::kNfCols;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&y_f,  (void*)&y_b,  (void*)&c_f,  (void*)&c_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&NCP};
  return percival::narrow_f32_fwd_launch(B, H, Hb, U, R, resident, 4, kernel_for, reg_kernel_for,
                                         args, static_cast<cudaStream_t>(stream));
}
