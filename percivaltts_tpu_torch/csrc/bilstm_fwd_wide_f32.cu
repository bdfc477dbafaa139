// Fused bidirectional LSTM forward in f32 for widths one SM cannot hold
// (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_fwd_kernel
// (launched by _bilstm_fwd_pallas, :202) on the route "wide_f32"
// (ops/mma_layout.py::fwd_route): f32 past H = 256 up to 512
// (ops/wide_f32_layout.py::fits), where bilstm_fwd_wide.cu ran before; that
// kernel keeps f32 past 512 and bf16 past 608. Same contract as
// bilstm_fwd_wide.cu in f32:
//
//   z   = gx[t] + h · W_h ;  i, f, g, o = σ(z_i), σ(z_f), tanh(z_g), σ(z_o)
//   c   = f·c + i·g ;  h = o·tanh(c)        (h, c carried in f32)
//   y[t] = h ;  c_out[t] = c                 (c_out only when asked)
//
// the backward direction walking t = T-1 … 0 over the same arrays. Layouts:
// gx (T, B, 4H); y / c_out (T, B, H), all f32, H a multiple of 32 (the
// wrapper zero-pads the others, which is exact); W_h packed per block
// (ops/wide_layout.py::pack_wh, (U, H, 4·Hb) a direction).
//
// What bounds it on the card: the chain of T dependent steps, each a
// (R × H) · (H × 4·Hb) product a block on CUDA cores (R·H·NC FMAs, 524,288
// at R = 8, H = 512: ~4,100 clocks on an SM's 128 f32 lanes), then the
// exchange of h through the cluster. bilstm_fwd_wide.cu could not hold its
// f32 slice (256 KiB at H = 512) beside the rows, so it read W_h through L2
// at every step, for at most 8 rows, one column and k-slice a thread, the slices
// meeting in shared memory behind a __syncthreads and a full cluster barrier
// a step: 8.2 µs a step at B = 8 (PERF.md, its kernel table). Here
// (wide_f32_fwd.cuh) the slice stays on chip, in shared memory and, for
// the chunks that do not fit there (3 of 8 at H = 512), in registers, and
// each step reads it once for the cluster's 8 or 4 rows; all 8 warps run
// the product, a lane 8 columns × R rows over one k-quad of each chunk; h goes
// into every block's shared memory by st.async, counted by the receiving
// block's mbarrier, so a block waits for its data and no cluster barrier
// runs in the loop. No atomics, no allocation, PyTorch's stream; the
// launcher returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "wide_f32_fwd.cuh"

namespace {

using percival::F32LstmFwdCell;
using percival::wff_threads;
using percival::WideF32FwdPlan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x;
// wff_threads(NC) threads; R rows a cluster; the first NREG of the slice's
// NCH chunks in registers.
template <int NC, int NREG, int NCH, int R>
__global__ void __launch_bounds__(wff_threads(NC), 1) bilstm_fwd_wide_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    float* __restrict__ y_f, float* __restrict__ y_b,
    float* __restrict__ c_f, float* __restrict__ c_b,
    int n_steps, int B, int H) {
  const bool backward = blockIdx.y == 1;
  F32LstmFwdCell cell{backward ? gx_b : gx_f, backward ? y_b : y_f, backward ? c_b : c_f, B, H};
  percival::wide_f32_fwd<F32LstmFwdCell, NC, NREG, NCH, R>(cell, backward ? wp_b : wp_f, n_steps, B,
                                                    H, backward);
}

// NC = 4·Hb: 128 (Hb = 32, H > 384) or 96 (Hb = 24)
// the (NC = 4·Hb, chunks in registers, chunks, rows) of the route's widths
// (ops/wide_f32_layout.py::fwd_rows): NC 96 (Hb = 24) at H <= 384, every
// chunk in shared memory (5 at H 288 / 320, 6 at 352 / 384); NC 128 past
// it, of 7 chunks (H 416 / 448) 2 in registers at R = 8 and 1 at R = 4, of
// 8 (H 480 / 512) 3 and 2
const void* kernel_for(int NC, int nreg, int nch, int R) {
#define PERCIVAL_FWD_WIDE_F32(C, G, N, RR)                                        \
  if (NC == C && nreg == G && nch == N && R == RR)                                \
    return (const void*)&bilstm_fwd_wide_f32_kernel<C, G, N, RR>;
  PERCIVAL_FWD_WIDE_F32(96, 0, 5, 8)
  PERCIVAL_FWD_WIDE_F32(96, 0, 6, 8)
  PERCIVAL_FWD_WIDE_F32(128, 2, 7, 8)
  PERCIVAL_FWD_WIDE_F32(128, 3, 8, 8)
  PERCIVAL_FWD_WIDE_F32(96, 0, 5, 4)
  PERCIVAL_FWD_WIDE_F32(96, 0, 6, 4)
  PERCIVAL_FWD_WIDE_F32(128, 1, 7, 4)
  PERCIVAL_FWD_WIDE_F32(128, 2, 8, 4)
#undef PERCIVAL_FWD_WIDE_F32
  return nullptr;
}

cudaError_t plan_for(int B, int H, int Hb, int U, WideF32FwdPlan* plan) {
  return percival::wide_f32_fwd_plan(B, H, Hb, U, 4, kernel_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes, into out[9]: U, Hb, NC, R,
// chunks resident in shared memory, chunks in registers, clusters at once,
// waves, shared memory a block.
extern "C" int percival_bilstm_fwd_wide_f32_plan(int B, int H, int Hb, int U, int* out) {
  WideF32FwdPlan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err == cudaSuccess) percival::wide_f32_fwd_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 32. Inputs in the order of _bilstm_fwd_pallas:
// gx, W_h (packed per block, ops/wide_layout.py::pack_wh), each as (forward
// direction, backward direction); then y, and c (both null when the cells
// are not wanted). W_h 16-byte aligned. Returns a cudaError_t.
extern "C" int percival_bilstm_fwd_wide_f32(const void* gx_f, const void* gx_b,
                                            const void* wp_f, const void* wp_b,
                                            void* y_f, void* y_b, void* c_f, void* c_b,
                                            int n_steps, int B, int H, int Hb, int U,
                                            void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  for (const void* ptr : {gx_f, gx_b, wp_f, wp_b, (const void*)y_f, (const void*)y_b})
    if (ptr == nullptr) return cudaErrorInvalidValue;
  if ((c_f == nullptr) != (c_b == nullptr)) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideF32FwdPlan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, &plan);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&y_f,  (void*)&y_b,  (void*)&c_f,  (void*)&c_b,
                  (void*)&n_steps, (void*)&B, (void*)&H};
  return percival::wide_f32_fwd_launch(plan, B, kernel_for, args,
                                       static_cast<cudaStream_t>(stream));
}
