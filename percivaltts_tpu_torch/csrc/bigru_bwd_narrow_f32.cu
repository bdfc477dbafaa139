// Fused bidirectional GRU backward (BPTT) in f32 at the widths one block held
// before (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_gru_bwd_kernel
// (launched by _bigru_bwd_pallas, :616) on the route "narrow_f32"
// (ops/mma_layout.py::bwd_route): f32 up to H = 320, where bigru_bwd.cu ran
// before (it keeps bf16 widths off the tensor-core route). Same contract as
// bigru_bwd.cu in f32:
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
// the backward one). Layouts: gx / dgx (T, B, 3H); h_prev / dy / dnr
// (T, B, H); b_hn (H), all f32, H a multiple of 8 (the wrapper zero-pads the
// others); W_h packed per block (ops/narrow_f32_layout.py::pack_wh, (U, H, NCP)
// a direction).
//
// What bounds it on the card: as the LSTM's (bilstm_bwd_narrow_f32.cu), with
// 3H gate columns. bigru_bwd.cu held W_h (192 KiB at H = 128) in one block
// for one batch row and reduced each row of dz·W_hᵀ over a warp with five
// shuffle levels: 6.6 µs a step, ~4.3 µs of it that product (PERF.md).
// Here the LSTM's design (narrow_f32_common.cuh); the owner adds its own
// dh·z, then the U partial slots in block order, into the carry.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "narrow_f32_common.cuh"

namespace {

using percival::F32GruCell;
using percival::kNfThreads;
using percival::NarrowF32Plan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int R>
__global__ void __launch_bounds__(kNfThreads, 1) bigru_bwd_narrow_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ bn_f, const float* __restrict__ bn_b,
    const float* __restrict__ hp_f, const float* __restrict__ hp_b,
    const float* __restrict__ dy_f, const float* __restrict__ dy_b,
    float* __restrict__ dgx_f, float* __restrict__ dgx_b,
    float* __restrict__ dnr_f, float* __restrict__ dnr_b,
    int n_steps, int B, int H, int Hb, int NCP) {
  const bool backward = blockIdx.y == 1;
  const float* hp = backward ? hp_b : hp_f;
  F32GruCell cell{backward ? gx_b : gx_f, backward ? bn_b : bn_f, hp, backward ? dy_b : dy_f,
                  backward ? dgx_b : dgx_f, backward ? dnr_b : dnr_f, B, H};
  percival::narrow_f32_bptt<F32GruCell, R>(cell, backward ? wp_b : wp_f, hp, n_steps, B, H, Hb,
                                           NCP, backward);
}

const void* kernel_for(int R) {
  switch (R) {
    case 2: return (const void*)&bigru_bwd_narrow_f32_kernel<2>;
    case 4: return (const void*)&bigru_bwd_narrow_f32_kernel<4>;
    case 8: return (const void*)&bigru_bwd_narrow_f32_kernel<8>;
    case 16: return (const void*)&bigru_bwd_narrow_f32_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

// The plan of B rows at width H, into out[8], as
// percival_bilstm_bwd_narrow_f32_plan.
extern "C" int percival_bigru_bwd_narrow_f32_plan(int B, int H, int blocks, int rows,
                                                  int* out) {
  NarrowF32Plan plan{};
  const cudaError_t err = percival::narrow_f32_plan(B, H, 3, blocks, rows, kernel_for, &plan);
  if (err == cudaSuccess) percival::narrow_f32_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 8. Inputs in the order of _bigru_bwd_pallas: gx,
// W_h (packed per block for the plan of (B, H, U, R):
// ops/narrow_f32_layout.py::pack_wh), b_hn, h_prev, dy; then the outputs dgx
// and dnr; each as (forward direction, backward direction). W_h and h_prev
// 16-byte aligned, no pointer null. Returns a cudaError_t.
extern "C" int percival_bigru_bwd_narrow_f32(const void* gx_f, const void* gx_b,
                                             const void* wp_f, const void* wp_b,
                                             const void* bn_f, const void* bn_b,
                                             const void* hp_f, const void* hp_b,
                                             const void* dy_f, const void* dy_b,
                                             void* dgx_f, void* dgx_b,
                                             void* dnr_f, void* dnr_b,
                                             int n_steps, int B, int H, int Hb, int U, int R,
                                             void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, bn_f, bn_b, hp_f, hp_b, dy_f, dy_b,
                          dgx_f, dgx_b, dnr_f, dnr_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b, hp_f, hp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  NarrowF32Plan plan{};
  cudaError_t err = percival::narrow_f32_checked_plan(B, H, Hb, U, R, 3, kernel_for, &plan);
  if (err != cudaSuccess) return err;
  int NCP = plan.NCP;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&bn_f, (void*)&bn_b, (void*)&hp_f, (void*)&hp_b,
                  (void*)&dy_f, (void*)&dy_b, (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&dnr_f, (void*)&dnr_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&NCP};
  return percival::narrow_f32_launch(plan, B, kernel_for, args,
                                     static_cast<cudaStream_t>(stream));
}
