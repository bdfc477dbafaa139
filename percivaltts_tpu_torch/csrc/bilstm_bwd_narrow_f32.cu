// Fused bidirectional LSTM backward (BPTT) in f32 at the widths one block
// held before (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas, :321) on the route "narrow_f32"
// (ops/mma_layout.py::bwd_route): f32 up to H = 256, where bilstm_bwd.cu ran
// before (it keeps bf16 widths off the tensor-core route). Same contract as
// bilstm_bwd.cu in f32:
//
//   z    = gx[t] + h_prev[t] · W_h                  (gates recomputed)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o)
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ ;  dc_carry = dc·f
//
// the forward direction's BPTT walking t = T-1 … 0, the backward one's
// t = 0 … T-1. Layouts: gx / dgx (T, B, 4H); h_prev / c_prev / c / dy
// (T, B, H), all f32, H a multiple of 8 (the wrapper zero-pads the others,
// which is exact); W_h packed per block (ops/narrow_f32_layout.py::pack_wh,
// (U, H, NCP) a direction).
//
// What bounds it on the card: a step's two products, 2·R·H·4H FMAs a cluster,
// and the chain from one step's dz to the next step's dh through the cluster.
// bilstm_bwd.cu ran one block a direction and batch row; at H = 128 its f32
// W_h (256 KiB) was past a block's 227 KB, so both products read it through
// L2, for one row: 22.6 µs a step, ~15 µs of it the two products
// (PERF.md). Here (narrow_f32_common.cuh) W_h's slice stays in the shared
// memory of a cluster of U blocks and each step reads it once for the
// cluster's R rows; the dz·W_hᵀ partials meet in their owners' slots through
// distributed shared memory behind one split cluster barrier a step, whose
// wait the next step's recompute hides; both products on CUDA cores in f32.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "narrow_f32_common.cuh"

namespace {

using percival::F32LstmCell;
using percival::kNfThreads;
using percival::NarrowF32Plan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 512 threads.
template <int R>
__global__ void __launch_bounds__(kNfThreads, 1) bilstm_bwd_narrow_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ hp_f, const float* __restrict__ hp_b,
    const float* __restrict__ cp_f, const float* __restrict__ cp_b,
    const float* __restrict__ c_f, const float* __restrict__ c_b,
    const float* __restrict__ dy_f, const float* __restrict__ dy_b,
    float* __restrict__ dgx_f, float* __restrict__ dgx_b,
    int n_steps, int B, int H, int Hb, int NCP) {
  const bool backward = blockIdx.y == 1;
  F32LstmCell cell{backward ? gx_b : gx_f, backward ? cp_b : cp_f, backward ? c_b : c_f,
                   backward ? dy_b : dy_f, backward ? dgx_b : dgx_f, B, H};
  percival::narrow_f32_bptt<F32LstmCell, R>(cell, backward ? wp_b : wp_f,
                                            backward ? hp_b : hp_f, n_steps, B, H, Hb, NCP,
                                            backward);
}

const void* kernel_for(int R) {
  switch (R) {
    case 2: return (const void*)&bilstm_bwd_narrow_f32_kernel<2>;
    case 4: return (const void*)&bilstm_bwd_narrow_f32_kernel<4>;
    case 8: return (const void*)&bilstm_bwd_narrow_f32_kernel<8>;
    case 16: return (const void*)&bilstm_bwd_narrow_f32_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

// The plan of B rows at width H (a multiple of 8), into out[8]: U, Hb, NC,
// NCP, R, clusters at once, waves, shared memory a block. blocks / rows > 0
// force that cluster size / those rows (0: the plan's choice).
extern "C" int percival_bilstm_bwd_narrow_f32_plan(int B, int H, int blocks, int rows,
                                                   int* out) {
  NarrowF32Plan plan{};
  const cudaError_t err = percival::narrow_f32_plan(B, H, 4, blocks, rows, kernel_for, &plan);
  if (err == cudaSuccess) percival::narrow_f32_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 8. Inputs in the order of _bilstm_bwd_pallas:
// gx, W_h (packed per block for the plan of (B, H, U, R):
// ops/narrow_f32_layout.py::pack_wh), h_prev, c_prev, c, dy, each as
// (forward direction, backward direction); then dgx. W_h and h_prev 16-byte
// aligned, no pointer null. Returns a cudaError_t.
extern "C" int percival_bilstm_bwd_narrow_f32(const void* gx_f, const void* gx_b,
                                              const void* wp_f, const void* wp_b,
                                              const void* hp_f, const void* hp_b,
                                              const void* cp_f, const void* cp_b,
                                              const void* c_f, const void* c_b,
                                              const void* dy_f, const void* dy_b,
                                              void* dgx_f, void* dgx_b,
                                              int n_steps, int B, int H, int Hb, int U, int R,
                                              void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b,
                          dy_f, dy_b, dgx_f, dgx_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b, hp_f, hp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  NarrowF32Plan plan{};
  cudaError_t err = percival::narrow_f32_checked_plan(B, H, Hb, U, R, 4, kernel_for, &plan);
  if (err != cudaSuccess) return err;
  int NCP = plan.NCP;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&hp_f, (void*)&hp_b, (void*)&cp_f, (void*)&cp_b,
                  (void*)&c_f,  (void*)&c_b,  (void*)&dy_f, (void*)&dy_b,
                  (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&NCP};
  return percival::narrow_f32_launch(plan, B, kernel_for, args,
                                     static_cast<cudaStream_t>(stream));
}
