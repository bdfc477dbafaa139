// Fused bidirectional LSTM backward (BPTT) in f32 for widths one SM cannot
// hold (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/lstm_pallas.py::_bwd_kernel
// (launched by _bilstm_bwd_pallas, :321) on the route "wide_f32"
// (ops/mma_layout.py::bwd_route): f32 past H = 256 up to 512
// (ops/wide_f32_layout.py::fits), where bilstm_bwd_wide.cu ran before; that
// kernel keeps f32 past 512 and bf16 past 608. Same contract as
// bilstm_bwd_wide.cu:
//
//   z    = gx[t] + h_prev[t] · W_h                  (gates recomputed)
//   dh   = dy[t] + dh_carry ;  dc = dc_carry + dh·o·(1 − tanh²c[t])
//   dz   = dc·g·i(1−i) | dc·c_prev[t]·f(1−f) | dc·i(1−g²) | dh·tanh(c[t])·o(1−o)
//   dgx[t] = dz ;  dh_carry = dz · W_hᵀ ;  dc_carry = dc·f
//
// the forward direction's BPTT walking t = T-1 … 0, the backward one's
// t = 0 … T-1. Layouts: gx / dgx (T, B, 4H); h_prev / c_prev / c / dy
// (T, B, H), all f32, H a multiple of 32 (the wrapper zero-pads the others,
// which is exact); W_h packed per block (ops/wide_layout.py::pack_wh,
// (U, H, 4·Hb) a direction).
//
// What bounds it on the card: a step's two products over the block's W_h
// slice, 2·R·H·4Hb FMAs, on the chain from one step's dz to the next step's
// dh through the whole cluster. bilstm_bwd_wide.cu held at most 8 rows a
// cluster and, its f32 slice (258 KiB with padding) being past a block's
// 227 KB, read W_h through L2 for both products: 48.7 µs a step at B = 8,
// 6 waves of clusters at B = 160 (PERF.md, its kernel table). Here
// (wide_f32_common.cuh):
//   * the slice is cut into 64-row chunks; as many as fit beside the rows
//     stay resident, the rest stream through three ring slots by cp.async
//     two chunks ahead, and every chunk feeds both products of the step;
//   * both products on CUDA cores in f32, each on its own warps (8 for the
//     recompute, 4 for the dh product: 384 threads, so at most 168
//     registers a thread; ptxas spills 12 bytes at R = 24 and none at
//     R = 8 / 16, where 512 threads spilled), a lane a tile of
//     2·R sums (4 columns or rows of k × R/2 batch rows), so that each float4
//     it reads from shared memory feeds 16 FMAs; FMAs are most of the
//     products' instructions. Tensor cores in 3xTF32 measured slower here
//     (mma.sync's TF32 rate on this card, three products a tile and the
//     operand splits; PERF.md, §6);
//   * up to 24 rows a cluster (B = 160 in two waves), the recompute's sums in
//     registers for the whole pass (no partial-sum tile in shared memory),
//     one buffer of partial slots behind split cluster barriers;
//   * the gate math of a (row, unit) pair runs on the thread that loaded its
//     operands a step ahead; no atomics, no allocation, PyTorch's stream; the
//     launcher returns cudaGetLastError().
// At B <= 8 the launcher takes the few-row kernels instead
// (wide_f32_few.cuh: R = 1, 2 or 4 rows a cluster, the whole slice resident,
// both products a thread, the dh partials sent by st.async to mbarriers, no
// cluster barrier in the loop), where "wide" had been faster than the
// chunked kernels; the plan (wide_f32_bwd_plan) picks the kernel and R.

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "f32_cells.cuh"
#include "wide_f32_common.cuh"
#include "wide_f32_few.cuh"

namespace {

using percival::F32LstmCell;
using percival::kWfThreads;
using percival::WideF32Plan;

// grid = (U · ceil(B / R), 2 directions) in clusters of U along x; 384 threads;
// R = 8·NT rows a cluster.
template <int NT>
__global__ void __launch_bounds__(kWfThreads, 1) bilstm_bwd_wide_f32_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ hp_f, const float* __restrict__ hp_b,
    const float* __restrict__ cp_f, const float* __restrict__ cp_b,
    const float* __restrict__ c_f, const float* __restrict__ c_b,
    const float* __restrict__ dy_f, const float* __restrict__ dy_b,
    float* __restrict__ dgx_f, float* __restrict__ dgx_b,
    int n_steps, int B, int H, int Hb, int nres) {
  const bool backward = blockIdx.y == 1;
  F32LstmCell cell{backward ? gx_b : gx_f, backward ? cp_b : cp_f, backward ? c_b : c_f,
                backward ? dy_b : dy_f, backward ? dgx_b : dgx_f, B, H};
  percival::wide_f32_bptt<F32LstmCell, NT>(cell, backward ? wp_b : wp_f, backward ? hp_b : hp_f,
                                        n_steps, B, H, Hb, nres, backward);
}

// The few-row plan's kernel (wide_f32_few.cuh): 4·NC threads, R rows a
// cluster; nres unused.
template <int NC, int R>
__global__ void __launch_bounds__(percival::wfr_threads(NC), 1) bilstm_bwd_wide_f32_few_kernel(
    const float* __restrict__ gx_f, const float* __restrict__ gx_b,
    const float* __restrict__ wp_f, const float* __restrict__ wp_b,
    const float* __restrict__ hp_f, const float* __restrict__ hp_b,
    const float* __restrict__ cp_f, const float* __restrict__ cp_b,
    const float* __restrict__ c_f, const float* __restrict__ c_b,
    const float* __restrict__ dy_f, const float* __restrict__ dy_b,
    float* __restrict__ dgx_f, float* __restrict__ dgx_b,
    int n_steps, int B, int H, int Hb, int) {
  const bool backward = blockIdx.y == 1;
  F32LstmCell cell{backward ? gx_b : gx_f, backward ? cp_b : cp_f, backward ? c_b : c_f,
                backward ? dy_b : dy_f, backward ? dgx_b : dgx_f, B, H};
  percival::wide_f32_few<F32LstmCell, NC, R>(cell, backward ? wp_b : wp_f,
                                             backward ? hp_b : hp_f, n_steps, B, H, Hb, backward);
}

const void* kernel_for(int NT) {
  switch (NT) {
    case 1: return (const void*)&bilstm_bwd_wide_f32_kernel<1>;
    case 2: return (const void*)&bilstm_bwd_wide_f32_kernel<2>;
    case 3: return (const void*)&bilstm_bwd_wide_f32_kernel<3>;
    default: return nullptr;
  }
}

// NC = 96 (H up to 384) and 128 (416)
const void* few_for(int NC, int R) {
  switch (NC * 8 + R) {
    case 96 * 8 + 1: return (const void*)&bilstm_bwd_wide_f32_few_kernel<96, 1>;
    case 96 * 8 + 2: return (const void*)&bilstm_bwd_wide_f32_few_kernel<96, 2>;
    case 96 * 8 + 4: return (const void*)&bilstm_bwd_wide_f32_few_kernel<96, 4>;
    case 128 * 8 + 1: return (const void*)&bilstm_bwd_wide_f32_few_kernel<128, 1>;
    case 128 * 8 + 2: return (const void*)&bilstm_bwd_wide_f32_few_kernel<128, 2>;
    case 128 * 8 + 4: return (const void*)&bilstm_bwd_wide_f32_few_kernel<128, 4>;
    default: return nullptr;
  }
}

cudaError_t plan_for(int B, int H, int Hb, int U, int rows, WideF32Plan* plan) {
  return percival::wide_f32_bwd_plan(B, H, Hb, U, 4, rows, kernel_for, few_for, plan);
}

}  // namespace

// The plan a launch of (B, H, Hb, U) takes (rows: R forced, 1, 2, 4 the
// few-row kernels, 8, 16, 24 the chunked ones; 0 the plan's choice), into
// out[9]: U, Hb, NC, R, resident chunks, streamed chunks, clusters at once,
// waves, shared memory a block.
extern "C" int percival_bilstm_bwd_wide_f32_plan(int B, int H, int Hb, int U, int rows,
                                                  int* out) {
  WideF32Plan plan{};
  const cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err == cudaSuccess) percival::wide_f32_plan_out(plan, out);
  return err;
}

// f32 only, H a multiple of 32. Inputs in the order of _bilstm_bwd_pallas:
// gx, W_h (packed per block, ops/wide_layout.py::pack_wh), h_prev, c_prev,
// c, dy, each as (forward direction, backward direction); then dgx; rows as
// the plan's. h_prev 16-byte aligned, no pointer null. Returns a
// cudaError_t.
extern "C" int percival_bilstm_bwd_wide_f32(const void* gx_f, const void* gx_b,
                                            const void* wp_f, const void* wp_b,
                                            const void* hp_f, const void* hp_b,
                                            const void* cp_f, const void* cp_b,
                                            const void* c_f, const void* c_b,
                                            const void* dy_f, const void* dy_b,
                                            void* dgx_f, void* dgx_b,
                                            int n_steps, int B, int H, int Hb, int U,
                                            int rows, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  const void* ptrs[14] = {gx_f, gx_b, wp_f, wp_b, hp_f, hp_b, cp_f, cp_b, c_f, c_b,
                          dy_f, dy_b, dgx_f, dgx_b};
  for (const void* ptr : ptrs)
    if (ptr == nullptr) return cudaErrorInvalidValue;
  for (const void* ptr : {wp_f, wp_b, hp_f, hp_b})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  WideF32Plan plan{};
  cudaError_t err = plan_for(B, H, Hb, U, rows, &plan);
  if (err != cudaSuccess) return err;
  int nres = plan.nres;
  void* args[] = {(void*)&gx_f, (void*)&gx_b, (void*)&wp_f, (void*)&wp_b,
                  (void*)&hp_f, (void*)&hp_b, (void*)&cp_f, (void*)&cp_b,
                  (void*)&c_f,  (void*)&c_b,  (void*)&dy_f, (void*)&dy_b,
                  (void*)&dgx_f, (void*)&dgx_b,
                  (void*)&n_steps, (void*)&B, (void*)&H, (void*)&Hb, (void*)&nres};
  return percival::wide_f32_bwd_launch(plan, B, kernel_for, few_for, args,
                                       static_cast<cudaStream_t>(stream));
}
