// Centred overlap-add, for Hopper (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/pallas_kernels.py::overlap_add
// (its pallas_call). Same function, with a leading batch axis: frame i of
// frames (B, nf, fl) is added centred at sample i·hop, and the output is the
// sum cut to [fl/2, fl/2 + out_length). In the gather form the TPU kernel uses,
// output sample s (p = s + fl/2, block t = p / hop, column c = p % hop) is
//
//   out[b, s] = Σ_{r = 0 … R−1} frames[b, t − r, r·hop + c],   R = ceil(fl / hop)
//
// over the r whose frame exists (0 ≤ t − r < nf) and whose column lies inside
// the frame (r·hop + c < fl). The terms are added in the order r = 0 … R−1 of
// the JAX loop (percivaltts_tpu/ops/stft.py::overlap_add), each sum rounded to
// dt as the plain twin's dt buffer rounds it, so the kernel equals the twin
// bit for bit in f32 and in bf16, and runs are deterministic. Layouts: frames
// (B, nf, fl), out (B, out_length), contiguous, dt = float or bfloat16.
//
// What bounds it on the card: bytes, (B·nf·fl + B·out_length)·sizeof(dt) over
// 3.35 TB/s; R ≤ 3 adds an output sample at the vocoder's shapes (fl = 160,
// hop = 80).
// What the design does about it: one thread per output sample, no atomics and
// no scatter (each output is written once, by the thread that sums it); the
// threads of a warp read consecutive columns of each frame they touch and write
// consecutive samples; grid = (ceil(out_length / 256), B). No shared memory, no
// allocation, PyTorch's stream; the launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::to_f32;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) overlap_add_kernel(
    const T* __restrict__ frames, T* __restrict__ out, int nf, int fl, int hop,
    int out_length) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= out_length) return;
  const int b = blockIdx.y;
  const long long p = static_cast<long long>(s) + fl / 2;
  const long long t = p / hop;
  const int c = static_cast<int>(p - t * hop);
  const int R = (fl + hop - 1) / hop;
  const T* fb = frames + static_cast<long long>(b) * nf * fl;
  float acc = 0.0f;
  for (int r = 0; r < R; ++r) {
    const long long i = t - r;
    const int col = r * hop + c;
    if (i < 0 || i >= nf || col >= fl) continue;
    // round every partial sum to dt, as the twin's dt buffer does
    acc = to_f32(from_f32<T>(acc + to_f32(fb[i * fl + col])));
  }
  out[static_cast<long long>(b) * out_length + s] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* frames, void* out, int B, int nf, int fl, int hop, int out_length,
           cudaStream_t st) {
  const dim3 grid((out_length + kThreads - 1) / kThreads, B);
  overlap_add_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(frames), static_cast<T*>(out), nf, fl, hop, out_length);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames (B, nf, fl), out (B, out_length); dtype 0 = f32, 1 = bf16. Returns a
// cudaError_t code (0 on success).
extern "C" int percival_overlap_add(const void* frames, void* out, int B, int nf, int fl,
                                    int hop, int out_length, int dtype, void* stream) {
  if (frames == nullptr || out == nullptr || B < 1 || B > 65535 || nf < 1 || fl < 1 ||
      hop < 1 || out_length < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(frames, out, B, nf, fl, hop, out_length, st);
  if (dtype == 1) return launch<__nv_bfloat16>(frames, out, B, nf, fl, hop, out_length, st);
  return cudaErrorInvalidValue;
}
