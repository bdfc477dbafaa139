// Centred framing times a window, for Hopper (sm_90a).
//
// Replaces the TPU kernel percivaltts_tpu/ops/pallas_kernels.py::frame_window
// (its pallas_call). Same function, with a leading batch axis:
//
//   out[b, i, j] = x[b, i·hop + j − fl/2] · w[j]     i < nf = ceil(n / hop), j < fl
//
// with x read as 0 outside [0, n) and w = 1 when no window is given. Layouts:
// x (B, n), w (fl), out (B, nf, fl), all contiguous, dt = float or bfloat16.
// The product is one f32 multiply rounded once to dt, as PyTorch's
// elementwise multiply does, so the kernel equals its plain twin bit for bit.
//
// What bounds it on the card: bytes. Each output element is one load and at
// most one multiply; the least traffic is the signal once, the window once and
// the frames once, (B·n + fl + B·nf·fl)·sizeof(dt) over 3.35 TB/s. The frames
// are fl/hop times the signal (10× at fl = 800, hop = 80), so the store stream
// sets the bound.
// What the design does about it (the TPU kernel's 80→128 lane padding and its
// per-program DMA copies exist for the TPU's tiling only and are not carried
// over):
//   * one thread per output element along j, so a warp stores one contiguous
//     run of a frame row and loads the contiguous run of the signal it copies;
//     neighbouring frames re-read the same signal bytes, which L1/L2 serve (the
//     signal is under 2 MB at the vocoder's shapes);
//   * the window goes through the read-only data cache (__ldg);
//   * grid = (ceil(fl / 128), rows) with a stride loop over the B·nf rows: one
//     integer division a row, none an element;
//   * no shared memory, no atomics, no allocation, PyTorch's stream, and the
//     launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::to_f32;

constexpr int kThreads = 128;
constexpr int kMaxRowBlocks = 65535;  // gridDim.y limit

template <typename T>
__global__ void __launch_bounds__(kThreads) frame_window_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int rows, int n, int nf, int fl, int hop) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= fl) return;
  const int half = fl / 2;
  const float wj = w == nullptr ? 1.0f : to_f32(__ldg(w + j));
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int b = row / nf;
    const int i = row - b * nf;
    const long long s = static_cast<long long>(i) * hop + j - half;
    const float v = (s >= 0 && s < n) ? to_f32(x[static_cast<long long>(b) * n + s]) : 0.0f;
    out[static_cast<long long>(row) * fl + j] = from_f32<T>(w == nullptr ? v : v * wj);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int n, int fl, int hop,
           cudaStream_t st) {
  const int nf = (n + hop - 1) / hop;
  const int rows = B * nf;
  const dim3 grid((fl + kThreads - 1) / kThreads, rows < kMaxRowBlocks ? rows : kMaxRowBlocks);
  frame_window_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      rows, n, nf, fl, hop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, n), window (fl) or nullptr, out (B, ceil(n / hop), fl); dtype 0 = f32,
// 1 = bf16. Returns a cudaError_t code (0 on success).
extern "C" int percival_frame_window(const void* x, const void* window, void* out,
                                     int B, int n, int fl, int hop, int dtype,
                                     void* stream) {
  if (x == nullptr || out == nullptr || B < 1 || n < 1 || fl < 1 || hop < 1)
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(B) * ((n + hop - 1) / hop);
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, window, out, B, n, fl, hop, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, window, out, B, n, fl, hop, st);
  return cudaErrorInvalidValue;
}
