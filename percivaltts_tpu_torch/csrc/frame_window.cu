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
// What bounds it on the card: bytes. The least traffic is the signal once,
// the window once and the frames once, (B·n + fl + B·nf·fl)·sizeof(dt) over
// 3.35 TB/s; the frames are fl/hop times the signal (10× at fl = 800,
// hop = 80), so the store stream sets the bound.
// What the design does about it (the TPU kernel's 80→128 lane padding and its
// per-program DMA copies exist for the TPU's tiling only and are not carried
// over; ops/frames_layout.py replays this partition on the CPU):
//   * one block per tile of F consecutive frames of one signal row. The tile
//     reads the signal span [i0·hop − fl/2, (i0+F−1)·hop + fl − fl/2), which
//     the block stages once in shared memory: 16-byte cp.async for the
//     aligned middle, scalar loads and zeros for the ragged and out-of-signal
//     edges. Each sample then leaves device memory ~(1 + fl/(F·hop)) times,
//     not fl/hop times. The window is staged the same way;
//   * rows i0 … i0+F−1 of (B, nf, fl) are adjacent, so the tile's output is one
//     contiguous run of F·fl elements, written with 16-byte stores (4 f32 or
//     8 bf16 a thread); a scalar head and tail peel the run to 16-byte
//     alignment. Each vector finds its (frame, column) with one division; a
//     vector inside one frame reads its samples and window values with the
//     widest shared-memory loads their alignment allows, one that crosses a
//     frame boundary steps (frame, column) element by element;
//   * F = 8 and 256 threads a block: at the vocoder's (4, 122880) framings
//     (fl 804 / 800, hop 80) that is 768 blocks of ~25 KB of output and
//     8.7 KB of shared memory, all resident at once (8 blocks of 256 threads
//     an SM, 5.8 a SM on average over 132 SMs, so the imbalance is under one
//     block in six); the noise STFT's (1, 122880) fl 160 framing gives 192
//     blocks, one per SM and change, and sits at the launch floor anyway.
//     Shared memory stays under 48 KB: a larger span lowers F, and a frame
//     too wide for one block (F = 1) is cut into column slices, each still one
//     contiguous run;
//   * no atomics, no allocation, PyTorch's stream, and the launcher returns
//     cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"
#include "mma_common.cuh"

namespace {

using percival::cp_async16;
using percival::cp_async_commit;
using percival::cp_async_wait;
using percival::from_f32;
using percival::to_f32;

constexpr int kThreads = 256;
constexpr int kFrames = 8;              // F: frames a tile
constexpr int kSmemBytes = 48 * 1024;   // a tile's staged span and window

template <typename T>
struct Vec {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte store
};

__host__ __device__ inline long long mod_pos(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// Shared-memory elements of a tile of F frames by J columns: the window slice
// (when windowed) and the signal span, each with up to V−1 elements of
// alignment pad in front, each rounded up to whole 16-byte chunks.
inline long long smem_elems(int F, int J, int hop, int V, bool windowed) {
  const long long span = static_cast<long long>(F - 1) * hop + J;
  const long long xs = (V - 1 + span + V - 1) / V * V;
  const long long ws = windowed ? (V - 1 + J + V - 1) / V * V : 0;
  return xs + ws;
}

// dst[k] = src[s0 − pad + k] for k in [pad, pad + span), 0 where that index
// lies outside [0, n). pad ≡ (address of src, in elements) + s0 (mod V), so a
// 16-byte aligned chunk of the source lands on a 16-byte aligned chunk of dst:
// whole chunks inside the source go by cp.async, the rest element by element.
template <typename T>
__device__ void stage(T* dst, const T* src, long long n, long long s0, int pad, int span) {
  constexpr int V = Vec<T>::V;
  const int end = pad + span;
  const long long lo = pad - s0 > pad ? pad - s0 : pad;   // k >= pad, sample >= 0
  const long long hi = n - s0 + pad < end ? n - s0 + pad : end;  // k < end, sample < n
  const long long c_lo = (lo + V - 1) / V;
  const long long c_hi = hi > 0 ? hi / V : 0;
  int a = end, e = end;  // the chunks cover [a, e)
  if (c_hi > c_lo) {
    a = static_cast<int>(c_lo * V);
    e = static_cast<int>(c_hi * V);
    for (long long c = c_lo + threadIdx.x; c < c_hi; c += blockDim.x)
      cp_async16(dst + c * V, src + (s0 - pad + c * V), true);
  }
  const T zero = from_f32<T>(0.0f);
  for (int k = pad + threadIdx.x; k < a; k += blockDim.x) {
    const long long s = s0 - pad + k;
    dst[k] = (s >= 0 && s < n) ? src[s] : zero;
  }
  for (int k = e + threadIdx.x; k < end; k += blockDim.x) {
    const long long s = s0 - pad + k;
    dst[k] = (s >= 0 && s < n) ? src[s] : zero;
  }
}

// V consecutive elements from shared memory with the widest loads that p's
// alignment allows (16, 8, 4 or 2 bytes).
template <typename T>
__device__ __forceinline__ void lds_vec(const T* p, T (&v)[Vec<T>::V]) {
  constexpr int V = Vec<T>::V;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      reinterpret_cast<uint2*>(v)[i] = reinterpret_cast<const uint2*>(p)[i];
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<uint32_t*>(v)[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <typename T>
__device__ __forceinline__ T product(T xv, const T* s_w, int j) {
  return s_w == nullptr ? xv : from_f32<T>(to_f32(xv) * to_f32(s_w[j]));
}

// One block per tile: frames [i0, i0 + F) (or one frame) of row b, columns
// [j0, j0 + J) (J = fl unless a frame is cut into slices).
template <typename T>
__global__ void __launch_bounds__(kThreads) frame_window_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int n, int nf,
    int fl, int hop, int F, int J, int slices, int tiles_row) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x / tiles_row;
  const int it = blockIdx.x - b * tiles_row;
  const int group = it / slices;
  const int i0 = group * F;
  const int j0 = (it - group * slices) * J;
  const int nfr = min(F, nf - i0);
  const int Jt = min(J, fl - j0);
  const int span = (nfr - 1) * hop + Jt;
  const long long s0 = static_cast<long long>(i0) * hop - fl / 2 + j0;

  const T* xrow = x + static_cast<long long>(b) * n;
  const int pad = static_cast<int>(mod_pos(
      static_cast<long long>((reinterpret_cast<uintptr_t>(xrow) / sizeof(T)) % V) + s0, V));
  T* s_w = nullptr;
  int pad_w = 0;
  T* s_x = smem;
  if (w != nullptr) {
    pad_w = static_cast<int>(((reinterpret_cast<uintptr_t>(w) / sizeof(T)) + j0) % V);
    s_w = smem;
    s_x = smem + (V - 1 + J + V - 1) / V * V;
    stage(s_w, w, fl, j0, pad_w, Jt);
  }
  stage(s_x, xrow, n, s0, pad, span);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const T* sx = s_x + pad;
  const T* sw = s_w == nullptr ? nullptr : s_w + pad_w;

  // the tile's output run, peeled to 16-byte alignment
  const long long R0 = (static_cast<long long>(b) * nf + i0) * fl + j0;
  T* run = out + R0;
  const int L = nfr * Jt;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(run) / sizeof(T)) % V);
  const int head = min(L, (V - mis) % V);
  const int nv = (L - head) / V;
  const int tail = L - head - nv * V;

  for (int k = threadIdx.x; k < nv; k += blockDim.x) {
    const int q = head + k * V;
    int f = q / Jt;
    int j = q - f * Jt;
    alignas(16) T ov[V];
    if (j + V <= Jt) {  // inside one frame: contiguous samples and window values
      alignas(16) T xv[V];
      lds_vec(sx + f * hop + j, xv);
      if (sw == nullptr) {
#pragma unroll
        for (int e = 0; e < V; ++e) ov[e] = xv[e];
      } else {
        alignas(16) T wv[V];
        lds_vec(sw + j, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) ov[e] = from_f32<T>(to_f32(xv[e]) * to_f32(wv[e]));
      }
    } else {  // crosses a frame boundary
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ov[e] = product(sx[f * hop + j], sw, j);
        if (++j == Jt) {
          j = 0;
          ++f;
        }
      }
    }
    *reinterpret_cast<uint4*>(run + q) = *reinterpret_cast<const uint4*>(ov);
  }
  // the scalar head (threads 0 … head−1) and tail (threads V … V+tail−1)
  const int t = threadIdx.x;
  int q = -1;
  if (t < head) q = t;
  else if (t >= V && t < V + tail) q = head + nv * V + (t - V);
  if (q >= 0) {
    const int f = q / Jt;
    const int j = q - f * Jt;
    run[q] = product(sx[f * hop + j], sw, j);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int n, int fl, int hop,
           cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  const int nf = (n + hop - 1) / hop;
  const bool windowed = w != nullptr;
  const int budget = kSmemBytes / static_cast<int>(sizeof(T));
  int F = kFrames, J = fl;
  while (F > 1 && smem_elems(F, J, hop, V, windowed) > budget) --F;
  if (smem_elems(F, J, hop, V, windowed) > budget) {  // F = 1: cut the frame into slices
    J = (budget / (windowed ? 2 : 1) - 3 * V) / V * V;
  }
  const int slices = (fl + J - 1) / J;
  const long long tiles_row = static_cast<long long>((nf + F - 1) / F) * slices;
  const long long blocks = tiles_row * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(smem_elems(F, J, hop, V, windowed)) * sizeof(T);
  frame_window_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), n, nf, fl,
      hop, F, J, slices, static_cast<int>(tiles_row));
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, window, out, B, n, fl, hop, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, window, out, B, n, fl, hop, st);
  return cudaErrorInvalidValue;
}
