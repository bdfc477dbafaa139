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
// (B, nf, fl) with its last axis contiguous and any batch and frame strides
// (in elements, 0 included: a broadcast row is read without a copy), out
// (B, out_length) contiguous, dt = float or bfloat16.
//
// What bounds it on the card: bytes, (B·nf·fl + B·out_length)·sizeof(dt) over
// 3.35 TB/s (a stride-0 row is read once); R ≤ 3 adds an output sample at
// the vocoder's shapes (fl = 160, hop = 80).
// What the design does about it (ops/frames_layout.py replays this partition
// on the CPU):
//   * V consecutive outputs a thread (V = 4 f32 or 8 bf16), one 16-byte
//     store, over the flattened (B·out_length) output; a scalar head and tail
//     peel it to 16-byte alignment. A vector finds its row, block and column
//     with two divisions;
//   * when the V outputs share a row and a hop block (c + V ≤ hop: at the
//     vocoder's shapes, hop 80 and fl/2 = 80, every vector), each of the R
//     terms is V contiguous frame elements, loaded with the widest loads
//     their address allows (16 bytes at the vocoder's shapes); otherwise each
//     output sums its own terms element by element, in the same kernel;
//   * no atomics and no scatter (each output is written once, by the thread
//     that sums it);
//   * 128 threads a block and one vector a thread, up to 16 blocks an SM
//     (2048 threads), with a grid-stride loop past that: (4, 1536, 160) in f32
//     is 960 blocks and (1, 1536, 160) 240, each all resident at once on the
//     132 SMs;
//   * no shared memory, no allocation, PyTorch's stream; the launcher returns
//     cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace {

using percival::from_f32;
using percival::to_f32;

constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 2048 / kThreads;

template <typename T>
struct Vec {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte store
};

template <typename T>
__device__ __forceinline__ float add_rounded(float acc, T v) {
  return to_f32(from_f32<T>(acc + to_f32(v)));  // the twin's dt buffer rounds every sum
}

// V consecutive elements from global memory with the widest loads that p's
// alignment allows (16, 8, 4 or 2 bytes).
template <typename T>
__device__ __forceinline__ void ldg_vec(const T* p, T (&v)[Vec<T>::V]) {
  constexpr int V = Vec<T>::V;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if ((a & 7) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      reinterpret_cast<uint2*>(v)[i] = __ldg(reinterpret_cast<const uint2*>(p) + i);
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<unsigned*>(v)[i] = __ldg(reinterpret_cast<const unsigned*>(p) + i);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

struct Geometry {
  int nf, fl, hop, out_length;
  long long bs, fs;  // batch and frame strides, elements
};

// One output sample (row b, sample s), its terms in the order r = 0 … R−1.
template <typename T>
__device__ T sum_one(const T* __restrict__ frames, const Geometry& g, long long b, long long s) {
  const long long p = s + g.fl / 2;
  const long long t = p / g.hop;
  const int c = static_cast<int>(p - t * g.hop);
  const int R = (g.fl + g.hop - 1) / g.hop;
  const T* fb = frames + b * g.bs;
  float acc = 0.0f;
  for (int r = 0; r < R; ++r) {
    const long long i = t - r;
    const int col = r * g.hop + c;
    if (i < 0 || i >= g.nf || col >= g.fl) continue;
    acc = add_rounded(acc, fb[i * g.fs + col]);
  }
  return from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) overlap_add_kernel(
    const T* __restrict__ frames, T* __restrict__ out, Geometry g, int head, long long nv,
    int tail) {
  constexpr int V = Vec<T>::V;
  const int R = (g.fl + g.hop - 1) / g.hop;
  for (long long k = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; k < nv;
       k += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long q = head + k * V;  // flattened output index of the vector's first sample
    const long long b = q / g.out_length;
    const long long s = q - b * g.out_length;
    const long long p = s + g.fl / 2;
    const long long t = p / g.hop;
    const int c = static_cast<int>(p - t * g.hop);
    alignas(16) T ov[V];
    if (s + V <= g.out_length && c + V <= g.hop) {  // one row, one hop block
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      for (int r = 0; r < R; ++r) {
        const long long i = t - r;
        const int col = r * g.hop + c;
        if (i < 0 || i >= g.nf || col >= g.fl) continue;
        const T* src = frames + b * g.bs + i * g.fs + col;
        if (col + V <= g.fl) {
          alignas(16) T v[V];
          ldg_vec(src, v);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = add_rounded(acc[e], v[e]);
        } else {  // the frame ends inside the vector
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (col + e < g.fl) acc[e] = add_rounded(acc[e], src[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) ov[e] = from_f32<T>(acc[e]);
    } else {  // the vector crosses a hop block or a row
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const long long qe = q + e;
        const long long be = qe / g.out_length;
        ov[e] = sum_one(frames, g, be, qe - be * g.out_length);
      }
    }
    *reinterpret_cast<uint4*>(out + q) = *reinterpret_cast<const uint4*>(ov);
  }
  // the scalar head (threads 0 … head−1 of block 0) and tail (threads V … V+tail−1)
  if (blockIdx.x == 0) {
    const int u = threadIdx.x;
    long long q = -1;
    if (u < head) q = u;
    else if (u >= V && u < V + tail) q = head + nv * V + (u - V);
    if (q >= 0) {
      const long long b = q / g.out_length;
      out[q] = sum_one(frames, g, b, q - b * g.out_length);
    }
  }
}

template <typename T>
int launch(const void* frames, void* out, int B, const Geometry& g, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  const long long total = static_cast<long long>(B) * g.out_length;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(out) / sizeof(T)) % V);
  const int head = static_cast<int>(total < (V - mis) % V ? total : (V - mis) % V);
  const long long nv = (total - head) / V;
  const int tail = static_cast<int>(total - head - nv * V);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (nv + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSM;
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  overlap_add_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(frames), static_cast<T*>(out), g, head, nv, tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames (B, nf, fl): last axis contiguous, batch stride bs and frame stride
// fs in elements (0 allowed); out (B, out_length) contiguous; dtype 0 = f32,
// 1 = bf16. Returns a cudaError_t code (0 on success).
extern "C" int percival_overlap_add(const void* frames, void* out, int B, int nf, int fl,
                                    int hop, int out_length, long long bs, long long fs,
                                    int dtype, void* stream) {
  if (frames == nullptr || out == nullptr || B < 1 || nf < 1 || fl < 1 || hop < 1 ||
      out_length < 1 || bs < 0 || fs < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geometry g{nf, fl, hop, out_length, bs, fs};
  if (dtype == 0) return launch<float>(frames, out, B, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(frames, out, B, g, st);
  return cudaErrorInvalidValue;
}
