// Helpers shared by the recurrent kernels (bilstm_{fwd,bwd,fwd_mma,bwd_mma}.cu,
// bigru_{fwd,bwd,fwd_mma,bwd_mma}.cu) and the DSP kernels (frame_window.cu, overlap_add.cu):
// dtype conversions between the compute dtype (float or
// bfloat16) and the f32 arithmetic, the gate nonlinearity, a float4 dot
// product, and the shared-memory opt-in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace percival {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's astype
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc + a·b over the four lanes of a float4, x first, as one FMA chain.
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Dynamic shared memory a block may opt into on the current device.
inline cudaError_t smem_optin_bytes(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace percival
