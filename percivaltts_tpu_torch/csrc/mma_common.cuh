// PTX wrappers shared by the tensor-core recurrent kernels
// (bilstm_{fwd,bwd}_mma.cu, bigru_{fwd,bwd}_mma.cu, {bilstm,bigru}_bwd_wide_mma.cu): the bf16 m16n8k16
// product, ldmatrix from shared memory, and the cp.async ring that streams
// the inputs (also the framing kernel's staging, frame_window.cu).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace percival {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a·b: a 16×16 bf16 (row-major A fragment), b 16×8 bf16 (column-major B
// fragment), d 16×8 f32. Fragment layouts: PTX ISA, "mma.m16n8k16".
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four (x4) or two (x2) 8×8 b16 matrices; lane i gives the address of row
// i % 8 of matrix i / 8 (16 bytes each), and receives row i / 4, columns
// 2·(i % 4) and 2·(i % 4) + 1 of each matrix.
__device__ __forceinline__ void ldmatrix_x4(const void* p, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

// As ldmatrix_x4, each matrix transposed: lane i receives rows 2·(i % 4) and
// 2·(i % 4) + 1 of column i / 4 of each matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes global → shared, asynchronously; zero-filled when !full (src is
// then not read). Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two adjacent bf16 as one 32-bit fragment register (4-byte aligned).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace percival
