// Asynchronous global -> shared copies (`cp.async`, sm_80 and later) and the
// shared-memory address they take, shared by the tensor-core kernels: the
// attention kernels (through flash_attention_common.cuh), bf16_mma.cuh, the
// fused bottleneck E-mma (fused_bottleneck_mma.cu), the int8 matmul F
// (int8_matmul.cu) and the LAP B (lap.cu); the int8 3x3 convolution G
// (int8_conv.cu), whose copies are TMA's, takes the address alone.

#pragma once

#include <cuda_runtime.h>

namespace cpa {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 8 bytes global -> shared (both 8-byte aligned), asynchronously; src_bytes
// 0 writes 8 zero bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace cpa
