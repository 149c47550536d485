// The bf16 tensor-core helpers shared by the attention forward A-mma
// (flash_attention_fwd_mma.cu) and the fused bottleneck E-mma
// (fused_bottleneck_mma.cu): `ldmatrix` loads of 8x8 bf16 matrices from
// shared memory (also the int8 kernels F, int8_matmul.cu, and G,
// int8_conv.cu), `mma.sync.m16n8k16` with fp32 accumulators, and the
// packing of two fp32 values into one bf16x2 register.
//
// Fragments follow the PTX ISA's m16n8k16 layouts: lane = 4 * g + t holds A
// (row g, k 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B
// (k 2t..2t+1, n g), (k 2t + 8.., n g); the accumulator (g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cuda_bf16.h>

#include "cp_async.cuh"

namespace bf16mma {

// Four 8x8 matrices; lanes 8j..8j+7 give the row addresses of matrix j.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(cpa::smem_addr(p)));
}

// The same, each matrix transposed: rows of a row-major (k, n) tile give B.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(cpa::smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register, the first in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace bf16mma
