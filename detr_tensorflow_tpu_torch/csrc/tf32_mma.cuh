// The fp32-accurate 3xTF32 products on Hopper's tensor cores, shared by the
// attention forward A-tf32 (flash_attention_fwd_tf32.cu), the attention
// backward A'-mma (flash_attention_bwd_mma.cu, both through
// flash_attention_common.cuh too) and the fused bottleneck E-tf32
// (fused_bottleneck_tf32.cu): TF32 rounding and splitting, the m16n8k8 TF32
// MMA, and its A fragment loaded with `ldmatrix`.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits. Each fp32 operand x is
// split into big = tf32(x) (round to nearest) and small = tf32(x - big); the
// subtraction is exact, and big + small carries 22 of x's 24 significant
// bits. A product is taken as big_a big_b + (small_a big_b + big_a small_b),
// three `mma.sync.m16n8k8` TF32 MMAs; the dropped small_a small_b term is
// 2^-22 of it, and each TF32 product of two 11-bit significands is exact
// (CUTLASS's OpMultiplyAddFastF32, written out by hand). An MMA adds its
// products to its accumulator with truncation at the accumulator's
// magnitude, so long chains through one accumulator bias a sum: big x big
// keeps an accumulator of its own, apart from the cross terms (2^-11 of
// it), and the callers sum a few MMAs in fresh accumulators and add those
// to their running sums with rounded fp32 adds.
//
// Fragments follow the PTX ISA's m16n8k8 layouts: lane 4g + t holds A (row
// g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (k t, n g), (t + 4,
// g); the accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace tf32mma {

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as the bits of an fp32 value whose low 13 bits are zero: what
// `cvt.rna.tf32.f32` gives for finite x, in two integer instructions (the
// cvt compiles to a check and select for NaN around the same work; the two
// alone made A-tf32 faster at the served shapes in a trial on an H100).
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + O(2^-22 |x|).
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a (16x8 TF32, row) * b (8x8 TF32, col), fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// hi += a_big b_big, lo += a_small b_big + a_big b_small: 3xTF32 in two
// accumulators, read as hi + lo. B comes from shared memory, at offsets o0
// (k = t) and o1 (k = t + 4) of the big and small parts.
__device__ __forceinline__ void mma_3xtf32(float (&hi)[4], float (&lo)[4],
                                           const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4], const float* b_big,
                                           const float* b_small, int o0, int o1) {
  const unsigned bb0 = __float_as_uint(b_big[o0]), bb1 = __float_as_uint(b_big[o1]);
  mma_tf32(hi, a_big, bb0, bb1);
  mma_tf32(lo, a_small, bb0, bb1);
  mma_tf32(lo, a_big, __float_as_uint(b_small[o0]), __float_as_uint(b_small[o1]));
}

// A 16x8 fp32 A fragment from 16 rows of shared memory, k contiguous in each
// row: `ldmatrix` of four 8x8 b16 matrices reads each 16-byte row piece as
// four fp32 values, lane 4g + t getting value t of row g. Lanes 0-15 give
// rows 0-15 at column 0, lanes 16-31 the same rows at column 4, so `row` is
// this lane's row (lane % 16) at column 4 (lane / 16): a[0..3] = (g, t), (g
// + 8, t), (g, t + 4), (g + 8, t + 4). Rows must be 16-byte aligned.
__device__ __forceinline__ void ldmatrix_a(unsigned (&a)[4], const float* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(cpa::smem_addr(row)));
}

}  // namespace tf32mma
