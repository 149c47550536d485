// Shared pieces of the int8 backbone kernels (int8_matmul.cu, int8_conv.cu):
// `mma.sync.m16n8k32` s8 and the requantization epilogue of `_epilogue` in
// detr_tensorflow_tpu/ops/pallas/int8_matmul.py (both kernels), the
// template dispatch over the epilogue's flags (both), and the warp-tile
// product with its 16-byte operand loads (int8_conv.cu; int8_matmul.cu
// stages its operands in shared memory instead).
//
// Tiling. A CTA of 4 warps computes a 64 x 64 output tile, each warp a
// 32 x 32 sub-tile as 2 x 4 fragments of mma.sync m16n8k32 (s8 x s8 -> s32).
// Operands are read straight from global memory (through L1), no shared
// memory: a lane loads 16 contiguous bytes of a row, so four lanes cover a
// 64-byte chunk of the contraction. Each 16-byte load feeds two k32 steps.
// The bytes of a chunk enter the product in a permuted k order, the same
// for A and B; a dot product does not depend on the order of its terms, so
// the sum is the exact integer product. Hence C % 64 == 0 (every R50
// contraction is a multiple of 64) and the output width K % 8 == 0.
//
// Epilogue, in the TPU kernel's order of operations (Python precedence
// included), with every product and sum rounded on its own (no FMA
// contraction, `__fmul_rn` / `__fadd_rn`):
//   plain:      (acc*s) + b
//   residual:   ((acc*s) + b) + (res*rs)
//   residual2:  (((acc*s) + b) + (accd*sd)) + bd
// then ReLU folded into the clip, round half to even, clip to int8; or the
// value (ReLU'd) rounded to bf16. kPrecise = false is the TPU kernel's bf16
// epilogue: every operand and result rounded to bf16, and under ReLU with
// an int8 output, clip to [0, 127], add 0.5 and truncate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8 {

constexpr int kWarpRows = 32;
constexpr int kWarpCols = 32;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kBlockRows = kWarpRows * kWarpsM;
constexpr int kBlockCols = kWarpCols * kWarpsN;
constexpr int kChunk = 64;  // contraction bytes per 16-byte load of 4 lanes

enum Variant { kPlain = 0, kResidual = 1, kResidual2 = 2 };

using Acc = int[2][4][4];  // [m16 fragment][n8 fragment][c0..c3]

__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int4 load16(const int8_t* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
}

// The operands of one 64-byte contraction chunk of a warp tile: a[mt][h]
// holds 16 bytes of row (mt * 16 + h * 8 + lane / 4), b[nt] 16 bytes of
// output column (nt * 8 + lane / 4), both at byte offset (lane % 4) * 16 of
// the chunk. The kernels load chunk i + 1 into a second Frags while the
// tensor cores work on chunk i.
struct Frags {
  int4 a[2][2];
  int4 b[4];
};

// Step s of a chunk takes words 2s and 2s + 1 as the fragments' low and
// high k halves.
__device__ __forceinline__ void mma_chunk(Acc& acc, const Frags& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int a0 = s ? f.a[mt][0].z : f.a[mt][0].x;
      const int a2 = s ? f.a[mt][0].w : f.a[mt][0].y;
      const int a1 = s ? f.a[mt][1].z : f.a[mt][1].x;
      const int a3 = s ? f.a[mt][1].w : f.a[mt][1].y;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], a0, a1, a2, a3, s ? f.b[nt].z : f.b[nt].x, s ? f.b[nt].w : f.b[nt].y);
    }
  }
}

struct Epilogue {
  const float* scale;      // (K,)
  const float* bias;       // (K,)
  const int8_t* res;       // (M, K), kResidual
  const float* res_scale;  // one value on the device, kResidual
  const float* scale_d;    // (K,), kResidual2
  const float* bias_d;     // (K,), kResidual2
  void* out;               // (M, K) int8 or bf16
};

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <int V, bool kPrecise>
__device__ __forceinline__ float affine(int acc, float s, float b, int res, float rs, int accd,
                                        float sd, float bd) {
  if (kPrecise) {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
    if (V == kResidual) y = __fadd_rn(y, __fmul_rn(static_cast<float>(res), rs));
    if (V == kResidual2) y = __fadd_rn(__fadd_rn(y, __fmul_rn(__int2float_rn(accd), sd)), bd);
    return y;
  }
  float y = bf(__fadd_rn(bf(__fmul_rn(bf(__int2float_rn(acc)), bf(s))), bf(b)));
  if (V == kResidual) y = bf(__fadd_rn(y, bf(__fmul_rn(static_cast<float>(res), bf(rs)))));
  if (V == kResidual2)
    y = bf(__fadd_rn(bf(__fadd_rn(y, bf(__fmul_rn(bf(__int2float_rn(accd)), bf(sd))))), bf(bd)));
  return y;
}

template <bool kRelu, bool kPrecise>
__device__ __forceinline__ int8_t to_int8(float y) {
  if (!kPrecise && kRelu)
    return static_cast<int8_t>(__float2int_rz(bf(fminf(fmaxf(y, 0.f), 127.f) + 0.5f)));
  const float v = fminf(fmaxf(rintf(y), kRelu ? 0.f : -128.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(v));
}

// Writes the warp tile at (row0, col0) of the (m, k) output.
template <int V, bool kRelu, bool kOutBf16, bool kPrecise>
__device__ __forceinline__ void store_tile(const Acc& acc, const Acc& accd, const Epilogue& ep,
                                           int row0, int col0, int m, int k, int lane) {
  const int group = lane >> 2, quad = lane & 3;
  const float rs = V == kResidual ? __ldg(ep.res_scale) : 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + nt * 8 + quad * 2;
    if (col >= k) continue;
    const float s0 = __ldg(ep.scale + col), s1 = __ldg(ep.scale + col + 1);
    const float b0 = __ldg(ep.bias + col), b1 = __ldg(ep.bias + col + 1);
    float sd0 = 0.f, sd1 = 0.f, bd0 = 0.f, bd1 = 0.f;
    if (V == kResidual2) {
      sd0 = __ldg(ep.scale_d + col), sd1 = __ldg(ep.scale_d + col + 1);
      bd0 = __ldg(ep.bias_d + col), bd1 = __ldg(ep.bias_d + col + 1);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + h * 8 + group;
        if (row >= m) continue;
        const size_t at = static_cast<size_t>(row) * k + col;
        char2 r = make_char2(0, 0);
        if (V == kResidual) r = *reinterpret_cast<const char2*>(ep.res + at);
        const float y0 = affine<V, kPrecise>(acc[mt][nt][2 * h], s0, b0, r.x, rs,
                                             accd[mt][nt][2 * h], sd0, bd0);
        const float y1 = affine<V, kPrecise>(acc[mt][nt][2 * h + 1], s1, b1, r.y, rs,
                                             accd[mt][nt][2 * h + 1], sd1, bd1);
        if (kOutBf16) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(kRelu ? fmaxf(y0, 0.f) : y0);
          v.y = __float2bfloat16_rn(kRelu ? fmaxf(y1, 0.f) : y1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(ep.out) + at) = v;
        } else {
          *reinterpret_cast<char2*>(static_cast<int8_t*>(ep.out) + at) =
              make_char2(to_int8<kRelu, kPrecise>(y0), to_int8<kRelu, kPrecise>(y1));
        }
      }
    }
  }
}

// Host-side: the launch arguments and the template dispatch over
// (ReLU, output dtype, epilogue precision) shared by both kernels.
struct Flags {
  bool relu, out_bf16, precise;
};

template <template <bool, bool, bool> class Launcher, typename Args>
cudaError_t dispatch(const Flags& f, const Args& a) {
  if (f.relu) {
    if (f.out_bf16)
      return f.precise ? Launcher<true, true, true>::run(a) : Launcher<true, true, false>::run(a);
    return f.precise ? Launcher<true, false, true>::run(a) : Launcher<true, false, false>::run(a);
  }
  if (f.out_bf16)
    return f.precise ? Launcher<false, true, true>::run(a) : Launcher<false, true, false>::run(a);
  return f.precise ? Launcher<false, false, true>::run(a) : Launcher<false, false, false>::run(a);
}

}  // namespace i8
