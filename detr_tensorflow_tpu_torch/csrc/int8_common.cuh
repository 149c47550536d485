// Shared pieces of the int8 backbone kernels, F (int8_matmul.cu) and G
// (int8_conv.cu): `mma.sync.m16n8k32` s8, the requantization epilogue of
// `_epilogue` in detr_tensorflow_tpu/ops/pallas/int8_matmul.py, and the
// template dispatch over the epilogue's flags. Both kernels stage their
// operands in shared memory and hand them to the MMA by `ldmatrix`.
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

enum Variant { kPlain = 0, kResidual = 1, kResidual2 = 2 };

__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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
