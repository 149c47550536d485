// Helpers shared by the flash-attention forward and backward kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu, flash_attention_bwd_mma.cu):
// vector loads that widen to fp32, the bf16 rounding points of the TPU
// kernel, the attention-dropout keep bit, and the backward's delta pre-pass.
//
// Dropout: the TPU kernel draws its mask per grid block from the TPU's
// PRNG and replays it in the backward by re-seeding with the same program
// ids (detr_tensorflow_tpu/ops/pallas/flash_attention.py:_dropout_mask).
// On the GPU the forward tiles by query and the backward's dK/dV pass by
// key, so a mask seeded per block could not be replayed. The keep bit is
// therefore a pure function of the element's coordinates: Philox4x32-10
// keyed by the call's 64-bit seed, with counter (j / 4, i, b * H + h, 0)
// for query i and key j; word j % 4 of the result is the element's 32
// random bits. A key is dropped iff bits < threshold, threshold =
// ceil(rate * 2^32), i.e. iff the uniform bits / 2^32 < rate; kept
// probabilities are scaled by 1 / (1 - rate). Every kernel regenerates the
// same bit whatever its tiling, and `flash_attention_keep_mask` writes the
// mask out for tests. ops/flash_attention.py:philox4x32_10 is the same
// generator in PyTorch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fa {

constexpr float kMaskBias = -1e30f;
// A row whose lse is this low had every key padded: its softmax is uniform.
constexpr float kMaskedRowLse = 0.5f * kMaskBias;

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// A value takes the tensors' type before a product, as the TPU kernel's
// astype(v.dtype) / astype(q.dtype) do: a no-op in fp32.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Philox4x32-10 (Salmon et al., SC'11), as in Random123.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

__device__ __forceinline__ uint2 seed_key(const unsigned long long* seed) {
  const unsigned long long s = *seed;
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
}

// Dropout multiplier of element (bh, i, j): keep_scale if kept, else 0.
__device__ __forceinline__ float dropout_factor(uint2 key, unsigned bh, unsigned i,
                                                unsigned j, unsigned threshold,
                                                float keep_scale) {
  const uint4 r = philox4x32_10(make_uint4(j >> 2, i, bh, 0u), key);
  const unsigned w = j & 3u;
  const unsigned bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  return bits >= threshold ? keep_scale : 0.f;
}

// ---- the backward's delta pre-pass -----------------------------------------

// delta[b * H + h, i] = dO_i . O_i, the TPU kernel's `delta`, for row r =
// (b, i, h) of (B, Lq, H, Dh) out and dout; delta is (B * H, Lq) fp32.
template <typename T, int Dh>
__device__ __forceinline__ void delta_row(const T* __restrict__ out, const T* __restrict__ dout,
                                          float* __restrict__ delta, long r, int lq, int heads) {
  const T* o = out + r * Dh;
  const T* g = dout + r * Dh;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < Dh; d += 8) {
    float a[8], c[8];
    load8(o + d, a);
    load8(g + d, c);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(a[e], c[e], s);
  }
  const long h = r % heads;
  const long bi = r / heads;
  const long i = bi % lq;
  const long b = bi / lq;
  delta[(b * heads + h) * lq + i] = s;
}

template <typename T, int Dh>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, long rows, int lq, int heads) {
  for (long r = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; r < rows;
       r += static_cast<long>(gridDim.x) * blockDim.x)
    delta_row<T, Dh>(out, dout, delta, r, lq, heads);
}

template <typename T, int Dh>
cudaError_t launch_delta(const T* out, const T* dout, float* delta, int batch, int lq, int heads,
                         cudaStream_t stream) {
  const long rows = static_cast<long>(batch) * lq * heads;
  const int blocks = static_cast<int>((rows + 255) / 256 < 4096 ? (rows + 255) / 256 : 4096);
  delta_kernel<T, Dh><<<blocks, 256, 0, stream>>>(out, dout, delta, rows, lq, heads);
  return cudaGetLastError();
}

}  // namespace fa
