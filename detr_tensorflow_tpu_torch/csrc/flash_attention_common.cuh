// Helpers shared by the flash-attention forward and backward kernels
// (flash_attention_fwd.cu, flash_attention_fwd_mma.cu,
// flash_attention_fwd_tf32.cu, flash_attention_bwd.cu,
// flash_attention_bwd_mma.cu): vector loads that widen to fp32, the bf16
// rounding points of the TPU kernel, the attention-dropout keep bit, the
// backward's delta pre-pass, `cp.async` copies, and the helpers around the
// 3xTF32 products (tf32_mma.cuh) of the two fp32 tensor-core kernels.
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

#include "cp_async.cuh"
#include "tf32_mma.cuh"

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


// ---- cp.async (cp_async.cuh) ------------------------------------------------

using cpa::cp_async16;
using cpa::cp_async4;
using cpa::cp_async_commit;
using cpa::cp_async_wait;
using cpa::smem_addr;

// ---- helpers of the two 3xTF32 kernels (tf32_mma.cuh) -------------------------

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&x)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) zero(x[i]);
}

// A 16-byte chunk of a staged tile, split in place: the big parts
// overwrite it, the small parts go to the same offset of `small`.
__device__ __forceinline__ void split_chunk(float* big, float* small) {
  const float4 x = *reinterpret_cast<const float4*>(big);
  uint4 hi, lo;
  tf32mma::split_tf32(x.x, hi.x, lo.x);
  tf32mma::split_tf32(x.y, hi.y, lo.y);
  tf32mma::split_tf32(x.z, hi.z, lo.z);
  tf32mma::split_tf32(x.w, hi.w, lo.w);
  *reinterpret_cast<uint4*>(big) = hi;
  *reinterpret_cast<uint4*>(small) = lo;
}

// Accumulator values c0..c3 = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1) as a split A fragment over their 8 columns, k position t being
// column 2t and t + 4 column 2t + 1. The order of a product's k dimension
// is free as long as A and B agree on it, so a product whose A comes out
// of an accumulator (P o M, dS) needs no lane exchange; its B loads read
// rows 2t and 2t + 1 (`add_products`).
__device__ __forceinline__ void accumulator_as_a(const float (&c)[4], unsigned (&big)[4],
                                                 unsigned (&small)[4]) {
  tf32mma::split_tf32(c[0], big[0], small[0]);
  tf32mma::split_tf32(c[2], big[1], small[1]);
  tf32mma::split_tf32(c[1], big[2], small[2]);
  tf32mma::split_tf32(c[3], big[3], small[3]);
}

// acc (16 rows x 8 kSteps columns) += A B over kStep n tiles of 8 from row
// r0 of a staged tile: A the split fragments of each n tile (k order as
// accumulator_as_a), B rows r0 + 8u + 2t and + 1 at columns 8d + g. The
// step's products are summed in fresh accumulators and then added to acc
// with fp32 adds. At a row stride of 4 mod 32 floats the B loads hit banks
// (8t + g + 8d) and (8t + g + 8d + 4) mod 32: no conflict.
template <int kSteps, int kStep, int kStride>
__device__ __forceinline__ void add_products(float (&acc)[kSteps][4],
                                             const unsigned (&a_big)[kStep][4],
                                             const unsigned (&a_small)[kStep][4],
                                             const float* b_big, const float* b_small, int r0,
                                             int t, int g) {
#pragma unroll
  for (int d = 0; d < kSteps; ++d) {
    float hi[4], lo[4];
    zero(hi);
    zero(lo);
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const int o = (r0 + 8 * u + 2 * t) * kStride + 8 * d + g;
      tf32mma::mma_3xtf32(hi, lo, a_big[u], a_small[u], b_big, b_small, o, o + kStride);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] += hi[e] + lo[e];
  }
}

// An A operand kept for a warp's whole loop, split: 16 rows by N k8 steps
// of the head dim, fragment (row g, col t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4) of each step. At Dh = 32 the parts sit in registers. At Dh = 64,
// where the kernels' accumulators take 64 registers of their own, they
// sit in a per-warp slab of shared memory, a 32-word row per register
// that each lane reads at its own column: no bank conflict, no barrier.
template <int N, bool kInRegs>
struct HeldA {
  static constexpr int kSlabWords = kInRegs ? 0 : N * 4 * 2 * 32;  // per warp
  unsigned big[kInRegs ? N : 1][4], small[kInRegs ? N : 1][4];
  unsigned* slab;  // this lane's column of the warp's slab

  // Loads rows r0 and r0 + 8 (of n_rows, zero past them) of a (rows,
  // heads, Dh) slab at token stride ts, columns from the lane's t.
  __device__ __forceinline__ void load(const float* head, long ts, int r0, int n_rows, int t,
                                       unsigned* warp_slab, int lane) {
    slab = warp_slab + lane;
    const bool ok0 = r0 < n_rows, ok1 = r0 + 8 < n_rows;
    const float* p0 = head + (ok0 ? static_cast<long>(r0) * ts : 0L);
    const float* p1 = head + (ok1 ? static_cast<long>(r0 + 8) * ts : 0L);
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int col = 8 * s + t;
      const float x[4] = {ok0 ? p0[col] : 0.f, ok1 ? p1[col] : 0.f, ok0 ? p0[col + 4] : 0.f,
                          ok1 ? p1[col + 4] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned b, sm;
        tf32mma::split_tf32(x[e], b, sm);
        if constexpr (kInRegs) {
          big[s][e] = b;
          small[s][e] = sm;
        } else {
          slab[(s * 4 + e) * 64] = b;
          slab[(s * 4 + e) * 64 + 32] = sm;
        }
      }
    }
  }

  __device__ __forceinline__ void get(int s, unsigned (&b)[4], unsigned (&sm)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kInRegs) {
        b[e] = big[s][e];
        sm[e] = small[s][e];
      } else {
        b[e] = slab[(s * 4 + e) * 64];
        sm[e] = slab[(s * 4 + e) * 64 + 32];
      }
    }
  }
};

}  // namespace fa
