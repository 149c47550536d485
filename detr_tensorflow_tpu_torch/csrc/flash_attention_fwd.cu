// Fused multi-head attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// detr_tensorflow_tpu/ops/pallas/flash_attention.py (launched by
// `_mha_fwd_call` through `pl.pallas_call`). It runs on no path: fp32 calls
// run flash_attention_fwd_tf32.cu and bf16 calls, with or without dropout,
// flash_attention_fwd_mma.cu (ops/flash_attention.py:forward_route). It
// stays callable (launch_forward_simt) as their yardstick, and its
// flash_attention_keep_mask writes the keep mask the tests hold the others
// to. It computes the same function:
//
//   out[b, i, h, :] = sum_j drop_ij softmax_j(q[b, i, h, :] . k[b, j, h, :] + bias[b, j]) v[b, j, h, :]
//
// with scores and softmax in fp32, bias = -1e30 on padded keys (mask true)
// and 0 elsewhere, and q already scaled by head_dim ** -0.5 by the caller.
// drop_ij is 1 without dropout; with dropout it is the Philox keep bit of
// flash_attention_common.cuh times 1 / (1 - rate), as the TPU kernel's
// `_dropout_mask`. Tensors keep the model's (B, L, H, Dh) layout; the
// kernel reads them with strides, so the caller folds and pads nothing.
// For the backward (flash_attention_bwd.cu) the kernel can also write the
// row log-sum-exp lse[b, h, i] = max_j s_ij + log sum_j exp(s_ij - max);
// the served path passes a null pointer and does no extra work.
//
// What bounds it on the card: at DETR's shapes (Dh = 32, at most ~1.2k keys)
// each (query, key) pair costs 2 * Dh fused multiply-adds and one exp, while
// K and V of one head are only 2 * Lk * Dh elements. The work is arithmetic,
// not bytes: this first version runs it on the fp32 FMA pipes, and shared
// memory bandwidth for the K/V reads is its second limit. With dropout
// each pair also runs one Philox4x32-10 (10 rounds of two 32-bit
// multiplies). Tensor cores (mma/wgmma) and TMA are left for later work.
//
// Design, rethought for the GPU instead of copied from the TPU's blocks:
//   * one CTA per (batch * head, tile of 16 query rows); 128 threads;
//   * 8 threads share one query row. Each keeps the row's q and its own
//     fp32 accumulator in registers and takes every 8th key of a tile, so a
//     row's keys are spread over 8 lanes and short query tiles still fill
//     the card. The 8 partial softmax states are merged with warp shuffles
//     at the end;
//   * K/V stream through shared memory 64 keys at a time, converted to fp32
//     on the way in, rows padded to Dh + 4 floats so the 8 lanes of a row
//     group read 8 different keys without bank conflicts;
//   * online softmax (running max and sum) instead of the TPU kernel's
//     single pass over all keys: nothing of size Lk is kept per row. The
//     running sum takes every key; only the PV accumulator sees dropout;
//   * the ragged edges are masked in the kernel (no padding of Lq or Lk),
//     and padded keys get the -1e30 additive bias, as on the TPU.
//
// Numerics: in bf16 the TPU kernel normalises P and then rounds it to bf16
// before the PV product; here the unnormalised P (in [0, 1], times the
// dropout scale) is rounded to bf16 and the sum is divided out at the end,
// so bf16 results differ from the TPU kernel's by rounding only. In fp32
// the two agree to summation order. A row whose keys are all padded has
// every score at -1e30 exactly (the dot product is below half an ulp of
// 1e30), so its softmax is uniform, as on the TPU; its lse is then -1e30
// and the backward recognises the row by that.
//
// Entry points: plain C functions, built with nvcc into a shared library
// and called through ctypes. They launch on the given stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using fa::kMaskBias;

constexpr int kThreads = 128;
constexpr int kSplit = 8;                          // lanes sharing one query row
constexpr int kRows = kThreads / kSplit;           // query rows per CTA
constexpr int kTileK = 64;                         // keys staged per step
constexpr int kKeysPerLane = kTileK / kSplit;      // keys of a tile per lane

// kTraining (dropout or a row lse to write) is a template flag so that the
// served variant compiles to the inference-only kernel: with the Philox code
// and the lse store merely present, it took 0.304 ms instead of 0.276 ms at
// (1232, 1232) fp32, B=2, on an H100 at 700 W.
template <typename T, int Dh, bool kTraining>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const unsigned char* __restrict__ mask,
                           const unsigned long long* __restrict__ seed,
                           unsigned threshold, float keep_scale,
                           T* __restrict__ out, float* __restrict__ lse,
                           int lq, int lk, int heads) {
  constexpr int kStride = Dh + 4;
  constexpr int kChunksPerRow = Dh / 8;
  __shared__ __align__(16) float k_tile[kTileK * kStride];
  __shared__ __align__(16) float v_tile[kTileK * kStride];
  __shared__ float bias_tile[kTileK];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane_key = tid % kSplit;
  const int row = blockIdx.x * kRows + tid / kSplit;
  const bool row_ok = row < lq;
  const bool dropout = kTraining && threshold != 0u;
  const uint2 key = dropout ? fa::seed_key(seed) : make_uint2(0u, 0u);
  const long token_stride = static_cast<long>(heads) * Dh;
  const T* k_head = k + (static_cast<long>(b) * lk * heads + h) * Dh;
  const T* v_head = v + (static_cast<long>(b) * lk * heads + h) * Dh;

  float q_row[Dh];
  if (row_ok) {
    const T* q_ptr = q + ((static_cast<long>(b) * lq + row) * heads + h) * Dh;
#pragma unroll
    for (int d = 0; d < Dh; d += 8) fa::load8(q_ptr + d, q_row + d);
  } else {
#pragma unroll
    for (int d = 0; d < Dh; ++d) q_row[d] = 0.f;
  }

  float acc[Dh];
#pragma unroll
  for (int d = 0; d < Dh; ++d) acc[d] = 0.f;
  float m = -INFINITY;  // running max of this lane's scores
  float l = 0.f;        // running sum of exp(score - m), dropped keys included

  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    for (int c = tid; c < kTileK * kChunksPerRow; c += kThreads) {
      const int r = c / kChunksPerRow;
      const int col = (c % kChunksPerRow) * 8;
      const int j = k0 + r;
      float kv[8], vv[8];
      if (j < lk) {
        fa::load8(k_head + j * token_stride + col, kv);
        fa::load8(v_head + j * token_stride + col, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(k_tile + r * kStride + col);
      float4* vd = reinterpret_cast<float4*>(v_tile + r * kStride + col);
      kd[0] = make_float4(kv[0], kv[1], kv[2], kv[3]);
      kd[1] = make_float4(kv[4], kv[5], kv[6], kv[7]);
      vd[0] = make_float4(vv[0], vv[1], vv[2], vv[3]);
      vd[1] = make_float4(vv[4], vv[5], vv[6], vv[7]);
    }
    if (tid < kTileK) {
      const int j = k0 + tid;
      const bool padded = mask != nullptr && j < lk &&
                          mask[static_cast<long>(b) * lk + j] != 0;
      bias_tile[tid] = padded ? kMaskBias : 0.f;
    }
    __syncthreads();

    float s[kKeysPerLane];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int r = lane_key + i * kSplit;
      const float* k_row = k_tile + r * kStride;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < Dh; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
        dot = fmaf(q_row[d], kk.x, dot);
        dot = fmaf(q_row[d + 1], kk.y, dot);
        dot = fmaf(q_row[d + 2], kk.z, dot);
        dot = fmaf(q_row[d + 3], kk.w, dot);
      }
      s[i] = (k0 + r < lk) ? dot + bias_tile[r] : -INFINITY;
      m_tile = fmaxf(m_tile, s[i]);
    }

    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {  // false only while this lane has seen no key
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < Dh; ++d) acc[d] *= alpha;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const float p = __expf(s[i] - m_new);
        l += p;
        float pd = p;
        if (dropout && row_ok && k0 + lane_key + i * kSplit < lk)
          pd *= fa::dropout_factor(key, bh, row, k0 + lane_key + i * kSplit, threshold,
                                   keep_scale);
        const float pv = fa::round_to(pd, q);
        const float* v_row = v_tile + (lane_key + i * kSplit) * kStride;
#pragma unroll
        for (int d = 0; d < Dh; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(v_row + d);
          acc[d] = fmaf(pv, vv.x, acc[d]);
          acc[d + 1] = fmaf(pv, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(pv, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(pv, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  // Merge the kSplit partial softmax states of a row (neighbouring lanes).
  float m_row = m;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
  const float scale = (m == -INFINITY) ? 0.f : __expf(m - m_row);
  l *= scale;
#pragma unroll
  for (int d = 0; d < Dh; ++d) acc[d] *= scale;
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int d = 0; d < Dh; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }

  if (row_ok) {
    const float inv_l = 1.f / l;
    T* out_ptr = out + ((static_cast<long>(b) * lq + row) * heads + h) * Dh;
    constexpr int kPerLane = Dh / kSplit;  // each lane writes its own slice
#pragma unroll
    for (int d = 0; d < Dh; ++d) {
      if (d / kPerLane == lane_key) fa::store_out(out_ptr + d, acc[d] * inv_l);
    }
    if (kTraining && lse != nullptr && lane_key == 0)
      lse[static_cast<long>(bh) * lq + row] = m_row + logf(l);
  }
}

// keep[bh, i, j] = 1 if the dropout of (bh, i, j) keeps the element.
__global__ void keep_mask_kernel(const unsigned long long* __restrict__ seed,
                                 unsigned char* __restrict__ keep, long total,
                                 int lq, int lk, unsigned threshold) {
  const uint2 key = fa::seed_key(seed);
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(e % lk);
    const long rest = e / lk;
    const int i = static_cast<int>(rest % lq);
    const unsigned bh = static_cast<unsigned>(rest / lq);
    keep[e] = fa::dropout_factor(key, bh, i, j, threshold, 1.f) != 0.f;
  }
}

template <typename T, int Dh>
void launch(const void* q, const void* k, const void* v, const void* mask,
            const void* seed, unsigned threshold, float keep_scale, void* out,
            float* lse, int batch, int lq, int lk, int heads, cudaStream_t stream) {
  const dim3 grid((lq + kRows - 1) / kRows, batch * heads);
  auto kernel = threshold != 0u || lse != nullptr ? flash_attention_fwd_kernel<T, Dh, true>
                                                 : flash_attention_fwd_kernel<T, Dh, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
      static_cast<const unsigned long long*>(seed), threshold, keep_scale,
      static_cast<T*>(out), lse, lq, lk, heads);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: (batch, lk) bytes, nonzero = padded
// key, or null for no mask. threshold: 0 for no dropout, else
// ceil(rate * 2^32) with seed a device pointer to one 64-bit seed and
// keep_scale = 1 / (1 - rate). lse: (batch, heads, lq) fp32, or null.
// Returns a cudaError_t as int (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, const void* seed,
                                   unsigned threshold, float keep_scale, void* out,
                                   void* lse, int batch, int lq, int lk, int heads,
                                   int head_dim, int dtype, void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch * heads > 65535 ||
      (threshold != 0u && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && head_dim == 32) {
    launch<float, 32>(q, k, v, mask, seed, threshold, keep_scale, out, l, batch, lq, lk, heads, s);
  } else if (dtype == 0 && head_dim == 64) {
    launch<float, 64>(q, k, v, mask, seed, threshold, keep_scale, out, l, batch, lq, lk, heads, s);
  } else if (dtype == 1 && head_dim == 32) {
    launch<__nv_bfloat16, 32>(q, k, v, mask, seed, threshold, keep_scale, out, l, batch, lq,
                              lk, heads, s);
  } else if (dtype == 1 && head_dim == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, mask, seed, threshold, keep_scale, out, l, batch, lq,
                              lk, heads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dropout keep mask of one attention call, (batch * heads, lq, lk)
// bytes: the bits the kernels above and in flash_attention_bwd.cu draw for
// the same seed and threshold. For tests; the training path never
// materialises it.
extern "C" int flash_attention_keep_mask(const void* seed, void* keep, int batch_heads,
                                         int lq, int lk, unsigned threshold,
                                         void* stream) {
  if (batch_heads <= 0 || lq <= 0 || lk <= 0 || seed == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long total = static_cast<long>(batch_heads) * lq * lk;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  keep_mask_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(seed), static_cast<unsigned char*>(keep), total,
      lq, lk, threshold);
  return static_cast<int>(cudaGetLastError());
}
