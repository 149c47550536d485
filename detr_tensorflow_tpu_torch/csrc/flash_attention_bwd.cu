// Fused multi-head attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_bwd_kernel` (with its launcher `_mha_bwd_rule`)
// of detr_tensorflow_tpu/ops/pallas/flash_attention.py. Given the forward's
// inputs, its row log-sum-exp (flash_attention_fwd.cu writes it when
// autograd needs it) and dO, it computes dQ, dK and dV with the
// softmax recomputed and the dropout mask replayed, never storing an
// (Lq, Lk) matrix:
//
//   p_ij  = exp(q_i . k_j + bias_j - lse_i)        (1 / Lk on a row whose keys are all padded)
//   m_ij  = dropout multiplier (0 or 1 / (1 - rate)), flash_attention_common.cuh
//   dV_j  = sum_i p_ij m_ij dO_i
//   dS_ij = p_ij (m_ij dO_i . v_j - delta_i),  0 on padded keys
//   delta_i = sum_j p_ij m_ij dO_i . v_j        (= dO_i . O_i in exact arithmetic)
//   dQ_i  = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i
//
// q is already scaled by head_dim ** -0.5, so dQ is the gradient of the
// scaled q, as in the TPU kernel. A padded key's score is a fill in the
// plain version (masked_fill), so no gradient reaches q or k through it.
//
// What bounds it: as in the forward, 2 * Dh fused multiply-adds per
// (query, key) pair and matrix product (four products here: QK^T, dO V^T,
// P^T dO, dS^T Q for dK/dV; three for dQ), plus one exp and, with dropout,
// one Philox4x32-10 per pair. Arithmetic on the fp32 FMA pipes. fp32 calls
// run flash_attention_bwd_mma.cu on the tensor cores instead
// (ops/flash_attention.py:backward_route); this kernel takes bf16, and fp32
// when called directly.
//
// Design. The TPU kernel keeps one head's K/V resident and walks the query
// chunks in order, carrying dK/dV in VMEM scratch: one program per
// (batch * head), 64 programs at DETR's training batch, half of the
// H100's 132 SMs. Here the work is split the usual GPU way, into two
// kernels that need no atomics, so the gradients are deterministic:
//   * dK/dV: one CTA per (batch * head, 64 keys); a thread owns one key row
//     (two threads share a row at Dh = 64) and keeps k, v, dk, dv in
//     registers, while tiles of 16 queries with their dO, lse and delta
//     are staged in shared memory and read by all threads as broadcasts;
//   * dQ: the forward's layout, one CTA per (batch * head, 16 query rows),
//     8 lanes per row, K/V streamed in 64-key tiles through shared memory,
//     the lanes' partial dq merged with warp shuffles at the end;
//   * delta_i = sum_j p_ij m_ij dO_i . v_j, the TPU kernel's `delta`, in a
//     pre-pass: the dQ kernel's walk over the keys without the dS K product,
//     summed in fp32. rowsum(dO * O) is the same sum in exact arithmetic
//     (flash_attention_bwd_mma.cu computes it so, from its fp32 O), but
//     from a bf16 O it misses the walk's sum by O's rounding: dS's rows no
//     longer sum to zero, and where the keys share a large common component
//     (DETR's cross-attention keys are memory + pos) dK carries it as error.
//     A DETR-R50 bf16 step's k_proj weight gradient came out ~15x further
//     from the fp32 step's than autograd's. The TPU kernel recomputes o in
//     fp32 for the same reason. The walk serves both dtypes, so the
//     forward's O is not read here.
// The dropout bit is a pure function of (seed, b * H + h, i, j), so each
// kernel regenerates the forward's mask whatever its own tiling.
//
// Numerics: in bf16 the products take bf16 operands as the TPU kernel's
// astype() calls do (p * m rounded before P^T dO, dS rounded before dS K and
// dS^T Q); accumulation is fp32 everywhere, delta included.
//
// Entry point: a plain C function launching the three kernels on the given
// stream. It allocates nothing (the caller passes the delta scratch), does
// not synchronise, and returns cudaGetLastError().

#include <math.h>

#include "flash_attention_common.cuh"

namespace {

using fa::kMaskBias;
using fa::kMaskedRowLse;

// ---- dK / dV -------------------------------------------------------------

constexpr int kKvThreads = 64;
constexpr int kTileQ = 16;  // queries staged per step
constexpr int kPart = 32;   // head dims owned by one thread

template <typename T, int Dh>
__global__ void __launch_bounds__(kKvThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, const unsigned char* __restrict__ mask,
            const unsigned long long* __restrict__ seed, unsigned threshold,
            float keep_scale, T* __restrict__ dk, T* __restrict__ dv, int lq, int lk,
            int heads) {
  constexpr int kLanes = Dh / kPart;          // threads sharing one key row
  constexpr int kKeys = kKvThreads / kLanes;  // keys per CTA
  constexpr int kChunksPerRow = Dh / 8;
  __shared__ __align__(16) float q_tile[kTileQ * Dh];
  __shared__ __align__(16) float do_tile[kTileQ * Dh];
  __shared__ float lse_tile[kTileQ];
  __shared__ float delta_tile[kTileQ];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int part = tid % kLanes;
  const int j = blockIdx.x * kKeys + tid / kLanes;
  const bool key_ok = j < lk;
  const bool key_padded = key_ok && mask != nullptr && mask[static_cast<long>(b) * lk + j] != 0;
  const float bias = key_padded ? kMaskBias : 0.f;
  const bool dropout = threshold != 0u;
  const uint2 key = dropout ? fa::seed_key(seed) : make_uint2(0u, 0u);
  const float inv_lk = 1.f / static_cast<float>(lk);
  const long kv_offset = ((static_cast<long>(b) * lk + j) * heads + h) * Dh + part * kPart;

  float kr[kPart], vr[kPart], dkr[kPart], dvr[kPart];
#pragma unroll
  for (int d = 0; d < kPart; d += 8) {
    if (key_ok) {
      fa::load8(k + kv_offset + d, kr + d);
      fa::load8(v + kv_offset + d, vr + d);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kr[d + e] = vr[d + e] = 0.f;
    }
  }
#pragma unroll
  for (int d = 0; d < kPart; ++d) dkr[d] = dvr[d] = 0.f;

  for (int i0 = 0; i0 < lq; i0 += kTileQ) {
    for (int c = tid; c < kTileQ * kChunksPerRow; c += kKvThreads) {
      const int r = c / kChunksPerRow;
      const int col = (c % kChunksPerRow) * 8;
      const int i = i0 + r;
      float qa[8], ga[8];
      if (i < lq) {
        const long off = ((static_cast<long>(b) * lq + i) * heads + h) * Dh + col;
        fa::load8(q + off, qa);
        fa::load8(dout + off, ga);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qa[e] = ga[e] = 0.f;
      }
      float4* qd = reinterpret_cast<float4*>(q_tile + r * Dh + col);
      float4* gd = reinterpret_cast<float4*>(do_tile + r * Dh + col);
      qd[0] = make_float4(qa[0], qa[1], qa[2], qa[3]);
      qd[1] = make_float4(qa[4], qa[5], qa[6], qa[7]);
      gd[0] = make_float4(ga[0], ga[1], ga[2], ga[3]);
      gd[1] = make_float4(ga[4], ga[5], ga[6], ga[7]);
    }
    if (tid < kTileQ) {
      const int i = i0 + tid;
      lse_tile[tid] = i < lq ? lse[static_cast<long>(bh) * lq + i] : 0.f;
      delta_tile[tid] = i < lq ? delta[static_cast<long>(bh) * lq + i] : 0.f;
    }
    __syncthreads();

    const int n = min(kTileQ, lq - i0);  // uniform across the CTA
    for (int r = 0; r < n; ++r) {
      const float* qr = q_tile + r * Dh + part * kPart;
      const float* gr = do_tile + r * Dh + part * kPart;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < kPart; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        const float4 gg = *reinterpret_cast<const float4*>(gr + d);
        s = fmaf(qq.x, kr[d], s);
        s = fmaf(qq.y, kr[d + 1], s);
        s = fmaf(qq.z, kr[d + 2], s);
        s = fmaf(qq.w, kr[d + 3], s);
        dpv = fmaf(gg.x, vr[d], dpv);
        dpv = fmaf(gg.y, vr[d + 1], dpv);
        dpv = fmaf(gg.z, vr[d + 2], dpv);
        dpv = fmaf(gg.w, vr[d + 3], dpv);
      }
      if (kLanes == 2) {  // the two halves of a Dh = 64 row are neighbouring lanes
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dpv += __shfl_xor_sync(0xffffffffu, dpv, 1);
      }
      const float l = lse_tile[r];
      const float p = l <= kMaskedRowLse ? inv_lk : __expf(s + bias - l);
      const float mf =
          dropout ? fa::dropout_factor(key, bh, i0 + r, j, threshold, keep_scale) : 1.f;
      const float pd = fa::round_to(p * mf, q);
      const float ds = key_padded ? 0.f : fa::round_to(p * (mf * dpv - delta_tile[r]), q);
#pragma unroll
      for (int d = 0; d < kPart; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qr + d);
        const float4 gg = *reinterpret_cast<const float4*>(gr + d);
        dvr[d] = fmaf(pd, gg.x, dvr[d]);
        dvr[d + 1] = fmaf(pd, gg.y, dvr[d + 1]);
        dvr[d + 2] = fmaf(pd, gg.z, dvr[d + 2]);
        dvr[d + 3] = fmaf(pd, gg.w, dvr[d + 3]);
        dkr[d] = fmaf(ds, qq.x, dkr[d]);
        dkr[d + 1] = fmaf(ds, qq.y, dkr[d + 1]);
        dkr[d + 2] = fmaf(ds, qq.z, dkr[d + 2]);
        dkr[d + 3] = fmaf(ds, qq.w, dkr[d + 3]);
      }
    }
    __syncthreads();
  }

  if (key_ok) {
#pragma unroll
    for (int d = 0; d < kPart; ++d) {
      fa::store_out(dk + kv_offset + d, dkr[d]);
      fa::store_out(dv + kv_offset + d, dvr[d]);
    }
  }
}

// ---- dQ ------------------------------------------------------------------

constexpr int kQThreads = 128;
constexpr int kSplit = 8;                      // lanes sharing one query row
constexpr int kRows = kQThreads / kSplit;      // query rows per CTA
constexpr int kTileK = 64;                     // keys staged per step
constexpr int kKeysPerLane = kTileK / kSplit;  // keys of a tile per lane

// kDelta: the pre-pass. The same walk writes delta_i = sum_j p_ij m_ij
// dO_i . v_j (every key, a padded one with its p of 0, or 1 / Lk on a row
// whose keys are all padded) to ``delta`` instead of reading it, and no dq.
template <typename T, int Dh, bool kDelta>
__global__ void __launch_bounds__(kQThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, const unsigned char* __restrict__ mask,
          const unsigned long long* __restrict__ seed, unsigned threshold,
          float keep_scale, T* __restrict__ dq, int lq, int lk, int heads) {
  constexpr int kStride = Dh + 4;  // conflict-free reads by the 8 lanes of a row
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
  const bool dropout = threshold != 0u;
  const uint2 key = dropout ? fa::seed_key(seed) : make_uint2(0u, 0u);
  const float inv_lk = 1.f / static_cast<float>(lk);
  const long token_stride = static_cast<long>(heads) * Dh;
  const T* k_head = k + (static_cast<long>(b) * lk * heads + h) * Dh;
  const T* v_head = v + (static_cast<long>(b) * lk * heads + h) * Dh;
  const long row_offset = ((static_cast<long>(b) * lq + row) * heads + h) * Dh;

  float q_row[Dh], do_row[Dh], acc[Dh];
  float l_row = 0.f, delta_row = 0.f;
  if (row_ok) {
#pragma unroll
    for (int d = 0; d < Dh; d += 8) {
      fa::load8(q + row_offset + d, q_row + d);
      fa::load8(dout + row_offset + d, do_row + d);
    }
    l_row = lse[static_cast<long>(bh) * lq + row];
    if constexpr (!kDelta) delta_row = delta[static_cast<long>(bh) * lq + row];
  } else {
#pragma unroll
    for (int d = 0; d < Dh; ++d) q_row[d] = do_row[d] = 0.f;
  }
  const bool row_padded = l_row <= kMaskedRowLse;
#pragma unroll
  for (int d = 0; d < Dh; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kTileK) {
    for (int c = tid; c < kTileK * kChunksPerRow; c += kQThreads) {
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
      const bool padded = mask != nullptr && j < lk && mask[static_cast<long>(b) * lk + j] != 0;
      bias_tile[tid] = padded ? kMaskBias : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int r = lane_key + t * kSplit;
      const int j = k0 + r;
      if (j < lk) {
        const float* k_row = k_tile + r * kStride;
        const float* v_row = v_tile + r * kStride;
        float s = 0.f, dpv = 0.f;
#pragma unroll
        for (int d = 0; d < Dh; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
          const float4 vv = *reinterpret_cast<const float4*>(v_row + d);
          s = fmaf(q_row[d], kk.x, s);
          s = fmaf(q_row[d + 1], kk.y, s);
          s = fmaf(q_row[d + 2], kk.z, s);
          s = fmaf(q_row[d + 3], kk.w, s);
          dpv = fmaf(do_row[d], vv.x, dpv);
          dpv = fmaf(do_row[d + 1], vv.y, dpv);
          dpv = fmaf(do_row[d + 2], vv.z, dpv);
          dpv = fmaf(do_row[d + 3], vv.w, dpv);
        }
        const float bias = bias_tile[r];
        const float p = row_padded ? inv_lk : __expf(s + bias - l_row);
        const float mf =
            dropout ? fa::dropout_factor(key, bh, row, j, threshold, keep_scale) : 1.f;
        if constexpr (kDelta) {
          delta_row = fmaf(p * mf, dpv, delta_row);
          continue;
        }
        const float ds = bias != 0.f ? 0.f : fa::round_to(p * (mf * dpv - delta_row), q);
#pragma unroll
        for (int d = 0; d < Dh; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
          acc[d] = fmaf(ds, kk.x, acc[d]);
          acc[d + 1] = fmaf(ds, kk.y, acc[d + 1]);
          acc[d + 2] = fmaf(ds, kk.z, acc[d + 2]);
          acc[d + 3] = fmaf(ds, kk.w, acc[d + 3]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (kDelta) {
#pragma unroll
    for (int off = 1; off < kSplit; off <<= 1)
      delta_row += __shfl_xor_sync(0xffffffffu, delta_row, off);
    if (row_ok && lane_key == 0) delta[static_cast<long>(bh) * lq + row] = delta_row;
    return;
  }

  // Sum the kSplit lanes' partial dq (neighbouring lanes of one warp).
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
#pragma unroll
    for (int d = 0; d < Dh; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], off);
  }
  if (row_ok) {
    constexpr int kPerLane = Dh / kSplit;  // each lane writes its own slice
#pragma unroll
    for (int d = 0; d < Dh; ++d) {
      if (d / kPerLane == lane_key) fa::store_out(dq + row_offset + d, acc[d]);
    }
  }
}

template <typename T, int Dh>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const void* mask, const void* seed, unsigned threshold,
           float keep_scale, void* dq, void* dk, void* dv, float* delta, int batch, int lq,
           int lk, int heads, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const unsigned long long* sd = static_cast<const unsigned long long*>(seed);
  const dim3 q_grid((lq + kRows - 1) / kRows, batch * heads);
  dq_kernel<T, Dh, true><<<q_grid, kQThreads, 0, stream>>>(
      tq, tk, tv, tdo, lse, delta, m, sd, threshold, keep_scale, nullptr, lq, lk, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kKeys = kKvThreads / (Dh / kPart);
  const dim3 kv_grid((lk + kKeys - 1) / kKeys, batch * heads);
  dkdv_kernel<T, Dh><<<kv_grid, kKvThreads, 0, stream>>>(
      tq, tk, tv, tdo, lse, delta, m, sd, threshold, keep_scale, static_cast<T*>(dk),
      static_cast<T*>(dv), lq, lk, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  dq_kernel<T, Dh, false><<<q_grid, kQThreads, 0, stream>>>(tq, tk, tv, tdo, lse, delta, m, sd,
                                                            threshold, keep_scale,
                                                            static_cast<T*>(dq), lq, lk, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dq: (batch, lq, heads, head_dim); k, v, dk, dv: (batch, lk, heads,
// head_dim); out, dout: as q; all of dtype (0 = float32, 1 = bfloat16),
// contiguous; out is not read (delta comes from the walk) and stays so
// that both backwards share one entry signature. lse: (batch * heads, lq)
// fp32 from flash_attention_fwd.
// mask, seed, threshold, keep_scale: as for flash_attention_fwd (the same
// values the forward got). delta: (batch * heads, lq) fp32 scratch.
// Returns a cudaError_t as int (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* lse,
                                   const void* mask, const void* seed, unsigned threshold,
                                   float keep_scale, void* dq, void* dk, void* dv,
                                   void* delta, int batch, int lq, int lk, int heads,
                                   int head_dim, int dtype, void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch * heads > 65535 ||
      lse == nullptr || delta == nullptr || (threshold != 0u && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0 && head_dim == 32)
    return launch<float, 32>(q, k, v, dout, l, mask, seed, threshold, keep_scale, dq, dk,
                             dv, dl, batch, lq, lk, heads, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, dout, l, mask, seed, threshold, keep_scale, dq, dk,
                             dv, dl, batch, lq, lk, heads, s);
  if (dtype == 1 && head_dim == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, dout, l, mask, seed, threshold, keep_scale,
                                     dq, dk, dv, dl, batch, lq, lk, heads, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, l, mask, seed, threshold, keep_scale,
                                     dq, dk, dv, dl, batch, lq, lk, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
