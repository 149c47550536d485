// Fused multi-head attention forward in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// detr_tensorflow_tpu/ops/pallas/flash_attention.py (launched by
// `_mha_fwd_call` through `pl.pallas_call`) for bf16 calls, with or without
// dropout:
//
//   out[b, i, h, :] =
//       sum_j m_ij softmax_j(q[b, i, h, :] . k[b, j, h, :] + bias[b, j]) v[b, j, h, :]
//
// with scores and softmax in fp32, bias = -1e30 on padded keys (mask true)
// and 0 elsewhere, q already scaled by head_dim ** -0.5 by the caller, and
// m_ij the dropout multiplier (1 without dropout; else 0 or 1 / (1 - rate)
// from the Philox bits of flash_attention_common.cuh, which the backward
// replays). Optionally it writes the row log-sum-exp lse[b, h, i] = max_j
// s_ij + log sum_j exp(s_ij - max), taken before dropout, that the backward
// (flash_attention_bwd_bf16.cu) reads. fp32 calls run on the tensor cores
// too, with 3xTF32 products (flash_attention_fwd_tf32.cu); the SIMT kernel
// of flash_attention_fwd.cu runs on no path (ops/flash_attention.py:
// forward_route).
//
// What bounds it on this card, and what the design does about each:
//   * The exps. At Dh = 32 each (query, key) pair costs 64 tensor-core
//     flops (QK^T and PV) but one exp on the SFU (16 results per clock per
//     SM). At (1232, 1232) B=2 H=8 that is 24.3 M exps, ~6 us at 1.98 GHz
//     on 132 SMs, against 3.1 us for the products at 989 TFLOP/s. So the
//     scores are kept in natural units and each p costs one subtract, one
//     multiply by log2(e) and one `ex2.approx` (no libm `expf`); the
//     subtract comes first so that a row whose keys are all padded (every
//     score exactly -1e30) gets exp2(0) = 1 for each key: a uniform softmax,
//     as on the TPU.
//   * The tensor-core issue rate at k = 32. QK^T has only two k16 steps at
//     Dh = 32, so each warp keeps its 16 query rows' Q fragments in
//     registers for the whole key loop, takes K from shared memory with
//     `ldmatrix` (rows padded to Dh + 8 elements: the 8 row addresses of
//     every 8x8 matrix fall in distinct bank groups), and reuses the fp32
//     score accumulators, rounded to bf16, directly as the A operand of PV
//     (the m16n8 accumulator layout is the m16n8k16 A layout); V comes in
//     with `ldmatrix.trans`.
//   * The latency of the K/V loads. A CTA walks its keys one 64-key tile
//     after another, so the tiles stream through a double-buffered
//     `cp.async` ring (16-byte chunks), and the key-padding mask bytes are
//     fetched into registers a tile ahead. Rows past Lk are zero-filled
//     with the src-size-0 form, so a stale row times p = 0 cannot make a
//     NaN.
//   * The fill at b1, and each warp's serial chain (scores, max, exps, PV
//     for one tile after another). A CTA has four warps. With 64 query rows
//     a CTA, b1's encoder (Lq = 1232, H = 8) gives 160 CTAs for 132 SMs and
//     the decoder (Lq = 100) 16. So the four warps of a CTA may instead
//     split each tile's keys over one row group of 16 rows, each warp with
//     its own running softmax, merged through shared memory at the end.
//     The wrapper (ops/flash_attention.py:cta_shape, the tf32 kernel's rule
//     too) takes 64-row CTAs when they number at least half the SMs (the
//     encoder at b1 and B=2; (320, 320) at B=2, 80 CTAs: 0.0063 ms against
//     0.0073 split; the b8 training step's 100 decoder queries, 128 CTAs:
//     10-20% faster than split, with or without dropout) and the 4-way
//     split otherwise (the 100 decoder queries served: 1.37x faster than
//     64-row CTAs at b1 on an H100). A 2 x 2 shape (32 rows, 312 CTAs at
//     b1) tied the 64-row CTAs there and was dropped. Splitting keys across
//     CTAs is the next lever for the decoder.
//   * Dropout (the bf16 training step): the Philox4x32-10 rounds, ~40
//     integer multiplies for the bits of 4 keys. The m16n8k16 accumulator
//     has the m16n8k8 TF32 layout of flash_attention_fwd_tf32.cu, so its
//     draw carries over: lanes t and t + 1 hold keys 4u .. 4u + 3 of rows g
//     and g + 8, lane t draws row g's call if t is even and row g + 8's if
//     odd, and the pair swap the two words the other needs (one call per 4
//     elements). The counters take the absolute key index, so the (1, 4)
//     shape, whose warps split each tile's keys, draws the bits of the
//     (4, 1) shape, of ops/flash_attention.py:keep_mask and of the
//     backward's pre-pass. The served kernel compiles without it (template
//     flag kDropout): its instructions are those of the kernel before. On
//     an H100 the draws take about a third of a b8 training call at Dh 32
//     ((252, 252): 0.0113 ms against 0.0076 without them). Moving them to
//     four warps of their own a tile ahead (A'-bf16's pre-pass design)
//     saved 2-9% at the 64-row shape but, at 8 warps a CTA, lost 40-80% at
//     the split shape, so the softmax warps draw. Nothing spills: ptxas
//     gives the dropout instantiations 140 / 94 registers at Dh 32 (64-row
//     / split shape; 103 / 72 without dropout, so three 64-row CTAs an SM
//     in place of four) and 136 / 124 at Dh 64; a cap of 128 (four CTAs an
//     SM) spilled 36-48 bytes and was slower (0.0122 ms).
// `wgmma` with TMA-fed tiles is the next step if this kernel stays behind
// PyTorch's scaled_dot_product_attention at the same shapes.
//
// Numerics: P is left unnormalised, multiplied by the dropout factor in
// fp32, rounded to bf16 for the PV product, and the fp32 row sum (of the
// unrounded p, before dropout) is divided out at the end; bf16 results
// differ from the TPU kernel's (which normalises and drops before rounding)
// by rounding only. The row max and sum are merged across the four lanes
// that hold a row with quad shuffles. A fully padded row stays uniform and
// is then dropped; keys past Lk keep p = 0, so a dropped key adds no NaN.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_attention_common.cuh"

namespace {

using bf16mma::ldmatrix_x4;
using bf16mma::ldmatrix_x4_trans;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
using fa::cp_async16;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::kMaskBias;

constexpr int kTileK = 64;             // keys per shared-memory tile
// Tiles of the cp.async ring: the next tile's loads overlap this one's math
// (four stages at Dh = 32 gave the same times on an H100, within the spread
// between two chip_smoke.py runs).
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One CTA: kRowGroups x kSplit warps over 16 * kRowGroups query rows of one
// (batch, head). The key loop walks every 64-key tile; the kSplit warps of a
// row group share its rows and take 64 / kSplit keys of each tile apiece,
// each with its own running softmax, merged through shared memory at the
// end. Fragment coordinates follow the PTX ISA's m16n8k16 layouts: lane =
// 4 * g + t holds rows g and g + 8 and, in each 8-column block, columns 2t
// and 2t + 1.
template <int Dh, int kRowGroups, int kSplit, bool kDropout>
__global__ void __launch_bounds__(32 * kRowGroups * kSplit)
flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const unsigned char* __restrict__ mask,
                               const unsigned long long* __restrict__ seed, unsigned threshold,
                               float keep_scale, __nv_bfloat16* __restrict__ out,
                               float* __restrict__ lse, int lq, int lk, int heads) {
  constexpr int kThreads = 32 * kRowGroups * kSplit;
  constexpr int kStride = Dh + 8;              // padded shared row, in elements
  constexpr int kChunks = Dh / 8;              // 16-byte chunks of one key row
  constexpr int kSteps = Dh / 16;              // k16 steps of QK^T
  constexpr int kNT = kTileK / 8 / kSplit;     // 8-key column blocks of S per warp and tile
  constexpr int kDT = Dh / 8;                  // 8-wide column blocks of O
  constexpr int kS = kStages;
  constexpr int kMerge = 16 * Dh + 32;         // floats a warp hands over: O, row max, row sum
  static_assert(kNT >= 2, "a warp takes at least one k16 step of keys");
  static_assert(kRowGroups * (kSplit - 1) * kMerge * 4 <= kS * kTileK * kStride * 2,
                "the merge reuses the K tiles' shared memory");
  __shared__ __align__(16) __nv_bfloat16 k_tile[kS][kTileK * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_tile[kS][kTileK * kStride];
  __shared__ float bias_tile[kS][kTileK];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int group = warp / kSplit;             // row group
  const int part = warp % kSplit;              // share of each tile's keys
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long token_stride = static_cast<long>(heads) * Dh;
  const __nv_bfloat16* k_head = k + (static_cast<long>(b) * lk * heads + h) * Dh;
  const __nv_bfloat16* v_head = v + (static_cast<long>(b) * lk * heads + h) * Dh;
  const unsigned char* mask_row = mask == nullptr ? nullptr : mask + static_cast<long>(b) * lk;
  const int n_tiles = (lk + kTileK - 1) / kTileK;

  // Issues the K/V loads of one tile and commits them as one cp.async
  // group; past the last tile it commits an empty group, so that the group
  // count stays one per tile.
  auto load_kv = [&](int tile, int stage) {
    if (tile < n_tiles) {
      const int k0 = tile * kTileK;
      for (int c = tid; c < kTileK * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int col = (c % kChunks) * 8;
        const int j = k0 + r;
        const long off = (j < lk ? static_cast<long>(j) : 0L) * token_stride + col;
        const int bytes = j < lk ? 16 : 0;
        cp_async16(&k_tile[stage][r * kStride + col], k_head + off, bytes);
        cp_async16(&v_tile[stage][r * kStride + col], v_head + off, bytes);
      }
    }
    cp_async_commit();
  };

  // The additive bias of a tile's keys (0, -1e30 when padded, -inf past Lk),
  // kBiasPer keys a thread. The mask bytes are fetched into registers one
  // tile before the bias is written, so a tile never waits on a load of
  // them (the mask's rows need not be aligned for cp.async).
  constexpr int kBiasPer = (kTileK + kThreads - 1) / kThreads;
  unsigned char mask_bytes[kBiasPer];
  auto fetch_mask = [&](int tile) {
#pragma unroll
    for (int e = 0; e < kBiasPer; ++e) {
      const int r = tid + e * kThreads;
      const int j = tile * kTileK + r;
      mask_bytes[e] = mask_row != nullptr && r < kTileK && j < lk ? mask_row[j] : 0;
    }
  };
  auto write_bias = [&](int tile) {
#pragma unroll
    for (int e = 0; e < kBiasPer; ++e) {
      const int r = tid + e * kThreads;
      const int j = tile * kTileK + r;
      if (r < kTileK)
        bias_tile[tile % kS][r] = j >= lk ? -INFINITY : mask_bytes[e] != 0 ? kMaskBias : 0.f;
    }
  };

#pragma unroll
  for (int tile = 0; tile < kS - 1; ++tile) load_kv(tile, tile);
  fetch_mask(0);
  write_bias(0);
  fetch_mask(1);

  // This warp's 16 query rows as A fragments, kept for the whole key loop.
  const int row0 = blockIdx.x * (16 * kRowGroups) + group * 16 + g;
  const int row1 = row0 + 8;
  unsigned qf[kSteps][4];
  {
    const __nv_bfloat16* q0 = q + ((static_cast<long>(b) * lq + row0) * heads + h) * Dh;
    const __nv_bfloat16* q1 = q + ((static_cast<long>(b) * lq + row1) * heads + h) * Dh;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int col = 16 * s + 2 * t;
      qf[s][0] = row0 < lq ? *reinterpret_cast<const unsigned*>(q0 + col) : 0u;
      qf[s][1] = row1 < lq ? *reinterpret_cast<const unsigned*>(q1 + col) : 0u;
      qf[s][2] = row0 < lq ? *reinterpret_cast<const unsigned*>(q0 + col + 8) : 0u;
      qf[s][3] = row1 < lq ? *reinterpret_cast<const unsigned*>(q1 + col + 8) : 0u;
    }
  }

  // Dropout: this lane draws the Philox call of row g (t even) or g + 8 (t
  // odd) for keys 4 (t / 2) .. + 3 of each 8-key column block.
  const uint2 philox_key = kDropout ? fa::seed_key(seed) : make_uint2(0u, 0u);
  const bool odd = (t & 1) != 0;
  const unsigned philox_row = static_cast<unsigned>(odd ? row1 : row0);

  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows g, g + 8)
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the running row sums

  // ldmatrix row addresses of this lane inside a tile: K non-transposed
  // (matrix j of an x4 = dims 8j.., row = key), V transposed (matrices =
  // keys 0-7 / 8-15 of a k16 step by dims 0-7 / 8-15 of a 16-wide block).
  const int key0 = part * kNT * 8;  // this warp's first key in a tile
  const int k_lane_off = (key0 + lane % 8) * kStride + 8 * (lane / 8);
  const int v_lane_off = (key0 + lane % 8 + 8 * ((lane / 8) % 2)) * kStride + 8 * (lane / 16);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kS;
    // The next tile's bias from the bytes fetched one iteration ago (its
    // stage was last read before the previous iteration's final barrier).
    if (tile + 1 < n_tiles) write_bias(tile + 1);
    fetch_mask(tile + 2);
    // Refill the stage that the previous tile used; then wait until only
    // the kS - 1 newest groups are in flight, i.e. this tile has landed.
    load_kv(tile + kS - 1, (tile + kS - 1) % kS);
    cp_async_wait<kS - 1>();
    __syncthreads();

    const __nv_bfloat16* kt = k_tile[stage];
    const __nv_bfloat16* vt = v_tile[stage];
    const float* bias = bias_tile[stage] + key0;

    // S = Q K^T for 16 rows x this warp's keys of the tile.
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int p = 0; p < kSteps / 2; ++p) {
        unsigned kb[4];
        ldmatrix_x4(kb, kt + n * 8 * kStride + 32 * p + k_lane_off);
        mma_bf16(s[n], qf[2 * p], kb[0], kb[1]);
        mma_bf16(s[n], qf[2 * p + 1], kb[2], kb[3]);
      }
    }

    // Bias, then the online softmax in fp32.
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const float b0 = bias[8 * n + 2 * t];
      const float b1 = bias[8 * n + 2 * t + 1];
      s[n][0] += b0;
      s[n][1] += b1;
      s[n][2] += b0;
      s[n][3] += b1;
      mt0 = fmaxf(mt0, fmaxf(s[n][0], s[n][1]));
      mt1 = fmaxf(mt1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
    }
    // Every bias below Lk is finite, so a maximum is -inf only while all of
    // this warp's keys so far lie past Lk (a short Lk split several ways);
    // exps are then taken against 0, giving exp2(-inf) = 0 for every key.
    const float mx0 = fmaxf(m0, mt0), mx1 = fmaxf(m1, mt1);
    const float mn0 = mx0 == -INFINITY ? 0.f : mx0, mn1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2_approx((m0 - mn0) * kLog2e);
    const float alpha1 = exp2_approx((m1 - mn1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      o[d][0] *= alpha0;
      o[d][1] *= alpha0;
      o[d][2] *= alpha1;
      o[d][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = exp2_approx((s[n][0] - mn0) * kLog2e);
      s[n][1] = exp2_approx((s[n][1] - mn0) * kLog2e);
      s[n][2] = exp2_approx((s[n][2] - mn1) * kLog2e);
      s[n][3] = exp2_approx((s[n][3] - mn1) * kLog2e);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
      if constexpr (kDropout) {
        // Keys 4 (t / 2) .. + 3 of the block (absolute key indices): this
        // lane's call covers its own row's two keys and its partner's (lane
        // t ^ 1) two.
        const unsigned j0 = static_cast<unsigned>(tile * kTileK + key0 + 8 * n);
        const uint4 r = fa::philox4x32_10(
            make_uint4(j0 / 4 + t / 2, philox_row, static_cast<unsigned>(bh), 0u), philox_key);
        const unsigned x0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
        const unsigned x1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
        const unsigned bits[4] = {odd ? x0 : r.x, odd ? x1 : r.y, odd ? r.z : x0,
                                  odd ? r.w : x1};
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= bits[e] >= threshold ? keep_scale : 0.f;
      }
    }

    // O += (P o M) V: the accumulators, rounded to bf16, are the A fragments.
#pragma unroll
    for (int ks = 0; ks < kNT / 2; ++ks) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vt + ks * 16 * kStride + 16 * dp + v_lane_off);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // The four lanes of a row hold disjoint columns: sum their shares.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (kSplit > 1) {
    // Warps 1.. of a row group hand their O, row max and row sum to warp 0
    // through the K tiles' shared memory (the loop ended on a barrier).
    float* merge = reinterpret_cast<float*>(&k_tile[0][0]) + group * (kSplit - 1) * kMerge;
    if (part > 0) {
      float* mine = merge + (part - 1) * kMerge;
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        const int col = 8 * d + 2 * t;
        mine[g * Dh + col] = o[d][0];
        mine[g * Dh + col + 1] = o[d][1];
        mine[(g + 8) * Dh + col] = o[d][2];
        mine[(g + 8) * Dh + col + 1] = o[d][3];
      }
      if (t == 0) {
        mine[16 * Dh + g] = m0;
        mine[16 * Dh + g + 8] = m1;
        mine[16 * Dh + 16 + g] = l0;
        mine[16 * Dh + 16 + g + 8] = l1;
      }
    }
    __syncthreads();
    if (part > 0) return;
#pragma unroll
    for (int j = 0; j < kSplit - 1; ++j) {
      // Warp 0 holds key 0, so its maxima are finite; a share whose keys
      // all lie past Lk has maximum -inf and weighs 0.
      const float* other = merge + j * kMerge;
      const float mo0 = other[16 * Dh + g], mo1 = other[16 * Dh + g + 8];
      const float mx0 = fmaxf(m0, mo0), mx1 = fmaxf(m1, mo1);
      const float a0 = exp2_approx((m0 - mx0) * kLog2e), a1 = exp2_approx((m1 - mx1) * kLog2e);
      const float c0 = exp2_approx((mo0 - mx0) * kLog2e), c1 = exp2_approx((mo1 - mx1) * kLog2e);
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        const int col = 8 * d + 2 * t;
        o[d][0] = o[d][0] * a0 + other[g * Dh + col] * c0;
        o[d][1] = o[d][1] * a0 + other[g * Dh + col + 1] * c0;
        o[d][2] = o[d][2] * a1 + other[(g + 8) * Dh + col] * c1;
        o[d][3] = o[d][3] * a1 + other[(g + 8) * Dh + col + 1] * c1;
      }
      l0 = l0 * a0 + other[16 * Dh + 16 + g] * c0;
      l1 = l1 * a1 + other[16 * Dh + 16 + g + 8] * c1;
      m0 = mx0;
      m1 = mx1;
    }
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* o0 = out + ((static_cast<long>(b) * lq + row0) * heads + h) * Dh;
  __nv_bfloat16* o1 = out + ((static_cast<long>(b) * lq + row1) * heads + h) * Dh;
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    const int col = 8 * d + 2 * t;
    if (row0 < lq)
      *reinterpret_cast<unsigned*>(o0 + col) = pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    if (row1 < lq)
      *reinterpret_cast<unsigned*>(o1 + col) = pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    if (row0 < lq) lse[static_cast<long>(bh) * lq + row0] = m0 + logf(l0);
    if (row1 < lq) lse[static_cast<long>(bh) * lq + row1] = m1 + logf(l1);
  }
}

struct Args {
  const void *q, *k, *v, *mask;
  const unsigned long long* seed;
  unsigned threshold;
  float keep_scale;
  void* out;
  float* lse;
  int batch, lq, lk, heads;
  cudaStream_t stream;
};

template <int Dh, int kRowGroups, int kSplit, bool kDropout>
bool launch(const Args& a) {
  const dim3 grid((a.lq + 16 * kRowGroups - 1) / (16 * kRowGroups), a.batch * a.heads);
  flash_attention_fwd_mma_kernel<Dh, kRowGroups, kSplit, kDropout>
      <<<grid, 32 * kRowGroups * kSplit, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
          static_cast<const __nv_bfloat16*>(a.v), static_cast<const unsigned char*>(a.mask),
          a.seed, a.threshold, a.keep_scale, static_cast<__nv_bfloat16*>(a.out), a.lse, a.lq,
          a.lk, a.heads);
  return true;
}

// The CTA shapes the wrapper may ask for, four warps each: row groups of
// 16 queries times warps sharing each row group's keys.
template <int Dh, bool kDropout>
bool launch_shape(int row_groups, int split, const Args& a) {
  switch (row_groups * 10 + split) {
    case 41: return launch<Dh, 4, 1, kDropout>(a);
    case 14: return launch<Dh, 1, 4, kDropout>(a);
    default: return false;
  }
}

template <int Dh>
bool launch_dh(int row_groups, int split, const Args& a) {
  return a.threshold != 0u ? launch_shape<Dh, true>(row_groups, split, a)
                           : launch_shape<Dh, false>(row_groups, split, a);
}

}  // namespace

// The arguments of flash_attention_fwd_tf32 (flash_attention_fwd_tf32.cu)
// at bf16. q, k, v, out: bf16 (batch, L, heads, head_dim), contiguous,
// 16-byte aligned; head_dim 32 or 64. mask: (batch, lk) bytes, nonzero =
// padded key, or null. threshold: 0 for no dropout, else ceil(rate * 2^32)
// with seed a device pointer to one 64-bit seed and keep_scale = 1 / (1 -
// rate). lse: (batch * heads, lq) fp32, or null. A CTA takes 16 *
// row_groups query rows with split warps on each 16 rows: (row_groups,
// split) one of (4, 1), (1, 4). Returns a cudaError_t as int (0 =
// launched).
extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v,
                                       const void* mask, const void* seed, unsigned threshold,
                                       float keep_scale, void* out, void* lse, int batch,
                                       int lq, int lk, int heads, int head_dim, int row_groups,
                                       int split, void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch * heads > 65535 ||
      (threshold != 0u && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, mask, static_cast<const unsigned long long*>(seed), threshold,
               keep_scale, out, static_cast<float*>(lse), batch, lq, lk, heads,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (head_dim == 32) {
    ok = launch_dh<32>(row_groups, split, a);
  } else if (head_dim == 64) {
    ok = launch_dh<64>(row_groups, split, a);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
