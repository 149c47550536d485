// Fused multi-head attention forward at fp32 on Hopper's tensor cores
// (sm_90a), with fp32-accurate 3xTF32 products.
//
// Replaces the TPU kernel `_fwd_kernel` (detr_tensorflow_tpu/ops/pallas/
// flash_attention.py:77, launched by `_mha_fwd_call` through
// `pl.pallas_call`) for fp32 calls at head dim 32 and 64, with or without
// dropout; bf16 calls, with or without dropout, run
// flash_attention_fwd_mma.cu (ops/flash_attention.py:forward_route). It
// computes what that computes:
//
//   out[b, i, h, :] = sum_j m_ij softmax_j(q[b, i, h, :] . k[b, j, h, :] + bias[b, j]) v[b, j, h, :]
//
// with bias = -1e30 on padded keys (mask true) and 0 elsewhere, q already
// scaled by head_dim ** -0.5, and m_ij the dropout multiplier (1 without
// dropout; else 0 or 1 / (1 - rate) from the Philox bits of
// flash_attention_common.cuh, which the backward replays). The running sum
// takes every key; only the PV product sees the dropout. Optionally it
// writes the row log-sum-exp lse[b, h, i] = max_j s_ij + log sum_j exp(s_ij
// - max) that the backward (flash_attention_bwd_mma.cu) reads; a row whose
// keys are all padded gets a uniform softmax and an lse of -1e30. Inputs
// are (B, L, H, Dh) fp32, read with strides.
//
// Accuracy: 3xTF32 (tf32_mma.cuh). Both products, S = Q K^T
// and O = (P o M) V, run as three TF32 MMAs, big x big in an accumulator of
// its own. The tensor cores truncate when an MMA adds to its accumulator,
// so no big x big sum is chained through one: a score adds each 8-dim
// step's big x big MMA to it in fp32 (chaining the 4 steps of Dh = 32
// nearly doubled the output's distance from float64 in a trial on an
// H100), and PV sums each 16 keys' products in fresh accumulators that are
// then added to the running output with rounded fp32 adds, after the online
// rescale. The cross terms, 2^-11 of big x big, chain. A numpy emulation of this algorithm
// (tests/test_torch_attention.py) puts the output within 1e-5 of its
// largest value against float64, single TF32 at least 100x further off.
//
// What bounds it on this card, and what the design does about each
// (numbers for DETR's served encoder self-attention, (1232, 1232) B=2 H=8
// Dh=32, 128 flops a (query, key) pair):
//   * The products: 3.1 GFLOP, 0.046 ms on the fp32 pipes, 0.019 ms as three
//     TF32 MMAs each at 495 TFLOP/s (9.3 GFLOP of MMAs). All run as
//     `mma.sync.m16n8k8` TF32. Q is split once into (big, small) and held
//     for the warp's whole key loop, in registers at Dh = 32 and in a
//     per-warp slab of shared memory at Dh = 64; each staged K and V tile
//     is split in place in shared memory, big over the fp32 value, small
//     beside it, by the whole CTA once; P o M is split as it is formed.
//   * The layout change between the products. PV takes k position t of an
//     8-key step as key 2t and t + 4 as key 2t + 1, so P o M goes from the
//     score accumulators into A fragments with no lane exchange, and the V
//     loads read rows 2t and 2t + 1 (fa::add_products).
//   * Shared-memory reads: no `ldmatrix` serves 32-bit B fragments, so they
//     are scalar loads, from rows padded to Dh + 4 floats: K as n = key
//     (bank 4g + t + 8s) and V as k = key (banks 8t + g + 8d, + 4) hit 32
//     distinct banks, no conflict.
//   * The exps: one per pair, `__expf(s - max)` as in the SIMT kernel, the
//     subtraction first so a fully padded row (every score -1e30) stays
//     uniform.
//   * Dropout (training): a Philox4x32-10 call gives the bits of 4
//     consecutive keys of a row. In the accumulator layout lanes t and t + 1
//     hold keys 4u .. 4u + 3 of rows g and g + 8, so lane t draws row g's
//     call if t is even and row g + 8's if odd, and the pair swap the two
//     words the other needs: one call per 4 elements, not one per element.
//     The served variant compiles without it (template flag).
//   * The latency of the K/V loads: a double-buffered `cp.async` ring of
//     64-key tiles (16-byte chunks, rows past Lk zero-filled with the
//     src-size-0 form and their bias -inf, so p = 0 there), the mask bytes
//     fetched a tile ahead. Dynamic shared memory: 54 KB at Dh = 32, 134 KB
//     at Dh = 64 with the held Q.
//   * The fill. A CTA has four warps, as A-mma's two shapes: (4, 1), 64
//     query rows a CTA, a warp per 16 rows, each walking every key; or (1,
//     4), 16 rows a CTA whose four warps split each tile's keys, each with
//     its own running softmax, merged through shared memory at the end. The
//     wrapper picks with ops/flash_attention.py:cta_shape: (4, 1) where
//     64-row CTAs number at least half the SMs (every encoder shape, and
//     the 100 decoder queries of b8 training: 128 CTAs), (1, 4) below (the
//     100 decoder queries served at b1 and B=2: 16 and 32 CTAs), each the
//     faster shape there on an H100.
// What is left: on an H100 (700 W) it takes ~5x its 3xTF32 bound at
// (1232, 1232) B=2. One TF32 MMA per product in place of three saved only
// about a third of that in a trial, so it is latency that bounds it: each
// warp's tile is a serial chain (S, exps, P's split, PV) between two CTA
// barriers, three 4-warp CTAs an SM. More query rows a warp (fewer B loads
// per MMA) and `wgmma` are the next levers.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "tf32_mma.cuh"

namespace {

using fa::accumulator_as_a;
using fa::add_products;
using fa::cp_async16;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::HeldA;
using fa::kMaskBias;
using fa::split_chunk;
using fa::zero;
using tf32mma::mma_3xtf32;

constexpr int kTileK = 64;  // keys of a staged tile

// Q of a warp's 16 rows, split: in registers at Dh = 32, in a per-warp
// slab of shared memory at Dh = 64 (in registers it spilled 192 bytes there;
// with the slab the 64-row shape spills 44-76 bytes at 255 registers, and
// no DETR path runs Dh = 64).
template <int Dh>
using HeldQ = HeldA<Dh / 8, Dh == 32>;

// Dynamic shared memory: K and V, two stages of big parts and one of small
// parts each, one tile's key bias, and the four warps' held Q at Dh = 64.
template <int Dh>
constexpr int smem_bytes() {
  return (6 * kTileK * (Dh + 4) + kTileK + 4 * HeldQ<Dh>::kSlabWords) * 4;
}

// CTAs an SM must hold: three of the 64-row shape at Dh = 32, which caps
// its registers at 168 (it took 179 uncapped: two CTAs an SM, and the 320
// CTAs of (1232, 1232) B=2 ran in two waves, 1.5x slower on an H100). It
// spills 40-56 bytes under the cap and still ran faster at every DETR
// shape than a key-outer S loop that fits uncapped.
template <int Dh, int kRowGroups>
constexpr int kMinBlocks = Dh == 32 && kRowGroups == 4 ? 3 : 1;

// One CTA: kRowGroups x kSplit warps over 16 * kRowGroups query rows of one
// (batch, head). The kSplit warps of a row group share its rows and take
// 64 / kSplit keys of each tile apiece.
template <int Dh, int kRowGroups, int kSplit, bool kDropout>
__global__ void __launch_bounds__(32 * kRowGroups * kSplit, (kMinBlocks<Dh, kRowGroups>))
flash_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v,
                                const unsigned char* __restrict__ mask,
                                const unsigned long long* __restrict__ seed, unsigned threshold,
                                float keep_scale, float* __restrict__ out,
                                float* __restrict__ lse, int lq, int lk, int heads) {
  constexpr int kThreads = 32 * kRowGroups * kSplit;
  constexpr int kStride = Dh + 4;             // padded shared row, in floats
  constexpr int kSteps = Dh / 8;              // k8 steps of S; n8 tiles of O
  constexpr int kChunks = Dh / 4;             // 16-byte chunks of a row
  constexpr int kTile = kTileK * kStride;     // floats of one staged K or V tile
  constexpr int kNT = kTileK / 8 / kSplit;    // 8-key n tiles of S per warp and tile
  constexpr int kMerge = 16 * Dh + 32;        // floats a warp hands over: O, row max, row sum
  static_assert(kThreads >= kTileK, "a thread per key writes the bias");
  static_assert(kNT % 2 == 0, "PV sums two n tiles of keys a step");
  static_assert(kRowGroups * (kSplit - 1) * kMerge <= 6 * kTile,
                "the merge reuses the tiles' shared memory");
  extern __shared__ __align__(16) float smem[];
  float* const k_big = smem;              // [2][kTile]
  float* const v_big = smem + 2 * kTile;  // [2][kTile]
  float* const k_small = smem + 4 * kTile;
  float* const v_small = smem + 5 * kTile;
  float* const bias_tile = smem + 6 * kTile;  // [kTileK]
  unsigned* const held = reinterpret_cast<unsigned*>(bias_tile + kTileK);  // Q at Dh = 64

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int group = warp / kSplit;  // row group
  const int part = warp % kSplit;   // share of each tile's keys
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long ts = static_cast<long>(heads) * Dh;
  const long q_head = (static_cast<long>(b) * lq * heads + h) * Dh;
  const long kv_head = (static_cast<long>(b) * lk * heads + h) * Dh;
  const unsigned char* mask_row = mask == nullptr ? nullptr : mask + static_cast<long>(b) * lk;
  const int n_tiles = (lk + kTileK - 1) / kTileK;

  // One tile's K and V as one cp.async group (an empty group past the last
  // tile, so that there is one group per tile).
  auto load_kv = [&](int tile, int stage) {
    if (tile < n_tiles) {
      const int k0 = tile * kTileK;
      for (int c = tid; c < kTileK * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int col = (c % kChunks) * 4;
        const int j = k0 + r;
        const long off = kv_head + (j < lk ? static_cast<long>(j) : 0L) * ts + col;
        const int bytes = j < lk ? 16 : 0;
        cp_async16(k_big + stage * kTile + r * kStride + col, k + off, bytes);
        cp_async16(v_big + stage * kTile + r * kStride + col, v + off, bytes);
      }
    }
    cp_async_commit();
  };
  // The mask bytes of a tile's keys go through a register a tile ahead (the
  // mask's rows need not be aligned for cp.async).
  unsigned char mask_byte = 0;
  auto fetch_mask = [&](int tile) {
    const int j = tile * kTileK + tid;
    mask_byte = mask_row != nullptr && tid < kTileK && j < lk ? mask_row[j] : 0;
  };

  load_kv(0, 0);
  fetch_mask(0);

  // This warp's 16 query rows (g and g + 8 in this lane) as split A
  // fragments, held for the whole key loop.
  const int row0 = blockIdx.x * (16 * kRowGroups) + group * 16 + g;
  const int row1 = row0 + 8;
  HeldQ<Dh> qf;
  qf.load(q + q_head, ts, row0, lq, t, held + warp * HeldQ<Dh>::kSlabWords, lane);
  // Dropout: this lane draws the Philox call of row g (t even) or g + 8 (t
  // odd) for keys 4 (t / 2) .. + 3 of each n tile.
  const uint2 philox_key = kDropout ? fa::seed_key(seed) : make_uint2(0u, 0u);
  const bool odd = (t & 1) != 0;
  const unsigned philox_row = static_cast<unsigned>(odd ? row1 : row0);

  float o[kSteps][4];
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows g, g + 8)
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the running row sums
  const int key0 = part * kNT * 8;       // this warp's first key in a tile

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // The other stage was last read before the previous iteration's final
    // barrier: refill it, then wait until only that group is in flight.
    load_kv(tile + 1, stage ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    float* const kb = k_big + stage * kTile;
    float* const vb = v_big + stage * kTile;
    for (int c = tid; c < kTileK * kChunks; c += kThreads) {
      const int off = (c / kChunks) * kStride + (c % kChunks) * 4;
      split_chunk(kb + off, k_small + off);
      split_chunk(vb + off, v_small + off);
    }
    const int k0 = tile * kTileK;
    if (tid < kTileK) {
      // 0 for a key that counts, -1e30 for a padded one, -inf past Lk.
      bias_tile[tid] = k0 + tid >= lk ? -INFINITY : mask_byte != 0 ? kMaskBias : 0.f;
    }
    fetch_mask(tile + 1);
    __syncthreads();

    if (k0 + key0 < lk) {  // uniform across the warp: a share past Lk has nothing to add
      // S = Q K^T, 16 rows x 8 keys per n tile, kNT tiles side by side; B
      // (k = head dim, n = key g) from the tile's rows key0 + 8n + g. Each
      // k8 step's big x big products land in a fresh accumulator and are
      // added to the score in fp32; the cross terms chain (see the accuracy
      // note above).
      float s[kNT][4], s_lo[kNT][4];
      zero(s);
      zero(s_lo);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        unsigned ab[4], as[4];
        qf.get(st, ab, as);
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int off = (key0 + 8 * n + g) * kStride + 8 * st + t;
          float hi[4];
          zero(hi);
          mma_3xtf32(hi, s_lo[n], ab, as, kb, k_small, off, off + 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += hi[e];
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float b0 = bias_tile[key0 + 8 * n + 2 * t];
        const float b1 = bias_tile[key0 + 8 * n + 2 * t + 1];
        s[n][0] = s[n][0] + s_lo[n][0] + b0;
        s[n][1] = s[n][1] + s_lo[n][1] + b1;
        s[n][2] = s[n][2] + s_lo[n][2] + b0;
        s[n][3] = s[n][3] + s_lo[n][3] + b1;
      }

      // The online softmax in fp32.
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mt0 = fmaxf(mt0, fmaxf(s[n][0], s[n][1]));
        mt1 = fmaxf(mt1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      // Every bias below Lk is finite, so a maximum is -inf only while all
      // of this warp's keys so far lie past Lk; exps are then taken against
      // 0, giving exp(-inf) = 0 for every key.
      const float mx0 = fmaxf(m0, mt0), mx1 = fmaxf(m1, mt1);
      const float mn0 = mx0 == -INFINITY ? 0.f : mx0, mn1 = mx1 == -INFINITY ? 0.f : mx1;
      const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int d = 0; d < kSteps; ++d) {
        o[d][0] *= alpha0;
        o[d][1] *= alpha0;
        o[d][2] *= alpha1;
        o[d][3] *= alpha1;
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        s[n][0] = __expf(s[n][0] - mn0);
        s[n][1] = __expf(s[n][1] - mn0);
        s[n][2] = __expf(s[n][2] - mn1);
        s[n][3] = __expf(s[n][3] - mn1);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
        if constexpr (kDropout) {
          // Keys 4 (t / 2) .. + 3 of the n tile: this lane's call covers its
          // own row's two keys and its partner's (lane t ^ 1) two.
          const unsigned j0 = static_cast<unsigned>(k0 + key0 + 8 * n);
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

      // O += (P o M) V over two n tiles (16 keys) a step; B (k = key, n =
      // head dim 8d + g) from the tile's rows key0 + 16 ks + 8u + 2t, + 1.
#pragma unroll
      for (int ks = 0; ks < kNT / 2; ++ks) {
        unsigned pb[2][4], ps[2][4];
        accumulator_as_a(s[2 * ks], pb[0], ps[0]);
        accumulator_as_a(s[2 * ks + 1], pb[1], ps[1]);
        add_products<kSteps, 2, kStride>(o, pb, ps, vb, v_small, key0 + 16 * ks, t, g);
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
    // through the tiles' shared memory (the loop ended on a barrier).
    float* merge = smem + group * (kSplit - 1) * kMerge;
    if (part > 0) {
      float* mine = merge + (part - 1) * kMerge;
#pragma unroll
      for (int d = 0; d < kSteps; ++d) {
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
      const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
      const float c0 = __expf(mo0 - mx0), c1 = __expf(mo1 - mx1);
#pragma unroll
      for (int d = 0; d < kSteps; ++d) {
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row0 : row1;
    if (row >= lq) continue;
    const float inv = r == 0 ? inv0 : inv1;
    float* dst = out + q_head + static_cast<long>(row) * ts + 2 * t;
#pragma unroll
    for (int d = 0; d < kSteps; ++d) {
      *reinterpret_cast<float2*>(dst + 8 * d) =
          make_float2(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
  if (lse != nullptr && t == 0) {
    if (row0 < lq) lse[static_cast<long>(bh) * lq + row0] = m0 + logf(l0);
    if (row1 < lq) lse[static_cast<long>(bh) * lq + row1] = m1 + logf(l1);
  }
}

struct Args {
  const float *q, *k, *v;
  const unsigned char* mask;
  const unsigned long long* seed;
  unsigned threshold;
  float keep_scale;
  float *out, *lse;
  int batch, lq, lk, heads;
  cudaStream_t stream;
};

template <int Dh, int kRowGroups, int kSplit, bool kDropout>
int launch(const Args& a) {
  constexpr int kBytes = smem_bytes<Dh>();
  auto* kernel = flash_attention_fwd_tf32_kernel<Dh, kRowGroups, kSplit, kDropout>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.lq + 16 * kRowGroups - 1) / (16 * kRowGroups), a.batch * a.heads);
  kernel<<<grid, 32 * kRowGroups * kSplit, kBytes, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.seed, a.threshold, a.keep_scale, a.out, a.lse, a.lq, a.lk,
      a.heads);
  return static_cast<int>(cudaGetLastError());
}

// The CTA shapes the wrapper may ask for, four warps each: row groups of
// 16 queries times warps sharing each row group's keys.
template <int Dh, bool kDropout>
int launch_shape(int row_groups, int split, const Args& a) {
  switch (row_groups * 10 + split) {
    case 41: return launch<Dh, 4, 1, kDropout>(a);
    case 14: return launch<Dh, 1, 4, kDropout>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int Dh>
int launch_dh(int row_groups, int split, const Args& a) {
  return a.threshold != 0u ? launch_shape<Dh, true>(row_groups, split, a)
                           : launch_shape<Dh, false>(row_groups, split, a);
}

}  // namespace

// The arguments of flash_attention_fwd (flash_attention_fwd.cu) without its
// dtype, plus flash_attention_fwd_mma's CTA shape. q, k, v, out: fp32
// (batch, L, heads, head_dim), contiguous, 16-byte aligned; head_dim 32 or
// 64. mask: (batch, lk) bytes, nonzero = padded key, or null. threshold: 0
// for no dropout, else ceil(rate * 2^32) with seed a device pointer to one
// 64-bit seed and keep_scale = 1 / (1 - rate). lse: (batch * heads, lq)
// fp32, or null. (row_groups, split): (4, 1) or (1, 4). Returns a
// cudaError_t as int (0 = launched).
extern "C" int flash_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                        const void* mask, const void* seed, unsigned threshold,
                                        float keep_scale, void* out, void* lse, int batch,
                                        int lq, int lk, int heads, int head_dim, int row_groups,
                                        int split, void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch * heads > 65535 ||
      (threshold != 0u && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
               static_cast<const unsigned long long*>(seed), threshold, keep_scale,
               static_cast<float*>(out), static_cast<float*>(lse), batch, lq, lk, heads,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 32) return launch_dh<32>(row_groups, split, a);
  if (head_dim == 64) return launch_dh<64>(row_groups, split, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
