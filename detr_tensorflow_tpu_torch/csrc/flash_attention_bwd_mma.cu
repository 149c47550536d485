// Fused multi-head attention backward at fp32 on Hopper's tensor cores
// (sm_90a), with fp32-accurate 3xTF32 products.
//
// Replaces the TPU kernel `_bwd_kernel` (detr_tensorflow_tpu/ops/pallas/
// flash_attention.py:115, launched by `_mha_bwd_rule` through
// `pl.pallas_call`) for fp32 calls at head dim 32 and 64; bf16 calls stay
// on the SIMT kernel of flash_attention_bwd.cu
// (ops/flash_attention.py:backward_route). It computes what that kernel
// computes, from the forward's output O and row log-sum-exp (written by
// flash_attention_fwd_tf32.cu) and dO, with the dropout mask replayed:
//
//   p_ij  = exp(q_i . k_j + bias_j - lse_i)        (1 / Lk on a row whose keys are all padded)
//   m_ij  = dropout multiplier (0 or 1 / (1 - rate)), flash_attention_common.cuh
//   dV_j  = sum_i p_ij m_ij dO_i
//   dS_ij = p_ij (m_ij dO_i . v_j - delta_i),  delta_i = dO_i . O_i;  0 on padded keys
//   dQ_i  = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i
//
// q is already scaled by head_dim ** -0.5. Inputs are (B, L, H, Dh) fp32,
// read with strides.
//
// Accuracy: 3xTF32. A TF32 operand keeps 10 of fp32's 23 mantissa bits, so
// one TF32 product is off by ~2^-11 relative: ~3e-4 of the largest dQ at
// (252, 252), above the port's fp32 gradient tolerance (1e-4). Each fp32
// operand x is split into big = tf32(x) (to nearest) and small = tf32(x -
// big); the subtraction is exact, and big + small carries 22 of x's 24
// significant bits. A product is taken as big_a big_b + (small_a big_b +
// big_a small_b), three TF32 MMAs; the dropped small_a small_b term is
// 2^-22 of it, and each TF32 product of two 11-bit significands is exact.
// A numpy emulation (tests/test_torch_attention.py) puts dQ and dK at
// ~3e-7 of their largest value against float64, single TF32 at ~3e-4. This
// is CUTLASS's "fast accurate" fp32 GEMM (OpMultiplyAddFastF32) written out
// by hand. One more thing matters on the card: an MMA adds its products to
// its accumulator with truncation, at the accumulator's magnitude, not with
// rounding to nearest. Chained through one accumulator (12 MMAs a score at
// Dh = 32, ~100 a dK element over 252 queries), that bias made the
// gradients 5-10x further from float64 than the SIMT kernel's, and one
// DETR-R50 weight gradient that cancels over nearly equal keys missed the
// training step's 1e-3 tolerance. So big x big has an accumulator of its
// own, apart from the cross terms (2^-11 of it), and dK, dV and dQ sum each
// step's products in fresh accumulators that are then added with rounded
// fp32 adds: ~2x the SIMT kernel's error against float64.
//
// What bounds it on this card, and what the design does about each
// (numbers for DETR's encoder self-attention in training, (252, 252) B=8
// H=8 Dh=32):
//   * The products: five per (query, key) pair and head dim (S and dP,
//     which both passes compute, dV, dK, dQ), 1.30 GFLOP: 0.0194 ms on the
//     fp32 pipes, 0.0079 ms as three TF32 MMAs each at 495 TFLOP/s. All run
//     as `mma.sync.m16n8k8` TF32. Each operand is split once, where it is
//     loaded: K and V (dK/dV pass) and Q and dO (dQ pass) into registers for
//     the warp's whole loop (at Dh = 64 into a per-warp slab of shared
//     memory, which keeps the kernels clear of spills); the staged tiles in
//     place in shared memory, big over the fp32 values and small beside
//     them; P o M and dS as they are formed.
//   * The layout change between products. An m16n8 accumulator holds
//     (row g, cols 2t, 2t + 1) in lane 4g + t, while the m16n8k8 A operand
//     wants (row g, k t) and (g, t + 4). The order of a product's k
//     dimension is free, as long as A and B agree on it, so the second
//     products take k position t as column 2t and t + 4 as column 2t + 1:
//     P o M and dS go from the accumulators into A fragments with no lane
//     exchange, and the B loads from shared memory read rows 2t and 2t + 1.
//   * Shared-memory reads. There is no `ldmatrix` for 32-bit elements in
//     the orientation B needs, so B fragments are scalar loads. Rows are
//     padded to Dh + 4 floats (stride 36 at Dh = 32). A B load as n = row
//     (Q^T, dO^T, K^T: element [g][8s + t]) hits bank (4g + t + 8s) mod
//     32; as k = row under the k order above ([2t][8d + g] and [2t + 1]
//     [8d + g]) bank (8t + g + 8d) and (8t + g + 8d + 4) mod 32. Both are
//     32 distinct banks: no conflict in either orientation.
//   * Instruction issue and latency, not the MMAs: in a trial on an H100,
//     one TF32 MMA per product in place of three barely moved the time.
//     What each warp issues per 8-query step (B loads, the accumulator
//     adds, p and dS) and the chain from S to dS set it, with two warps on
//     each SM sub-partition at (252, 252) b8. So each warp takes two n
//     tiles at once at Dh = 32 (independent chains), and
//   * the Philox rounds go to the pre-pass. A dropout bit is word j % 4 of
//     Philox4x32-10 at counter (j / 4, i, b * H + h, 0)
//     (flash_attention_common.cuh). Drawn in both passes, a call per
//     element per pass, they were about a quarter of the kernel's time
//     (chip_smoke.py on an H100 at (252, 252): 0.0883 ms, 0.0674 ms from
//     the pre-pass's words). The pre-pass draws each call once and writes
//     one keep bit per element, 32 keys a word (B * H * Lq * ceil(Lk / 32)
//     words, 0.5 MB at (252, 252) b8); the passes stage the words of their
//     tiles with the tiles. The bits are those of the forward and of
//     `flash_attention_keep_mask`.
//   * The exps: one per pair and pass (8.1 M in the two passes, ~1.9 us of
//     the SFUs), as `__expf`, as in the SIMT kernel.
//   * The warp count of the dK/dV pass, ~1,024 warps at (252, 252) b8 on 528
//     SM sub-partitions, each walking every query: its loads go through a
//     double-buffered `cp.async` ring (16-byte chunks; lse, delta and keep
//     words in 4-byte copies) so the next tile lands while this one is
//     computed.
//
// Design: three launches and no atomics, so the gradients are
// deterministic.
//   * A pre-pass: delta = rowsum(dO * O) (flash_attention_common.cuh) and,
//     with dropout, the keep bits.
//   * dK/dV: one CTA of four warps per (batch * head, 64 keys), a warp per
//     16 keys. Keys are the M dimension: S^T = K Q^T and dP^T = V dO^T over
//     8-query n tiles, then dV += (P o M)^T dO and dK += dS^T Q. Q and dO
//     stream in tiles of 1024 / Dh queries through the ring; rows past Lq
//     are zero-filled (src-size 0) and p is forced to 0 there and on keys
//     past Lk.
//   * dQ: A-mma's (4, 1) layout, a CTA of four warps over 64 query rows, a
//     warp per 16, each walking all keys. K and V stream in 64-key tiles
//     through the ring (dynamic shared memory: 55 KB at Dh = 32, 167 KB at
//     Dh = 64 with the held Q and dO); the key-padding bytes are fetched a
//     tile ahead. A-mma's
//     other shape, (1, 4) (16 rows a CTA, each tile's keys split among the
//     four warps), gives the decoder's 100 queries 3.5x the CTAs, but was
//     slower here at every training shape on an H100: it splits each K/V
//     tile four times as often and adds the warps' dQ at the end.
//
// Entry point: a plain C function launching the three kernels on the given
// stream. It allocates nothing (the caller passes the scratch), does not
// synchronise, and returns cudaGetLastError().

#include <math.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "tf32_mma.cuh"

namespace {

using fa::accumulator_as_a;
using fa::add_products;
using fa::cp_async16;
using fa::cp_async4;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::HeldA;
using fa::kMaskBias;
using fa::kMaskedRowLse;
using fa::split_chunk;
using fa::zero;
using tf32mma::mma_3xtf32;
using tf32mma::split_tf32;

constexpr int kThreads = 128;  // four warps a CTA in both passes
constexpr int kKvKeys = 64;    // keys of a dK/dV CTA, 16 a warp
constexpr int kTileK = 64;     // keys of a dQ tile
constexpr int kQRows = 64;     // query rows of a dQ CTA, 16 a warp

// 8-wide n tiles a warp takes at once, and how far the step loop unrolls:
// two and fully at Dh = 32; one and not at all at Dh = 64, where the
// accumulators alone take 64 registers.
template <int Dh>
constexpr int kN = Dh == 32 ? 2 : 1;
template <int Dh>
constexpr int kUnroll = Dh == 32 ? 8 : 1;

// ---- pre-pass: delta and the keep bits -----------------------------------

// Items [0, rows) are delta rows (fa::delta_row); with keep, items [rows,
// rows + rows * words) are keep words: word w of row bh * lq + i has bit c
// set iff key 32w + c of query i is kept, i.e. its Philox bits (word c % 4
// of the call at counter (8w + c / 4, i, bh, 0)) reach the threshold.
template <int Dh>
__global__ void prepass_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                               float* __restrict__ delta, unsigned* __restrict__ keep,
                               const unsigned long long* __restrict__ seed, unsigned threshold,
                               long rows, int lq, int heads, int words) {
  const long items = rows + (keep != nullptr ? rows * words : 0L);
  for (long n = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; n < items;
       n += static_cast<long>(gridDim.x) * blockDim.x) {
    if (n < rows) {
      fa::delta_row<float, Dh>(out, dout, delta, n, lq, heads);
      continue;
    }
    const long m = n - rows;
    const unsigned w = static_cast<unsigned>(m % words);
    const long row = m / words;
    const uint2 key = fa::seed_key(seed);
    unsigned bits = 0u;
#pragma unroll
    for (unsigned c = 0; c < 8; ++c) {
      const uint4 r = fa::philox4x32_10(
          make_uint4(8 * w + c, static_cast<unsigned>(row % lq),
                     static_cast<unsigned>(row / lq), 0u), key);
      bits |= (r.x >= threshold ? 1u : 0u) << (4 * c);
      bits |= (r.y >= threshold ? 1u : 0u) << (4 * c + 1);
      bits |= (r.z >= threshold ? 1u : 0u) << (4 * c + 2);
      bits |= (r.w >= threshold ? 1u : 0u) << (4 * c + 3);
    }
    keep[m] = bits;
  }
}

// ---- dK / dV -------------------------------------------------------------

template <int Dh>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const unsigned char* __restrict__ mask, const unsigned* __restrict__ keep,
                float keep_scale, float* __restrict__ dk, float* __restrict__ dv, int lq,
                int lk, int heads, int words) {
  constexpr int kTileQ = 1024 / Dh;  // queries a stage: 32 at Dh = 32, 16 at Dh = 64
  constexpr int kStride = Dh + 4;    // padded shared row, in floats
  constexpr int kSteps = Dh / 8;     // k8 steps of S^T and dP^T; n8 tiles of dK and dV
  constexpr int kChunks = Dh / 4;    // 16-byte chunks of a row
  constexpr int kStep = kN<Dh>;
  __shared__ __align__(16) float q_big[2][kTileQ * kStride];
  __shared__ __align__(16) float do_big[2][kTileQ * kStride];
  __shared__ __align__(16) float q_small[kTileQ * kStride];
  __shared__ __align__(16) float do_small[kTileQ * kStride];
  __shared__ float lse_tile[2][kTileQ];
  __shared__ float delta_tile[2][kTileQ];
  __shared__ unsigned keep_tile[2][kTileQ][2];  // the CTA's two keep words a query
  using Held = HeldA<kSteps, Dh == 32>;
  extern __shared__ __align__(16) float smem[];  // K and V slabs at Dh = 64

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long ts = static_cast<long>(heads) * Dh;
  const long q_head = (static_cast<long>(b) * lq * heads + h) * Dh;
  const long kv_head = (static_cast<long>(b) * lk * heads + h) * Dh;
  const int key_base = blockIdx.x * kKvKeys + warp * 16;  // this warp's 16 keys
  const int keep_shift = (warp & 1) * 16 + g;  // bit of key g in its keep word
  const float inv_lk = 1.f / static_cast<float>(lk);

  // This lane's keys: rows g and g + 8 of the warp's 16.
  bool key_ok[2], padded[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key_base + g + 8 * r;
    key_ok[r] = j < lk;
    padded[r] = key_ok[r] && mask != nullptr && mask[static_cast<long>(b) * lk + j] != 0;
    bias[r] = padded[r] ? kMaskBias : 0.f;
  }
  Held kf, vf;
  unsigned* const slab = reinterpret_cast<unsigned*>(smem) + 2 * warp * Held::kSlabWords;
  kf.load(k + kv_head, ts, key_base + g, lk, t, slab, lane);
  vf.load(v + kv_head, ts, key_base + g, lk, t, slab + Held::kSlabWords, lane);

  float dka[kSteps][4], dva[kSteps][4];
  zero(dka);
  zero(dva);

  const int n_tiles = (lq + kTileQ - 1) / kTileQ;
  // One tile's Q, dO, lse, delta and keep words as one cp.async group (an
  // empty group past the last tile, so that there is one group per tile).
  auto load_q = [&](int tile, int stage) {
    if (tile < n_tiles) {
      const int i0 = tile * kTileQ;
      for (int c = tid; c < kTileQ * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int col = (c % kChunks) * 4;
        const int i = i0 + r;
        const long off = q_head + (i < lq ? static_cast<long>(i) : 0L) * ts + col;
        const int bytes = i < lq ? 16 : 0;
        cp_async16(&q_big[stage][r * kStride + col], q + off, bytes);
        cp_async16(&do_big[stage][r * kStride + col], dout + off, bytes);
      }
      const int r = tid % kTileQ;
      const int i = i0 + r;
      const long row = static_cast<long>(bh) * lq + (i < lq ? i : 0);
      if (tid < kTileQ) {
        cp_async4(&lse_tile[stage][r], lse + row, i < lq ? 4 : 0);
      } else if (tid < 2 * kTileQ) {
        cp_async4(&delta_tile[stage][r], delta + row, i < lq ? 4 : 0);
      } else if (keep != nullptr && tid < 4 * kTileQ) {
        const int wi = 2 * blockIdx.x + (tid - 2 * kTileQ) / kTileQ;
        const bool ok = i < lq && wi < words;
        cp_async4(&keep_tile[stage][r][wi & 1], keep + row * words + (ok ? wi : 0), ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  load_q(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // The other stage was last read before the previous iteration's final
    // barrier: refill it, then wait until only that group is in flight.
    load_q(tile + 1, stage ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    for (int c = tid; c < kTileQ * kChunks; c += kThreads) {
      const int o = (c / kChunks) * kStride + (c % kChunks) * 4;
      split_chunk(&q_big[stage][o], &q_small[o]);
      split_chunk(&do_big[stage][o], &do_small[o]);
    }
    __syncthreads();

    const int i0 = tile * kTileQ;
    if (key_base < lk) {  // uniform across the warp
#pragma unroll(kUnroll<Dh>)
      for (int n = 0; n < kTileQ / 8; n += kStep) {
        const int c0 = 8 * n;  // the step's first query in the stage
        if (i0 + c0 >= lq) break;

        // S^T = K Q^T and dP^T = V dO^T, 16 keys x 8 queries per n tile; B
        // (k = head dim, n = query g) from the stage's rows c0 + 8u + g.
        float st[kStep][4], dpt[kStep][4], st_lo[kStep][4], dpt_lo[kStep][4];
        zero(st);
        zero(dpt);
        zero(st_lo);
        zero(dpt_lo);
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          unsigned ab[4], as[4];
          kf.get(s, ab, as);
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            const int o = (c0 + 8 * u + g) * kStride + 8 * s + t;
            mma_3xtf32(st[u], st_lo[u], ab, as, q_big[stage], q_small, o, o + 4);
          }
          vf.get(s, ab, as);
#pragma unroll
          for (int u = 0; u < kStep; ++u) {
            const int o = (c0 + 8 * u + g) * kStride + 8 * s + t;
            mma_3xtf32(dpt[u], dpt_lo[u], ab, as, do_big[stage], do_small, o, o + 4);
          }
        }

        // P o M and dS, as split A fragments over each n tile's 8 queries.
        unsigned pb[kStep][4], ps[kStep][4], sb[kStep][4], ss[kStep][4];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          float pm[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            const int col = c0 + 8 * u + 2 * t + e % 2;
            const float l = lse_tile[stage][col];
            float p = l <= kMaskedRowLse ? inv_lk : __expf(st[u][e] + st_lo[u][e] + bias[r] - l);
            if (!key_ok[r] || i0 + col >= lq) p = 0.f;
            float mf = 1.f;
            if (keep != nullptr) {
              const unsigned word = keep_tile[stage][col][warp >> 1];
              mf = (word >> (keep_shift + 8 * r)) & 1u ? keep_scale : 0.f;
            }
            pm[e] = p * mf;
            const float dp = dpt[u][e] + dpt_lo[u][e];
            ds[e] = padded[r] ? 0.f : p * (mf * dp - delta_tile[stage][col]);
          }
          accumulator_as_a(pm, pb[u], ps[u]);
          accumulator_as_a(ds, sb[u], ss[u]);
        }

        // dV += (P o M)^T dO, then dK += dS^T Q, over the step's queries;
        // B (k = query, n = head dim 8d + g) from the stage's rows c0 + 8u
        // + 2t, + 1.
        add_products<kSteps, kStep, kStride>(dva, pb, ps, do_big[stage], do_small, c0, t, g);
        add_products<kSteps, kStep, kStride>(dka, sb, ss, q_big[stage], q_small, c0, t, g);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const long row = kv_head + static_cast<long>(key_base + g + 8 * r) * ts + 2 * t;
#pragma unroll
    for (int d = 0; d < kSteps; ++d) {
      *reinterpret_cast<float2*>(dk + row + 8 * d) = make_float2(dka[d][2 * r], dka[d][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + row + 8 * d) = make_float2(dva[d][2 * r], dva[d][2 * r + 1]);
    }
  }
}

// ---- dQ ------------------------------------------------------------------

// Shared memory of the two held A operands of the four warps of a CTA
// (none at Dh = 32, where they sit in registers).
template <int Dh>
constexpr int held_bytes() {
  return 4 * 2 * HeldA<Dh / 8, Dh == 32>::kSlabWords * 4;
}

// Dynamic shared memory of the dQ kernel: K and V, two stages of big parts
// and one of small parts each, one tile's key bias, two stages of keep
// words (two a query row), and the held Q and dO.
template <int Dh>
constexpr int dq_smem_bytes() {
  return (6 * kTileK * (Dh + 4) + kTileK + 2 * kQRows * 2) * 4 + held_bytes<Dh>();
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 1)
dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const unsigned char* __restrict__ mask, const unsigned* __restrict__ keep,
              float keep_scale, float* __restrict__ dq, int lq, int lk, int heads, int words) {
  constexpr int kStride = Dh + 4;
  constexpr int kSteps = Dh / 8;              // k8 steps of S and dP; n8 tiles of dQ
  constexpr int kChunks = Dh / 4;
  constexpr int kTile = kTileK * kStride;     // floats of one staged K or V tile
  constexpr int kStep = kN<Dh>;
  extern __shared__ __align__(16) float smem[];
  float* const k_big = smem;              // [2][kTile]
  float* const v_big = smem + 2 * kTile;  // [2][kTile]
  float* const k_small = smem + 4 * kTile;
  float* const v_small = smem + 5 * kTile;
  float* const bias_tile = smem + 6 * kTile;  // [kTileK]
  unsigned* const keep_tile = reinterpret_cast<unsigned*>(bias_tile + kTileK);  // [2][kQRows][2]
  unsigned* const held = keep_tile + 2 * kQRows * 2;  // the held Q and dO at Dh = 64

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long ts = static_cast<long>(heads) * Dh;
  const long q_head = (static_cast<long>(b) * lq * heads + h) * Dh;
  const long kv_head = (static_cast<long>(b) * lk * heads + h) * Dh;
  const unsigned char* mask_row = mask == nullptr ? nullptr : mask + static_cast<long>(b) * lk;
  const int row0 = blockIdx.x * kQRows;
  const int row_base = row0 + warp * 16;  // this warp's 16 query rows
  const float inv_lk = 1.f / static_cast<float>(lk);
  const int n_tiles = (lk + kTileK - 1) / kTileK;

  // One tile's K, V and keep words (two a row: keys 64 tile .. + 63) as
  // one cp.async group.
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
      if (keep != nullptr && tid < 2 * kQRows) {
        const int i = row0 + tid / 2;
        const int wi = 2 * tile + tid % 2;
        const bool ok = i < lq && wi < words;
        const long word = (static_cast<long>(bh) * lq + (ok ? i : 0)) * words + (ok ? wi : 0);
        cp_async4(keep_tile + (stage * kQRows + tid / 2) * 2 + tid % 2, keep + word, ok ? 4 : 0);
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

  // This warp's 16 query rows (g and g + 8 in this lane) as A fragments.
  using Held = HeldA<kSteps, Dh == 32>;
  Held qf, gf;
  unsigned* const slab = held + 2 * warp * Held::kSlabWords;
  qf.load(q + q_head, ts, row_base + g, lq, t, slab, lane);
  gf.load(dout + q_head, ts, row_base + g, lq, t, slab + Held::kSlabWords, lane);
  float l[2], dl[2];
  bool row_padded[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + g + 8 * r;
    l[r] = row < lq ? lse[static_cast<long>(bh) * lq + row] : 0.f;
    dl[r] = row < lq ? delta[static_cast<long>(bh) * lq + row] : 0.f;
    row_padded[r] = l[r] <= kMaskedRowLse;
  }
  float acc[kSteps][4];
  zero(acc);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    load_kv(tile + 1, stage ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    float* const kb = k_big + stage * kTile;
    float* const vb = v_big + stage * kTile;
    for (int c = tid; c < kTileK * kChunks; c += kThreads) {
      const int o = (c / kChunks) * kStride + (c % kChunks) * 4;
      split_chunk(kb + o, k_small + o);
      split_chunk(vb + o, v_small + o);
    }
    const int k0 = tile * kTileK;
    if (tid < kTileK) {
      // 0 for a key that counts, -1e30 for a padded one, -inf past Lk.
      bias_tile[tid] = k0 + tid >= lk ? -INFINITY : mask_byte != 0 ? kMaskBias : 0.f;
    }
    fetch_mask(tile + 1);
    __syncthreads();
    const unsigned* keep_rows = keep_tile + (stage * kQRows + warp * 16 + g) * 2;

#pragma unroll(kUnroll<Dh>)
    for (int kr = 0; kr < kTileK; kr += 8 * kStep) {  // the step's first key in the tile
      if (k0 + kr >= lk) break;

      // S = Q K^T and dP = dO V^T, 16 queries x 8 keys per n tile; B (k =
      // head dim, n = key g) from the tile's rows kr + 8u + g.
      float s[kStep][4], dp[kStep][4], s_lo[kStep][4], dp_lo[kStep][4];
      zero(s);
      zero(dp);
      zero(s_lo);
      zero(dp_lo);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        unsigned ab[4], as[4];
        qf.get(st, ab, as);
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int o = (kr + 8 * u + g) * kStride + 8 * st + t;
          mma_3xtf32(s[u], s_lo[u], ab, as, kb, k_small, o, o + 4);
        }
        gf.get(st, ab, as);
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int o = (kr + 8 * u + g) * kStride + 8 * st + t;
          mma_3xtf32(dp[u], dp_lo[u], ab, as, vb, v_small, o, o + 4);
        }
      }

      // dS as split A fragments over each n tile's 8 keys.
      unsigned sb[kStep][4], ss[kStep][4];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const int key = kr + 8 * u + 2 * t;  // this lane's first key of the n tile
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const float bias = bias_tile[key + e % 2];
          const float p = row_padded[r] ? inv_lk : __expf(s[u][e] + s_lo[u][e] + bias - l[r]);
          float mf = 1.f;
          if (keep != nullptr) {
            const unsigned word = keep_rows[16 * r + (key >> 5)];
            mf = (word >> ((key & 31) + e % 2)) & 1u ? keep_scale : 0.f;
          }
          ds[e] = bias != 0.f ? 0.f : p * (mf * (dp[u][e] + dp_lo[u][e]) - dl[r]);
        }
        accumulator_as_a(ds, sb[u], ss[u]);
      }

      // dQ += dS K over the step's keys; B (k = key, n = head dim 8d + g)
      // from the tile's rows kr + 8u + 2t, + 1.
      add_products<kSteps, kStep, kStride>(acc, sb, ss, kb, k_small, kr, t, g);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + g + 8 * r;
    if (row >= lq) continue;
    float* out = dq + q_head + static_cast<long>(row) * ts + 2 * t;
#pragma unroll
    for (int d = 0; d < kSteps; ++d) {
      *reinterpret_cast<float2*>(out + 8 * d) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
    }
  }
}

struct Args {
  const float *q, *k, *v, *out, *dout, *lse;
  const unsigned char* mask;
  const unsigned long long* seed;
  unsigned threshold;
  float keep_scale;
  float *dq, *dk, *dv, *delta;
  int batch, lq, lk, heads;
  cudaStream_t stream;
};

template <int Dh>
int launch(const Args& a) {
  // The scratch: delta, then (with dropout) the keep words.
  const long rows = static_cast<long>(a.batch) * a.heads * a.lq;
  const int words = (a.lk + 31) / 32;
  unsigned* keep = a.threshold != 0u ? reinterpret_cast<unsigned*>(a.delta + rows) : nullptr;
  const long items = rows + (keep != nullptr ? rows * words : 0L);
  const int blocks = static_cast<int>((items + 255) / 256 < 8192 ? (items + 255) / 256 : 8192);
  prepass_kernel<Dh><<<blocks, 256, 0, a.stream>>>(a.out, a.dout, a.delta, keep, a.seed,
                                                    a.threshold, rows, a.lq, a.heads, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kKvBytes = held_bytes<Dh>();
  auto* kv_kernel = dkdv_mma_kernel<Dh>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kKvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((a.lk + kKvKeys - 1) / kKvKeys, a.batch * a.heads);
  kv_kernel<<<kv_grid, kThreads, kKvBytes, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.mask, keep, a.keep_scale, a.dk, a.dv, a.lq, a.lk,
      a.heads, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kBytes = dq_smem_bytes<Dh>();
  auto* dq_kernel = dq_mma_kernel<Dh>;
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((a.lq + kQRows - 1) / kQRows, a.batch * a.heads);
  dq_kernel<<<q_grid, kThreads, kBytes, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.mask,
                                                    keep, a.keep_scale, a.dq, a.lq, a.lk,
                                                    a.heads, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of flash_attention_bwd (flash_attention_bwd.cu), with dtype
// 0 (float32) only. q, k, v, out,
// dout, dq, dk, dv: fp32 (batch, L, heads, head_dim), contiguous, 16-byte
// aligned; head_dim 32 or 64. lse: (batch * heads, lq) fp32 from
// flash_attention_fwd. mask, seed, threshold, keep_scale: as the forward
// got them. delta: scratch of batch * heads * lq floats followed, when
// threshold is not 0, by batch * heads * lq * ceil(lk / 32) 32-bit words.
// Returns a cudaError_t as int (0 = launched).
extern "C" int flash_attention_bwd_mma(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       const void* mask, const void* seed, unsigned threshold,
                                       float keep_scale, void* dq, void* dk, void* dv,
                                       void* delta, int batch, int lq, int lk, int heads,
                                       int head_dim, int dtype, void* stream) {
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch * heads > 65535 || dtype != 0 ||
      lse == nullptr || delta == nullptr || (threshold != 0u && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(out),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<const unsigned char*>(mask),
               static_cast<const unsigned long long*>(seed), threshold, keep_scale,
               static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(delta), batch, lq, lk, heads,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 32) return launch<32>(a);
  if (head_dim == 64) return launch<64>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
