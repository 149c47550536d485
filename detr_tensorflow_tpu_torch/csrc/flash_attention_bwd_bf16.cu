// Fused multi-head attention backward in bf16 on Hopper's tensor cores
// (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (detr_tensorflow_tpu/ops/pallas/
// flash_attention.py:115, launched by `_mha_bwd_rule` through
// `pl.pallas_call`) for bf16 calls at head dim 32 and 64
// (ops/flash_attention.py:backward_route); fp32 calls run the 3xTF32
// kernel of flash_attention_bwd_mma.cu. It computes what `_bwd_kernel`
// computes, from the forward's row log-sum-exp and dO, with the dropout mask
// replayed:
//
//   p_ij    = exp(q_i . k_j + bias_j - lse_i)      (1 / Lk on a row whose keys are all padded)
//   m_ij    = dropout multiplier (0 or 1 / (1 - rate)), flash_attention_common.cuh
//   dP_ij   = dO_i . v_j
//   delta_i = sum_j p_ij m_ij dP_ij                (= dO_i . O_i in exact arithmetic)
//   dV_j    = sum_i bf16(p_ij m_ij) dO_i
//   dS_ij   = bf16(p_ij (m_ij dP_ij - delta_i)),   0 on padded keys
//   dQ_i    = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i
//
// q is already scaled by head_dim ** -0.5. Inputs are contiguous (B, L, H,
// Dh) bf16, a head's rows read at a stride of H * Dh; lse is the forward's
// fp32 (B * H, Lq).
//
// Numerics, those of the SIMT kernel (flash_attention_bwd.cu): p * m is
// rounded to bf16 before (P o M)^T dO and dS before dS K and dS^T Q, the TPU
// kernel's astype() points (`pd_low`, `ds_low`); every sum is fp32. delta
// is summed in fp32 from the same dP the passes use, not rowsum(dO * O) from
// the bf16 O: that form misses the walk's sum by O's rounding, so dS's rows
// no longer sum to zero, and where the keys share a large common component
// (DETR's cross-attention keys are memory + pos) dK carries it as error (a
// DETR-R50 bf16 step's k_proj weight gradient came out ~15x further from the
// fp32 step's than autograd's). An MMA adds its products to its accumulator
// with truncation, at the accumulator's magnitude (flash_attention_bwd_mma.cu,
// header), which A'-mma answers by summing each step in a fresh accumulator
// and adding it in fp32. Here the MMAs chain through the running dK, dV and
// dQ: the truncation (2^-23 of the running sum an MMA, ~16 MMAs a sum at
// 252 queries) is far below the bf16 rounding of the outputs (2^-9), so no
// error of the bf16 outputs can show it; what decides is a whole DETR-R50
// bf16 training step on an H100, whose every gradient stays within 1.4x of
// the plain route's distance from the fp32 step (chip_smoke.py's bf16
// parity, bound 3x). Fresh accumulators change 0.006-0.02% of the outputs,
// each by under 2e-3 of its tensor's largest value, and cost 3-25% of the
// call at the training shapes (scripts/torch_attention_bwd_probe.py
// --variants keeps that variant).
//
// What bounds it on this card, and what the design does about each
// (numbers for DETR's encoder self-attention in training, (252, 252) B=8
// H=8 Dh=32, dropout 0.1, on an H100; scripts/torch_attention_bwd_probe.py):
//   * Neither bytes nor products. q, k, v and dO in, dq, dk and dv out at 2
//     bytes, lse and delta at 4: 7.3 MB, 0.0022 ms at 3.35 TB/s (the keep
//     words add 0.5 MB, written once and read twice). Nine products of 2 Lq
//     Lk Dh flops a head (S and dP in each of the three walks, dV, dK, dQ):
//     2.3 GFLOP, 0.0024 ms at the bf16 peak. The call takes ~0.025 ms: each
//     warp walks 252 queries or keys 16 at a time, a chain of loads, MMAs,
//     exps and MMAs with few warps to hide it, and the Philox draws add
//     ~0.002 ms to the pre-pass.
//   * Every product runs as `mma.sync.m16n8k16` bf16 with fp32
//     accumulators, one MMA per 16 x 8 x 16 block: S = Q K^T, dP = dO V^T
//     (row walks) and S^T = K Q^T, dP^T = V dO^T (key walk), with the warp's
//     16 rows of Q and dO, or of K and V, held in registers as A fragments
//     for the whole walk; dV += (P o M)^T dO, dK += dS^T Q and dQ += dS K,
//     whose A fragments are two adjacent m16n8 accumulator tiles packed to
//     bf16 pairs (the accumulator layout is the m16n8k16 A layout: no lane
//     exchange).
//   * Shared-memory reads: every B operand is an `ldmatrix.x4`. Rows of Q,
//     dO, K and V staged as they lie in memory (token rows of Dh values)
//     give, read plainly, the B operands of the products over the head dim
//     (S, dP, S^T, dP^T), and read with `ldmatrix.trans` the B operands of
//     the products over tokens (dV, dK, dQ). Staged rows are padded to Dh +
//     8 elements (80 bytes at Dh = 32, 144 at Dh = 64): the eight 16-byte row
//     segments of each 8x8 matrix fall in distinct bank groups (5r and 9r
//     mod 8), so neither orientation has a bank conflict. A lane's lse,
//     delta, keep words and key bias come two at a time (8-byte loads).
//   * The instructions around the products, which outnumber the MMAs: each
//     p is one FMA and one `ex2.approx` (the score in units of log2(e), the
//     bias and lse scaled once); rows past Lq and keys past Lk are left to
//     their zero-filled operands (their dP and dO are 0, so they add nothing)
//     instead of a test an element, and every 16-row step of a stage runs,
//     a last tile's too: a test that skipped the steps wholly past Lq or Lk
//     made the call slower (0.0257 against 0.0249 ms).
//   * The Philox rounds: drawn once, in the pre-pass, which writes one keep
//     bit per (query, key), 32 keys a word, as A'-mma's pre-pass does; the
//     passes stage the words of their tiles with the tiles. With dropout
//     the pre-pass CTA has four more warps that only draw, a tile ahead of
//     the walk, so the rounds overlap its loads and products: the call takes
//     0.0249 ms against 0.0267 when the walk's own warps draw, and 0.0226
//     with no draws at all.
//   * The latency of the streamed tiles: a double-buffered `cp.async` ring
//     (16-byte chunks; lse, delta and keep words in 4-byte copies), the next
//     tile landing while this one is computed; the key-padding bytes of the
//     row walks are fetched into registers a tile ahead. Rings of three and
//     four stages at Dh = 32, every tile of a 252-token walk in flight from
//     its start, were slower on an H100 (0.0257 and 0.0266 ms against
//     0.0249 in one call).
//
// Design: two launches and no atomics, so the gradients are deterministic.
//   * The pre-pass: a row walk over the keys (a CTA of four warps over 64
//     query rows, a warp per 16, K and V streaming in 64-key tiles) with the
//     S and dP products and no dS K, which sums delta; with dropout, four
//     more warps draw the keep words of each tile and write them.
//   * The passes, in one launch: dK/dV, one CTA of four warps per (batch *
//     head, 64 keys), a warp per 16 keys as the M dimension, Q, dO, lse,
//     delta and the keep words streaming in 64-query tiles (rows past Lq
//     zero-filled by src-size 0); and dQ, the pre-pass's walk reading delta
//     and the keep words, with dQ += dS K. Each reads only what the
//     pre-pass wrote, so their CTAs share one grid: at (252, 252) b8 that is
//     512 CTAs in flight where either pass alone has 256, and the one pass's
//     warps fill the other's waits (with the passes as two launches the call
//     takes 0.0298 ms against 0.0249).
//
// Entry point: a plain C function launching the two kernels on the given
// stream. It allocates nothing (the caller passes the scratch), does not
// synchronise, and returns cudaGetLastError().

#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16mma::ldmatrix_x4;
using bf16mma::ldmatrix_x4_trans;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
using fa::cp_async16;
using fa::cp_async4;
using fa::cp_async_commit;
using fa::cp_async_wait;
using fa::kMaskBias;
using fa::kMaskedRowLse;

constexpr int kThreads = 128;  // four warps a walk's CTA (the pre-pass adds four draw warps)
constexpr int kKvKeys = 64;    // keys of a dK/dV CTA, 16 a warp
constexpr int kTileQ = 64;     // queries of a dK/dV stage
constexpr int kTileK = 64;     // keys of a row-walk stage
constexpr int kQRows = 64;     // query rows of a row-walk CTA, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kTileQ && kThreads == 2 * kQRows && kTileK <= kThreads,
              "a thread stages one keep word, lse or delta of a tile");

// A staged row, padded: Dh + 8 bf16 elements.
template <int Dh>
constexpr int kStride = Dh + 8;
// How far the 16-row steps of a stage unroll: fully at Dh = 32; not at Dh =
// 64, where the held operands and the accumulators take ~100 registers.
template <int Dh>
constexpr int kUnroll = Dh == 32 ? 4 : 1;

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 and r0 + 8 (zero at or past n_rows) of a (rows, heads, Dh) bf16
// slab at token stride ts as m16n8k16 A fragments, one per k16 step of the
// head dim: lane 4g + t holds (row g, cols 2t, 2t + 1), (g + 8, ...), (g,
// 2t + 8, ...), (g + 8, 2t + 8, ...) of each step.
template <int Dh>
__device__ __forceinline__ void load_a(unsigned (&a)[Dh / 16][4], const bf16* head, long ts,
                                       int r0, int n_rows, int t) {
  const bool ok0 = r0 < n_rows, ok1 = r0 + 8 < n_rows;
  const bf16* p0 = head + (ok0 ? static_cast<long>(r0) * ts : 0L);
  const bf16* p1 = head + (ok1 ? static_cast<long>(r0 + 8) * ts : 0L);
#pragma unroll
  for (int s = 0; s < Dh / 16; ++s) {
    const int col = 16 * s + 2 * t;
    a[s][0] = ok0 ? *reinterpret_cast<const unsigned*>(p0 + col) : 0u;
    a[s][1] = ok1 ? *reinterpret_cast<const unsigned*>(p1 + col) : 0u;
    a[s][2] = ok0 ? *reinterpret_cast<const unsigned*>(p0 + col + 8) : 0u;
    a[s][3] = ok1 ? *reinterpret_cast<const unsigned*>(p1 + col + 8) : 0u;
  }
}

// d = A B over the head dim for one n tile of 8 staged rows: A the held
// fragments, B (k = head dim, n = row) read plainly by `ldmatrix.x4` from
// `rows`, this lane's address in the tile's first row (row lane % 8,
// column 8 (lane / 8)); each x4 gives two k16 steps.
template <int Dh>
__device__ __forceinline__ void product_nt(float (&d)[4], const unsigned (&a)[Dh / 16][4],
                                           const bf16* rows) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int p = 0; p < Dh / 32; ++p) {
    unsigned b[4];
    ldmatrix_x4(b, rows + 32 * p);
    mma_bf16(d, a[2 * p], b[0], b[1]);
    mma_bf16(d, a[2 * p + 1], b[2], b[3]);
  }
}

// acc (16 rows x Dh) += A B over 16 staged rows: A one packed fragment, B (k
// = staged row, n = head dim) read by `ldmatrix.x4.trans` from `rows`, this
// lane's address in the first row (row lane % 8 + 8 ((lane / 8) % 2),
// column 8 (lane / 16)); each x4 gives two n tiles.
template <int Dh>
__device__ __forceinline__ void add_product_t(float (&acc)[Dh / 8][4], const unsigned (&a)[4],
                                              const bf16* rows) {
#pragma unroll
  for (int dp = 0; dp < Dh / 16; ++dp) {
    unsigned b[4];
    ldmatrix_x4_trans(b, rows + 16 * dp);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Two adjacent m16n8 accumulator tiles, columns 0-7 and 8-15, as one
// m16n8k16 A fragment rounded to bf16.
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

template <int Dh>
__device__ __forceinline__ void store_rows(bf16* out, long ts, int r0, int n_rows, int t,
                                           const float (&acc)[Dh / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r0 + 8 * r >= n_rows) continue;
    bf16* row = out + static_cast<long>(r0 + 8 * r) * ts + 2 * t;
#pragma unroll
    for (int d = 0; d < Dh / 8; ++d)
      *reinterpret_cast<unsigned*>(row + 8 * d) = pack_bf16(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// The shared memory of a row walk and of a key walk; the launch that runs
// both kinds of CTA gives each the larger, as one buffer.
template <int Dh>
struct RowSmem {
  bf16 k_tile[2][kTileK * kStride<Dh>];
  bf16 v_tile[2][kTileK * kStride<Dh>];
  float bias_tile[2][kTileK];
  unsigned keep_tile[2][kQRows][2];  // a row's two words of the tile's keys
};

template <int Dh>
struct KeySmem {
  bf16 q_tile[2][kTileQ * kStride<Dh>];
  bf16 do_tile[2][kTileQ * kStride<Dh>];
  float lse_tile[2][kTileQ];
  float delta_tile[2][kTileQ];
  unsigned keep_tile[2][2][kTileQ];  // the CTA's two keep words of each query
};

// ---- the row walks: the pre-pass (kDelta) and dQ -----------------------------

// One CTA (row block `block` of head `bh`): four warps over 64 query rows of
// one (batch, head), a warp per 16, walking every 64-key tile. kDelta: the pre-pass, which draws the keep
// words (with dropout), writes them to `keep` and sums delta_i = sum_j p_ij
// m_ij dP_ij into `delta`; otherwise dQ, which reads both. Keep word w of
// row bh * lq + i has bit c set iff key 32w + c of query i is kept: word c %
// 4 of Philox4x32-10 at counter (8w + c / 4, i, bh, 0) reaches the
// threshold (flash_attention_common.cuh).
template <int Dh, bool kDelta>
__device__ __forceinline__ void row_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
    const unsigned char* __restrict__ mask, const unsigned long long* __restrict__ seed,
    unsigned threshold, unsigned* __restrict__ keep, float keep_scale, bf16* __restrict__ dq,
    int lq, int lk, int heads, int words, int block, int bh, unsigned char* smem) {
  constexpr int S = kStride<Dh>;
  constexpr int kChunks = Dh / 8;  // 16-byte chunks of a row
  RowSmem<Dh>& sm = *reinterpret_cast<RowSmem<Dh>*>(smem);
  auto& k_tile = sm.k_tile;
  auto& v_tile = sm.v_tile;
  auto& bias_tile = sm.bias_tile;
  auto& keep_tile = sm.keep_tile;

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
  const int row0 = block * kQRows;
  const int row_base = row0 + warp * 16;  // this warp's 16 query rows
  const float inv_lk = 1.f / static_cast<float>(lk);
  const int n_tiles = (lk + kTileK - 1) / kTileK;
  const uint2 philox_key = kDelta && keep != nullptr ? fa::seed_key(seed) : make_uint2(0u, 0u);

  // One tile's K, V and (dQ, with dropout) keep words as one cp.async group;
  // an empty group past the last tile, so that there is one group a tile.
  auto load_kv = [&](int tile, int stage) {
    if (tile < n_tiles) {
      const int k0 = tile * kTileK;
      for (int c = tid; c < kTileK * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int col = (c % kChunks) * 8;
        const int j = k0 + r;
        const long off = kv_head + (j < lk ? static_cast<long>(j) : 0L) * ts + col;
        const int bytes = j < lk ? 16 : 0;
        cp_async16(&k_tile[stage][r * S + col], k + off, bytes);
        cp_async16(&v_tile[stage][r * S + col], v + off, bytes);
      }
      if (!kDelta && keep != nullptr) {
        const int i = row0 + tid / 2;
        const int wi = 2 * tile + tid % 2;
        const bool ok = i < lq && wi < words;
        const long word = (static_cast<long>(bh) * lq + (ok ? i : 0)) * words + (ok ? wi : 0);
        cp_async4(&keep_tile[stage][tid / 2][tid % 2], keep + word, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // The pre-pass draws a tile's keep words, a word a thread (dt of 128),
  // into the stage's slots and out to `keep`.
  auto draw_keep = [&](int tile, int stage, int dt) {
    const int i = row0 + dt / 2;
    const int wi = 2 * tile + dt % 2;
    unsigned bits = 0u;
    if (i < lq && wi < words) {
#pragma unroll
      for (unsigned c = 0; c < 8; ++c) {
        const uint4 r = fa::philox4x32_10(
            make_uint4(8 * wi + c, static_cast<unsigned>(i), static_cast<unsigned>(bh), 0u),
            philox_key);
        bits |= (r.x >= threshold ? 1u : 0u) << (4 * c);
        bits |= (r.y >= threshold ? 1u : 0u) << (4 * c + 1);
        bits |= (r.z >= threshold ? 1u : 0u) << (4 * c + 2);
        bits |= (r.w >= threshold ? 1u : 0u) << (4 * c + 3);
      }
      keep[(static_cast<long>(bh) * lq + i) * words + wi] = bits;
    }
    keep_tile[stage][dt / 2][dt % 2] = bits;
  };
  // The mask bytes of a tile's keys go through a register a tile ahead (the
  // mask's rows need not be aligned for cp.async); its bias, in units of
  // log2(e) as the exps take it, is 0 for a key that counts, -1e30 log2(e)
  // for a padded one, -inf past Lk.
  unsigned char mask_byte = 0;
  auto fetch_mask = [&](int tile) {
    const int j = tile * kTileK + tid;
    mask_byte = mask_row != nullptr && tid < kTileK && j < lk ? mask_row[j] : 0;
  };
  auto write_bias = [&](int tile) {
    const int j = tile * kTileK + tid;
    if (tid < kTileK)
      bias_tile[tile & 1][tid] = j >= lk ? -INFINITY : mask_byte != 0 ? kMaskBias * kLog2e : 0.f;
  };

  if (kDelta && tid >= kThreads) {
    // With dropout the pre-pass has four more warps, which draw the keep
    // words: tile 0's first, then each next tile's while the walk computes
    // this one (its stage was last read before the previous barrier), so
    // the Philox rounds overlap the walk's loads and products.
    draw_keep(0, 0, tid - kThreads);
    for (int tile = 0; tile < n_tiles; ++tile) {
      __syncthreads();  // the walk's first barrier of the tile
      if (tile + 1 < n_tiles) draw_keep(tile + 1, (tile + 1) & 1, tid - kThreads);
      __syncthreads();  // and its last
    }
    return;
  }

  load_kv(0, 0);
  fetch_mask(0);
  write_bias(0);
  fetch_mask(1);

  // This warp's 16 query rows (g and g + 8 in this lane) as A fragments.
  unsigned qf[Dh / 16][4], gf[Dh / 16][4];
  load_a<Dh>(qf, q + q_head, ts, row_base + g, lq, t);
  load_a<Dh>(gf, dout + q_head, ts, row_base + g, lq, t);
  float l2[2], dl[2];  // lse in units of log2(e), delta
  bool row_padded[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_base + g + 8 * r;
    const float l = row < lq ? lse[static_cast<long>(bh) * lq + row] : 0.f;
    l2[r] = l * kLog2e;
    dl[r] = !kDelta && row < lq ? delta[static_cast<long>(bh) * lq + row] : 0.f;
    row_padded[r] = l <= kMaskedRowLse;
  }
  float acc[Dh / 8][4];
  zero(acc);

  // ldmatrix addresses of this lane in a tile: plain (B = rows as n) and
  // transposed (B = rows as k).
  const int b_lane = (lane % 8) * S + 8 * (lane / 8);
  const int bt_lane = (lane % 8 + 8 * ((lane / 8) % 2)) * S + 8 * (lane / 16);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // The next tile's bias from the bytes fetched a tile ago; its stage was
    // last read before the previous iteration's final barrier.
    if (tile + 1 < n_tiles) write_bias(tile + 1);
    fetch_mask(tile + 2);
    load_kv(tile + 1, stage ^ 1);
    cp_async_wait<1>();
    __syncthreads();

    const bf16* kt = k_tile[stage];
    const bf16* vt = v_tile[stage];
    const float* bias = bias_tile[stage];
    // This lane's rows' keep words: row g's two, row g + 8's 16 words on.
    const unsigned* keep_rows = keep_tile[stage][warp * 16 + g];

    // Every step of the tile runs, a last tile's past Lk too: they add
    // nothing (below), and a test for them made the walk slower.
#pragma unroll(kUnroll<Dh>)
    for (int kr = 0; kr < kTileK; kr += 16) {  // the step's first key in the tile
      // S = Q K^T and dP = dO V^T, 16 queries x 8 keys per n tile.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        product_nt<Dh>(s[u], qf, kt + (kr + 8 * u) * S + b_lane);
        product_nt<Dh>(dp[u], gf, vt + (kr + 8 * u) * S + b_lane);
      }
      // p, m and dS on this lane's keys kr + 8u + 2t and + 1 (in the tile).
      // Past Lk the K and V rows are zero-filled: dP is 0 there, so p m dP
      // adds nothing to delta, and dS is 0 as on a padded key.
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = kr + 8 * u + 2 * t;
        const float2 kb = *reinterpret_cast<const float2*>(bias + key);
        unsigned bits[2] = {0u, 0u};  // rows g and g + 8, key `key` at bit 0
        if (keep != nullptr) {
          bits[0] = keep_rows[key >> 5] >> (key & 31);
          bits[1] = keep_rows[16 + (key >> 5)] >> (key & 31);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const float b = e % 2 ? kb.y : kb.x;
          const float p =
              row_padded[r] ? inv_lk : exp2_approx(fmaf(s[u][e], kLog2e, b - l2[r]));
          const float mf = keep == nullptr ? 1.f : (bits[r] >> (e % 2)) & 1u ? keep_scale : 0.f;
          if constexpr (kDelta) {
            dl[r] = fmaf(p * mf, dp[u][e], dl[r]);
          } else {
            s[u][e] = b != 0.f ? 0.f : p * (mf * dp[u][e] - dl[r]);  // dS
          }
        }
      }
      if constexpr (!kDelta) {
        unsigned da[4];
        pack_a(da, s);
        add_product_t<Dh>(acc, da, kt + kr * S + bt_lane);  // dQ += dS K
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if constexpr (kDelta) {
    // The four lanes of a row hold disjoint keys: sum their shares.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
      dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
      const int row = row_base + g + 8 * r;
      if (t == 0 && row < lq) delta[static_cast<long>(bh) * lq + row] = dl[r];
    }
  } else {
    store_rows<Dh>(dq + q_head, ts, row_base + g, lq, t, acc);
  }
}

// ---- dK / dV -------------------------------------------------------------

// One CTA (key block `block` of head `bh`): four warps over 64 keys, a warp
// per 16 as the M dimension, walking every 64-query tile.
template <int Dh>
__device__ __forceinline__ void key_walk(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mask,
    const unsigned* __restrict__ keep, float keep_scale, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int lq, int lk, int heads, int words, int block, int bh,
    unsigned char* smem) {
  constexpr int S = kStride<Dh>;
  constexpr int kChunks = Dh / 8;
  KeySmem<Dh>& sm = *reinterpret_cast<KeySmem<Dh>*>(smem);
  auto& q_tile = sm.q_tile;
  auto& do_tile = sm.do_tile;
  auto& lse_tile = sm.lse_tile;
  auto& delta_tile = sm.delta_tile;
  auto& keep_tile = sm.keep_tile;

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
  const int key_base = block * kKvKeys + warp * 16;  // this warp's 16 keys
  const int keep_shift = (warp & 1) * 16 + g;  // bit of key g in its keep word
  const float inv_lk = 1.f / static_cast<float>(lk);

  // This lane's keys: rows g and g + 8 of the warp's 16, their bias in units
  // of log2(e). A key past Lk has zero K and V rows and is never stored.
  bool padded[2];
  float bias2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key_base + g + 8 * r;
    padded[r] = j < lk && mask != nullptr && mask[static_cast<long>(b) * lk + j] != 0;
    bias2[r] = padded[r] ? kMaskBias * kLog2e : 0.f;
  }
  unsigned kf[Dh / 16][4], vf[Dh / 16][4];
  load_a<Dh>(kf, k + kv_head, ts, key_base + g, lk, t);
  load_a<Dh>(vf, v + kv_head, ts, key_base + g, lk, t);
  float dka[Dh / 8][4], dva[Dh / 8][4];
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
        const int col = (c % kChunks) * 8;
        const int i = i0 + r;
        const long off = q_head + (i < lq ? static_cast<long>(i) : 0L) * ts + col;
        const int bytes = i < lq ? 16 : 0;
        cp_async16(&q_tile[stage][r * S + col], q + off, bytes);
        cp_async16(&do_tile[stage][r * S + col], dout + off, bytes);
      }
      {  // threads 0-63 lse, 64-127 delta
        const int r = tid % kTileQ;
        const int i = i0 + r;
        const long row = static_cast<long>(bh) * lq + (i < lq ? i : 0);
        if (tid < kTileQ) {
          cp_async4(&lse_tile[stage][r], lse + row, i < lq ? 4 : 0);
        } else {
          cp_async4(&delta_tile[stage][r], delta + row, i < lq ? 4 : 0);
        }
      }
      if (keep != nullptr) {  // a word a thread: query tid / 2, the CTA's word tid % 2
        const int i = i0 + tid / 2;
        const int wi = 2 * block + tid % 2;
        const bool ok = i < lq && wi < words;
        const long word = (static_cast<long>(bh) * lq + (ok ? i : 0)) * words + (ok ? wi : 0);
        cp_async4(&keep_tile[stage][tid % 2][tid / 2], keep + word, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int b_lane = (lane % 8) * S + 8 * (lane / 8);
  const int bt_lane = (lane % 8 + 8 * ((lane / 8) % 2)) * S + 8 * (lane / 16);

  load_q(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    // The other stage was last read before the previous iteration's final
    // barrier: refill it, then wait until only that group is in flight.
    load_q(tile + 1, stage ^ 1);
    cp_async_wait<1>();
    __syncthreads();

    const bf16* qt = q_tile[stage];
    const bf16* gt = do_tile[stage];
    if (key_base < lk) {  // uniform across the warp
#pragma unroll(kUnroll<Dh>)
      for (int c0 = 0; c0 < kTileQ; c0 += 16) {  // the step's first query in the stage
        // S^T = K Q^T and dP^T = V dO^T, 16 keys x 8 queries per n tile.
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          product_nt<Dh>(st[u], kf, qt + (c0 + 8 * u) * S + b_lane);
          product_nt<Dh>(dpt[u], vf, gt + (c0 + 8 * u) * S + b_lane);
        }
        // P o M over st, dS over dpt, on this lane's queries c0 + 8u + 2t and
        // + 1 (in the stage); then each as a packed A fragment over the
        // step's 16 queries. Past Lq the Q and dO rows, lse, delta and keep
        // words are zero-filled: p stays finite and dP and dO are 0, so
        // those rows add nothing to dV or dK.
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = c0 + 8 * u + 2 * t;
          const float2 lr = *reinterpret_cast<const float2*>(&lse_tile[stage][col]);
          const float2 dl = *reinterpret_cast<const float2*>(&delta_tile[stage][col]);
          uint2 words2 = make_uint2(0u, 0u);
          if (keep != nullptr)
            words2 = *reinterpret_cast<const uint2*>(&keep_tile[stage][warp >> 1][col]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            const float l = e % 2 ? lr.y : lr.x;
            const float p = l <= kMaskedRowLse
                                ? inv_lk
                                : exp2_approx(fmaf(l, -kLog2e, fmaf(st[u][e], kLog2e, bias2[r])));
            const unsigned word = e % 2 ? words2.y : words2.x;
            const float mf =
                keep == nullptr ? 1.f : (word >> (keep_shift + 8 * r)) & 1u ? keep_scale : 0.f;
            st[u][e] = p * mf;
            dpt[u][e] = padded[r] ? 0.f : p * (mf * dpt[u][e] - (e % 2 ? dl.y : dl.x));
          }
        }
        unsigned pa[4], sa[4];
        pack_a(pa, st);
        pack_a(sa, dpt);
        add_product_t<Dh>(dva, pa, gt + c0 * S + bt_lane);  // dV += (P o M)^T dO
        add_product_t<Dh>(dka, sa, qt + c0 * S + bt_lane);  // dK += dS^T Q
      }
    }
    __syncthreads();
  }

  store_rows<Dh>(dk + kv_head, ts, key_base + g, lk, t, dka);
  store_rows<Dh>(dv + kv_head, ts, key_base + g, lk, t, dva);
}

template <int Dh>
__global__ void __launch_bounds__(2 * kThreads)
prepass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ delta,
               const unsigned char* __restrict__ mask,
               const unsigned long long* __restrict__ seed, unsigned threshold,
               unsigned* __restrict__ keep, float keep_scale, int lq, int lk, int heads,
               int words) {
  __shared__ __align__(16) unsigned char smem[sizeof(RowSmem<Dh>)];
  row_walk<Dh, true>(q, k, v, dout, lse, delta, mask, seed, threshold, keep, keep_scale, nullptr,
                     lq, lk, heads, words, blockIdx.x, blockIdx.y, smem);
}

// The two passes in one launch: CTAs [0, kv_blocks) of each head walk keys
// (dK, dV), the others walk rows (dQ). Both read only what the pre-pass
// wrote, so they run side by side, twice the CTAs in flight of either.
template <int Dh>
__global__ void __launch_bounds__(kThreads)
passes_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ delta,
              const unsigned char* __restrict__ mask, unsigned* __restrict__ keep,
              float keep_scale, bf16* __restrict__ dq, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int lq, int lk, int heads, int words, int kv_blocks) {
  constexpr int kBytes = sizeof(RowSmem<Dh>) > sizeof(KeySmem<Dh>) ? sizeof(RowSmem<Dh>)
                                                                   : sizeof(KeySmem<Dh>);
  __shared__ __align__(16) unsigned char smem[kBytes];
  if (static_cast<int>(blockIdx.x) < kv_blocks) {
    key_walk<Dh>(q, k, v, dout, lse, delta, mask, keep, keep_scale, dk, dv, lq, lk, heads, words,
                 blockIdx.x, blockIdx.y, smem);
  } else {
    row_walk<Dh, false>(q, k, v, dout, lse, delta, mask, nullptr, 0u, keep, keep_scale, dq, lq,
                        lk, heads, words, blockIdx.x - kv_blocks, blockIdx.y, smem);
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float* lse;
  const unsigned char* mask;
  const unsigned long long* seed;
  unsigned threshold;
  float keep_scale;
  bf16 *dq, *dk, *dv;
  float* delta;
  int batch, lq, lk, heads;
  cudaStream_t stream;
};

template <int Dh>
int launch(const Args& a) {
  // The scratch: delta, then (with dropout) the keep words.
  const long rows = static_cast<long>(a.batch) * a.heads * a.lq;
  const int words = (a.lk + 31) / 32;
  unsigned* keep = a.threshold != 0u ? reinterpret_cast<unsigned*>(a.delta + rows) : nullptr;
  const int row_blocks = (a.lq + kQRows - 1) / kQRows;
  const int kv_blocks = (a.lk + kKvKeys - 1) / kKvKeys;
  const int prepass_threads = keep != nullptr ? 2 * kThreads : kThreads;  // + the draw warps
  prepass_kernel<Dh><<<dim3(row_blocks, a.batch * a.heads), prepass_threads, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.mask, a.seed, a.threshold, keep, a.keep_scale,
      a.lq, a.lk, a.heads, words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  passes_kernel<Dh><<<dim3(kv_blocks + row_blocks, a.batch * a.heads), kThreads, 0, a.stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.mask, keep, a.keep_scale, a.dq, a.dk, a.dv, a.lq,
      a.lk, a.heads, words, kv_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The arguments of flash_attention_bwd (flash_attention_bwd.cu), with dtype
// 1 (bfloat16) only; out is not read. q, k, v, dout, dq, dk, dv: bf16
// (batch, L, heads, head_dim), contiguous, 16-byte aligned; head_dim 32 or
// 64. lse: (batch * heads, lq) fp32 from the forward. mask, seed, threshold,
// keep_scale: as the forward got them. delta: scratch of batch * heads * lq
// floats followed, when threshold is not 0, by batch * heads * lq * ceil(lk
// / 32) 32-bit words. Returns a cudaError_t as int (0 = launched).
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        const void* mask, const void* seed, unsigned threshold,
                                        float keep_scale, void* dq, void* dk, void* dv,
                                        void* delta, int batch, int lq, int lk, int heads,
                                        int head_dim, int dtype, void* stream) {
  (void)out;
  if (batch <= 0 || lq <= 0 || lk <= 0 || heads <= 0 || batch * heads > 65535 || dtype != 1 ||
      lse == nullptr || delta == nullptr || (threshold != 0u && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
               static_cast<const float*>(lse), static_cast<const unsigned char*>(mask),
               static_cast<const unsigned long long*>(seed), threshold, keep_scale,
               static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               static_cast<float*>(delta), batch, lq, lk, heads,
               static_cast<cudaStream_t>(stream)};
  if (head_dim == 32) return launch<32>(a);
  if (head_dim == 64) return launch<64>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
