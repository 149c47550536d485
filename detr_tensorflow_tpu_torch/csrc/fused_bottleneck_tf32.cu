// The whole identity bottleneck of ResNet in one kernel, in fp32 on
// Hopper's tensor cores (sm_90a) with fp32-accurate 3xTF32 products, and
// thread-block clusters splitting the channels: E-tf32.
//
// Replaces the TPU kernel `_kernel` (launched by `fused_bottleneck`) of
// detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py for fp32:
//   T1 = relu(W1 x + b1), zero outside the image
//   T2 = relu(W2 * T1 + b2)        (3x3, pad 1)
//   y  = relu(W3 T2 + b3 + x)
// over x and y (N, H, W, C) in memory (the port's NCHW activations in
// channels_last), fp32 weights (the BN scale folded in fp32), fp32 biases,
// fp32 accumulation, the residual added in fp32, one rounding of y (T1 and
// T2 "rounded to fp32" is a no-op). bf16 calls run E-mma
// (fused_bottleneck_mma.cu; ops/fused_bottleneck.py:route). This is
// E-mma's design carried to `mma.sync.m16n8k8` TF32:
//
//   * The products. 2 H W (C M + 9 M^2 + M C) operations a block, 8.56
//     GFLOP at each ResNet-50 width of the 768x1280 bucket (more with the
//     halo); as 3xTF32 (tf32_mma.cuh) each is three TF32 MMAs, 25.7 GFLOP of
//     MMAs, 0.052 ms at the 495 TFLOP/s TF32 peak (0.128 ms on the 67
//     TFLOP/s fp32 pipes); that bounds every width, the bytes (x read, y
//     written, the weights once) stay below it. Each stage is a product of
//     [tile pixels x K] by [K x N] on `mma.sync.m16n8k8` TF32: a warp owns
//     16-row x 8-column accumulator blocks, takes A (pixel rows) with
//     `ldmatrix` (fp32 read as b16 pairs) and B (a row-major (K, N) weight
//     chunk, `pack_weights`' layouts) with scalar loads, and splits both
//     into big and small parts in registers. Rows of T1 and of x's chunk
//     are padded by 4 floats, so the 8 row addresses of each `ldmatrix`
//     matrix fall in distinct 16-byte bank groups; weight rows by 8, so
//     lane (g, t)'s B loads hit bank 8t + g. conv2's nine taps are a free
//     gather: output pixel p's row for tap (dy, dx) is halo row (p / TW +
//     dy) (TW + 2) + p % TW + dx of T1, one row address a lane.
//   * Accuracy. The tensor cores truncate when an MMA adds to its
//     accumulator, and conv2's sum is 9 M deep (4608 at M = 512), so no
//     big x big sum is chained: the big x big products of every 32
//     contraction rows sum in a fresh accumulator (4 MMAs deep), added to
//     the running fp32 sum with a rounded add; the cross terms (2^-11 of
//     it) chain in an accumulator of their own, added at the end. A numpy
//     emulation of this (tests/test_torch_fused.py, truncating every MMA)
//     stays within 1e-5 of float64 at every width; single TF32, or 3xTF32
//     chained without the flushes, does not at M = 512. Three accumulator
//     sets cap a warp at 8 blocks of 16 x 8 (96 floats), so every product
//     runs in passes of at most 64 blocks a CTA; the plans give stages 1
//     and 2 one pass each.
//   * The loads. x's halo chunks and the weight chunks stream through a
//     3-stage `cp.async` ring, two chunks ahead of the MMAs, one barrier a
//     chunk (fused_bottleneck_common.cuh); pixels outside the image are
//     zero-filled (src-size 0).
//   * Shared memory. At fp32, T1 over the halo and T2 over the tile at all
//     M channels take twice E-mma's bytes: 339 KB at M = 512 with E-mma's 8
//     x 8 tile. T2 therefore overlays T1, which conv2 no longer needs once
//     its product is done (in a cluster, after a barrier at which every
//     rank has finished reading its T1), and M = 512 takes a 4 x 8 tile:
//     124 KB of T1, 228 KB in all.
//   * The width. A cluster of K CTAs (Hopper's thread-block clusters)
//     shares one pixel tile: rank r computes T1's and T2's r-th slice of
//     M / K channels from W1's and W2's r-th column slices, pushes it into
//     the other ranks' shared memory (fused_bottleneck_common.cuh), and
//     computes y's r-th slice of C / K channels in passes.
//   * The halo. conv1 runs over (TH + 2) (TW + 2) pixels for TH TW outputs
//     (1.56x its work at 8 x 8, 1.88x at 4 x 8); T1 is zeroed at halo
//     pixels outside the image, where the unfused conv2 reads zero padding
//     (relu(b1) != 0 there).
// One plan (TH, TW, K) is compiled per M (with_plan below): 8 x 8 tiles
// with clusters of 1, 2 and 4 at M = 64, 128 and 256, 4 x 8 with clusters
// of 4 at M = 512; any other M is refused. ops/fused_bottleneck.py:
// TF32_PLANS lists the same, and tf32_smem_bytes mirrors Plan::kSmem.
// What is left: on an H100 (700 W) it takes ~5.4x its 3xTF32 bound, at
// about three times the cycles an MMA that issue and the MMA pipe allow,
// with two warps a scheduler (193 registers, one CTA an SM). Weights split
// once ahead of the kernel (fewer instructions an MMA), `wgmma` and more
// CTAs an SM are the next levers.
//
// Entry points: plain C functions, built with nvcc into a shared library
// and called through ctypes. The kernel launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "fused_bottleneck_common.cuh"
#include "tf32_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using cpa::cp_async16;
using fbc::cluster_arrive_relaxed;
using fbc::cluster_sync;
using fbc::cluster_wait;
using fbc::kMaxSmem;
using fbc::kStages;
using fbc::kThreads;
using fbc::kWarps;
using fbc::max3;
using fbc::pipeline;
using fbc::push_slice;
using tf32mma::ldmatrix_a;
using tf32mma::mma_tf32;
using tf32mma::split_tf32;

// Contraction rows a chunk_product: big x big sums in a fresh accumulator
// over its 4 k8 steps before it joins the running sum. A chunk of the ring
// is one chunk_product in stages 1 and 3, two in stage 2 (half the
// barriers of the longest stage; 4% faster on an H100).
constexpr int kKc = 32;
constexpr int kKc2 = 64;
// 16 x 8 accumulator blocks a warp: three sets (running sum, a chunk's big
// x big, the cross terms) of four floats each, 96 registers.
constexpr int kMaxBlocks = 8;

// A warp's issue slots per k8 step at RTW row tiles by NTW column tiles:
// per row tile one `ldmatrix` and four splits, per column tile two loads and
// two splits (a split is 5 instructions).
constexpr int step_cost(int rtw, int ntw) { return 21 * rtw + 12 * ntw; }

// The warps of a pass split its RT row tiles (16 pixels) x NT column tiles
// (8 channels) as WR x WC: warp (wr, wc) takes row tiles wr, wr + WR, ...
// and the NTW adjacent column tiles from wc NTW. WC is the split with the
// fewest issue slots a k8 step that keeps a warp within kMaxBlocks; 0 if
// none does.
constexpr int warp_cols(int rt, int nt) {
  int best = 0, best_cost = 1 << 30;
  for (int wc = 1; wc <= kWarps; wc *= 2) {
    const int wr = kWarps / wc, rtw = (rt + wr - 1) / wr, ntw = nt / wc;
    if (nt % wc != 0 || rtw * ntw > kMaxBlocks) continue;
    if (step_cost(rtw, ntw) < best_cost) {
      best = wc;
      best_cost = step_cost(rtw, ntw);
    }
  }
  return best;
}

template <int RT, int NT>
struct Warps {
  static constexpr int WC = warp_cols(RT, NT);
  static_assert(WC > 0, "a pass holds at most 8 accumulator blocks a warp");
  static constexpr int WR = kWarps / WC, RTW = (RT + WR - 1) / WR, NTW = NT / WC;
};

// A plan: T1 / T2 width M, a TH x TW pixel tile, K CTAs a cluster. Shared
// memory, in floats: T1 [P1][LD] (T2 [P2][LD] over it once conv2 is done),
// then kStages ring stages of the largest of stage 1's x chunk [P1][kKc +
// 4] with its W1 chunk [kKc][NK + 8], stage 2's W2 chunk [kKc2][NK + 8] and
// stage 3's W3 chunk [kKc][NP3 + 8]. ops/fused_bottleneck.py:
// tf32_smem_bytes mirrors this.
template <int M_, int TH_, int TW_, int K_>
struct Plan {
  static constexpr int M = M_, TH = TH_, TW = TW_, K = K_;
  static constexpr int HW = TW + 2;  // halo row width
  static constexpr int P1 = (TH + 2) * HW, P2 = TH * TW;
  static constexpr int RT1 = (P1 + 15) / 16, RT2 = P2 / 16;
  static constexpr int NK = M / K;  // T1 / T2 channels of a rank
  // y channels a stage-3 pass: kWarps * kMaxBlocks blocks a CTA.
  static constexpr int NP3 = 8 * kWarps * kMaxBlocks / RT2;
  static constexpr int LD = M + 4, LDX = kKc + 4, LDW = NK + 8, LDW3 = NP3 + 8;
  static constexpr int kRing = max3(P1 * LDX + kKc * LDW, kKc2 * LDW, kKc * LDW3);
  static constexpr int kSmem = 4 * (P1 * LD + kStages * kRing);
  static_assert(M % K == 0 && M % kKc2 == 0 && NK % 8 == 0, "whole chunks, rank slices of blocks");
  static_assert(TW % 8 == 0 && P2 % 16 == 0, "8-row groups of output pixels in one tile row");
  static_assert(kSmem <= kMaxSmem, "a CTA holds at most 227 KB");
};

// hi = A_big B_big over one chunk of kKc contraction rows, in fresh
// accumulators, then acc += hi; lo += A_small B_big + A_big B_small. a[i]:
// this lane's `ldmatrix_a` row address of row tile i at the chunk's first
// column (a row tile past the product's rows reads its last row, and its
// results are dropped); b: this lane's B address (row t, column g of the
// warp's first column tile) in the chunk. Every row tile is computed, so a
// k8 step is one block of straight-line code (a branch per row tile made
// E-tf32 11% slower on an H100).
template <int RTW, int NTW>
__device__ __forceinline__ void chunk_product(float (&acc)[RTW][NTW][4],
                                              float (&lo)[RTW][NTW][4],
                                              const float* (&a)[RTW], const float* b, int ldb) {
  float hi[RTW][NTW][4] = {};
#pragma unroll
  for (int ks = 0; ks < kKc / 8; ++ks) {
    unsigned bb[NTW][2], bs[NTW][2], ab[RTW][4], as[RTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      split_tf32(b[8 * ks * ldb + 8 * j], bb[j][0], bs[j][0]);
      split_tf32(b[(8 * ks + 4) * ldb + 8 * j], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int i = 0; i < RTW; ++i) {
      unsigned af[4];
      ldmatrix_a(af, a[i] + 8 * ks);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(af[e]), ab[i][e], as[i][e]);
    }
    // Three passes over the blocks, so that the two MMAs into one lo
    // accumulator issue RTW NTW MMAs apart (the MMAs keep their order).
#pragma unroll
    for (int i = 0; i < RTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma_tf32(hi[i][j], ab[i], bb[j][0], bb[j][1]);
#pragma unroll
    for (int i = 0; i < RTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma_tf32(lo[i][j], as[i], bb[j][0], bb[j][1]);
#pragma unroll
    for (int i = 0; i < RTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma_tf32(lo[i][j], ab[i], bs[j][0], bs[j][1]);
  }
#pragma unroll
  for (int i = 0; i < RTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += hi[i][j][e];
}

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    fused_bottleneck_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                                 const float* __restrict__ b1, const float* __restrict__ w2t,
                                 const float* __restrict__ b2, const float* __restrict__ w3t,
                                 const float* __restrict__ b3, float* __restrict__ y, int c,
                                 int h, int w, int tiles_x) {
  constexpr int M = P::M, TW = P::TW, HW = P::HW, K = P::K, NK = P::NK, LD = P::LD;
  constexpr int P1 = P::P1, P2 = P::P2;
  extern __shared__ __align__(16) float smem[];
  float* t1 = smem;                // [P1][LD]
  float* t2 = smem;                // [P2][LD], over T1 once conv2 is done
  float* ring = smem + P1 * LD;    // [kStages][kRing]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  int rank = 0;
  if constexpr (K > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    cluster_arrive_relaxed();  // this CTA runs; waited on before the first push
  }
  const int tile = blockIdx.x / K;
  const int oy0 = (tile / tiles_x) * P::TH, ox0 = (tile % tiles_x) * TW;
  const float* xb = x + static_cast<int64_t>(blockIdx.y) * h * w * c;
  float* yb = y + static_cast<int64_t>(blockIdx.y) * h * w * c;
  // ldmatrix_a's row and column of this lane in a 16-row tile.
  const int a_row = lane % 16, a_col = 4 * (lane / 16);

  // Halo pixel q sits at image (oy0 - 1 + q / HW, ox0 - 1 + q % HW).
  auto halo_in_image = [&](int q) {
    const int gy = oy0 - 1 + q / HW, gx = ox0 - 1 + q % HW;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  };

  // 1. T1's slice = relu(x W1[:, slice] + b1) over the halo, zero outside
  //    the image. Rows past the halo's last pixel repeat it (discarded).
  {
    using L = Warps<P::RT1, NK / 8>;
    const int wr = warp / L::WC, wc = warp % L::WC;
    const int rows = min(L::RTW, (P::RT1 - wr + L::WR - 1) / L::WR);
    int a_off[L::RTW];
#pragma unroll
    for (int i = 0; i < L::RTW; ++i)
      a_off[i] = min((wr + L::WR * i) * 16 + a_row, P1 - 1) * P::LDX + a_col;
    const int b_off = t * P::LDW + wc * L::NTW * 8 + g;
    float acc[L::RTW][L::NTW][4] = {}, lo[L::RTW][L::NTW][4] = {};
    pipeline(
        c / kKc,
        [&](int chunk, int stage) {
          float* xs = ring + stage * P::kRing;
          float* ws = xs + P1 * P::LDX;
          const int k0 = chunk * kKc;
          for (int i = tid; i < P1 * (kKc / 4); i += kThreads) {
            const int q = i / (kKc / 4), part = i % (kKc / 4);
            const bool inside = halo_in_image(q);
            const int64_t pixel = static_cast<int64_t>(oy0 - 1 + q / HW) * w + ox0 - 1 + q % HW;
            cp_async16(xs + q * P::LDX + 4 * part, inside ? xb + pixel * c + k0 + 4 * part : xb,
                       inside ? 16 : 0);
          }
          for (int i = tid; i < kKc * (NK / 4); i += kThreads) {
            const int kk = i / (NK / 4), part = i % (NK / 4);
            cp_async16(ws + kk * P::LDW + 4 * part,
                       w1t + static_cast<int64_t>(k0 + kk) * M + rank * NK + 4 * part, 16);
          }
        },
        [&](int, int stage) {
          const float* xs = ring + stage * P::kRing;
          const float* a[L::RTW];
#pragma unroll
          for (int i = 0; i < L::RTW; ++i) a[i] = xs + a_off[i];
          chunk_product<L::RTW, L::NTW>(acc, lo, a, xs + P1 * P::LDX + b_off, P::LDW);
        });
#pragma unroll
    for (int i = 0; i < L::RTW; ++i) {
      if (i >= rows) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (wr + L::WR * i) * 16 + g + 8 * half;
        if (q >= P1) continue;
        const bool inside = halo_in_image(q);
#pragma unroll
        for (int j = 0; j < L::NTW; ++j) {
          const int n = rank * NK + (wc * L::NTW + j) * 8 + 2 * t;
          const float2 bias = *reinterpret_cast<const float2*>(b1 + n);
          const float v0 = fmaxf(acc[i][j][2 * half] + lo[i][j][2 * half] + bias.x, 0.f);
          const float v1 = fmaxf(acc[i][j][2 * half + 1] + lo[i][j][2 * half + 1] + bias.y, 0.f);
          *reinterpret_cast<float2*>(t1 + q * LD + n) =
              inside ? make_float2(v0, v1) : make_float2(0.f, 0.f);
        }
      }
    }
  }
  if constexpr (K > 1) {
    __syncthreads();  // this rank's T1 slice is complete
    cluster_wait();   // every rank has started
    push_slice<P>(t1, P1, rank);
    cluster_sync();   // every rank's slice is in every T1
  }

  // 2. T2's slice = relu(conv3x3(T1) W2[:, :, slice] + b2): chunk (tap, k0)
  //    gathers output pixel p's rows from halo row (p / TW + dy) HW + p % TW
  //    + dx. The pipeline's last barrier ends this CTA's reads of T1, so
  //    its T2 slice is written over it; in a cluster, the other ranks'
  //    slices come after a barrier at which every rank is past its reads.
  {
    using L = Warps<P::RT2, NK / 8>;
    const int wr = warp / L::WC, wc = warp % L::WC;
    const int rows = min(L::RTW, (P::RT2 - wr + L::WR - 1) / L::WR);
    int a_off[L::RTW];
#pragma unroll
    for (int i = 0; i < L::RTW; ++i) {
      const int p = min((wr + L::WR * i) * 16 + a_row, P2 - 1);
      a_off[i] = ((p / TW) * HW + p % TW) * LD + a_col;
    }
    const int b_off = t * P::LDW + wc * L::NTW * 8 + g;
    constexpr int kChunksPerTap = M / kKc2;
    float acc[L::RTW][L::NTW][4] = {}, lo[L::RTW][L::NTW][4] = {};
    pipeline(
        9 * kChunksPerTap,
        [&](int chunk, int stage) {
          float* ws = ring + stage * P::kRing;
          const int tap = chunk / kChunksPerTap, k0 = (chunk % kChunksPerTap) * kKc2;
          for (int i = tid; i < kKc2 * (NK / 4); i += kThreads) {
            const int kk = i / (NK / 4), part = i % (NK / 4);
            cp_async16(ws + kk * P::LDW + 4 * part,
                       w2t + (static_cast<int64_t>(tap) * M + k0 + kk) * M + rank * NK + 4 * part,
                       16);
          }
        },
        [&](int chunk, int stage) {
          const int tap = chunk / kChunksPerTap, k0 = (chunk % kChunksPerTap) * kKc2;
          const float* t1_tap = t1 + ((tap / 3) * HW + tap % 3) * LD + k0;
#pragma unroll
          for (int half = 0; half < kKc2 / kKc; ++half) {
            const float* a[L::RTW];
#pragma unroll
            for (int i = 0; i < L::RTW; ++i) a[i] = t1_tap + a_off[i] + half * kKc;
            chunk_product<L::RTW, L::NTW>(
                acc, lo, a, ring + stage * P::kRing + half * kKc * P::LDW + b_off, P::LDW);
          }
        });
#pragma unroll
    for (int i = 0; i < L::RTW; ++i) {
      if (i >= rows) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (wr + L::WR * i) * 16 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < L::NTW; ++j) {
          const int n = rank * NK + (wc * L::NTW + j) * 8 + 2 * t;
          const float2 bias = *reinterpret_cast<const float2*>(b2 + n);
          *reinterpret_cast<float2*>(t2 + p * LD + n) = make_float2(
              fmaxf(acc[i][j][2 * half] + lo[i][j][2 * half] + bias.x, 0.f),
              fmaxf(acc[i][j][2 * half + 1] + lo[i][j][2 * half + 1] + bias.y, 0.f));
        }
      }
    }
  }
  if constexpr (K > 1) {
    cluster_sync();  // every rank is done reading its T1 and wrote its T2 slice
    push_slice<P>(t2, P2, rank);
    cluster_sync();  // T2 is whole in every rank; no remote access after this
  } else {
    __syncthreads();  // T2 is complete
  }

  // 3. y's slice of C / K channels = relu(T2 W3[:, slice] + b3 + x), in
  //    passes of NP3 channels; x read again (from L2), pixels outside the
  //    image skipped.
  {
    constexpr int NP3 = P::NP3;
    using L = Warps<P::RT2, NP3 / 8>;
    const int wr = warp / L::WC, wc = warp % L::WC;
    const int rows = min(L::RTW, (P::RT2 - wr + L::WR - 1) / L::WR);
    int a_off[L::RTW];
#pragma unroll
    for (int i = 0; i < L::RTW; ++i)
      a_off[i] = min((wr + L::WR * i) * 16 + a_row, P2 - 1) * LD + a_col;
    const int b_off = t * P::LDW3 + wc * L::NTW * 8 + g;
    const int slice = c / K;
    for (int n0 = rank * slice; n0 < (rank + 1) * slice; n0 += NP3) {
      float acc[L::RTW][L::NTW][4] = {}, lo[L::RTW][L::NTW][4] = {};
      pipeline(
          M / kKc,
          [&](int chunk, int stage) {
            float* ws = ring + stage * P::kRing;
            const int k0 = chunk * kKc;
            for (int i = tid; i < kKc * (NP3 / 4); i += kThreads) {
              const int kk = i / (NP3 / 4), part = i % (NP3 / 4);
              cp_async16(ws + kk * P::LDW3 + 4 * part,
                         w3t + static_cast<int64_t>(k0 + kk) * c + n0 + 4 * part, 16);
            }
          },
          [&](int chunk, int stage) {
            const float* a[L::RTW];
#pragma unroll
            for (int i = 0; i < L::RTW; ++i) a[i] = t2 + a_off[i] + chunk * kKc;
            chunk_product<L::RTW, L::NTW>(acc, lo, a, ring + stage * P::kRing + b_off, P::LDW3);
          });
#pragma unroll
      for (int i = 0; i < L::RTW; ++i) {
        if (i >= rows) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (wr + L::WR * i) * 16 + g + 8 * half;
          const int gy = oy0 + p / TW, gx = ox0 + p % TW;
          if (gy >= h || gx >= w) continue;
          const int64_t at = (static_cast<int64_t>(gy) * w + gx) * c;
#pragma unroll
          for (int j = 0; j < L::NTW; ++j) {
            const int n = n0 + (wc * L::NTW + j) * 8 + 2 * t;
            const float2 bias = *reinterpret_cast<const float2*>(b3 + n);
            const float2 xv = *reinterpret_cast<const float2*>(xb + at + n);
            *reinterpret_cast<float2*>(yb + at + n) = make_float2(
                fmaxf((acc[i][j][2 * half] + lo[i][j][2 * half] + bias.x) + xv.x, 0.f),
                fmaxf((acc[i][j][2 * half + 1] + lo[i][j][2 * half + 1] + bias.y) + xv.y, 0.f));
          }
        }
      }
    }
  }
}

struct Args {
  const float *x, *w1t, *b1, *w2t, *b2, *w3t, *b3;
  float* y;
  int n, c, h, w;
  cudaStream_t stream;
};

// The launch configuration of plan P over an (n, h, w) map: K CTAs a
// cluster along x, one cluster a pixel tile, images along y.
template <class P>
cudaLaunchConfig_t launch_config(int n, int h, int w, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  const int tiles = ((h + P::TH - 1) / P::TH) * ((w + P::TW - 1) / P::TW);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = P::K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * P::K, n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Above 48 KB of dynamic shared memory only after this opt-in, made once
// per plan, on its first use.
template <class P>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_tf32_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  return err;
}

template <class P>
bool takes(int c) {
  return c % kKc == 0 && c % (P::K * P::NP3) == 0;
}

template <class P>
cudaError_t launch(const Args& a) {
  if (!takes<P>(a.c)) return cudaErrorInvalidValue;
  const cudaError_t err = opt_in<P>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<P>(a.n, a.h, a.w, a.stream, &attr);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, fused_bottleneck_tf32_kernel<P>, a.x, a.w1t, a.b1, a.w2t, a.b2, a.w3t, a.b3, a.y,
      a.c, a.h, a.w, (a.w + P::TW - 1) / P::TW);
  const cudaError_t last = cudaGetLastError();
  return launched != cudaSuccess ? launched : last;
}

// Calls f(P{}) for width m's plan, or returns cudaErrorInvalidValue.
// ops/fused_bottleneck.py:TF32_PLANS lists the same plans.
template <class F>
cudaError_t with_plan(int m, F&& f) {
  switch (m) {
    case 64: return f(Plan<64, 8, 8, 1>{});
    case 128: return f(Plan<128, 8, 8, 2>{});
    case 256: return f(Plan<256, 8, 8, 4>{});
    case 512: return f(Plan<512, 4, 8, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (n, h, w, c) float32; w1t: (c, m); w2t: (9, m, m) as (tap, in, out)
// with tap = 3 * dy + dx; w3t: (m, c); all contiguous float32, 16-byte
// aligned; b1, b2: (m,) and b3: (c,) float32. m one of 64, 128, 256 and
// 512; c a multiple of 32 and of m's cluster times its stage-3 pass (128
// channels at the 8 x 8 tiles, 256 at 4 x 8). Returns a cudaError_t as int
// (0 = launched).
extern "C" int fused_bottleneck_tf32(const void* x, const void* w1t, const void* b1,
                                     const void* w2t, const void* b2, const void* w3t,
                                     const void* b3, void* y, int n, int c, int m, int h, int w,
                                     void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x),  static_cast<const float*>(w1t),
               static_cast<const float*>(b1), static_cast<const float*>(w2t),
               static_cast<const float*>(b2), static_cast<const float*>(w3t),
               static_cast<const float*>(b3), static_cast<float*>(y),
               n, c, h, w, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      with_plan(m, [&](auto plan) { return launch<decltype(plan)>(a); }));
}

// How many clusters of width m's plan the current device can hold at once
// (cudaOccupancyMaxActiveClusters), into *clusters; the shared-memory bytes
// of one CTA into *smem_bytes. Returns a cudaError_t as int.
extern "C" int fused_bottleneck_tf32_occupancy(int m, int* clusters, int* smem_bytes) {
  return static_cast<int>(with_plan(m, [&](auto plan) {
    using P = decltype(plan);
    const cudaError_t err = opt_in<P>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<P>(1, 8 * P::TH, 8 * P::TW, nullptr, &attr);
    *smem_bytes = P::kSmem;
    return cudaOccupancyMaxActiveClusters(clusters, fused_bottleneck_tf32_kernel<P>, &cfg);
  }));
}
