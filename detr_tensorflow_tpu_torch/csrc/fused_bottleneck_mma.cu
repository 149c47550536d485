// The whole identity bottleneck of ResNet in one kernel, in bf16 on
// Hopper's tensor cores (sm_90a), with thread-block clusters splitting the
// wide blocks' channels: E-mma.
//
// Replaces the TPU kernel `_kernel` (launched by `fused_bottleneck`) of
// detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py for bf16:
//   T1 = relu(W1 x + b1), zero outside the image
//   T2 = relu(W2 * T1 + b2)        (3x3, pad 1)
//   y  = relu(W3 T2 + b3 + x)
// over x and y (N, H, W, C) in memory (the port's NCHW activations in
// channels_last), bf16 weights (the BN scale folded in fp32 before the
// cast), fp32 biases, fp32 accumulation; T1 and T2 rounded to bf16 after
// the ReLU, the residual added in fp32, one rounding of y. fp32 calls stay
// on the SIMT kernel of fused_bottleneck.cu
// (ops/fused_bottleneck.py:route).
//
// What bounds it on the H100, and what the design does about each:
//   * The products. 2 H W (C M + 9 M^2 + M C) operations a block, 8.56
//     GFLOP at each ResNet-50 width of the 768x1280 bucket (9.4-9.7 with the
//     halo), 8.7 us at the 989 TFLOP/s bf16 peak; the bytes (x read, y
//     written, the weights once) bound layers 1-2 (M = 64, 128). Each
//     stage is a product of [tile pixels x K] by [K x N] on
//     `mma.sync.m16n8k16` (bf16 in, fp32 accumulators): a warp owns
//     16-row x 8n-column accumulator blocks, takes A (pixel rows)
//     with `ldmatrix` and B (a row-major (K, N) weight chunk) with
//     `ldmatrix.trans`. Rows in shared memory are padded by 8 elements, so
//     the 8 row addresses of each 8x8 matrix fall in distinct 16-byte bank
//     groups. conv2's nine taps are a free gather: `ldmatrix` takes one row
//     address per lane, and output pixel p's row for tap (dy, dx) is halo
//     row (p / TW + dy) (TW + 2) + p % TW + dx of T1. No im2col.
//   * The loads. x's halo chunks and the weight chunks stream through a
//     3-stage `cp.async` ring, two chunks ahead of the MMAs, one barrier a
//     chunk; pixels outside the image are zero-filled (src-size 0).
//   * The width of the wide blocks. One CTA holds T1 and T2 over all M
//     channels of its TH x TW pixel tile (and the halo), which fills shared
//     memory at M = 512; and the products' N (a rank's channels) has to fit
//     the accumulators. So a cluster of K CTAs (Hopper's thread-block
//     clusters) shares one pixel tile, and rank r computes T1's and T2's
//     r-th slice of M / K channels from W1's and W2's r-th column slices,
//     then pushes its slice into the other ranks' shared memory through
//     distributed shared memory, and computes y's r-th slice of C / K
//     channels. Each CTA reads 1/K of the weights, and the grid grows K-fold
//     without shrinking the pixel tile.
//   * The halo. conv1 runs over (TH + 2) (TW + 2) pixels for TH TW outputs:
//     1.56x its work at 8 x 8, 1.41x at 8 x 16. T1 is zeroed at halo pixels
//     outside the image: relu(b1) != 0 there, and the unfused conv2 reads
//     zero padding.
// One plan (TH, TW, K) is compiled per M (with_plan below): 8 x 16 at M =
// 64, 8 x 8 with clusters of 1, 2 and 8 at M = 128, 256 and 512; any other
// M is refused. `wgmma`,
// TMA and multicast of the weight slices along a cluster of pixel tiles are
// the next levers.
//
// Cluster protocol (K > 1), fused_bottleneck_common.cuh: after stage 1 each
// rank pushes its T1 slice into every other rank's T1 between cluster
// barriers, T2 likewise after stage 2. No CTA touches another's shared
// memory after the second barrier, so every CTA may exit when its stage 3
// is done.
//
// Entry points: plain C functions, built with nvcc into a shared library
// and called through ctypes. The kernel launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "fused_bottleneck_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using bf16mma::ldmatrix_x4;
using bf16mma::ldmatrix_x4_trans;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
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

constexpr int kSmemPerSm = 233472;  // 228 KB an SM, of which 1 KB is reserved per CTA
// Contraction rows a chunk, per stage (x's channels, T1's, T2's).
constexpr int kKc1 = 32, kKc2 = 64, kKc3 = 32;

// The warps of a product split its RT row tiles (16 pixels) x NT column
// tiles (8 channels) as WR x WC: warp (wr, wc) takes row tiles wr, wr + WR,
// ... and the NTW adjacent column tiles from wc NTW. About 4 column tiles a
// column group, and no more row groups than row tiles.
constexpr int warp_cols(int rt, int nt) {
  int wc = nt / 4 < 2 ? 2 : (nt / 4 > kWarps ? kWarps : nt / 4);
  const int need = rt >= kWarps ? 1 : kWarps / rt;
  return wc < need ? need : wc;
}

template <int RT, int NT>
struct Warps {
  static constexpr int WC = warp_cols(RT, NT), WR = kWarps / WC;
  static constexpr int RTW = (RT + WR - 1) / WR, NTW = NT / WC;
  static_assert(NT % WC == 0 && NTW % 2 == 0, "a warp takes pairs of column tiles");
  static_assert(RTW * NTW <= 16, "at most 64 accumulators a thread");
};

// A plan: T1 / T2 width M, a TH x TW pixel tile, K CTAs a
// cluster. Shared memory, in bf16 elements: T1 [P1][LD], T2 [P2][LD], then
// kStages ring stages of the largest of stage 1's x chunk [P1][kKc1 + 8]
// with its W1 chunk [kKc1][NK + 8], stage 2's W2 chunk [kKc2][NK + 8] and
// stage 3's W3 chunk [kKc3][NP3 + 8]. (Rings that fill the rest of a
// one-CTA-an-SM plan's shared memory, 4-8 chunks in flight, were slower at
// M = 256 and 512 on an H100.) ops/fused_bottleneck.py:mma_smem_bytes
// mirrors this.
template <int M_, int TH_, int TW_, int K_>
struct Plan {
  static constexpr int M = M_, TH = TH_, TW = TW_, K = K_;
  static constexpr int HW = TW + 2;                 // halo row width
  static constexpr int P1 = (TH + 2) * HW, P2 = TH * TW;
  static constexpr int RT1 = (P1 + 15) / 16, RT2 = P2 / 16;
  static constexpr int NK = M / K;                  // T1 / T2 channels of a rank
  static constexpr int NP3 = M <= 128 ? 128 : 256;  // y channels a stage-3 pass
  static constexpr int LD = M + 8, LDX = kKc1 + 8, LDW = NK + 8, LDW3 = NP3 + 8;
  static constexpr int kRing = max3(P1 * LDX + kKc1 * LDW, kKc2 * LDW, kKc3 * LDW3);
  static constexpr int kSmem = 2 * ((P1 + P2) * LD + kStages * kRing);
  static constexpr int kMinBlocks = 2 * (kSmem + 1024) <= kSmemPerSm ? 2 : 1;
  static_assert(M % K == 0 && M % kKc2 == 0 && NK % 16 == 0, "rank slices of whole k16 steps");
  static_assert(TW % 8 == 0 && P2 % 16 == 0, "8-row groups of output pixels in one tile row");
  static_assert(kSmem <= kMaxSmem, "a CTA holds at most 227 KB");
};

// acc[i][j] += A (row tile i of the warp) x B (column tile j), over one
// chunk of KC contraction rows. a[i]: this lane's ldmatrix row address of
// row tile i at the chunk's first column (row lane % 16, column 8 (lane /
// 16)); b: this lane's ldmatrix.trans address in the chunk at the warp's
// first column; rows: the warp's row tiles that exist.
template <int RTW, int NTW, int KC>
__device__ __forceinline__ void chunk_product(float (&acc)[RTW][NTW][4],
                                              const bf16* (&a)[RTW], int rows,
                                              const bf16* b, int ldb) {
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    unsigned bf[NTW / 2][4];
#pragma unroll
    for (int jp = 0; jp < NTW / 2; ++jp) ldmatrix_x4_trans(bf[jp], b + ks * 16 * ldb + 16 * jp);
#pragma unroll
    for (int i = 0; i < RTW; ++i) {
      if (i < rows) {
        unsigned af[4];
        ldmatrix_x4(af, a[i] + 16 * ks);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          mma_bf16(acc[i][j], af, bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads, P::kMinBlocks)
    fused_bottleneck_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
                                const float* __restrict__ b1, const bf16* __restrict__ w2t,
                                const float* __restrict__ b2, const bf16* __restrict__ w3t,
                                const float* __restrict__ b3, bf16* __restrict__ y, int c, int h,
                                int w, int tiles_x) {
  constexpr int M = P::M, TW = P::TW, HW = P::HW, K = P::K, NK = P::NK, LD = P::LD;
  constexpr int P1 = P::P1, P2 = P::P2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* t1 = reinterpret_cast<bf16*>(smem_raw);  // [P1][LD]
  bf16* t2 = t1 + P1 * LD;                       // [P2][LD]
  bf16* ring = t2 + P2 * LD;                     // [kStages][kRing]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  int rank = 0;
  if constexpr (K > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    cluster_arrive_relaxed();  // this CTA runs; waited on before the first push
  }
  const int tile = blockIdx.x / K;
  const int oy0 = (tile / tiles_x) * P::TH, ox0 = (tile % tiles_x) * TW;
  const bf16* xb = x + static_cast<int64_t>(blockIdx.y) * h * w * c;
  bf16* yb = y + static_cast<int64_t>(blockIdx.y) * h * w * c;
  // ldmatrix offsets of this lane: A's row in its 16-row tile and column
  // half, B's (k, n) in a 16 x 16 block.
  const int a_row = lane % 16, a_col = 8 * (lane / 16);
  const int b_k = lane % 8 + 8 * ((lane / 8) % 2), b_n = 8 * (lane / 16);

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
    const int b_off = b_k * P::LDW + b_n + wc * L::NTW * 8;
    float acc[L::RTW][L::NTW][4] = {};
    pipeline(
        c / kKc1,
        [&](int chunk, int stage) {
          bf16* xs = ring + stage * P::kRing;
          bf16* ws = xs + P1 * P::LDX;
          const int k0 = chunk * kKc1;
          for (int i = tid; i < P1 * (kKc1 / 8); i += kThreads) {
            const int q = i / (kKc1 / 8), part = i % (kKc1 / 8);
            const bool inside = halo_in_image(q);
            const int64_t pixel = static_cast<int64_t>(oy0 - 1 + q / HW) * w + ox0 - 1 + q % HW;
            cp_async16(xs + q * P::LDX + 8 * part, inside ? xb + pixel * c + k0 + 8 * part : xb,
                       inside ? 16 : 0);
          }
          for (int i = tid; i < kKc1 * (NK / 8); i += kThreads) {
            const int kk = i / (NK / 8), part = i % (NK / 8);
            cp_async16(ws + kk * P::LDW + 8 * part,
                       w1t + static_cast<int64_t>(k0 + kk) * M + rank * NK + 8 * part, 16);
          }
        },
        [&](int, int stage) {
          const bf16* xs = ring + stage * P::kRing;
          const bf16* a[L::RTW];
#pragma unroll
          for (int i = 0; i < L::RTW; ++i) a[i] = xs + a_off[i];
          chunk_product<L::RTW, L::NTW, kKc1>(acc, a, rows, xs + P1 * P::LDX + b_off, P::LDW);
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
          const float v0 = fmaxf(acc[i][j][2 * half] + bias.x, 0.f);
          const float v1 = fmaxf(acc[i][j][2 * half + 1] + bias.y, 0.f);
          *reinterpret_cast<unsigned*>(t1 + q * LD + n) = inside ? pack_bf16(v0, v1) : 0u;
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
  //    + dx.
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
    const int b_off = b_k * P::LDW + b_n + wc * L::NTW * 8;
    constexpr int kChunksPerTap = M / kKc2;
    float acc[L::RTW][L::NTW][4] = {};
    pipeline(
        9 * kChunksPerTap,
        [&](int chunk, int stage) {
          bf16* ws = ring + stage * P::kRing;
          const int tap = chunk / kChunksPerTap, k0 = (chunk % kChunksPerTap) * kKc2;
          for (int i = tid; i < kKc2 * (NK / 8); i += kThreads) {
            const int kk = i / (NK / 8), part = i % (NK / 8);
            cp_async16(ws + kk * P::LDW + 8 * part,
                       w2t + (static_cast<int64_t>(tap) * M + k0 + kk) * M + rank * NK + 8 * part,
                       16);
          }
        },
        [&](int chunk, int stage) {
          const int tap = chunk / kChunksPerTap, k0 = (chunk % kChunksPerTap) * kKc2;
          const bf16* t1_tap = t1 + ((tap / 3) * HW + tap % 3) * LD + k0;
          const bf16* a[L::RTW];
#pragma unroll
          for (int i = 0; i < L::RTW; ++i) a[i] = t1_tap + a_off[i];
          chunk_product<L::RTW, L::NTW, kKc2>(acc, a, rows, ring + stage * P::kRing + b_off,
                                              P::LDW);
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
          *reinterpret_cast<unsigned*>(t2 + p * LD + n) =
              pack_bf16(fmaxf(acc[i][j][2 * half] + bias.x, 0.f),
                        fmaxf(acc[i][j][2 * half + 1] + bias.y, 0.f));
        }
      }
    }
  }
  if constexpr (K > 1) {
    __syncthreads();
    push_slice<P>(t2, P2, rank);
    cluster_sync();  // T2 is whole in every rank; no remote access after this
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
    const int b_off = b_k * P::LDW3 + b_n + wc * L::NTW * 8;
    const int slice = c / K;
    for (int n0 = rank * slice; n0 < (rank + 1) * slice; n0 += NP3) {
      float acc[L::RTW][L::NTW][4] = {};
      pipeline(
          M / kKc3,
          [&](int chunk, int stage) {
            bf16* ws = ring + stage * P::kRing;
            const int k0 = chunk * kKc3;
            for (int i = tid; i < kKc3 * (NP3 / 8); i += kThreads) {
              const int kk = i / (NP3 / 8), part = i % (NP3 / 8);
              cp_async16(ws + kk * P::LDW3 + 8 * part,
                         w3t + static_cast<int64_t>(k0 + kk) * c + n0 + 8 * part, 16);
            }
          },
          [&](int chunk, int stage) {
            const bf16* a[L::RTW];
#pragma unroll
            for (int i = 0; i < L::RTW; ++i) a[i] = t2 + a_off[i] + chunk * kKc3;
            chunk_product<L::RTW, L::NTW, kKc3>(acc, a, rows, ring + stage * P::kRing + b_off,
                                                P::LDW3);
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
            const float2 xv =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xb + at + n));
            *reinterpret_cast<unsigned*>(yb + at + n) =
                pack_bf16(fmaxf((acc[i][j][2 * half] + bias.x) + xv.x, 0.f),
                          fmaxf((acc[i][j][2 * half + 1] + bias.y) + xv.y, 0.f));
          }
        }
      }
    }
  }
}

struct Args {
  const void *x, *w1t, *w2t, *w3t;
  const float *b1, *b2, *b3;
  void* y;
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
      fused_bottleneck_mma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  return err;
}

template <class P>
bool takes(int c) {
  return c % kKc1 == 0 && c % (P::K * P::NP3) == 0;
}

template <class P>
cudaError_t launch(const Args& a) {
  if (!takes<P>(a.c)) return cudaErrorInvalidValue;
  const cudaError_t err = opt_in<P>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<P>(a.n, a.h, a.w, a.stream, &attr);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, fused_bottleneck_mma_kernel<P>, static_cast<const bf16*>(a.x),
      static_cast<const bf16*>(a.w1t), a.b1, static_cast<const bf16*>(a.w2t), a.b2,
      static_cast<const bf16*>(a.w3t), a.b3, static_cast<bf16*>(a.y), a.c, a.h, a.w,
      (a.w + P::TW - 1) / P::TW);
  const cudaError_t last = cudaGetLastError();
  return launched != cudaSuccess ? launched : last;
}

// Calls f(P{}) for width m's plan, or returns cudaErrorInvalidValue.
// ops/fused_bottleneck.py:MMA_PLANS lists the same plans.
template <class F>
cudaError_t with_plan(int m, F&& f) {
  switch (m) {
    case 64: return f(Plan<64, 8, 16, 1>{});
    case 128: return f(Plan<128, 8, 8, 1>{});
    case 256: return f(Plan<256, 8, 8, 2>{});
    case 512: return f(Plan<512, 8, 8, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (n, h, w, c) bf16; w1t: (c, m); w2t: (9, m, m) as (tap, in, out)
// with tap = 3 * dy + dx; w3t: (m, c); all contiguous bf16, 16-byte
// aligned; b1, b2: (m,) and b3: (c,) float32. m one of 64, 128, 256 and
// 512; c a multiple of 32 and of m's cluster times its stage-3 pass (128
// channels for m <= 128, else 256). Returns a cudaError_t as int (0 =
// launched).
extern "C" int fused_bottleneck_mma(const void* x, const void* w1t, const void* b1,
                                    const void* w2t, const void* b2, const void* w3t,
                                    const void* b3, void* y, int n, int c, int m, int h, int w,
                                    void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w1t, w2t, w3t, static_cast<const float*>(b1), static_cast<const float*>(b2),
               static_cast<const float*>(b3), y, n, c, h, w, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      with_plan(m, [&](auto plan) { return launch<decltype(plan)>(a); }));
}

// How many clusters of width m's plan the current device can hold at once
// (cudaOccupancyMaxActiveClusters), into *clusters; the shared-memory bytes
// of one CTA into *smem_bytes. Returns a cudaError_t as int.
extern "C" int fused_bottleneck_mma_occupancy(int m, int* clusters, int* smem_bytes) {
  return static_cast<int>(with_plan(m, [&](auto plan) {
    using P = decltype(plan);
    const cudaError_t err = opt_in<P>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<P>(1, 8 * P::TH, 8 * P::TW, nullptr, &attr);
    *smem_bytes = P::kSmem;
    return cudaOccupancyMaxActiveClusters(clusters, fused_bottleneck_mma_kernel<P>, &cfg);
  }));
}
