// Fused int8 1x1 convolution (matrix product) with the requantization
// epilogue, on Hopper's tensor cores (sm_90a): kernel F.
//
// Replaces the TPU kernel built by `_call` in
// detr_tensorflow_tpu/ops/pallas/int8_matmul.py (bodies `_qmm_kernel`,
// `_qmm_res_kernel`, `_qmm_res2_kernel`), reached through `qmatmul`,
// `qmatmul_residual` and `qmatmul_residual2`: over NHWC activations
// flattened to (M, C),
//   plain:      y = q(relu(x @ W * s + b))                        (conv1)
//   residual:   y = q(relu(x @ W * s + b + res * rs))             (conv3 + identity)
//   residual2:  y = q(relu(x @ W * s + b + xd @ Wd * sd + bd))    (conv3 + downsample)
// int8 x int8 -> exact int32 sums on `mma.sync.m16n8k32`, the epilogue of
// int8_common.cuh (`affine`, `to_int8`: the TPU kernel's order, no FMA),
// int8 (or bf16) out. W is K-major: (K, C), row n the weights of output
// channel n.
//
// What bounds it on the H100, and what the design does about each:
//   * The bytes, at every shape with M = 78,848 or 19,712 (layers 1-2 of
//     DETR-R50 at 896x1408): 2*C*K operations a row against C + K (+ K of
//     the residual) bytes, below the ~590 operations a byte where the int8
//     tensor cores would take over. The residual read and the output write
//     weigh most, so the epilogue is staged in shared memory: the residual
//     tile streams in by `cp.async` while the products run, 16 bytes a
//     thread; the int8 (or bf16) result is written over it; the tile goes
//     out 16 bytes a thread, neighbouring threads on neighbouring channels.
//     The scale and bias of the tile's channels are copied in once. x's row
//     tile is read from device memory once: the channel tile is the fast
//     grid index, so the CTAs that share it run together and find it in L2.
//   * The products. A CTA computes a 128-row x 64-channel tile, 8 warps as
//     4 x 2, each a 32 x 32 block of 2 x 4 m16n8k32 fragments. x's rows and
//     W's rows stream through a 2-stage `cp.async` ring in 64-byte chunks of
//     the contraction. Each 64-byte row is stored as four 16-byte columns,
//     column q of row r at q ^ ((r >> 1) & 3): the 8 rows an `ldmatrix`
//     reads land in 8 distinct 16-byte bank groups. `ldmatrix.x4` (b16
//     matrices of 8 rows x 16 bytes) hands lane 4g + t bytes 4t..4t+3 of
//     row g of each matrix, which is the m16n8k32 s8 A fragment of x's rows
//     and, W being K-major, the `.col` B fragment of W's rows, with no
//     transpose or repacking.
//   * Latency at the deep, narrow shapes with few output tiles (layer 4's
//     conv1, C = 2,048, 80 tiles; layer 3's, C = 1,024, 156 tiles: fewer than
//     two CTAs an SM). A thread-block cluster of 2-8 CTAs shares one output
//     tile and splits the contraction: rank r sums its share of C into int32.
//     Rank r finishes rows [r, r + 1) * 128 /
//     cluster of the tile: every other rank leaves its partial sums of
//     those rows in its own shared memory, in fragment order, and rank r
//     adds them in through distributed shared memory before its epilogue.
//     Integer addition is associative: the result is bit-identical
//     whatever the split. ops/int8_matmul.py:plan picks the cluster from
//     the shape.
//   * residual2 keeps its second contraction (xd @ Wd^T) in a second set
//     of accumulators over the same output tile: s and sd differ by channel.
//     A cluster splits both C and Cd.
//   * Ragged edges. Rows past M and channels past K are zero-filled
//     (`cp.async` src-size 0) and never stored; C and Cd are whole chunks
//     (multiples of 64, of 64 x cluster with a cluster); K a multiple of 8:
//     an 8-channel group of y is wholly in or out, and the residual and the
//     int8 output move 8 bytes a copy where K is not a multiple of 16.
// Measured (PERF.md; scripts/torch_int8_matmul_probe.py --variants): the
// chunk pipeline's loads bound it, not device memory. Its tiles move about
// three times the bytes that must move (x once per 64-channel tile, W once
// per 128-row tile) at ~2 TB/s; the products, the epilogue's arithmetic and
// the stores take the rest. Wider or taller tiles, a deeper ring, 128-byte
// chunks and more splits measured no faster at mma.sync's register budget;
// CTAs that walk several tiles with the next one's operands in flight, CTAs
// that keep x's row tile for several channel tiles, and residual2 split
// across a cluster measured no faster or slower. TMA (multicast across a
// cluster), warp-specialised pipelines and `wgmma` are the next levers.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "int8_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16mma::ldmatrix_x4;
using cpa::cp_async16;

// The one compiled tile (ops/int8_matmul.py:TILE): BM rows x BN output
// channels, 8 warps as WM x WN, the contraction in KC-byte chunks through
// an S-stage ring. Shared memory, in bytes: the ring (or, after the
// products, the cluster's exchange of partial sums); the staged int8 tile
// [BM][LDY] (the residual in, an int8 y out); scale, bias, scale_d and
// bias_d of the tile's channels, BN floats each; then the staged bf16 y
// [BM][LDO] (bf16 output only).
struct T {
  static constexpr int BM = 128, BN = 64, WM = 4, WN = 2, KC = 64, S = 2, kMinBlocks = 3;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's block
  static constexpr int MT = TM / 16, NT = TN / 8;   // its m16 and n8 fragments
  static constexpr int kStage = (BM + BN) * KC, Q = KC / 16;  // Q 16-byte columns a row
  static constexpr int LDY = BN + 16, LDO = 2 * BN + 16;
  static constexpr int kStaging = BM * LDY + 4 * BN * 4;  // one staging buffer
  static constexpr int kAccBytes = BM * BN * 4;  // one set of partial sums
  static constexpr int kMaxCluster = 8;          // a rank finishes >= 16 rows
  static constexpr int kSplit = 64;              // bytes of C a cluster splits by
  static_assert(KC % 64 == 0 && NT % 2 == 0 && BM % (16 * kMaxCluster) == 0, "tile");
  static_assert(KC == 64 || KC % 128 == 0, "swizzle() covers 64-byte rows and whole lines");
};

// The 16-byte column of a stage row r where its column q lies: q ^
// swizzle(r). The 8 rows an ldmatrix reads (r0..r0 + 7, r0 a multiple of 8)
// then fall in 8 distinct 16-byte bank groups of 128 bytes: 64-byte rows
// pair up in a group's line, so (r >> 1) & 3; longer rows fill lines.
__host__ __device__ constexpr int swizzle(int row) {
  return T::KC == 64 ? (row >> 1) & 3 : row & 7;
}

// The ring, large enough for a cluster's exchange (one set of partial sums,
// two for residual2), and the dynamic shared memory of one CTA
// (ops/int8_matmul.py:smem_bytes).
__host__ __device__ constexpr int ring_bytes(int variant) {
  const int exchange = (variant == i8::kResidual2 ? 2 : 1) * T::kAccBytes;
  return T::S * T::kStage > exchange ? T::S * T::kStage : exchange;
}
__host__ __device__ constexpr int smem_bytes(int variant, bool out_bf16) {
  return ring_bytes(variant) + T::kStaging + (out_bf16 ? T::BM * T::LDO : 0);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

using Acc = int[T::MT][T::NT][4];

// One 64-byte chunk's products of the warp's block into acc: two k32 steps,
// A from rows a_row + 16 mt and B from rows b_row + 16 jp of the stage, at
// the swizzled column of each step's 16-byte half.
__device__ __forceinline__ void products(Acc& acc, const unsigned char* st, int a_row, int a_hi,
                                         int b_row, int b_hi, int swz) {
#pragma unroll
  for (int s = 0; s < T::KC / 32; ++s) {
    unsigned bfr[T::NT / 2][4];
#pragma unroll
    for (int jp = 0; jp < T::NT / 2; ++jp)
      ldmatrix_x4(bfr[jp], st + (b_row + 16 * jp) * T::KC + 16 * ((2 * s + b_hi) ^ swz));
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      unsigned af[4];
      ldmatrix_x4(af, st + (a_row + 16 * mt) * T::KC + 16 * ((2 * s + a_hi) ^ swz));
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
        i8::mma_s8(acc[mt][nt], af[0], af[1], af[2], af[3], bfr[nt / 2][2 * (nt % 2)],
                   bfr[nt / 2][2 * (nt % 2) + 1]);
    }
  }
}

template <int V, bool kRelu, bool kOutBf16, bool kPrecise>
__global__ void __launch_bounds__(T::kThreads, V == i8::kResidual2 && T::kMinBlocks > 1
                                                   ? T::kMinBlocks - 1
                                                   : T::kMinBlocks)
    int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int c,
                       const int8_t* __restrict__ xd, const int8_t* __restrict__ wd, int cd,
                       i8::Epilogue ep, int m, int k, int ctiles) {
  constexpr int BM = T::BM, BN = T::BN, KC = T::KC, S = T::S, LDY = T::LDY, LDO = T::LDO;
  constexpr int kThreads = T::kThreads;
  constexpr bool kTwo = V == i8::kResidual2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cluster = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  unsigned char* ring = smem;
  int8_t* ys = reinterpret_cast<int8_t*>(smem + ring_bytes(V));  // [BM][LDY]
  float* prm = reinterpret_cast<float*>(ys + BM * LDY);            // [4][BN]
  unsigned char* y16 = smem + ring_bytes(V) + T::kStaging;         // [BM][LDO]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int tile = blockIdx.x / cluster;
  const int64_t row0 = static_cast<int64_t>(tile / ctiles) * BM;
  const int col0 = (tile % ctiles) * BN;
  const int slice = BM / cluster, r_lo = rank * slice;  // the rows this rank finishes

  // This rank's share of the contraction: cs bytes of each row of x from
  // byte rank * cs, in nc chunks, then csd of xd in ncd; bytes of a chunk
  // past its share are zero-filled on both operands.
  const int cs = c / cluster, csd = kTwo ? cd / cluster : 0;
  const int nc = (cs + KC - 1) / KC, ncd = (csd + KC - 1) / KC, n = nc + ncd;
  auto load_chunk = [&](int i, int stage) {
    const bool second = kTwo && i >= nc;
    const int8_t* a = second ? xd : x;
    const int8_t* b = second ? wd : w;
    const int ld = second ? cd : c, share = second ? csd : cs, from = rank * share;
    const int kb = (second ? i - nc : i) * KC;  // within the share
    unsigned char* st = ring + stage * T::kStage;
#pragma unroll
    for (int idx = tid; idx < (BM + BN) * T::Q; idx += kThreads) {
      const int row = idx / T::Q, q = idx % T::Q;
      const int8_t* src;
      bool ok = kb + 16 * q < share;
      if (row < BM) {  // x's rows, then W's
        const int64_t r = row0 + row;
        ok = ok && r < m;
        src = a + (ok ? r * ld + from + kb + 16 * q : 0);
      } else {
        const int nn = col0 + row - BM;
        ok = ok && nn < k;
        src = b + (ok ? static_cast<int64_t>(nn) * ld + from + kb + 16 * q : 0);
      }
      cp_async16(st + row * KC + 16 * (q ^ swizzle(row)), src, ok ? 16 : 0);
    }
  };
  // The residual rows this rank finishes and the tile's epilogue
  // coefficients; channels past K zero-filled.
  auto load_epilogue_operands = [&]() {
    if (V == i8::kResidual) {
      const int vec = k % 16 ? 8 : 16, per_row = BN / vec;
      for (int idx = tid; idx < slice * per_row; idx += kThreads) {
        const int r = r_lo + idx / per_row, cb = vec * (idx % per_row);
        const int64_t gr = row0 + r;
        const bool ok = gr < m && col0 + cb < k;
        const int8_t* src = ep.res + (ok ? gr * k + col0 + cb : 0);
        if (vec == 16)
          cp_async16(ys + r * LDY + cb, src, ok ? 16 : 0);
        else
          cpa::cp_async8(ys + r * LDY + cb, src, ok ? 8 : 0);
      }
    }
    for (int idx = tid; idx < (kTwo ? 4 : 2) * (BN / 4); idx += kThreads) {
      const int which = idx / (BN / 4), cc = 4 * (idx % (BN / 4));
      const float* coef = which == 0   ? ep.scale
                          : which == 1 ? ep.bias
                          : which == 2 ? ep.scale_d
                                       : ep.bias_d;
      const bool ok = col0 + cc < k;
      cp_async16(prm + which * BN + cc, coef + (ok ? col0 + cc : 0), ok ? 16 : 0);
    }
  };

  // The ring's first S - 1 chunks, the epilogue operands in the group of the
  // last of them: the wait of iteration i leaves only the S - 2 newest groups
  // in flight, so chunk i has always landed.
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load_chunk(s, s);
    if (s == S - 2) load_epilogue_operands();
    cpa::cp_async_commit();
  }
  // ldmatrix row addresses of this lane: A's row in its 16-row fragment and
  // 16-byte half of a k32 step; B's row in a pair of 8-channel fragments and
  // its half. Both rows are a multiple of 8 plus lane % 8, so the swizzle of
  // every row a lane addresses is swizzle(lane % 8).
  const int a_row = wm * T::TM + lane % 16, a_hi = lane / 16;
  const int b_row = BM + wn * T::TN + 8 * (lane / 16) + lane % 8, b_hi = (lane / 8) % 2;
  const int swz = swizzle(lane % 8);
  Acc acc = {};
  Acc accd = {};
  for (int i = 0; i < n; ++i) {
    cpa::cp_async_wait<S - 2>();
    __syncthreads();  // chunk i is in; every warp is done with chunk i - 1's stage
    const int next = i + S - 1;
    if (next < n) load_chunk(next, next % S);
    cpa::cp_async_commit();
    const unsigned char* st = ring + (i % S) * T::kStage;
    if (kTwo && i >= nc)
      products(accd, st, a_row, a_hi, b_row, b_hi, swz);
    else
      products(acc, st, a_row, a_hi, b_row, b_hi, swz);
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // the epilogue operands are in; the ring is free

  // Fragment mt of this warp covers rows wm * TM + 16 mt .. + 16, finished by
  // the rank whose slice holds them.
  auto owner = [&](int mt) { return (wm * T::TM + 16 * mt) / slice; };
  if (cluster > 1) {
    // Partial sums of rows other ranks finish into this CTA's exchange
    // (the ring), one int4 a lane a fragment; then, for the rows this rank
    // finishes, every other rank's partial sums added in.
    int4* ex = reinterpret_cast<int4*>(ring);
    auto slot = [&](int set, int mt, int nt) {
      return (((set * (kThreads / 32) + warp) * T::MT + mt) * T::NT + nt) * 32 + lane;
    };
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      if (owner(mt) == rank) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int* v = acc[mt][nt];
        ex[slot(0, mt, nt)] = make_int4(v[0], v[1], v[2], v[3]);
        if (kTwo) {
          const int* d = accd[mt][nt];
          ex[slot(1, mt, nt)] = make_int4(d[0], d[1], d[2], d[3]);
        }
      }
    }
    cluster_arrive();
    cluster_wait();  // every rank's partial sums are in its exchange
    for (int p = 1; p < cluster; ++p) {
      const int4* peer = cg::this_cluster().map_shared_rank(ex, (rank + p) % cluster);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        if (owner(mt) != rank) continue;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const int4 v = peer[slot(0, mt, nt)];
          int* a = acc[mt][nt];
          a[0] += v.x, a[1] += v.y, a[2] += v.z, a[3] += v.w;
          if (kTwo) {
            const int4 u = peer[slot(1, mt, nt)];
            int* d = accd[mt][nt];
            d[0] += u.x, d[1] += u.y, d[2] += u.z, d[3] += u.w;
          }
        }
      }
    }
    cluster_arrive();  // done reading the others; waited on before exit
  }

  // Epilogue of the rows this rank finishes, written into the staged tile
  // (an int8 y over the residual: each lane reads and writes the same two
  // channels of its rows).
  const float rs = V == i8::kResidual ? __ldg(ep.res_scale) : 0.f;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    if (owner(mt) != rank) continue;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int col = wn * T::TN + 8 * nt + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(prm + col);
      const float2 b = *reinterpret_cast<const float2*>(prm + BN + col);
      float2 sd = make_float2(0.f, 0.f), bd = make_float2(0.f, 0.f);
      if (kTwo) {
        sd = *reinterpret_cast<const float2*>(prm + 2 * BN + col);
        bd = *reinterpret_cast<const float2*>(prm + 3 * BN + col);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * T::TM + 16 * mt + g + 8 * h;
        char2* at = reinterpret_cast<char2*>(ys + r * LDY + col);
        const char2 res = V == i8::kResidual ? *at : make_char2(0, 0);
        const float y0 = i8::affine<V, kPrecise>(acc[mt][nt][2 * h], s.x, b.x, res.x, rs,
                                                 accd[mt][nt][2 * h], sd.x, bd.x);
        const float y1 = i8::affine<V, kPrecise>(acc[mt][nt][2 * h + 1], s.y, b.y, res.y, rs,
                                                 accd[mt][nt][2 * h + 1], sd.y, bd.y);
        if (kOutBf16) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(kRelu ? fmaxf(y0, 0.f) : y0);
          v.y = __float2bfloat16_rn(kRelu ? fmaxf(y1, 0.f) : y1);
          *reinterpret_cast<__nv_bfloat162*>(y16 + r * LDO + 2 * col) = v;
        } else {
          *at = make_char2(i8::to_int8<kRelu, kPrecise>(y0), i8::to_int8<kRelu, kPrecise>(y1));
        }
      }
    }
  }
  __syncthreads();

  // The finished rows out, 16 bytes a thread (8 for an int8 y whose K is not
  // a multiple of 16), neighbouring threads on neighbouring channels.
  constexpr int ob = kOutBf16 ? 2 : 1;
  const unsigned char* staged = kOutBf16 ? y16 : reinterpret_cast<const unsigned char*>(ys);
  const int ldo = kOutBf16 ? LDO : LDY;
  const int vec = kOutBf16 || k % 16 == 0 ? 16 : 8, per_row = BN * ob / vec;
  unsigned char* out = static_cast<unsigned char*>(ep.out);
  for (int idx = tid; idx < slice * per_row; idx += kThreads) {
    const int r = r_lo + idx / per_row, cb = vec * (idx % per_row);
    const int64_t gr = row0 + r;
    if (gr >= m || col0 * ob + cb >= k * ob) continue;
    unsigned char* dst = out + (gr * k + col0) * ob + cb;
    if (vec == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(staged + r * ldo + cb);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(staged + r * ldo + cb);
  }
  if (cluster > 1) cluster_wait();  // no other rank reads this one's exchange any more
}

struct Args {
  const int8_t *x, *w, *xd, *wd;
  i8::Epilogue ep;
  int m, c, k, cd, cluster;
  cudaStream_t stream;
};

template <int V>
struct Launch {
  template <bool kRelu, bool kOutBf16, bool kPrecise>
  struct With {
    static cudaError_t run(const Args& a) {
      const auto kernel = int8_matmul_kernel<V, kRelu, kOutBf16, kPrecise>;
      // Above 48 KB of dynamic shared memory only after this opt-in, made once.
      static const cudaError_t opt_in = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(V, kOutBf16));
      if (opt_in != cudaSuccess) return opt_in;
      const int ctiles = (a.k + T::BN - 1) / T::BN;
      const int64_t ctas =
          static_cast<int64_t>((a.m + T::BM - 1) / T::BM) * ctiles * a.cluster;
      if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = a.cluster;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>(ctas));
      cfg.blockDim = dim3(T::kThreads);
      cfg.dynamicSmemBytes = smem_bytes(V, kOutBf16);
      cfg.stream = a.stream;
      cfg.attrs = &attr;
      cfg.numAttrs = a.cluster > 1 ? 1 : 0;
      const cudaError_t launched =
          cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.c, a.xd, a.wd, a.cd, a.ep, a.m, a.k, ctiles);
      const cudaError_t last = cudaGetLastError();
      return launched != cudaSuccess ? launched : last;
    }
  };
};

}  // namespace

// x: (m, c) int8; w: (k, c) int8; scale, bias: (k,) float32; out: (m, k)
// int8 or bf16. variant 1 adds res (m, k) int8 times *res_scale (one float
// on the device); variant 2 adds xd (m, cd) int8 @ wd (k, cd)^T times
// scale_d plus bias_d. Every pointer 16-byte aligned; k a multiple of 8;
// cluster 1, 2, 4 or 8 CTAs splitting the contraction, c (and cd) a
// multiple of 64 x cluster. Returns a cudaError_t as int (0 = launched).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, const void* bias,
                           const void* res, const void* res_scale, const void* xd,
                           const void* wd, const void* scale_d, const void* bias_d, void* out,
                           int m, int c, int k, int cd, int variant, int relu, int out_bf16,
                           int precise, int cluster, void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (m <= 0 || c <= 0 || k <= 0 || k % 8 || variant < 0 || variant > 2 || !cluster_ok ||
      c % (T::kSplit * cluster) ||
      (variant == i8::kResidual2 && (cd <= 0 || cd % (T::kSplit * cluster))))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.xd = static_cast<const int8_t*>(xd);
  a.wd = static_cast<const int8_t*>(wd);
  a.ep = i8::Epilogue{static_cast<const float*>(scale), static_cast<const float*>(bias),
                      static_cast<const int8_t*>(res), static_cast<const float*>(res_scale),
                      static_cast<const float*>(scale_d), static_cast<const float*>(bias_d), out};
  a.m = m;
  a.c = c;
  a.k = k;
  a.cd = cd;
  a.cluster = cluster;
  a.stream = static_cast<cudaStream_t>(stream);
  const i8::Flags f{relu != 0, out_bf16 != 0, precise != 0};
  cudaError_t err;
  if (variant == i8::kPlain)
    err = i8::dispatch<Launch<i8::kPlain>::With>(f, a);
  else if (variant == i8::kResidual)
    err = i8::dispatch<Launch<i8::kResidual>::With>(f, a);
  else
    err = i8::dispatch<Launch<i8::kResidual2>::With>(f, a);
  return static_cast<int>(err);
}
