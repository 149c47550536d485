// int8 3x3 convolution (SAME, pad 1, stride 1 or 2) with the requantization
// epilogue, on Hopper's tensor cores (sm_90a): kernel G.
//
// Replaces the TPU kernel `_conv_kernel` (launched by `conv3x3_int8`) of
// detr_tensorflow_tpu/ops/pallas/int8_conv.py, which takes the stride-1
// 3x3s of the int8 backbone, and the XLA int8 convolution
// `_conv3x3_int8_xla` of detr_tensorflow_tpu/models/quantized.py, which
// takes the three strided ones: y = q(relu(conv(x, W) * s + b)) over NHWC
// int8 x (N, H, W, C) and OHWI int8 W (K, 3, 3, C), exact int32 sums over
// the nine taps on `mma.sync.m16n8k32`, the epilogue of int8_common.cuh
// (`affine`, `to_int8`), int8 (or bf16) out, (N, Ho, Wo, K) with Ho =
// (H - 1) / stride + 1.
//
// What bounds it on the H100, and what the design does about each:
//   * Operations, from layer 2 on (1,152 to 4,608 per byte at layer 4; at
//     layer 1 bytes and operations weigh about the same). An implicit GEMM
//     over a 2-D output patch: a CTA computes PH x PW output pixels (the
//     rows of the product, pixel (py, px) at row py * PW + px) by 64 output
//     channels, 8 warps as 4 x 2, each a block of 16-row by 8-channel
//     m16n8k32 fragments; x's rows and W's rows go to the fragments by
//     `ldmatrix.x4`, as in int8_matmul.cu (W, K-major, is the `.col` B).
//   * The re-reads of x across the nine taps. For each 64-byte chunk of the
//     contraction, TMA stages the patch's halo'd input window, ((PH - 1) * s
//     + 3) x ((PW - 1) * s + 3) pixels, once; every tap then reads its A
//     fragments from that window: a lane's row address for tap (dy, dx) is
//     input pixel (py * s + dy, px * s + dx) of its output pixel, a constant
//     offset from the tap (0, 0) address. TMA fills pixels outside the image
//     with zeros, the SAME halo (zero-point 0 keeps it exact). x moves
//     through the SMs about 1.1-1.4 times, not nine.
//   * The loads. The pipeline's step is one (chunk, dy): its W slice, the
//     three taps (dy, 0..2) of the CTA's channels, goes through a WS-stage
//     ring, the window through a 2-stage ring at the first dy of its chunk.
//     One thread issues a step's TMA copies (`cp.async.bulk.tensor`, from
//     tensor maps the host encodes per launch) against the step's "full"
//     mbarrier; each warp waits on it, and after the step's products
//     arrives on its "empty" mbarrier, which the issuing thread waits on
//     before reusing the stage. No instruction of the other warps is spent
//     on addresses or copies, and no block-wide barrier stops a warp
//     between steps.
//   * Bank conflicts. Rows are 64 bytes, two to a 128-byte line; TMA's
//     64-byte swizzle puts column q of stored row r at q ^ ((r >> 1) & 3),
//     so 8 consecutive stored rows fall in 8 distinct 16-byte bank groups.
//     An ldmatrix phase reads 8 neighbouring output pixels of one patch row.
//     At stride 1 they are 8 consecutive window pixels. At stride 2 they are
//     every other one, which would fall in 4 groups twice, so the window is
//     staged as two blocks, its even columns then its odd ones (a TMA box
//     with a traversal stride of 2 each): the 8 pixels of a phase are again
//     8 consecutive stored rows, for every tap. W's rows (channel j, tap dx)
//     lie at 3 j + dx: 8 consecutive channels are 8 distinct rows mod 8.
//   * Few tiles at the deep layers (layer 4: 12 patches). A thread-block
//     cluster of 2-8 CTAs shares one output tile and splits the contraction
//     by whole chunks; partial sums are exchanged in fragment order through
//     distributed shared memory, each rank finishing a slice of the rows, as
//     in int8_matmul.cu. Integer addition makes it bit-identical whatever
//     the split. ops/int8_conv.py:plan picks the cluster.
//   * The epilogue. The int8 (or bf16) tile is staged in shared memory
//     (after the exchange, over the ring) and copied out 16 bytes a thread
//     (8 for an int8 y whose K is not a multiple of 16), no pixel past the
//     image, no channel past K. scale and bias are read once a CTA, while
//     the first copies are in flight.
// Measured (PERF.md; scripts/torch_int8_conv_probe.py --variants): of ~0.29
// ms a b1 896x1408 forward, the steps take ~0.19 (the products; the loads
// hide behind them), the prologue and epilogue ~0.07, the launches 0.02.
// The products run at about half of `mma.sync`'s rate: by count, a 32 x 32
// warp block reads 256 bytes of `ldmatrix` a m16n8k32 MMA, more than shared
// memory's 128 bytes a clock feed at the MMA rate, and larger warp blocks
// need 128 registers, two CTAs an SM, which measured slower. Copies by
// `cp.async` (every thread computing addresses, a block-wide barrier a
// step) measured 0.35 ms; W shared across a cluster by TMA multicast 0.42
// (2 CTAs) and 0.54 (4): each CTA then waits on the slowest of its cluster.
// `wgmma` was not tried: its A operand from shared memory needs the
// canonical core-matrix layout, which a tap's shifted window rows are not;
// A from registers (ldmatrix as here) with B from shared memory is the way.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError(). The tensor
// maps' encoder comes from the runtime (cudaGetDriverEntryPoint): the
// library links no driver library.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "int8_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16mma::ldmatrix_x4;
using cpa::smem_addr;

// Shared by every compiled tile (ops/int8_conv.py): BN output channels a
// CTA, 8 warps as WM x WN, KC-byte contraction chunks, a WS-stage ring of
// W slices.
constexpr int BN = 64, WM = 4, WN = 2, KC = 64, WS = 3, kThreads = 32 * WM * WN;
constexpr int kMaxCluster = 8;
constexpr int LDY = BN + 16, LDO = 2 * BN + 16;  // staged int8 and bf16 rows, bytes
constexpr int kAlign = 1024;  // TMA destinations: whole swizzle patterns

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// One compiled tile: stride S, an output patch of PH x PW pixels (BM rows of
// the product). Shared memory, in bytes: the two window stages and the WS
// slice stages (the ring); over them, once the products are done, the
// cluster's exchange of partial sums [BM][BN] int32 and after it the staged
// y [BM][LDY] int8 or [BM][LDO] bf16; then scale and bias of the tile's
// channels, BN floats each, and the full and empty mbarriers.
template <int kStride, int kPH, int kPW, int kMinBlocks_>
struct Cfg {
  static constexpr int S = kStride, PH = kPH, PW = kPW, kMinBlocks = kMinBlocks_;
  static constexpr int BM = PH * PW;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's block
  static constexpr int MT = TM / 16, NT = TN / 8;   // its m16 and n8 fragments
  // The halo'd window: WH rows; a block of P stored columns a row, one
  // block at stride 1 (all WW = PW + 2 columns), two at stride 2 (the PW + 1
  // even columns, then the PW odd ones and one past the window, unread).
  static constexpr int WH = (PH - 1) * S + 3, P = S == 1 ? PW + 2 : PW + 1;
  static constexpr int kBoxW = S == 1 ? P : 2 * P - 1;  // window columns a box spans
  static constexpr int kBlockRows = WH * P;
  static constexpr int kBlockPitch = round_up(kBlockRows * KC, kAlign) / KC;  // stored rows
  static constexpr int kWindowTx = S * kBlockRows * KC;  // bytes TMA writes a window
  static constexpr int kWindow = S * kBlockPitch * KC, kSlice = 3 * BN * KC;
  static constexpr int kRing = 2 * kWindow + WS * kSlice;
  static constexpr int kAccBytes = BM * BN * 4;
  static_assert(PW % 8 == 0 && TM % 16 == 0 && BM % (16 * kMaxCluster) == 0, "tile");
  static_assert(kSlice % kAlign == 0 && kWindow % kAlign == 0, "stages");

  // Stored rows from the window pixel of output pixel (py, px) at tap (0, 0),
  // py * S * P + px, to the one at tap (dy, dx): window pixel (py * S + dy,
  // px * S + dx), in the odd block at stride 2 when dx is 1.
  __host__ __device__ static constexpr int tap_offset(int dy, int dx) {
    return dy * P + (S == 1 ? dx : dx == 1 ? kBlockPitch : dx / 2);
  }
  __host__ __device__ static constexpr int body_bytes(bool out_bf16) {
    const int after = kAccBytes + BM * (out_bf16 ? LDO : LDY);
    return kRing > after ? kRing : after;
  }
  __host__ __device__ static constexpr int smem_bytes(bool out_bf16) {
    return body_bytes(out_bf16) + 2 * BN * 4 + 2 * WS * 8;
  }
};

// TMA's 64-byte swizzle: the 16-byte column of a stored row r (of a stage
// aligned to kAlign) where its column q lies is q ^ swizzle(r).
__host__ __device__ constexpr int swizzle(int row) { return (row >> 1) & 3; }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Waits for the phase of the given parity to complete. A phase that never
// completes (a copy that never lands) traps after some seconds rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (spin > (1ll << 28)) __trap();
  }
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
                  "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4}], [%5];\n"
               :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
               : "memory");
}

// The products of one step (chunk, dy) into acc: taps (dy, 0..2), each two
// k32 steps; A from the window at the lane's row a_sr[mt] plus the tap's
// offset, B from the slice's rows 3 j + dx of the lane's channels j.
template <class G>
__device__ __forceinline__ void products(int (&acc)[G::MT][G::NT][4], const unsigned char* xs,
                                         const unsigned char* ws, const int (&a_sr)[G::MT],
                                         int a_hi, int dy, int b_ch, int b_hi) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int off = G::tap_offset(dy, dx);
#pragma unroll
    for (int s = 0; s < KC / 32; ++s) {
      unsigned bfr[G::NT / 2][4];
#pragma unroll
      for (int jp = 0; jp < G::NT / 2; ++jp) {
        const int row = 3 * (b_ch + 16 * jp) + dx;
        ldmatrix_x4(bfr[jp], ws + row * KC + 16 * ((2 * s + b_hi) ^ swizzle(row)));
      }
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const int sr = a_sr[mt] + off;
        unsigned af[4];
        ldmatrix_x4(af, xs + sr * KC + 16 * ((2 * s + a_hi) ^ swizzle(sr)));
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt)
          i8::mma_s8(acc[mt][nt], af[0], af[1], af[2], af[3], bfr[nt / 2][2 * (nt % 2)],
                     bfr[nt / 2][2 * (nt % 2) + 1]);
      }
    }
  }
}

template <class G, bool kRelu, bool kOutBf16, bool kPrecise>
__global__ void __launch_bounds__(kThreads, G::kMinBlocks)
    int8_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, i8::Epilogue ep, int c, int k,
                        int ho, int wo, int ctiles, int pcols, int prows) {
  constexpr int BM = G::BM, PW = G::PW, S = G::S, MT = G::MT, NT = G::NT;
  extern __shared__ __align__(kAlign) unsigned char smem[];
  const int cluster = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  unsigned char* xring = smem;                   // 2 windows
  unsigned char* wring = smem + 2 * G::kWindow;  // WS slices
  unsigned char* staged = smem + G::kAccBytes;   // y [BM][LDY] int8 or [BM][LDO] bf16
  float* prm = reinterpret_cast<float*>(smem + G::body_bytes(kOutBf16));  // [2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(prm + 2 * BN);             // [WS]
  uint64_t* empty = full + WS;                                            // [WS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int tile = blockIdx.x / cluster;
  const int col0 = (tile % ctiles) * BN;
  const int patch = tile / ctiles;
  const int ox0 = (patch % pcols) * PW, oy0 = (patch / pcols % prows) * G::PH;
  const int img = patch / (pcols * prows);
  const int slice = BM / cluster, r_lo = rank * slice;  // the rows this rank finishes

  // This rank's share of the contraction: nc chunks from byte kb0 of every
  // pixel and every tap; three steps a chunk, one for each dy.
  const int nc = c / KC / cluster, steps = 3 * nc, kb0 = rank * nc * KC;
  if (tid == 0) {
    if (smem_addr(smem) % kAlign) __trap();  // the swizzle needs whole patterns
    for (int s = 0; s < WS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 2 * BN) {  // scale and bias, 0 past K, in flight during the products
    const int col = col0 + tid % BN;
    prm[tid] = col < k ? __ldg((tid < BN ? ep.scale : ep.bias) + col) : 0.f;
  }
  __syncthreads();
  // Step j's copies, issued by thread 0 into W stage j % WS and, at the
  // first dy of a chunk, the chunk's window into window stage (j / 3) % 2.
  auto issue = [&](int j) {
    const int i = j / 3, dy = j - 3 * i, kb = kb0 + i * KC;
    uint64_t* bar = full + j % WS;
    mbar_expect_tx(bar, G::kSlice + (dy == 0 ? G::kWindowTx : 0));
    if (dy == 0) {
      unsigned char* xs = xring + (i & 1) * G::kWindow;
#pragma unroll
      for (int b = 0; b < S; ++b)  // stride 2: the even columns, then the odd ones
        tma_load(xs + b * G::kBlockPitch * KC, &xmap, kb, ox0 * S - 1 + b, oy0 * S - 1, img,
                 bar);
    }
    tma_load(wring + (j % WS) * G::kSlice, &wmap, kb, 3 * dy, col0, bar);
  };
  if (tid == 0)
    for (int j = 0; j < WS - 1 && j < steps; ++j) issue(j);

  // ldmatrix row addresses of this lane: A's window row at tap (0, 0) for
  // each fragment and its 16-byte half of a k32 step; B's channel in a pair
  // of 8-channel fragments and its half.
  const int a_hi = lane / 16;
  int a_sr[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = wm * G::TM + 16 * mt + lane % 16;
    a_sr[mt] = (r / PW) * S * G::P + r % PW;
  }
  const int b_ch = wn * G::TN + 8 * (lane / 16) + lane % 8, b_hi = (lane / 8) % 2;
  int acc[MT][NT][4] = {};
  for (int j = 0; j < steps; ++j) {
    // Thread 0 refills the stage of step j - 1 once every warp is done with it.
    const int next = j + WS - 1;
    if (tid == 0 && next < steps) {
      if (next >= WS) mbar_wait(empty + next % WS, (next / WS - 1) & 1);
      issue(next);
    }
    mbar_wait(full + j % WS, (j / WS) & 1);
    __syncwarp();  // the MMAs and ldmatrix are warp-wide
    const int i = j / 3;
    products<G>(acc, xring + (i & 1) * G::kWindow, wring + (j % WS) * G::kSlice, a_sr, a_hi,
                j - 3 * i, b_ch, b_hi);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % WS);
  }
  __syncthreads();  // every warp is done with the ring, and every copy has landed

  // Fragment mt of this warp covers rows wm * TM + 16 mt .. + 16, finished by
  // the rank whose slice holds them.
  auto owner = [&](int mt) { return (wm * G::TM + 16 * mt) / slice; };
  if (cluster > 1) {
    // Partial sums of rows other ranks finish into this CTA's exchange (the
    // ring's start), one int4 a lane a fragment; then, for the rows this
    // rank finishes, every other rank's partial sums added in.
    int4* ex = reinterpret_cast<int4*>(smem);
    auto slot = [&](int mt, int nt) { return ((warp * MT + mt) * NT + nt) * 32 + lane; };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (owner(mt) == rank) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int* v = acc[mt][nt];
        ex[slot(mt, nt)] = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    cluster_arrive();
    cluster_wait();  // every rank's partial sums are in its exchange
    for (int p = 1; p < cluster; ++p) {
      const int4* peer = cg::this_cluster().map_shared_rank(ex, (rank + p) % cluster);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (owner(mt) != rank) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int4 v = peer[slot(mt, nt)];
          int* a = acc[mt][nt];
          a[0] += v.x, a[1] += v.y, a[2] += v.z, a[3] += v.w;
        }
      }
    }
    cluster_arrive();  // done reading the others; waited on before exit
  }

  // Epilogue of the rows this rank finishes, into the staged tile, which
  // lies past the exchange.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * G::TN + 8 * nt + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(prm + col);
    const float2 b = *reinterpret_cast<const float2*>(prm + BN + col);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (owner(mt) != rank) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * G::TM + 16 * mt + g + 8 * hh;
        const float y0 = i8::affine<i8::kPlain, kPrecise>(acc[mt][nt][2 * hh], s.x, b.x, 0, 0.f,
                                                          0, 0.f, 0.f);
        const float y1 = i8::affine<i8::kPlain, kPrecise>(acc[mt][nt][2 * hh + 1], s.y, b.y, 0,
                                                          0.f, 0, 0.f, 0.f);
        if (kOutBf16) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(kRelu ? fmaxf(y0, 0.f) : y0);
          v.y = __float2bfloat16_rn(kRelu ? fmaxf(y1, 0.f) : y1);
          *reinterpret_cast<__nv_bfloat162*>(staged + r * LDO + 2 * col) = v;
        } else {
          *reinterpret_cast<char2*>(staged + r * LDY + col) =
              make_char2(i8::to_int8<kRelu, kPrecise>(y0), i8::to_int8<kRelu, kPrecise>(y1));
        }
      }
    }
  }
  __syncthreads();

  // The finished rows out, 16 bytes a thread (8 for an int8 y whose K is not
  // a multiple of 16), neighbouring threads on neighbouring channels; no
  // pixel past the image, no channel past K.
  constexpr int ob = kOutBf16 ? 2 : 1, ldo = kOutBf16 ? LDO : LDY;
  const int vec = kOutBf16 || k % 16 == 0 ? 16 : 8, per_row = BN * ob / vec;
  unsigned char* out = static_cast<unsigned char*>(ep.out);
  for (int idx = tid; idx < slice * per_row; idx += kThreads) {
    const int r = r_lo + idx / per_row, cb = vec * (idx % per_row);
    const int oy = oy0 + r / PW, ox = ox0 + r % PW;
    if (oy >= ho || ox >= wo || col0 * ob + cb >= k * ob) continue;
    unsigned char* dst =
        out + (((static_cast<int64_t>(img) * ho + oy) * wo + ox) * k + col0) * ob + cb;
    if (vec == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(staged + r * ldo + cb);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(staged + r * ldo + cb);
  }
  if (cluster > 1) cluster_wait();  // no other rank reads this one's exchange any more
}

// The driver's tensor-map encoder, looked up once through the runtime.
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

struct Args {
  const int8_t *x, *w;
  i8::Epilogue ep;
  int n, h, wd, c, k, ho, wo, cluster;
  cudaStream_t stream;
};

template <class G>
struct Launch {
  template <bool kRelu, bool kOutBf16, bool kPrecise>
  struct With {
    static cudaError_t run(const Args& a) {
      const auto kernel = int8_conv3x3_kernel<G, kRelu, kOutBf16, kPrecise>;
      // Above 48 KB of dynamic shared memory only after this opt-in, made once.
      static const cudaError_t opt_in = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem_bytes(kOutBf16));
      if (opt_in != cudaSuccess) return opt_in;
      const auto encode = encoder();
      if (encode == nullptr) return cudaErrorNotSupported;
      // x as (C, W, H, N) bytes: a box of 64 channels x kBoxW columns (every
      // S-th loaded) x WH rows of one image; pixels outside it read as 0.
      CUtensorMap xmap, wmap;
      const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(a.c), static_cast<cuuint64_t>(a.wd),
                                  static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(a.n)};
      const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(a.c),
                                     static_cast<cuuint64_t>(a.c) * a.wd,
                                     static_cast<cuuint64_t>(a.c) * a.wd * a.h};
      const cuuint32_t xbox[4] = {KC, G::kBoxW, G::WH, 1}, xes[4] = {1, G::S, 1, 1};
      // W as (C, 9 taps, K) bytes: a box of 64 bytes x 3 taps x BN channels.
      const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(a.c), 9, static_cast<cuuint64_t>(a.k)};
      const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(a.c),
                                     static_cast<cuuint64_t>(a.c) * 9};
      const cuuint32_t wbox[3] = {KC, 3, BN}, wes[3] = {1, 1, 1};
      if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(a.x), xdim, xstride,
                 xbox, xes, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
              CUDA_SUCCESS ||
          encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(a.w), wdim, wstride,
                 wbox, wes, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
              CUDA_SUCCESS)
        return cudaErrorInvalidValue;
      int ctiles = (a.k + BN - 1) / BN;
      int pcols = (a.wo + G::PW - 1) / G::PW, prows = (a.ho + G::PH - 1) / G::PH;
      const int64_t ctas = static_cast<int64_t>(a.n) * prows * pcols * ctiles * a.cluster;
      if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = a.cluster;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>(ctas));
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = G::smem_bytes(kOutBf16);
      cfg.stream = a.stream;
      cfg.attrs = &attr;
      cfg.numAttrs = a.cluster > 1 ? 1 : 0;
      i8::Epilogue ep = a.ep;
      int c = a.c, k = a.k, ho = a.ho, wo = a.wo;
      void* args[] = {&xmap, &wmap, &ep, &c, &k, &ho, &wo, &ctiles, &pcols, &prows};
      const cudaError_t launched =
          cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
      const cudaError_t last = cudaGetLastError();
      return launched != cudaSuccess ? launched : last;
    }
  };
};

// The compiled tiles (ops/int8_conv.py:TILES): (stride, patch rows, patch
// columns, the CTAs an SM each is built for).
using S1 = Cfg<1, 8, 16, 3>;
using S2 = Cfg<2, 8, 16, 2>;

template <class G>
bool is(int stride, int ph, int pw) {
  return stride == G::S && ph == G::PH && pw == G::PW;
}

}  // namespace

// x: (n, h, w, c) int8; wt: (k, 3, 3, c) int8; scale, bias: (k,) float32;
// out: (n, ho, wo, k) int8 or bf16 with ho = (h - 1) / stride + 1 and
// wo = (w - 1) / stride + 1. stride 1 or 2; (patch_h, patch_w) the compiled
// tile of that stride; cluster 1, 2, 4 or 8 CTAs splitting the
// contraction, c a multiple of 64 x cluster; k a multiple of 8; every
// pointer 16-byte aligned. Returns a cudaError_t as int (0 = launched).
extern "C" int int8_conv3x3(const void* x, const void* wt, const void* scale, const void* bias,
                            void* out, int n, int h, int w, int c, int k, int stride, int relu,
                            int out_bf16, int precise, int patch_h, int patch_w, int cluster,
                            void* stream) {
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || k % 8 || !cluster_ok ||
      c % (KC * cluster) || (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(wt);
  a.ep = i8::Epilogue{static_cast<const float*>(scale), static_cast<const float*>(bias), nullptr,
                      nullptr, nullptr, nullptr, out};
  a.n = n;
  a.h = h;
  a.wd = w;
  a.c = c;
  a.k = k;
  a.ho = (h - 1) / stride + 1;
  a.wo = (w - 1) / stride + 1;
  a.cluster = cluster;
  a.stream = static_cast<cudaStream_t>(stream);
  const i8::Flags f{relu != 0, out_bf16 != 0, precise != 0};
  cudaError_t err;
  if (is<S1>(stride, patch_h, patch_w))
    err = i8::dispatch<Launch<S1>::With>(f, a);
  else if (is<S2>(stride, patch_h, patch_w))
    err = i8::dispatch<Launch<S2>::With>(f, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
