// The fused bottleneck tail in bf16 on Hopper's tensor cores (sm_90a):
// D-mma. 1x1 convolution, frozen-BN affine, residual and ReLU in one pass.
//
// Replaces the TPU kernel `_kernel` (launched by `matmul_bn_residual_relu`)
// of detr_tensorflow_tpu/ops/pallas/fused_residual.py for bf16:
//   y = relu((x W^T) * scale + shift + identity)
// over x (P, Cin) with P = B*H*W pixels (the port's NCHW activations in
// channels_last memory), W (Cout, Cin), identity and y (P, Cout), all bf16,
// and fp32 scale and shift (Cout). Numerics of the TPU kernel: bf16
// products summed in fp32, then ((acc * scale) + shift) + identity in fp32
// (explicit __fmul_rn / __fadd_rn: no contraction into an FMA), ReLU, one
// rounding to bf16. fp32 calls stay on the SIMT kernel of fused_residual.cu
// (ops/fused_residual.py:route).
//
// What bounds it on the H100, and what the design does about each:
//   * The bytes. Every ResNet-50 shape is 2 P Cin Cout = 2.58 GFLOP at the
//     896x1408 bucket (2.6 us at the 989 TFLOP/s bf16 peak), while x read
//     once, the identity read once and y written once take 4-27 us at 3.35
//     TB/s; the identity and y are 75-90% of them. So the epilogue is where
//     the time goes: each CTA stages its output tile in shared memory and
//     reads the identity and writes y 16 bytes a thread, neighbouring
//     threads on neighbouring channels of one pixel row. The identity tile
//     streams in by `cp.async` while the products run, and y is written
//     over it in place.
//   * The products. A CTA computes a 128-pixel x 128-channel tile of y on
//     `mma.sync.m16n8k16` (bf16 in, fp32 accumulators), 8 warps as 2 x 4,
//     each a 64 x 32 block, two CTAs an SM. x's rows (Cin contiguous) give
//     A through `ldmatrix`; W (Cout, Cin) row-major is already the `.col` B
//     operand, so `ldmatrix` without `.trans` on W's rows gives B: no
//     repacking.
//     Cin streams through a 3-stage `cp.async` ring in chunks of 32, rows
//     padded by 8 elements so the 8 row addresses of each 8x8 matrix fall in
//     distinct 16-byte bank groups.
//   * Reading x once. The channel tile is the fast grid index, so the CTAs
//     that share a pixel tile run together and find x in L2; W's slice
//     (128 x Cin) comes from L2.
//   * Filling the card. One tile is compiled: the path's shapes give 128
//     (960 pixels x 2048 channels) to 1232 CTAs (224 x 352 x 256 channels).
//   * Ragged edges. Rows past P and channels past Cout are zero-filled
//     (`cp.async` src-size 0) and never stored; Cin need only be a multiple
//     of 8 (16-byte rows), a chunk's columns past Cin zero-filled on both
//     operands; Cout a multiple of 8, so a 16-byte group of y is wholly in
//     or out.
// `wgmma`, TMA and persistent CTAs that overlap one tile's epilogue with the
// next one's loads are the next levers.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16mma::ldmatrix_x4;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;
using cpa::cp_async16;

// A CTA's tile: BM = 128 pixels x BN = 128 output channels, Cin in chunks
// of KC = 32 through a ring of S = 3 stages, 8 warps as WM x WN = 2 x 4.
// Shared memory, in bf16 elements: S ring stages of x's chunk [BM][KC + 8]
// and W's chunk [BN][KC + 8], then the identity / y tile [BM][BN + 8].
struct Cfg {
  static constexpr int BM = 128, BN = 128, KC = 32, S = 3, WM = 2, WN = 4;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's block
  static constexpr int RTW = TM / 16, NTW = TN / 8;
  static constexpr int LDK = KC + 8, LDY = BN + 8, VECS = BN / 8;
  static constexpr int kStage = (BM + BN) * LDK;
  static constexpr int kSmem = 2 * (S * kStage + BM * LDY);
  static_assert(NTW % 2 == 0 && RTW >= 1, "B comes in pairs of 8-channel tiles");
  static_assert(2 * (kSmem + 1024) <= 233472, "two CTAs fit an SM's 228 KB");
};

using C = Cfg;

__global__ void __launch_bounds__(C::kThreads, 2)
    conv1x1_bn_residual_relu_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        const bf16* __restrict__ identity, bf16* __restrict__ y,
                                        int64_t pixels, int cin, int cout, int ctiles) {
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, S = C::S, LDK = C::LDK, LDY = C::LDY;
  constexpr int VECS = C::VECS, kThreads = C::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* ys = ring + S * C::kStage;  // [BM][LDY]: the identity, then y

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / C::WN, wc = warp % C::WN;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x / ctiles) * BM;
  const int c0 = (blockIdx.x % ctiles) * BN;

  auto load_chunk = [&](int chunk, int stage) {
    bf16* xs = ring + stage * C::kStage;
    const int k0 = chunk * KC;
#pragma unroll
    for (int i = tid; i < (BM + BN) * (KC / 8); i += kThreads) {
      const int row = i / (KC / 8), k = k0 + 8 * (i % (KC / 8));
      bf16* dst = xs + row * LDK + k - k0;
      if (row < BM) {  // x's rows, then W's
        const int64_t p = p0 + row;
        const bool ok = p < pixels && k < cin;
        cp_async16(dst, ok ? x + p * cin + k : x, ok ? 16 : 0);
      } else {
        const int n = c0 + row - BM;
        const bool ok = n < cout && k < cin;
        cp_async16(dst, ok ? wt + static_cast<int64_t>(n) * cin + k : wt, ok ? 16 : 0);
      }
    }
  };

  // The ring's first S - 1 chunks, the identity tile in the group of the
  // last of them: the wait of iteration i leaves only the S - 2 newest groups
  // in flight, so chunk i has always landed, and the identity by chunk S - 2.
  const int chunks = (cin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < chunks) load_chunk(s, s);
    if (s == S - 2) {
      for (int i = tid; i < BM * VECS; i += kThreads) {
        const int row = i / VECS, n = c0 + 8 * (i % VECS);
        const int64_t p = p0 + row;
        const bool ok = p < pixels && n < cout;
        cp_async16(ys + row * LDY + 8 * (i % VECS), ok ? identity + p * cout + n : identity,
                   ok ? 16 : 0);
      }
    }
    cpa::cp_async_commit();
  }

  // ldmatrix row addresses of this lane: A's (pixel) row in its 16-row tile
  // and column half; B's channel in a 16-channel pair of tiles and k half.
  const int a_off = (wr * C::TM + lane % 16) * LDK + 8 * (lane / 16);
  const int b_off = (wc * C::TN + 8 * (lane / 16) + lane % 8) * LDK + 8 * ((lane / 8) % 2);
  float acc[C::RTW][C::NTW][4] = {};
  for (int i = 0; i < chunks; ++i) {
    cpa::cp_async_wait<S - 2>();
    __syncthreads();  // chunk i is in; every warp is done with chunk i - 1's stage
    const int next = i + S - 1;
    if (next < chunks) load_chunk(next, next % S);
    cpa::cp_async_commit();
    const bf16* xs = ring + (i % S) * C::kStage;
    const bf16* ws = xs + BM * LDK;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      unsigned bfr[C::NTW / 2][4];
#pragma unroll
      for (int jp = 0; jp < C::NTW / 2; ++jp)
        ldmatrix_x4(bfr[jp], ws + b_off + 16 * jp * LDK + 16 * ks);
#pragma unroll
      for (int r = 0; r < C::RTW; ++r) {
        unsigned af[4];
        ldmatrix_x4(af, xs + a_off + 16 * r * LDK + 16 * ks);
#pragma unroll
        for (int j = 0; j < C::NTW; ++j)
          mma_bf16(acc[r][j], af, bfr[j / 2][2 * (j % 2)], bfr[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // the identity tile is in

  // Epilogue: ((acc * scale) + shift) + identity, ReLU, one rounding, y
  // written over the identity in place (each lane reads and writes the same
  // two channels of its rows).
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) {
    const int col = wc * C::TN + 8 * j + 2 * t, n = c0 + col;
    float2 s = make_float2(0.f, 0.f), h = make_float2(0.f, 0.f);
    if (n < cout) {
      s = *reinterpret_cast<const float2*>(scale + n);
      h = *reinterpret_cast<const float2*>(shift + n);
    }
#pragma unroll
    for (int r = 0; r < C::RTW; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned* at = reinterpret_cast<unsigned*>(
            ys + (wr * C::TM + 16 * r + g + 8 * half) * LDY + col);
        const float2 id = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
        const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(acc[r][j][2 * half], s.x), h.x), id.x);
        const float v1 =
            __fadd_rn(__fadd_rn(__fmul_rn(acc[r][j][2 * half + 1], s.y), h.y), id.y);
        *at = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * VECS; i += kThreads) {
    const int row = i / VECS, n = c0 + 8 * (i % VECS);
    const int64_t p = p0 + row;
    if (p < pixels && n < cout)
      *reinterpret_cast<uint4*>(y + p * cout + n) =
          *reinterpret_cast<const uint4*>(ys + row * LDY + 8 * (i % VECS));
  }
}

}  // namespace

// x: (pixels, cin); wt: (cout, cin); identity, y: (pixels, cout); all bf16,
// contiguous, 16-byte aligned; scale, shift: (cout,) float32, 8-byte
// aligned. cin and cout multiples of 8. Returns a cudaError_t as int (0 =
// launched).
extern "C" int conv1x1_bn_residual_relu_mma(const void* x, const void* wt, const void* scale,
                                            const void* shift, const void* identity, void* y,
                                            int64_t pixels, int cin, int cout, void* stream) {
  if (pixels <= 0 || cin <= 0 || cout <= 0 || cin % 8 || cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctiles = (cout + C::BN - 1) / C::BN;
  const int64_t ctas = (pixels + C::BM - 1) / C::BM * ctiles;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of dynamic shared memory only after this opt-in, made once,
  // on the first call.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv1x1_bn_residual_relu_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv1x1_bn_residual_relu_mma_kernel<<<static_cast<unsigned>(ctas), C::kThreads, C::kSmem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const bf16*>(identity), static_cast<bf16*>(y), pixels, cin, cout, ctiles);
  return static_cast<int>(cudaGetLastError());
}
