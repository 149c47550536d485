// The fused bottleneck tail in fp32 on Hopper's tensor cores (sm_90a) with
// fp32-accurate 3xTF32 products: D-tf32. 1x1 convolution, frozen-BN affine,
// residual and ReLU in one pass.
//
// Replaces the TPU kernel `_kernel` (launched by `matmul_bn_residual_relu`)
// of detr_tensorflow_tpu/ops/pallas/fused_residual.py for fp32:
//   y = relu((x W^T) * scale + shift + identity)
// over x (P, Cin) with P = B*H*W pixels (the port's NCHW activations in
// channels_last memory), W (Cout, Cin), identity and y (P, Cout), scale and
// shift (Cout), all fp32. Numerics of the TPU kernel: fp32 operands, fp32
// sums, then ((acc * scale) + shift) + identity in fp32 (explicit __fmul_rn
// / __fadd_rn: no contraction into an FMA), ReLU. bf16 calls run D-mma
// (fused_residual_mma.cu; ops/fused_residual.py:route). This is D-mma's
// design carried to `mma.sync.m16n8k8` TF32:
//
//   * The bytes. x read once, the identity read once and y written once:
//     P (Cin + 2 Cout) 4 bytes, 8-54 us a launch at 3.35 TB/s over the
//     ResNet-50 shapes of the 896x1408 bucket, 75-90% of it the identity and
//     y. Each CTA streams its identity tile into shared memory by `cp.async`
//     while the products run, writes y over it in place, and copies it out
//     16 bytes a thread, neighbouring threads on neighbouring channels of
//     one pixel row.
//   * The products. 2 P Cin Cout = 2.58 GFLOP a launch at that bucket; as
//     3xTF32 (tf32_mma.cuh) each product is three TF32 MMAs, 7.75 GFLOP of
//     MMAs, 15.7 us at the 495 TFLOP/s TF32 peak (38.5 us on the 67 TFLOP/s
//     fp32 pipes). That bounds layers 3-4 (Cin 256-512), the bytes layers
//     1-2. A CTA computes a 128-pixel x 64-channel tile of y, 8 warps as 4 x
//     2, each a 32 x 32 block. x's rows (Cin contiguous) give A through
//     `ldmatrix` (fp32 read as b16 pairs); W (Cout, Cin) row-major is
//     already the `.col` B operand, so `ldmatrix` without `.trans` on W's
//     rows gives lane 4g + t the value (k t, n g): no repacked weight. Both
//     are split into big and small parts in registers, small passed to the
//     MMA unrounded (split_operand below: three instructions where
//     tf32mma::split_tf32 takes five).
//   * Accuracy. The tensor cores truncate when an MMA adds to its
//     accumulator. D's sum is at most 512 deep (64 k8 steps), against E's
//     4608. A numpy model of the truncating MMAs (tests/test_torch_fused.py)
//     puts 3xTF32 with big x big chained through one accumulator at 2.2e-6
//     of float64 at Cin = 512 (relative to the largest sum), a quarter of
//     the 1e-5 tolerance, where single TF32 misses it by 30x. So big x big
//     chains in one accumulator and the cross terms (2^-11 of it) in
//     another, added once at the end: two accumulator sets, 64 floats a
//     thread, where E-tf32's per-chunk flush takes three.
//   * Filling the card. 128 registers a thread and 90 KB of shared memory
//     (a 2-stage ring of 32-channel chunks, the next chunk loading while
//     this one's products run, rows padded by 4 floats so the 8 row
//     addresses of each `ldmatrix` matrix fall in distinct 16-byte bank
//     groups, and the [128][64 + 8] y tile) keep two CTAs an SM, four warps
//     a scheduler: on an H100 one CTA an SM was slower, and so were a
//     3-stage ring of 16-channel chunks and a 128 x 128 tile of 16 warps
//     (scripts/torch_fused_residual_probe.py --variants). The path's
//     shapes give 256 (960 pixels x 2048 channels)
//     to 2464 CTAs (224 x 352 x 256). The channel tile is the fast grid
//     index, so the CTAs that share a pixel tile run together and find x in
//     L2; W's slice (64 x Cin) comes from L2.
//   * Ragged edges. Rows past P and channels past Cout are zero-filled
//     (`cp.async` src-size 0) and never stored; Cin need only be a multiple
//     of 4 (16-byte rows), a chunk's columns past Cin zero-filled on both
//     operands; Cout a multiple of 4, so a 16-byte group of y is wholly in
//     or out.
// One tile is compiled. `wgmma`, TMA and W split once ahead of the kernel
// are the next levers.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16mma::ldmatrix_x4;  // b16 matrices: any 16-byte rows, fp32 ones too
using cpa::cp_async16;
using tf32mma::ldmatrix_a;
using tf32mma::mma_tf32;

// x = big + small as MMA operands: big = tf32(x) as tf32mma::split_tf32
// rounds it, small = x - big (exact in fp32) passed unrounded, the MMA taking
// its sign, exponent and top 10 mantissa bits. small's error is then up to
// 2^-10 of small (2^-21 of x) where rounding leaves 2^-11; the numpy model
// in tests/test_torch_fused.py truncates it so.
__device__ __forceinline__ void split_operand(float x, unsigned& big, unsigned& small) {
  big = tf32mma::to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// A CTA's tile: BM = 128 pixels x BN = 64 output channels, Cin in chunks of
// KC = 32 through a ring of S = 2 stages, 8 warps as WM x WN = 4 x 2.
// Shared memory, in floats: S ring stages of x's chunk [BM][KC + 4] and W's
// chunk [BN][KC + 4], then the identity / y tile [BM][BN + 8] (a lane's
// float2 at row g, column 2t falls in banks 8g + 2t, 8g + 2t + 1).
struct Cfg {
  static constexpr int BM = 128, BN = 64, KC = 32, S = 2, WM = 4, WN = 2;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's block
  static constexpr int RTW = TM / 16, NTW = TN / 8;
  static constexpr int LDK = KC + 4, LDY = BN + 8, VECS = BN / 4;
  static constexpr int kStage = (BM + BN) * LDK;
  static constexpr int kSmem = 4 * (S * kStage + BM * LDY);
  static_assert(NTW % 2 == 0 && KC % 8 == 0, "B comes in pairs of 8-channel tiles");
  static_assert(2 * (kSmem + 1024) <= 233472, "two CTAs fit an SM's 228 KB");
};

using C = Cfg;

__global__ void __launch_bounds__(C::kThreads, 2)
    conv1x1_bn_residual_relu_tf32_kernel(const float* __restrict__ x,
                                         const float* __restrict__ wt,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift,
                                         const float* __restrict__ identity,
                                         float* __restrict__ y, int64_t pixels, int cin,
                                         int cout, int ctiles) {
  constexpr int BM = C::BM, BN = C::BN, KC = C::KC, S = C::S, LDK = C::LDK, LDY = C::LDY;
  constexpr int VECS = C::VECS, kThreads = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* ys = ring + S * C::kStage;  // [BM][LDY]: the identity, then y

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / C::WN, wc = warp % C::WN;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x / ctiles) * BM;
  const int c0 = (blockIdx.x % ctiles) * BN;

  auto load_chunk = [&](int chunk, int stage) {
    float* xs = ring + stage * C::kStage;
    const int k0 = chunk * KC;
#pragma unroll
    for (int i = tid; i < (BM + BN) * (KC / 4); i += kThreads) {
      const int row = i / (KC / 4), k = k0 + 4 * (i % (KC / 4));
      float* dst = xs + row * LDK + k - k0;
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
        const int row = i / VECS, n = c0 + 4 * (i % VECS);
        const int64_t p = p0 + row;
        const bool ok = p < pixels && n < cout;
        cp_async16(ys + row * LDY + 4 * (i % VECS), ok ? identity + p * cout + n : identity,
                   ok ? 16 : 0);
      }
    }
    cpa::cp_async_commit();
  }

  // ldmatrix row addresses of this lane: A's (pixel) row in its 16-row tile
  // and k half (ldmatrix_a); B's channel in a 16-channel pair of tiles and k
  // half, so that the four matrices give b0, b1 of the pair's first tile,
  // then of its second.
  const int a_off = (wr * C::TM + lane % 16) * LDK + 4 * (lane / 16);
  const int b_off = (wc * C::TN + 8 * (lane / 16) + lane % 8) * LDK + 4 * ((lane / 8) % 2);
  // hi: big x big; lo: small x big + big x small. y's sum is hi + lo.
  float hi[C::RTW][C::NTW][4] = {}, lo[C::RTW][C::NTW][4] = {};
  for (int i = 0; i < chunks; ++i) {
    cpa::cp_async_wait<S - 2>();
    __syncthreads();  // chunk i is in; every warp is done with chunk i - 1's stage
    const int next = i + S - 1;
    if (next < chunks) load_chunk(next, next % S);
    cpa::cp_async_commit();
    const float* xs = ring + (i % S) * C::kStage;
    const float* ws = xs + BM * LDK;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      unsigned bb[C::NTW][2], bs[C::NTW][2];
#pragma unroll
      for (int jp = 0; jp < C::NTW / 2; ++jp) {
        unsigned r[4];
        ldmatrix_x4(r, ws + b_off + 16 * jp * LDK + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_operand(__uint_as_float(r[e]), bb[2 * jp + e / 2][e % 2],
                        bs[2 * jp + e / 2][e % 2]);
      }
#pragma unroll
      for (int rt = 0; rt < C::RTW; ++rt) {
        unsigned af[4], ab[4], as[4];
        ldmatrix_a(af, xs + a_off + 16 * rt * LDK + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_operand(__uint_as_float(af[e]), ab[e], as[e]);
        // Three passes over the column tiles, so that the two MMAs into one
        // lo accumulator issue NTW MMAs apart (the MMAs keep their order).
#pragma unroll
        for (int j = 0; j < C::NTW; ++j) mma_tf32(hi[rt][j], ab, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < C::NTW; ++j) mma_tf32(lo[rt][j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < C::NTW; ++j) mma_tf32(lo[rt][j], ab, bs[j][0], bs[j][1]);
      }
    }
  }
  cpa::cp_async_wait<0>();
  __syncthreads();  // the identity tile is in

  // Epilogue: ((acc * scale) + shift) + identity, ReLU, y written over the
  // identity in place (each lane reads and writes the same two channels of
  // its rows).
#pragma unroll
  for (int j = 0; j < C::NTW; ++j) {
    const int col = wc * C::TN + 8 * j + 2 * t, n = c0 + col;
    float2 s = make_float2(0.f, 0.f), h = make_float2(0.f, 0.f);
    if (n < cout) {
      s = *reinterpret_cast<const float2*>(scale + n);
      h = *reinterpret_cast<const float2*>(shift + n);
    }
#pragma unroll
    for (int rt = 0; rt < C::RTW; ++rt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2* at = reinterpret_cast<float2*>(ys + (wr * C::TM + 16 * rt + g + 8 * half) * LDY +
                                               col);
        const float2 id = *at;
        const float a0 = __fadd_rn(hi[rt][j][2 * half], lo[rt][j][2 * half]);
        const float a1 = __fadd_rn(hi[rt][j][2 * half + 1], lo[rt][j][2 * half + 1]);
        const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(a0, s.x), h.x), id.x);
        const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(a1, s.y), h.y), id.y);
        *at = make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BM * VECS; i += kThreads) {
    const int row = i / VECS, n = c0 + 4 * (i % VECS);
    const int64_t p = p0 + row;
    if (p < pixels && n < cout)
      *reinterpret_cast<float4*>(y + p * cout + n) =
          *reinterpret_cast<const float4*>(ys + row * LDY + 4 * (i % VECS));
  }
}

}  // namespace

// x: (pixels, cin); wt: (cout, cin); identity, y: (pixels, cout); all fp32,
// contiguous, 16-byte aligned; scale, shift: (cout,) float32, 8-byte
// aligned. cin and cout multiples of 4. Returns a cudaError_t as int (0 =
// launched).
extern "C" int conv1x1_bn_residual_relu_tf32(const void* x, const void* wt, const void* scale,
                                             const void* shift, const void* identity, void* y,
                                             int64_t pixels, int cin, int cout, void* stream) {
  if (pixels <= 0 || cin <= 0 || cout <= 0 || cin % 4 || cout % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctiles = (cout + C::BN - 1) / C::BN;
  const int64_t ctas = (pixels + C::BM - 1) / C::BM * ctiles;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of dynamic shared memory only after this opt-in, made once,
  // on the first call.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      conv1x1_bn_residual_relu_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  conv1x1_bn_residual_relu_tf32_kernel<<<static_cast<unsigned>(ctas), C::kThreads, C::kSmem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(identity), static_cast<float*>(y), pixels, cin, cout, ctiles);
  return static_cast<int>(cudaGetLastError());
}
