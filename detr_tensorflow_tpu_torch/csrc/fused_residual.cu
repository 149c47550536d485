// The fused bottleneck tail: 1x1 convolution, frozen-BN affine, residual
// and ReLU in one pass, for Hopper, CUDA C++.
//
// Replaces the TPU kernel `_kernel` (launched by `matmul_bn_residual_relu`)
// of detr_tensorflow_tpu/ops/pallas/fused_residual.py:
//   y = relu((x W^T) * scale + shift + identity)
// over x (P, Cin) with P = B*H*W pixels (the port's NCHW activations in
// channels_last memory, as its backbone holds them), weights W (Cout, Cin)
// in the compute type, fp32 scale and shift (Cout), identity and y
// (P, Cout); float32 or bf16 tensors, fp32 accumulation and epilogue, one
// rounding to the output type. The conv output never reaches device memory.
//
// Design: a CTA computes a 64-pixel x 64-channel tile of y: Cin in chunks
// of 16 through shared memory (both operands stored so that the product
// reads them without bank conflicts), 256 threads, each a 4 x 4 register
// tile of pixels x channels, fp32 FMAs (bf16 operands widened exactly).
// Channels are the fast thread index, so the epilogue reads the identity
// and writes y along contiguous channel rows. Every edge is masked.
//
// What bounds it on the H100: bytes at every ResNet-50 shape (layer1's
// block_0 tail at the 896x1408 bucket moves 181.6 MB, 54 us, for 2.58
// GFLOP, 38.5 us at the 67 TFLOP/s fp32 peak). This simple tile reaches a
// fraction of either: no tensor cores, no vector loads, no pipelining;
// wgmma with TMA-fed tiles is a later PR's work.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 64;  // pixels per CTA
constexpr int kTileC = 64;  // output channels per CTA
constexpr int kChunk = 16;  // input channels per shared-memory stage

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv1x1_bn_residual_relu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ shift,
                                    const T* __restrict__ identity, T* __restrict__ y,
                                    int64_t pixels, int cin, int cout) {
  // xs[p][k] = x[p0 + p][k0 + k], rows of 17: the product's two pixels of a
  // warp fall in different banks. ws[k][c] = W[c0 + c][k0 + k], rows of 68:
  // the stores, which walk k, spread over 16 banks and float4 reads stay
  // aligned.
  __shared__ float xs[kTileP][kChunk + 1];
  __shared__ __align__(16) float ws[kChunk][kTileC + 4];
  const int tid = threadIdx.x;
  const int tc = tid % 16, tp = tid / 16;  // channel group (fast), pixel group
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTileP;
  const int c0 = blockIdx.y * kTileC;

  float acc[4][4] = {};  // [pixel][channel]
  for (int k0 = 0; k0 < cin; k0 += kChunk) {
    __syncthreads();  // the previous chunk's products are done
#pragma unroll
    for (int i = tid; i < kChunk * kTileP; i += kThreads) {
      const int k = i % kChunk, p = i / kChunk;  // consecutive threads: consecutive k
      const bool ok = p0 + p < pixels && k0 + k < cin;
      xs[p][k] = ok ? to_float(x[(p0 + p) * cin + k0 + k]) : 0.0f;
    }
#pragma unroll
    for (int i = tid; i < kChunk * kTileC; i += kThreads) {
      const int k = i % kChunk, c = i / kChunk;
      const bool ok = c0 + c < cout && k0 + k < cin;
      ws[k][c] = ok ? to_float(wt[static_cast<int64_t>(c0 + c) * cin + k0 + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[k][tc * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = xs[tp + 16 * r][k];
        acc[r][0] = fmaf(a, wv.x, acc[r][0]);
        acc[r][1] = fmaf(a, wv.y, acc[r][1]);
        acc[r][2] = fmaf(a, wv.z, acc[r][2]);
        acc[r][3] = fmaf(a, wv.w, acc[r][3]);
      }
    }
  }
  // Epilogue: ((acc * scale) + shift) + identity, ReLU, one rounding.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t p = p0 + tp + 16 * r;
    if (p >= pixels) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + tc * 4 + i;
      if (c >= cout) continue;
      const int64_t at = p * cout + c;
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(acc[r][i], scale[c]), shift[c]),
                                to_float(identity[at]));
      y[at] = from_float<T>(fmaxf(v, 0.0f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, const float* scale, const float* shift,
                   const void* identity, void* y, int64_t pixels, int cin, int cout,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((pixels + kTileP - 1) / kTileP),
                  (cout + kTileC - 1) / kTileC);
  conv1x1_bn_residual_relu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), scale, shift,
      static_cast<const T*>(identity), static_cast<T*>(y), pixels, cin, cout);
  return cudaGetLastError();
}

}  // namespace

// x: (pixels, cin); wt: (cout, cin); scale, shift: (cout,) float32;
// identity, y: (pixels, cout); all contiguous. bf16 != 0 selects
// __nv_bfloat16 for x, wt, identity and y, else float. Returns a
// cudaError_t as int (0 = launched).
extern "C" int conv1x1_bn_residual_relu(const void* x, const void* wt, const void* scale,
                                        const void* shift, const void* identity, void* y,
                                        int64_t pixels, int cin, int cout, int bf16,
                                        void* stream) {
  if (pixels <= 0 || cin <= 0 || cout <= 0 || (pixels + kTileP - 1) / kTileP > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* t = static_cast<const float*>(shift);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(x, wt, s, t, identity, y, pixels, cin, cout, st)
           : launch<float>(x, wt, s, t, identity, y, pixels, cin, cout, st);
  return static_cast<int>(err);
}
