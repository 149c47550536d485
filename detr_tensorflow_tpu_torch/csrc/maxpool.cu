// 3x3, stride 2, pad 1 max pool of the ResNet stem, for Hopper, CUDA C++.
//
// Replaces the TPU kernel `_kernel` (launched by `max_pool_3x3_s2_pallas`)
// of detr_tensorflow_tpu/ops/pallas/maxpool.py: out[b, i, j, c] = the
// maximum of x[b, 2i-1 .. 2i+1, 2j-1 .. 2j+1, c] over the taps inside the
// image, float32 or bf16, (B, H, W, C) -> (B, (H-1)/2+1, (W-1)/2+1, C) in
// memory (the port's NCHW tensors in channels_last, as its backbone holds
// them), any H and W.
//
// The TPU kernel pads with zeros, which equals the -inf padding of
// F.max_pool2d only for x >= 0 (the stem's post-ReLU input). This kernel
// skips the taps outside the image instead, so it equals F.max_pool2d
// bit for bit on any input: it visits the taps in row-major order, starting
// from -inf, and takes a tap that is greater or NaN, which is ATen's rule
// (the first maximum wins a tie, NaN propagates). Every window holds its
// centre tap, which lies in the image. bf16 values are compared as floats
// and stored with their own bits.
//
// What bounds it on the H100: bytes. It reads each input once and writes
// each output once (9 loads a thread, neighbouring windows share their
// rows through L1), no arithmetic worth counting: at the stem of the
// 896x1408 bucket, 80.7 MB in and 20.2 MB out (fp32), 30 us at 3.35 TB/s.
// Design: one thread per output element, a grid-stride loop; consecutive
// threads take consecutive channels, so each of a warp's nine loads and its
// store is one contiguous run of 32 elements.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    max_pool_3x3_s2_kernel(const T* __restrict__ x, T* __restrict__ y, int batch, int h, int w,
                           int c, int ho, int wo) {
  const int64_t total = static_cast<int64_t>(batch) * ho * wo * c;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int ch = static_cast<int>(idx % c);
    const int64_t pixel = idx / c;
    const int j = static_cast<int>(pixel % wo);
    const int i = static_cast<int>((pixel / wo) % ho);
    const T* image = x + (pixel / (static_cast<int64_t>(ho) * wo)) * h * w * c + ch;
    float best = -INFINITY;
    T best_raw = image[(static_cast<int64_t>(2 * i) * w + 2 * j) * c];
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int r = 2 * i + dy;
      if (r < 0 || r >= h) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int col = 2 * j + dx;
        if (col < 0 || col >= w) continue;
        const T raw = image[(static_cast<int64_t>(r) * w + col) * c];
        const float v = to_float(raw);
        if (v > best || isnan(v)) {
          best = v;
          best_raw = raw;
        }
      }
    }
    y[idx] = best_raw;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int batch, int h, int w, int c, cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const int64_t total = static_cast<int64_t>(batch) * ho * wo * c;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
  max_pool_3x3_s2_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), batch, h, w, c, ho, wo);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, h, w, c) contiguous; y: (batch, (h-1)/2+1, (w-1)/2+1, c).
// bf16 != 0 selects __nv_bfloat16, else float. Returns a cudaError_t as int
// (0 = launched).
extern "C" int max_pool_3x3_s2(const void* x, void* y, int batch, int h, int w, int c, int bf16,
                               void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(x, y, batch, h, w, c, s)
                               : launch<float>(x, y, batch, h, w, c, s);
  return static_cast<int>(err);
}
