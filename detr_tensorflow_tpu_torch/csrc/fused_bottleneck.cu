// The whole identity bottleneck of ResNet in one kernel, for Hopper, CUDA
// C++: 1x1 (C -> M) -> 3x3 (M -> M) -> 1x1 (M -> C) + x, frozen BN folded
// into the weights, ReLU after each, T1 and T2 kept in shared memory.
//
// Replaces the TPU kernel `_kernel` (launched by `fused_bottleneck`) of
// detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py:
//   T1 = relu(W1 x + b1), zero outside the image
//   T2 = relu(W2 * T1 + b2)        (3x3, pad 1)
//   y  = relu(W3 T2 + b3 + x)
// over x and y (N, H, W, C) in memory (the port's NCHW activations in
// channels_last, as its backbone holds them), float32 or bf16, weights in
// that type (the BN scale folded in float32 before the cast), float32
// biases, fp32 accumulation; T1 and T2 are rounded to the compute type
// before the next contraction, the residual is added in fp32, one rounding
// of y.
//
// Design: one CTA of 256 threads per tile of TH x TW output pixels of one
// image, across all channels, in three stages:
//   1. conv1 over the (TH+2) x (TW+2) halo into shared memory as T1, input
//      channels in chunks of 16 staged beside the weights' chunk. The
//      halo's pixels outside the image read x as 0, where conv1 would give
//      relu(b1) != 0; the unfused conv2 reads zero padding there, so T1 is
//      zeroed outside the image;
//   2. conv2 as nine shifted products over T1 into T2 (shared memory);
//   3. conv3 plus the residual (x read again, from L2) and ReLU, streamed
//      over passes of output channels straight to y.
// Each stage is a block product: a thread holds RP pixels x 4 channels in
// registers, the activations come from shared memory (pixel rows of M + 1
// floats, so two pixels never share a bank) and the weights through a
// shared-memory chunk of 16 x NB. Channels are the fast thread index, so
// the epilogue reads x and writes y along contiguous channel runs. The
// tile is chosen per M, so that T1, T2 and the chunks fit in shared memory
// (at most 227 KB a CTA; above 48 KB only as dynamic shared memory after
// cudaFuncSetAttribute) and the grid still fills the 132 SMs at the
// smaller feature maps:
//   M <= 128: 8 x 8 pixels, 64 channels a pass  (54 KB at M = 64, 96 at 128)
//   M <= 256: 4 x 4 pixels, 256 channels a pass (73 KB)
//   M <= 512: 2 x 4 pixels, 512 channels a pass (100 KB)
// The halo costs conv1 (TH+2)(TW+2) / (TH TW) of its work: 1.6x at 8 x 8,
// 2.25x at 4 x 4, 3x at 2 x 4.
//
// What bounds it on the H100: operations, in fp32, at every ResNet-50
// shape: 2 H W (C M + 9 M^2 + M C) operations, 10.98 GFLOP per block at
// the 896x1408 bucket, 164 us at the 67 TFLOP/s fp32 peak, for 161 MB
// (48 us) at layer1. In bf16 (989 TFLOP/s on the tensor cores) the bytes
// bound layer1. This kernel runs fp32 FMAs from shared memory in both
// types, no tensor cores: wgmma over TMA-fed halo tiles is a later PR's
// work.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;        // contraction channels per shared-memory stage
constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA can have

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
// A value rounded to the compute type, held as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <int TH, int TW, int TCX>
struct Tile {
  static constexpr int kTH = TH, kTW = TW;
  static constexpr int kHaloW = TW + 2;
  static constexpr int kP1 = (TH + 2) * kHaloW;  // halo pixels (T1)
  static constexpr int kP2 = TH * TW;            // output pixels (T2, y)
  static constexpr int kTCX = TCX;               // channel groups, the fast thread index
  static constexpr int kTPY = kThreads / TCX;    // pixel groups
  static constexpr int kNB = 4 * TCX;            // channels a pass
  static constexpr int kRP1 = (kP1 + kTPY - 1) / kTPY;
  static constexpr int kRP2 = (kP2 + kTPY - 1) / kTPY;
  static constexpr int kWStride = kNB + 4;     // padded rows of the weight chunk
  static constexpr int kXStride = kChunk + 1;  // padded pixel rows of the input chunk
  static size_t smem_bytes(int m) {
    return sizeof(float) * (static_cast<size_t>(kChunk) * kWStride +
                            static_cast<size_t>(kP1 + kP2) * (m + 1) + kP1 * kXStride);
  }
};

// Stage the weight chunk ws[kk][nn] = w[(k0 + kk) * ldw + n0 + nn], zero
// beyond n_total; consecutive threads read consecutive nn.
template <typename T, typename Cfg>
__device__ __forceinline__ void stage_weights(float* ws, const T* __restrict__ w, int ldw,
                                              int k0, int n0, int n_total) {
  for (int i = threadIdx.x; i < kChunk * Cfg::kNB; i += kThreads) {
    const int kk = i / Cfg::kNB, nn = i % Cfg::kNB;
    const int n = n0 + nn;
    ws[kk * Cfg::kWStride + nn] =
        n < n_total ? to_float(w[static_cast<int64_t>(k0 + kk) * ldw + n]) : 0.0f;
  }
}

// acc[r][i] += sum over the chunk's kk of a[offs[r] + kk] * ws[kk][tx * 4 + i].
template <typename Cfg, int RP>
__device__ __forceinline__ void chunk_product(float (&acc)[RP][4], const float* a,
                                              const int (&offs)[RP], const float* ws, int tx) {
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {
    const float4 wv = *reinterpret_cast<const float4*>(ws + kk * Cfg::kWStride + tx * 4);
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const float av = a[offs[r] + kk];
      acc[r][0] = fmaf(av, wv.x, acc[r][0]);
      acc[r][1] = fmaf(av, wv.y, acc[r][1]);
      acc[r][2] = fmaf(av, wv.z, acc[r][2]);
      acc[r][3] = fmaf(av, wv.w, acc[r][3]);
    }
  }
}

template <typename T, typename Cfg>
__global__ void __launch_bounds__(kThreads)
    fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                            const float* __restrict__ b1, const T* __restrict__ w2t,
                            const float* __restrict__ b2, const T* __restrict__ w3t,
                            const float* __restrict__ b3, T* __restrict__ y, int c, int m, int h,
                            int w, int tiles_x) {
  constexpr int kP1 = Cfg::kP1, kP2 = Cfg::kP2, kHW = Cfg::kHaloW, kTW = Cfg::kTW;
  constexpr int kRP1 = Cfg::kRP1, kRP2 = Cfg::kRP2, kNB = Cfg::kNB, kTPY = Cfg::kTPY;
  constexpr int kXS = Cfg::kXStride;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                     // [kChunk][kWStride]
  float* t1 = ws + kChunk * Cfg::kWStride;              // [kP1][m + 1]
  float* t2 = t1 + static_cast<size_t>(kP1) * (m + 1);  // [kP2][m + 1]
  float* xs = t2 + static_cast<size_t>(kP2) * (m + 1);  // [kP1][kXS]
  const int ld = m + 1;

  const int tx = threadIdx.x % Cfg::kTCX, ty = threadIdx.x / Cfg::kTCX;
  const int oy0 = (blockIdx.x / tiles_x) * Cfg::kTH, ox0 = (blockIdx.x % tiles_x) * kTW;
  const T* xb = x + static_cast<int64_t>(blockIdx.y) * h * w * c;
  T* yb = y + static_cast<int64_t>(blockIdx.y) * h * w * c;

  // Halo pixel q sits at image (oy0 - 1 + q / kHW, ox0 - 1 + q % kHW).
  auto halo_in_image = [&](int q) {
    const int gy = oy0 - 1 + q / kHW, gx = ox0 - 1 + q % kHW;
    return gy >= 0 && gy < h && gx >= 0 && gx < w;
  };

  // 1. T1 = relu(W1 x + b1) over the halo, zero outside the image.
  int offs1[kRP1];
#pragma unroll
  for (int r = 0; r < kRP1; ++r) offs1[r] = min(ty + kTPY * r, kP1 - 1) * kXS;
  for (int n0 = 0; n0 < m; n0 += kNB) {
    float acc[kRP1][4] = {};
    for (int k0 = 0; k0 < c; k0 += kChunk) {
      __syncthreads();  // the previous chunk's products are done
      for (int i = threadIdx.x; i < kChunk * kP1; i += kThreads) {
        const int kk = i % kChunk, q = i / kChunk;
        const int64_t pixel =
            static_cast<int64_t>(oy0 - 1 + q / kHW) * w + ox0 - 1 + q % kHW;
        xs[q * kXS + kk] = halo_in_image(q) ? to_float(xb[pixel * c + k0 + kk]) : 0.0f;
      }
      stage_weights<T, Cfg>(ws, w1t, m, k0, n0, m);
      __syncthreads();
      chunk_product<Cfg, kRP1>(acc, xs, offs1, ws, tx);
    }
#pragma unroll
    for (int r = 0; r < kRP1; ++r) {
      const int q = ty + kTPY * r;
      if (q >= kP1) continue;
      const bool inside = halo_in_image(q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + tx * 4 + i;
        if (n < m) t1[q * ld + n] = inside ? round_to<T>(fmaxf(acc[r][i] + b1[n], 0.0f)) : 0.0f;
      }
    }
  }

  // 2. T2 = relu(conv3x3(T1) + b2): tap (dy, dx) of output pixel p reads
  //    halo pixel (p / TW + dy, p % TW + dx).
  int offs2[kRP2];
#pragma unroll
  for (int r = 0; r < kRP2; ++r) {
    const int p = min(ty + kTPY * r, kP2 - 1);
    offs2[r] = ((p / kTW) * kHW + p % kTW) * ld;
  }
  for (int n0 = 0; n0 < m; n0 += kNB) {
    float acc[kRP2][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const float* t1_tap = t1 + ((tap / 3) * kHW + tap % 3) * ld;
      for (int k0 = 0; k0 < m; k0 += kChunk) {
        __syncthreads();
        stage_weights<T, Cfg>(ws, w2t + static_cast<int64_t>(tap) * m * m, m, k0, n0, m);
        __syncthreads();
        chunk_product<Cfg, kRP2>(acc, t1_tap + k0, offs2, ws, tx);
      }
    }
#pragma unroll
    for (int r = 0; r < kRP2; ++r) {
      const int p = ty + kTPY * r;
      if (p >= kP2) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + tx * 4 + i;
        if (n < m) t2[p * ld + n] = round_to<T>(fmaxf(acc[r][i] + b2[n], 0.0f));
      }
    }
  }

  // 3. y = relu(W3 T2 + b3 + x), a pass of kNB output channels at a time.
  int offs3[kRP2];
#pragma unroll
  for (int r = 0; r < kRP2; ++r) offs3[r] = min(ty + kTPY * r, kP2 - 1) * ld;
  for (int n0 = 0; n0 < c; n0 += kNB) {
    float acc[kRP2][4] = {};
    for (int k0 = 0; k0 < m; k0 += kChunk) {
      __syncthreads();
      stage_weights<T, Cfg>(ws, w3t, c, k0, n0, c);
      __syncthreads();
      chunk_product<Cfg, kRP2>(acc, t2 + k0, offs3, ws, tx);
    }
#pragma unroll
    for (int r = 0; r < kRP2; ++r) {
      const int p = ty + kTPY * r;
      const int gy = oy0 + p / kTW, gx = ox0 + p % kTW;
      if (p >= kP2 || gy >= h || gx >= w) continue;
      const int64_t pixel = static_cast<int64_t>(gy) * w + gx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + tx * 4 + i;
        if (n >= c) continue;
        const int64_t at = pixel * c + n;
        yb[at] = from_float<T>(fmaxf((acc[r][i] + b3[n]) + to_float(xb[at]), 0.0f));
      }
    }
  }
}

struct Args {
  const void *x, *w1t, *w2t, *w3t;
  const float *b1, *b2, *b3;
  void* y;
  int n, c, m, h, w;
  cudaStream_t stream;
};

template <typename T, int TH, int TW, int TCX>
cudaError_t launch(const Args& a) {
  using Cfg = Tile<TH, TW, TCX>;
  const size_t smem = Cfg::smem_bytes(a.m);
  auto kernel = fused_bottleneck_kernel<T, Cfg>;
  // Above 48 KB of dynamic shared memory only after this opt-in, made once
  // per instantiation, on its first launch.
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return opt_in;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int tiles_x = (a.w + TW - 1) / TW, tiles_y = (a.h + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, a.n);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1t), a.b1,
      static_cast<const T*>(a.w2t), a.b2, static_cast<const T*>(a.w3t), a.b3,
      static_cast<T*>(a.y), a.c, a.m, a.h, a.w, tiles_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.m <= 128) return launch<T, 8, 8, 16>(a);
  if (a.m <= 256) return launch<T, 4, 4, 64>(a);
  return launch<T, 2, 4, 128>(a);
}

}  // namespace

// x, y: (n, h, w, c); w1t: (c, m); w2t: (9, m, m) as (tap, in, out) with
// tap = 3 * dy + dx; w3t: (m, c); all contiguous, in the compute type
// (bf16 != 0 selects __nv_bfloat16, else float); b1, b2: (m,) and b3: (c,)
// float32. c and m multiples of 16, m <= 512. Returns a cudaError_t as int
// (0 = launched).
extern "C" int fused_bottleneck(const void* x, const void* w1t, const void* b1, const void* w2t,
                                const void* b2, const void* w3t, const void* b3, void* y, int n,
                                int c, int m, int h, int w, int bf16, void* stream) {
  if (n <= 0 || n > 65535 || c <= 0 || h <= 0 || w <= 0 || c % kChunk || m <= 0 || m > 512 ||
      m % kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, w1t, w2t, w3t, static_cast<const float*>(b1), static_cast<const float*>(b2),
         static_cast<const float*>(b3), y, n, c, m, h, w, static_cast<cudaStream_t>(stream)};
  const cudaError_t err = bf16 ? dispatch<__nv_bfloat16>(a) : dispatch<float>(a);
  return static_cast<int>(err);
}
