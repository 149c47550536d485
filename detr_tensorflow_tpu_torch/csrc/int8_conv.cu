// int8 3x3 convolution (SAME, pad 1, stride 1 or 2) with the requantization
// epilogue, for Hopper, CUDA C++.
//
// Replaces the TPU kernel `_conv_kernel` (launched by `conv3x3_int8`) of
// detr_tensorflow_tpu/ops/pallas/int8_conv.py, which takes the stride-1
// 3x3s of the int8 backbone, and the XLA int8 convolution
// `_conv3x3_int8_xla` of detr_tensorflow_tpu/models/quantized.py, which
// takes the three strided ones: y = q(relu(conv(x, W) * s + b)) over NHWC
// int8 x (N, H, W, C) and OHWI int8 W (K, 3, 3, C), int32 accumulation
// over the nine taps, the epilogue of int8_common.cuh, int8 (or bf16) out,
// (N, Ho, Wo, K) with Ho = (H - 1) / stride + 1.
//
// Design: an implicit GEMM. The output pixels are the rows of an (M, K)
// product with M = N * Ho * Wo and a contraction of 9 * C, taken tap by tap:
// for tap (dy, dx) row (n, oy, ox) reads the C-vector of input pixel
// (oy * stride + dy - 1, ox * stride + dx - 1), and a pixel outside the
// image reads as zeros, the SAME halo (zero-point 0 keeps it exact). The
// warp tiles, the operand loads and the epilogue are int8_common.cuh's.
//
// What bounds it on the H100: at layer1's 224x352x64 and the first strided
// conv, 460-580 operations per byte of input and output, about where the
// int8 tensor cores break even (~590, 1,979 TOPS over 3.35 TB/s); from
// layer2's stride-1 convs on, operations (1,152 to 4,608 per byte at
// layer4). Without shared-memory staging every tap re-reads its
// rows through L1/L2, and mma.sync from registers reaches a fraction of
// the int8 peak; wgmma with TMA-fed halo tiles is a later PR's work.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include "int8_common.cuh"

namespace {

using namespace i8;

template <int kStride, bool kRelu, bool kOutBf16, bool kPrecise>
__global__ void __launch_bounds__(kThreads)
    int8_conv3x3_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epilogue ep,
                        int n, int h, int wd, int c, int k, int ho, int wo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane >> 2, quad = lane & 3;
  const int m = n * ho * wo;
  const int row0 = blockIdx.x * kBlockRows + (warp % kWarpsM) * kWarpRows;
  const int col0 = blockIdx.y * kBlockCols + (warp / kWarpsM) * kWarpCols;

  // The top-left input pixel of each row's 3x3 window, and its image.
  const int8_t* image[2][2];
  int iy0[2][2], ix0[2][2];
  bool row_ok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + mt * 16 + hh * 8 + group;
      row_ok[mt][hh] = row < m;
      const int r = row_ok[mt][hh] ? row : 0;
      const int ox = r % wo, oy = (r / wo) % ho, img = r / (wo * ho);
      image[mt][hh] = x + static_cast<size_t>(img) * h * wd * c + quad * 16;
      iy0[mt][hh] = oy * kStride - 1;
      ix0[mt][hh] = ox * kStride - 1;
    }
  const int8_t* b_ptr[4];
  bool b_ok[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + nt * 8 + group;
    b_ok[nt] = col < k;
    b_ptr[nt] = w + static_cast<size_t>(b_ok[nt] ? col : 0) * 9 * c + quad * 16;
  }

  // Contraction step s covers tap s / chunks, bytes (s % chunks) * 64 on.
  const int chunks = c / kChunk;
  auto load = [&](Frags& f, int step, bool on) {
    const int tap = step / chunks, kk = (step - tap * chunks) * kChunk;
    const int dy = tap / 3, dx = tap - dy * 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int iy = iy0[mt][hh] + dy, ix = ix0[mt][hh] + dx;
        const bool ok = on && row_ok[mt][hh] && iy >= 0 && iy < h && ix >= 0 && ix < wd;
        const size_t at = ok ? (static_cast<size_t>(iy) * wd + ix) * c + kk : 0;
        f.a[mt][hh] = load16(image[mt][hh] + at, ok);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      f.b[nt] = load16(b_ptr[nt] + static_cast<size_t>(tap) * c + kk, on && b_ok[nt]);
  };
  Acc acc = {};
  Frags cur, next;
  load(cur, 0, true);
  for (int step = 0; step < 9 * chunks; ++step) {
    load(next, step + 1, step + 1 < 9 * chunks);  // in flight during this step's products
    mma_chunk(acc, cur);
    cur = next;
  }
  const Acc none = {};
  store_tile<kPlain, kRelu, kOutBf16, kPrecise>(acc, none, ep, row0, col0, m, k, lane);
}

struct Args {
  const int8_t *x, *w;
  Epilogue ep;
  int n, h, wd, c, k, ho, wo;
  cudaStream_t stream;
};

template <int kStride>
struct Launch {
  template <bool kRelu, bool kOutBf16, bool kPrecise>
  struct With {
    static cudaError_t run(const Args& a) {
      const int m = a.n * a.ho * a.wo;
      const dim3 grid((m + kBlockRows - 1) / kBlockRows, (a.k + kBlockCols - 1) / kBlockCols);
      int8_conv3x3_kernel<kStride, kRelu, kOutBf16, kPrecise><<<grid, kThreads, 0, a.stream>>>(
          a.x, a.w, a.ep, a.n, a.h, a.wd, a.c, a.k, a.ho, a.wo);
      return cudaGetLastError();
    }
  };
};

}  // namespace

// x: (n, h, w, c) int8; wt: (k, 3, 3, c) int8; scale, bias: (k,) float32;
// out: (n, ho, wo, k) int8 or bf16 with ho = (h - 1) / stride + 1 and
// wo = (w - 1) / stride + 1. stride 1 or 2; c a multiple of 64, k of 8;
// every pointer 16-byte aligned. Returns a cudaError_t as int (0 = launched).
extern "C" int int8_conv3x3(const void* x, const void* wt, const void* scale, const void* bias,
                            void* out, int n, int h, int w, int c, int k, int stride, int relu,
                            int out_bf16, int precise, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0 || c % kChunk || k % 8 ||
      (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(wt);
  a.ep = Epilogue{static_cast<const float*>(scale), static_cast<const float*>(bias), nullptr,
                  nullptr, nullptr, nullptr, out};
  a.n = n;
  a.h = h;
  a.wd = w;
  a.c = c;
  a.k = k;
  a.ho = (h - 1) / stride + 1;
  a.wo = (w - 1) / stride + 1;
  a.stream = static_cast<cudaStream_t>(stream);
  const Flags f{relu != 0, out_bf16 != 0, precise != 0};
  const cudaError_t err = stride == 1 ? dispatch<Launch<1>::With>(f, a)
                                      : dispatch<Launch<2>::With>(f, a);
  return static_cast<int>(err);
}
