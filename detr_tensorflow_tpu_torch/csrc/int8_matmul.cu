// Fused int8 1x1 convolution (matrix product) with the requantization
// epilogue, for Hopper, CUDA C++.
//
// Replaces the TPU kernel built by `_call` in
// detr_tensorflow_tpu/ops/pallas/int8_matmul.py (bodies `_qmm_kernel`,
// `_qmm_res_kernel`, `_qmm_res2_kernel`), reached through `qmatmul`,
// `qmatmul_residual` and `qmatmul_residual2`: over NHWC activations
// flattened to (M, C),
//   plain:      y = q(relu(x @ W * s + b))                        (conv1)
//   residual:   y = q(relu(x @ W * s + b + res * rs))             (conv3 + identity)
//   residual2:  y = q(relu(x @ W * s + b + xd @ Wd * sd + bd))    (conv3 + downsample)
// int8 x int8 -> int32 products on the tensor cores, the epilogue of
// int8_common.cuh, int8 (or bf16) out. W is K-major: (K, C), row n the
// weights of output channel n.
//
// What bounds it on the H100: bytes. On the DETR-R50 path at 896x1408 the
// products do 2*C*K int8 operations per row against C + K (+ K of the
// residual) bytes, about 60 to 460 operations per byte; the int8 tensor
// cores break even at ~590 (1,979 TOPS over 3.35 TB/s), so the bound of
// every call is its bytes, and layer1's (M = 78,848) weigh most. This first kernel
// reads its operands through L1 without shared-memory staging or TMA, so
// it re-reads x once per 64-column tile of the output; its stores are 2
// bytes per lane. Both are for a later PR (see PERF.md for its times).
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include "int8_common.cuh"

namespace {

using namespace i8;

// The warp tile's contraction over c bytes of x rows and w rows.
__device__ __forceinline__ void contract(Acc& acc, const int8_t* __restrict__ x,
                                         const int8_t* __restrict__ w, int c, int row0, int col0,
                                         int m, int k, int lane) {
  const int group = lane >> 2, quad = lane & 3;
  const int8_t* a_ptr[2][2];
  bool a_ok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mt * 16 + h * 8 + group;
      a_ok[mt][h] = row < m;
      a_ptr[mt][h] = x + static_cast<size_t>(a_ok[mt][h] ? row : 0) * c + quad * 16;
    }
  const int8_t* b_ptr[4];
  bool b_ok[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = col0 + nt * 8 + group;
    b_ok[nt] = col < k;
    b_ptr[nt] = w + static_cast<size_t>(b_ok[nt] ? col : 0) * c + quad * 16;
  }
  auto load = [&](Frags& f, int kk, bool on) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) f.a[mt][h] = load16(a_ptr[mt][h] + kk, on && a_ok[mt][h]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) f.b[nt] = load16(b_ptr[nt] + kk, on && b_ok[nt]);
  };
  Frags cur, next;
  load(cur, 0, true);
  for (int kk = 0; kk < c; kk += kChunk) {
    load(next, kk + kChunk, kk + kChunk < c);  // in flight during this chunk's products
    mma_chunk(acc, cur);
    cur = next;
  }
}

template <int V, bool kRelu, bool kOutBf16, bool kPrecise>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int c,
                       const int8_t* __restrict__ xd, const int8_t* __restrict__ wd, int cd,
                       Epilogue ep, int m, int k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kBlockRows + (warp % kWarpsM) * kWarpRows;
  const int col0 = blockIdx.y * kBlockCols + (warp / kWarpsM) * kWarpCols;
  Acc acc = {};
  Acc accd = {};
  contract(acc, x, w, c, row0, col0, m, k, lane);
  if (V == kResidual2) contract(accd, xd, wd, cd, row0, col0, m, k, lane);
  store_tile<V, kRelu, kOutBf16, kPrecise>(acc, accd, ep, row0, col0, m, k, lane);
}

struct Args {
  const int8_t *x, *w, *xd, *wd;
  Epilogue ep;
  int m, c, k, cd;
  cudaStream_t stream;
};

template <int V>
struct Launch {
  template <bool kRelu, bool kOutBf16, bool kPrecise>
  struct With {
    static cudaError_t run(const Args& a) {
      const dim3 grid((a.m + kBlockRows - 1) / kBlockRows, (a.k + kBlockCols - 1) / kBlockCols);
      int8_matmul_kernel<V, kRelu, kOutBf16, kPrecise><<<grid, kThreads, 0, a.stream>>>(
          a.x, a.w, a.c, a.xd, a.wd, a.cd, a.ep, a.m, a.k);
      return cudaGetLastError();
    }
  };
};

}  // namespace

// x: (m, c) int8; w: (k, c) int8; scale, bias: (k,) float32; out: (m, k)
// int8 or bf16. variant 1 adds res (m, k) int8 times *res_scale (one float
// on the device); variant 2 adds xd (m, cd) int8 @ wd (k, cd)^T times
// scale_d plus bias_d. Every pointer 16-byte aligned; c and cd multiples of
// 64, k a multiple of 8. Returns a cudaError_t as int (0 = launched).
extern "C" int int8_matmul(const void* x, const void* w, const void* scale, const void* bias,
                           const void* res, const void* res_scale, const void* xd,
                           const void* wd, const void* scale_d, const void* bias_d, void* out,
                           int m, int c, int k, int cd, int variant, int relu, int out_bf16,
                           int precise, void* stream) {
  if (m <= 0 || c <= 0 || k <= 0 || c % kChunk || k % 8 || variant < 0 || variant > 2 ||
      (variant == kResidual2 && (cd <= 0 || cd % kChunk)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.xd = static_cast<const int8_t*>(xd);
  a.wd = static_cast<const int8_t*>(wd);
  a.ep = Epilogue{static_cast<const float*>(scale), static_cast<const float*>(bias),
                  static_cast<const int8_t*>(res), static_cast<const float*>(res_scale),
                  static_cast<const float*>(scale_d), static_cast<const float*>(bias_d), out};
  a.m = m;
  a.c = c;
  a.k = k;
  a.cd = cd;
  a.stream = static_cast<cudaStream_t>(stream);
  const Flags f{relu != 0, out_bf16 != 0, precise != 0};
  cudaError_t err;
  if (variant == kPlain)
    err = dispatch<Launch<kPlain>::With>(f, a);
  else if (variant == kResidual)
    err = dispatch<Launch<kResidual>::With>(f, a);
  else
    err = dispatch<Launch<kResidual2>::With>(f, a);
  return static_cast<int>(err);
}
