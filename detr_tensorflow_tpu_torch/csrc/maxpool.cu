// 3x3, stride 2, pad 1 max pool of the ResNet stem, for Hopper, CUDA C++.
//
// Replaces the TPU kernel `_kernel` (launched by `max_pool_3x3_s2_pallas`)
// of detr_tensorflow_tpu/ops/pallas/maxpool.py: out[b, i, j, c] = the
// maximum of x[b, 2i-1 .. 2i+1, 2j-1 .. 2j+1, c] over the taps inside the
// image, float32 or bf16, (B, H, W, C) -> (B, (H-1)/2+1, (W-1)/2+1, C) in
// memory (the port's NCHW tensors in channels_last, as its backbone holds
// them), any B, H, W and C.
//
// The TPU kernel pads with zeros, which equals the -inf padding of
// F.max_pool2d only for x >= 0 (the stem's post-ReLU input). This kernel
// skips the taps outside the image instead, so it equals F.max_pool2d
// bit for bit on any input: it visits the taps in row-major order, starting
// from -inf, and takes a tap that is greater or NaN, which is ATen's rule
// (the first maximum wins a tie, so -0 and +0 come out as ATen's do; NaN
// propagates). Every window holds its centre tap, which lies in the image.
// bf16 values are compared as floats and rounded back as ATen's CUDA pool
// rounds them (exact for every value, the canonical NaN for a NaN).
//
// What bounds it on the H100: bytes. It must read each input once and
// write each output once: at the stem of the 896x1408 bucket 80.7 MB in
// and 20.2 MB out in fp32, 30 us at 3.35 TB/s (15 us in bf16). One thread
// an element, with its index divisions and nine 2- or 4-byte loads, issues
// more instructions than those bytes leave time for: bf16 would take as
// long as fp32.
//
// Design: a thread owns 16 bytes of channels of one output pixel (4 fp32
// or 8 bf16 values; neighbouring threads hold neighbouring channel groups,
// so a warp's loads are runs of whole 32-byte sectors) and walks a run of
// RUN output columns of ROWS (1) output rows. Loads are 16-byte read-only
// vector loads, kept packed in registers until compared; stores are
// 16-byte stores. The window's last input column (2j+1) is the next
// window's first, so the thread keeps it in registers: each output costs 2
// new input columns of 3 rows, not 3 of 3. The work index is 32-bit, from
// a 1-D grid over (image and row block, column run, channel group),
// decomposed once per thread; the loop has no division. RUN is 4, 8 or 16:
// the launch takes the shortest whose grid the card holds in one wave
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Where C * size is not a
// multiple of 16 bytes, or x or y is not 16-byte aligned, the same kernel
// runs with one element a thread (the scalar channel path, RUN 8).
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int ROWS = 1;  // output rows a thread takes (2 reads 5 input rows for 2, not 6: slower)

// What a thread loads at once, kept as loaded (unpacked only to compare,
// which holds bf16 registers to half): V = 1 element's bits (fp32 as
// uint32_t, bf16 as uint16_t), or 16 bytes.
template <typename U, int V>
using Raw = std::conditional_t<V == 1, U, uint4>;

template <typename U, int V>
__device__ __forceinline__ Raw<U, V> load(const U* p) {
  if constexpr (V == 1) {
    return __ldg(p);
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// Element e of a load, as a float.
template <typename U, int V>
__device__ __forceinline__ float element(const Raw<U, V>& r, int e) {
  if constexpr (V == 1) {
    return __uint_as_float(sizeof(U) == 4 ? r : static_cast<uint32_t>(r) << 16);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(U) == 4) return __uint_as_float(w[e]);
    return __uint_as_float(e & 1 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);  // lower one first
  }
}

template <typename U, int V>
__device__ __forceinline__ void store(U* p, const float (&v)[V]) {
  if constexpr (sizeof(U) == 4) {
    if constexpr (V == 1) {
      *p = __float_as_uint(v[0]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                                __float_as_uint(v[2]), __float_as_uint(v[3]));
    }
  } else if constexpr (V == 1) {
    *p = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ATen's step: take the tap if it is greater or NaN.
template <typename U, int V>
__device__ __forceinline__ void fold(float (&best)[V], const Raw<U, V>& tap) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float t = element<U, V>(tap, e);
    if (t > best[e] || t != t) best[e] = t;
  }
}

// U: the element's bits; V: elements a thread (16 bytes, or 1); RUN: output
// columns a thread walks.
template <typename U, int V, int RUN>
__global__ void __launch_bounds__(kThreads)
    max_pool_3x3_s2_kernel(const U* __restrict__ x, U* __restrict__ y, int h, int w, int c,
                           int ho, int wo, int row_blocks, int runs, unsigned work,
                           unsigned first_block) {
  constexpr int NR = 2 * ROWS + 1;  // input rows of a row block
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= work) return;
  const int groups = c / V;
  const int g = t % groups;
  const unsigned rest = t / groups;
  const int run = rest % runs;
  const unsigned block = first_block + rest / runs;  // image * row_blocks + row block
  const int b = block / row_blocks;
  const int i0 = (block % row_blocks) * ROWS;  // first output row
  const int j0 = run * RUN;                    // first output column

  // Row q of the block is input row 2 * i0 - 1 + q.
  const U* rows[NR];
  bool valid[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int r = 2 * i0 - 1 + q;
    valid[q] = r >= 0 && r < h;
    rows[q] = x + (static_cast<int64_t>(b) * h + (valid[q] ? r : 0)) * w * c + g * V;
  }
  U* out[ROWS];
#pragma unroll
  for (int o = 0; o < ROWS; ++o)
    out[o] = y + (static_cast<int64_t>(b) * ho + i0 + o) * wo * c + g * V;

  // Column 2j - 1 of the window at j, carried from the last window.
  Raw<U, V> prev[NR];
  if (j0 > 0) {
#pragma unroll
    for (int q = 0; q < NR; ++q)
      if (valid[q]) prev[q] = load<U, V>(rows[q] + (2 * j0 - 1) * c);
  }
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const int j = j0 + k;
    if (j >= wo) break;
    const bool left = j > 0, right = 2 * j + 1 < w;
    Raw<U, V> mid[NR], last[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (!valid[q]) continue;
      mid[q] = load<U, V>(rows[q] + 2 * j * c);
      if (right) last[q] = load<U, V>(rows[q] + (2 * j + 1) * c);
    }
#pragma unroll
    for (int o = 0; o < ROWS; ++o) {
      if (i0 + o >= ho) break;
      float best[V];
#pragma unroll
      for (int e = 0; e < V; ++e) best[e] = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int q = 2 * o + dy;
        if (!valid[q]) continue;
        if (left) fold<U, V>(best, prev[q]);
        fold<U, V>(best, mid[q]);
        if (right) fold<U, V>(best, last[q]);
      }
      store<U, V>(out[o] + j * c, best);
    }
#pragma unroll
    for (int q = 0; q < NR; ++q) prev[q] = last[q];
  }
}

template <typename U, int V, int RUN>
int64_t grid_blocks(int batch, int h, int w, int c) {
  const int64_t ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  return (batch * ((ho + ROWS - 1) / ROWS) * ((wo + RUN - 1) / RUN) * (c / V) + kThreads - 1) /
         kThreads;
}

// The CTAs of max_pool_3x3_s2_kernel<U, V, RUN> the current device holds at
// once, queried once a process and device (0 if the query failed; the error
// is left for the launch's cudaGetLastError).
template <typename U, int V, int RUN>
int resident_blocks() {
  static int blocks[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 0;
  if (blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, max_pool_3x3_s2_kernel<U, V, RUN>, kThreads, 0) == cudaSuccess)
      blocks[device] = sms * per_sm;
  }
  return blocks[device];
}

template <typename U, int V, int RUN>
bool one_wave(int batch, int h, int w, int c) {
  return grid_blocks<U, V, RUN>(batch, h, w, c) <= resident_blocks<U, V, RUN>();
}

template <typename U, int V, int RUN>
cudaError_t launch_run(const void* x, void* y, int batch, int h, int w, int c,
                       cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const int row_blocks = (ho + ROWS - 1) / ROWS, runs = (wo + RUN - 1) / RUN;
  const int64_t per_block = static_cast<int64_t>(runs) * (c / V);
  const int64_t blocks = static_cast<int64_t>(batch) * row_blocks;
  // Launches of at most 2^31 threads each, so the work index stays 32-bit.
  const int64_t chunk = (int64_t{1} << 31) / per_block > 0 ? (int64_t{1} << 31) / per_block : 1;
  for (int64_t first = 0; first < blocks; first += chunk) {
    const int64_t n = blocks - first < chunk ? blocks - first : chunk;
    const unsigned work = static_cast<unsigned>(n * per_block);
    max_pool_3x3_s2_kernel<U, V, RUN><<<(work + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const U*>(x), static_cast<U*>(y), h, w, c, ho, wo, row_blocks, runs, work,
        static_cast<unsigned>(first));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename U>
cudaError_t launch(const void* x, void* y, int batch, int h, int w, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(U);
  const bool vector = (c * sizeof(U)) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (!vector) return launch_run<U, 1, 8>(x, y, batch, h, w, c, stream);
  // The shortest run whose grid the card holds in one wave, else the
  // longest: a second, part-filled wave of threads that each stream a run
  // costs more than fewer, longer threads.
  const int run = one_wave<U, V, 4>(batch, h, w, c)   ? 4
                  : one_wave<U, V, 8>(batch, h, w, c) ? 8
                                                      : 16;
  if (run == 4) return launch_run<U, V, 4>(x, y, batch, h, w, c, stream);
  if (run == 8) return launch_run<U, V, 8>(x, y, batch, h, w, c, stream);
  return launch_run<U, V, 16>(x, y, batch, h, w, c, stream);
}

}  // namespace

// x: (batch, h, w, c) contiguous; y: (batch, (h-1)/2+1, (w-1)/2+1, c).
// bf16 != 0 selects bf16 elements, else float32. Returns a cudaError_t as
// int (0 = launched).
extern "C" int max_pool_3x3_s2(const void* x, void* y, int batch, int h, int w, int c, int bf16,
                               void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<uint16_t>(x, y, batch, h, w, c, s)
                               : launch<uint32_t>(x, y, batch, h, w, c, s);
  return static_cast<int>(err);
}
