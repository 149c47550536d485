// Batched exact linear assignment (Jonker-Volgenant) for Hopper, CUDA C++.
//
// Replaces the TPU kernel `_lap_kernel` (launched by
// `solve_lap_masked_pallas`) of detr_tensorflow_tpu/ops/pallas/lap.py and
// solves the same problems as `solve_lap_masked` in
// detr_tensorflow_tpu/ops/matcher.py: for each of P independent problems,
// a cost matrix (R rows = padded target slots, C columns = queries,
// R <= C <= 127) and a row mask; every real row gets a distinct column so
// that the summed cost over real rows is minimal. Masked rows are skipped
// and come back as -1.
//
// The algorithm is matcher.py's: a five-round auction pre-pass (every
// unassigned real row bids on its reduced-cost argmin column at dual
// u = second minimum, the lowest bidding row wins a column and evicts its
// owner, v moves only on claimed columns), then the shortest augmenting
// path (Dijkstra on reduced costs, 1-indexed rows and columns with a
// virtual column 0) for the rows the auction left unassigned, in row
// order. Ties go to the lowest column and, in the auction, to the lowest
// row, as matcher.py's argmin/min do; both solvers are exact, so they
// give the same assignment whenever the optimum is unique, and the same
// optimal cost always.
//
// What bounds it: nothing of the card's throughput. The work is a serial
// chain of O(n_real) augmentations of O(C) relaxations each, a few
// microseconds of dependent shuffles and shared-memory reads per problem.
// On the TPU, Mosaic ran the grid steps one after another, and the kernel
// lost to the vmapped XLA solver (lap.py's docstring); on the GPU the
// problems run side by side, one per SM, and the point is to keep the
// matching on the device: no host round trip and no host sync.
//
// Design: one warp per problem (one CTA of 32 threads, grid = P). The
// 128 columns (virtual + up to 127 real) are spread 4 per lane
// (column j on lane j % 32, slot j / 32); the column state v, minv, way,
// used, p lives in registers, an argmin is a 5-step shuffle reduction
// on (value, column), and the problem's cost rows and row potentials u
// sit in shared memory. The kernel counts the real rows from the mask
// itself, so the caller needs no host sync.
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 128;            // virtual column 0 + up to 127 real ones
constexpr int kSlots = kCols / 32;    // columns per lane
constexpr int kMaxRows = kCols - 1;
constexpr float kInf = 1e9f;          // matcher.py's _INF
constexpr int kAuctionRounds = 5;     // matcher.py's measured convergence point

// (value, column) minimum over the warp; ties to the lowest column.
__device__ __forceinline__ void warp_argmin(float& value, int& index) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, value, off);
    const int oi = __shfl_xor_sync(kFull, index, off);
    if (ov < value || (ov == value && oi < index)) {
      value = ov;
      index = oi;
    }
  }
}

__device__ __forceinline__ float warp_min(float value) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) value = fminf(value, __shfl_xor_sync(kFull, value, off));
  return value;
}

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kSlots], int slot) {
  T out = a[0];
#pragma unroll
  for (int s = 1; s < kSlots; ++s)
    if (s == slot) out = a[s];
  return out;
}

// a[j] of the warp's column array, broadcast to every lane.
template <typename T>
__device__ __forceinline__ T column_value(const T (&a)[kSlots], int j) {
  return __shfl_sync(kFull, pick(a, j >> 5), j & 31);
}

__global__ void __launch_bounds__(32)
lap_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_mask,
           int* __restrict__ col_of_row, int rows, int cols) {
  extern __shared__ float cost_s[];  // rows * cols
  __shared__ float u[kMaxRows + 1];  // row potentials, 1-indexed (u[0]: virtual row)
  __shared__ float bid_min1[kMaxRows];
  __shared__ float bid_min2[kMaxRows];
  __shared__ int bid_col[kMaxRows];     // auction: column bid on this round, or -1
  __shared__ int owned_col[kMaxRows];   // auction: column held, or -1
  __shared__ int winner[kCols];         // auction: lowest bidding row per column
  __shared__ int result[kMaxRows];
  __shared__ unsigned char real[kMaxRows];

  const int lane = threadIdx.x;
  const long problem = blockIdx.x;
  const float* c = cost + problem * rows * cols;
  const unsigned char* rm = row_mask + problem * rows;

  for (int e = lane; e < rows * cols; e += 32) cost_s[e] = c[e];
  for (int i = lane; i < rows; i += 32) {
    real[i] = rm[i] != 0;
    owned_col[i] = -1;
    result[i] = -1;
    u[i + 1] = 0.f;
  }
  if (lane == 0) u[0] = 0.f;

  // Column state; column j = lane + 32 * s is real iff 1 <= j <= cols.
  float v[kSlots], minv[kSlots];
  int p[kSlots], way[kSlots];
  bool used[kSlots], col_real[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    col_real[s] = j >= 1 && j <= cols;
    v[s] = 0.f;
    p[s] = 0;
  }
  __syncwarp();

  // ---- auction pre-pass: rounds of simultaneous bids against the round's v ----
  for (int round = 0; round < kAuctionRounds; ++round) {
    for (int i = 0; i < rows; ++i) {  // uniform: every lane reads the same flags
      const bool bidder = real[i] && owned_col[i] < 0;
      if (!bidder) {
        if (lane == 0) bid_col[i] = -1;
        continue;
      }
      const float* row = cost_s + i * cols;
      float best = INFINITY;
      int best_j = INT_MAX;
      float red[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = lane + 32 * s;
        red[s] = col_real[s] ? row[j - 1] - v[s] : INFINITY;
        if (red[s] < best) {  // slots ascend in j: strict < keeps the lowest
          best = red[s];
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
      float second = INFINITY;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = lane + 32 * s;
        if (col_real[s]) second = fminf(second, j == best_j ? kInf : red[s]);
      }
      second = warp_min(second);
      if (lane == 0) {
        bid_col[i] = best_j;
        bid_min1[i] = best;
        bid_min2[i] = second < 0.5f * kInf ? second : best;
      }
    }
    for (int j = lane; j < kCols; j += 32) winner[j] = INT_MAX;
    __syncwarp();
    for (int i = lane; i < rows; i += 32)
      if (bid_col[i] >= 0) atomicMin(&winner[bid_col[i]], i);
    __syncwarp();
    // Winners take the second minimum, losing bidders the first.
    for (int i = lane; i < rows; i += 32)
      if (bid_col[i] >= 0) u[i + 1] = winner[bid_col[i]] == i ? bid_min2[i] : bid_min1[i];
    __syncwarp();
    // Claimed columns: v = cost[w, j] - u[w]; the winner evicts the owner.
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int j = lane + 32 * s;
      const int w = col_real[s] ? winner[j] : INT_MAX;
      if (w != INT_MAX) {
        v[s] = cost_s[w * cols + j - 1] - u[w + 1];
        if (p[s] > 0) owned_col[p[s] - 1] = -1;
        owned_col[w] = j;
        p[s] = w + 1;
      }
    }
    __syncwarp();
  }

  // ---- shortest augmenting paths for the rows the auction left free ----
  for (int i = 0; i < rows; ++i) {
    if (!real[i] || owned_col[i] >= 0) continue;  // uniform
    const int row = i + 1;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      minv[s] = kInf;
      way[s] = 0;
      used[s] = false;
    }
    if (lane == 0) p[0] = row;  // the virtual column carries the inserted row
    int j0 = 0;
    bool alive = true;
    while (true) {
      if (lane == (j0 & 31)) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          if (s == (j0 >> 5)) used[s] = true;
      }
      const int i0 = column_value(p, j0);
      const float u0 = u[i0];
      const float* crow = cost_s + (i0 - 1) * cols;
      float best = INFINITY;
      int best_j = INT_MAX;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = lane + 32 * s;
        if (j > cols) continue;  // no such column
        const bool cand = col_real[s] && !used[s];
        if (cand) {
          const float cur = crow[j - 1] - u0 - v[s];
          if (cur < minv[s]) {
            minv[s] = cur;
            way[s] = j0;
          }
        }
        const float masked = cand ? minv[s] : kInf;
        if (masked < best) {
          best = masked;
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
      const float delta = best;
      __syncwarp();  // every lane has read u[i0] before it changes
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (used[s]) {
          u[p[s]] += delta;  // the rows of used columns are distinct
          v[s] -= delta;
        } else {
          minv[s] -= delta;
        }
      }
      __syncwarp();
      j0 = best_j;
      alive = delta < 0.5f * kInf;
      if (!alive || column_value(p, j0) == 0) break;
    }
    // Augment: relink p back along the predecessor chain to column 0.
    while (alive && j0 != 0) {
      const int j1 = column_value(way, j0);
      const int pj1 = column_value(p, j1);
      if (lane == (j0 & 31)) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          if (s == (j0 >> 5)) p[s] = pj1;
      }
      j0 = j1;
    }
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (col_real[s] && p[s] > 0) result[p[s] - 1] = j - 1;
  }
  __syncwarp();
  int* out = col_of_row + problem * rows;
  for (int i = lane; i < rows; i += 32) out[i] = result[i];
}

}  // namespace

// cost: (problems, rows, cols) float32; row_mask: (problems, rows) bytes,
// nonzero = real row; col_of_row: (problems, rows) int32 out, the column
// of each real row and -1 for masked rows. rows <= cols <= 127. Returns a
// cudaError_t as int (0 = launched).
extern "C" int lap_solve(const void* cost, const void* row_mask, void* col_of_row,
                         int problems, int rows, int cols, void* stream) {
  if (problems <= 0 || rows <= 0 || cols <= 0 || rows > cols || cols > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rows) * cols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lap_kernel<<<problems, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const unsigned char*>(row_mask),
      static_cast<int*>(col_of_row), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
