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
// What bounds it: nothing of the card's throughput. The bytes are the real
// rows' costs (48 problems of <= 30 real rows of 100 columns: ~0.3 MB), and
// the work is latency: staging those rows, five rounds of bids, and the
// augmenting paths, a serial chain of dependent warp reductions and
// shared-memory reads. The point is to keep matching on the device: no
// host round trip and no host sync.
//
// Design: one CTA of sixteen warps per problem (grid = P).
// - Staging: the CTA counts the real rows itself (a ballot a warp, ranks by
//   popcount), so any row mask is legal and the caller needs no host sync,
//   and copies only those rows, compacted, into shared memory with
//   `cp.async`, all in flight at once: 16-byte copies where C is a multiple
//   of 4 and the costs are 16-byte aligned, else 4-byte ones.
// - Auction: a round's bids read only the round's v, so they are
//   independent: the warps take the bidders in turn (one warp a row:
//   its reduced-cost minimum and second minimum over 4 columns a lane), and
//   each bid goes straight to a shared-memory atomicMin on its column; one
//   barrier, then one thread a column settles the claims and one thread a
//   row its dual, and a second barrier ends the round.
// - Augmenting paths: a serial chain, on warp 0 alone, with the column
//   state (v, minv, way, used, p) in registers, 4 columns a lane, and u in
//   shared memory. An argmin is two `redux.sync` minima: one over the
//   value's order-preserving 32-bit key (-0 keyed as +0, so equal values
//   tie), then one over the column among the lanes at that minimum, so the
//   lowest column wins a tie (a shuffle reduction takes 10 shuffles).
//
// Entry point: a plain C function, built with nvcc into a shared library
// and called through ctypes. It launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;  // the auction's bidders spread further (4 and 8 warps: slower on an H100)
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;            // virtual column 0 + up to 127 real ones
constexpr int kSlots = kCols / 32;    // columns per lane
constexpr int kMaxRows = kCols - 1;
constexpr float kInf = 1e9f;          // matcher.py's _INF
constexpr int kAuctionRounds = 5;     // matcher.py's measured convergence point
static_assert(kThreads >= kCols, "one thread a column settles the auction's claims");

// Order-preserving 32-bit key of a float that is not NaN: a < b iff
// key(a) < key(b), and -0 has +0's key, so a == b iff the keys are equal.
__device__ __forceinline__ unsigned key(float f) {
  const unsigned b = __float_as_uint(f + 0.0f);  // -0 + 0 = +0
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// (key, column) minimum over the warp; ties to the lowest column.
__device__ __forceinline__ void warp_argmin(unsigned& k, int& j) {
  const unsigned least = __reduce_min_sync(kFull, k);
  j = static_cast<int>(__reduce_min_sync(kFull, k == least ? static_cast<unsigned>(j) : kFull));
  k = least;
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

__global__ void __launch_bounds__(kThreads)
lap_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ row_mask,
           int* __restrict__ col_of_row, int rows, int cols, int ld) {
  extern __shared__ __align__(16) float cost_s[];  // real rows, compacted, ld floats apart
  __shared__ float u[kMaxRows + 1];   // row potentials, 1-indexed (u[0]: virtual row)
  __shared__ float v_s[kCols];        // column potentials during the auction
  __shared__ int p_s[kCols];          // auction: owner of each column + 1, 0 = free
  __shared__ int owned[kMaxRows];     // auction: column held, or -1
  __shared__ int bid_col[kMaxRows];   // auction: column bid on this round, or -1
  __shared__ float bid_min1[kMaxRows];
  __shared__ float bid_min2[kMaxRows];
  __shared__ int winner[2][kCols];    // auction: lowest bidding row per column, by round parity
  __shared__ int orig[kMaxRows];      // the problem's row of each compacted row
  __shared__ int result[kMaxRows];
  __shared__ int warp_real[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int problem = blockIdx.x;
  const float* c = cost + static_cast<int64_t>(problem) * rows * cols;

  // ---- count and rank the real rows (rows <= 127 < kThreads) ----
  const bool real = tid < rows && row_mask[static_cast<int64_t>(problem) * rows + tid] != 0;
  const unsigned ballot = __ballot_sync(kFull, real);
  if (lane == 0) warp_real[warp] = __popc(ballot);
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_real[w] : 0;
    n += warp_real[w];
  }
  if (real) orig[before + __popc(ballot & ((1u << lane) - 1))] = tid;
  __syncthreads();

  // ---- stage the real rows, every copy in flight at once ----
  if ((cols & 3) == 0 && (reinterpret_cast<uintptr_t>(cost) & 15) == 0) {
    const int quads = cols >> 2;
    for (int e = tid; e < n * quads; e += kThreads) {
      const int k = e / quads, q = e - k * quads;
      cpa::cp_async16(cost_s + k * ld + 4 * q, c + orig[k] * cols + 4 * q, 16);
    }
  } else {
    for (int e = tid; e < n * cols; e += kThreads) {
      const int k = e / cols, q = e - k * cols;
      cpa::cp_async4(cost_s + k * ld + q, c + orig[k] * cols + q, 4);
    }
  }
  cpa::cp_async_commit();
  if (tid < kCols) {
    v_s[tid] = 0.f;
    p_s[tid] = 0;
    winner[0][tid] = INT_MAX;
  }
  if (tid < n) {
    owned[tid] = -1;
    u[tid + 1] = 0.f;
  }
  if (tid == 0) u[0] = 0.f;
  cpa::cp_async_wait<0>();
  __syncthreads();

  // Column j = lane + 32 * s is real iff 1 <= j <= cols.
  bool col_real[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    col_real[s] = j >= 1 && j <= cols;
  }

  // ---- auction pre-pass: rounds of simultaneous bids against the round's v ----
  for (int round = 0; round < kAuctionRounds; ++round) {
    int* win = winner[round & 1];
    float v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) v[s] = v_s[lane + 32 * s];
    for (int k = warp; k < n; k += kWarps) {  // warp-uniform
      if (owned[k] >= 0) {
        if (lane == 0) bid_col[k] = -1;
        continue;
      }
      const float* row = cost_s + k * ld;
      unsigned best = key(INFINITY);
      int best_j = INT_MAX;
      float red[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = lane + 32 * s;
        red[s] = col_real[s] ? row[j - 1] - v[s] : INFINITY;
        if (col_real[s] && key(red[s]) < best) {  // slots ascend in j: strict < keeps the lowest
          best = key(red[s]);
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
      unsigned second = key(INFINITY);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = lane + 32 * s;
        if (col_real[s]) second = min(second, key(j == best_j ? kInf : red[s]));
      }
      second = __reduce_min_sync(kFull, second);
      if (lane == 0) {
        const float min1 = from_key(best), min2 = from_key(second);
        const bool bids = best_j <= cols;  // a row of infinite costs bids on nothing
        bid_col[k] = bids ? best_j : -1;
        bid_min1[k] = min1;
        bid_min2[k] = min2 < 0.5f * kInf ? min2 : min1;
        if (bids) atomicMin(&win[best_j], k);
      }
    }
    __syncthreads();
    // One thread a column: the lowest bidder claims it at v = cost - its
    // second minimum (its new u) and evicts the owner; the next round's
    // winners start empty.
    if (tid < kCols) {
      const int w = win[tid];
      if (w != INT_MAX) {
        v_s[tid] = cost_s[w * ld + tid - 1] - bid_min2[w];
        if (p_s[tid] > 0) owned[p_s[tid] - 1] = -1;
        owned[w] = tid;
        p_s[tid] = w + 1;
      }
      winner[(round + 1) & 1][tid] = INT_MAX;
    }
    // One thread a row: winners take the second minimum, losing bidders the first.
    if (tid < n && bid_col[tid] >= 0)
      u[tid + 1] = win[bid_col[tid]] == tid ? bid_min2[tid] : bid_min1[tid];
    __syncthreads();
  }

  // ---- shortest augmenting paths for the rows the auction left free: warp 0 ----
  if (warp != 0) return;
  float v[kSlots], minv[kSlots];
  int p[kSlots], way[kSlots];
  bool used[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    v[s] = v_s[lane + 32 * s];
    p[s] = p_s[lane + 32 * s];
  }
  for (int k = 0; k < n; ++k) {
    if (owned[k] >= 0) continue;  // uniform
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      minv[s] = kInf;
      way[s] = 0;
      used[s] = false;
    }
    if (lane == 0) p[0] = k + 1;  // the virtual column carries the inserted row
    int j0 = 0, i0 = k + 1;
    bool alive = true;
    while (true) {
      if (lane == (j0 & 31)) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          if (s == (j0 >> 5)) used[s] = true;
      }
      const float u0 = u[i0];
      const float* crow = cost_s + (i0 - 1) * ld;
      unsigned best = key(INFINITY);
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
        const unsigned masked = key(cand ? minv[s] : kInf);
        if (masked < best) {
          best = masked;
          best_j = j;
        }
      }
      warp_argmin(best, best_j);
      const float delta = from_key(best);
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
      if (!alive) break;
      i0 = column_value(p, j0);
      if (i0 == 0) break;  // a free column: the path ends
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

  for (int i = lane; i < rows; i += 32) result[i] = -1;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int j = lane + 32 * s;
    if (col_real[s] && p[s] > 0) result[orig[p[s] - 1]] = j - 1;
  }
  __syncwarp();
  int* out = col_of_row + static_cast<int64_t>(problem) * rows;
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
  // The host does not know how many rows are real: room for all of them,
  // each row padded to 16 bytes.
  const int ld = (cols + 3) & ~3;
  const size_t smem = static_cast<size_t>(rows) * ld * sizeof(float);
  // Up to 40 KB fits beside the ~6 KB of static shared memory in the
  // default 48 KB; above, the kernel is set up once for the most it takes.
  static bool large = false;
  if (smem > 40 * 1024 && !large) {
    const cudaError_t err = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxRows * kCols * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    large = true;
  }
  lap_kernel<<<problems, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const unsigned char*>(row_mask),
      static_cast<int*>(col_of_row), rows, cols, ld);
  return static_cast<int>(cudaGetLastError());
}
