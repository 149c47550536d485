// What the two tensor-core fused bottleneck kernels share, E-mma (bf16,
// fused_bottleneck_mma.cu) and E-tf32 (fp32, fused_bottleneck_tf32.cu): the
// CTA size, the `cp.async` ring that streams a product's chunks, and the
// thread-block-cluster barriers and slice exchange.
//
// Cluster protocol (K CTAs a cluster, K > 1): every CTA arrives on the
// cluster barrier when it starts (`cluster_arrive_relaxed`) and waits on it
// (`cluster_wait`) before its first remote store, so no CTA writes into a
// CTA that has not started. A rank computes its slice of a buffer (columns
// rank NK.., which no other rank writes), then `push_slice` copies it into
// the same place in every other rank's buffer, and `cluster_sync` (release /
// acquire) makes all slices visible everywhere. No CTA reads another's
// shared memory, so none waits on another to exit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace fbc {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // chunks in the cp.async ring
constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA can have

constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Every CTA of the cluster has arrived; its earlier stores (to any CTA's
// shared memory) are visible to the waiting threads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// n chunks through the ring: load(i, stage) starts chunk i's copies,
// compute(i, stage) consumes them. Chunk i + 2 loads while chunk i is
// multiplied; one barrier a chunk (the stage refilled at iteration i was
// read at i - 1, which every warp finished before the barrier).
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int n, Load&& load, Compute&& compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, s);
    cpa::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cpa::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < n) load(next, next % kStages);
    cpa::cp_async_commit();
    compute(i, i % kStages);
  }
  __syncthreads();  // the ring is free for the next product
}

// Rank `rank`'s slice (columns rank P::NK.., rows 0..rows-1, row stride
// P::LD) of buf into the same place in every other rank of the P::K,
// 16 bytes a copy.
template <class P, class T>
__device__ __forceinline__ void push_slice(T* buf, int rows, int rank) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  constexpr int kVec = P::NK / kPer;
  cg::cluster_group cluster = cg::this_cluster();
  T* remote[P::K - 1];
#pragma unroll
  for (int d = 1; d < P::K; ++d) remote[d - 1] = cluster.map_shared_rank(buf, (rank + d) % P::K);
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int off = (i / kVec) * P::LD + rank * P::NK + kPer * (i % kVec);
    const uint4 v = *reinterpret_cast<const uint4*>(buf + off);
#pragma unroll
    for (int d = 0; d < P::K - 1; ++d) *reinterpret_cast<uint4*>(remote[d] + off) = v;
  }
}

}  // namespace fbc
