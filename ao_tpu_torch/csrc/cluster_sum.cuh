// A K split summed inside its launch, for the decode kernels of K3
// (int4_w4a8.cu) and of K13's magic form (grouped_matmul.cu).
//
// The S CTAs of a thread-block cluster along grid.z (at most 8: a portable
// cluster) hold partial sums of the same output tile over S ranges of K.
// Value i of the tile is finished by rank i % S: every CTA stores its
// partial of value i into that rank's shared memory (distributed shared
// memory), in the slot of its own rank; after one cluster barrier each rank
// sums its values from its own shared memory, always in rank order, so the
// result does not depend on which CTA finished first: it is the same bit
// for bit from run to run. No workspace in device memory and no second
// launch, where the earlier kernels wrote f32 partials and summed them in a
// second pass.
//
// A CTA may write into a peer's shared memory only once the peer runs: each
// kernel arrives on the cluster barrier when it starts (cluster_started) and
// waits on it just before its stores, which costs nothing by then.

#pragma once

#include <cooperative_groups.h>

namespace {

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Every thread of every CTA of a cluster of more than one CTA, first thing.
__device__ __forceinline__ void cluster_started() { cluster_arrive_relaxed(); }

// v: a thread's NV partials, its slot one of ``slots`` of the CTA; part:
// (NV + 7) * slots floats of the CTA's shared memory. For each value
// i = rank + j S that this CTA finishes, store(i, the sum of value i over
// the ranks in rank order), in the slot's thread. Every thread of every CTA
// of the cluster calls it, after cluster_started; only ``active`` threads
// hold partials.
template <int NV, class Store>
__device__ __forceinline__ void cluster_sum(const float (&v)[NV], float* part, int slot,
                                            int slots, bool active, Store&& store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster_wait();  // every peer runs: its shared memory may be written
  if (active) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      // slot (i / S, rank) of rank i % S
      float* dst = cluster.map_shared_rank(part, i % S);
      dst[((i / S) * S + rank) * slots + slot] = v[i];
    }
  }
  cluster_arrive_release();
  cluster_wait();
  if (!active) return;
  for (int j = 0; rank + j * S < NV; ++j) {
    const float* src = part + j * S * slots + slot;
    float acc = 0.f;
    for (int q = 0; q < S; ++q) acc += src[q * slots];
    store(rank + j * S, acc);
  }
}

// Launch kernel on grid (x, y, S) as clusters of (1, 1, S) CTAs (plainly at S = 1).
template <class... KArgs, class... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, cudaStream_t st,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;  // one CTA along K: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
