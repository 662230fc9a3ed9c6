// Shared pieces of the merge kernels: the op-row layout (the same fields as
// peritext_tpu_torch/ops/kernels.py), block-wide integer reductions and the
// cluster-wide one of the kernels' cluster forms.
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace pt {

constexpr int K_KIND = 0;
constexpr int K_CTR = 1;
constexpr int K_ACT = 2;
constexpr int K_REF_CTR = 3;
constexpr int K_REF_ACT = 4;
constexpr int K_PAYLOAD = 5;
constexpr int K_RUN_LEN = 6;  // insert runs; mark rows hold K_MACTION there
constexpr int K_MACTION = 6;
constexpr int K_MTYPE = 7;
constexpr int K_MATTR = 8;
constexpr int K_SKIND = 9;
constexpr int K_SCTR = 10;
constexpr int K_SACT = 11;
constexpr int K_EKIND = 12;
constexpr int K_ECTR = 13;
constexpr int K_EACT = 14;
constexpr int OP_FIELDS = 15;

constexpr int KIND_INSERT = 1;
constexpr int KIND_DELETE = 2;
constexpr int KIND_MARK = 3;
constexpr int KIND_INSERT_RUN = 4;
constexpr int MAX_RUN_LEN = 64;

// Threads per block of the mark kernel (a multiple of 32, at most 1024);
// the text kernel takes its block size from the launch.
constexpr int THREADS = 512;
// Shared ints each block keeps for the reductions below.
constexpr int SCRATCH_INTS = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Block-wide min of two ints at once; every thread gets both results.
// Two barriers: one publishes the per-warp partials, the second keeps the
// scratch words from being reused before every warp has read them.
__device__ __forceinline__ void block_min2(int& a, int& b, int* scratch) {
  const unsigned full = 0xffffffffu;
  a = __reduce_min_sync(full, a);
  b = __reduce_min_sync(full, b);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  a = __reduce_min_sync(full, lane < nwarps ? scratch[lane] : INT_MAX);
  b = __reduce_min_sync(full, lane < nwarps ? scratch[32 + lane] : INT_MAX);
  __syncthreads();
}

__device__ __forceinline__ int block_min(int a, int* scratch) {
  int b = INT_MAX;
  block_min2(a, b, scratch);
  return a;
}

// Block-wide max of two ints at once (as the min of their negations; the
// values are slot indices >= -1, so negation cannot overflow).
__device__ __forceinline__ void block_max2(int& a, int& b, int* scratch) {
  a = -a;
  b = -b;
  block_min2(a, b, scratch);
  a = -a;
  b = -b;
}

// Blocks a replica may span in the kernels' cluster forms (the portable
// cluster size).
constexpr int MAX_CLUSTER = 8;

// Cluster-wide min of two ints, each already uniform within its block:
// thread s of every block writes the block's pair into slot [rank] of block
// s's ``slots`` ([MAX_CLUSTER][2] ints, distributed shared memory), then one
// cluster barrier; every thread gets both results.  The caller guarantees
// another cluster barrier before the same ``slots`` are written again.
__device__ __forceinline__ void cluster_min2(int& a, int& b, int* slots) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned n = cluster.num_blocks();
  if (threadIdx.x < n) {
    int* dst = cluster.map_shared_rank(slots, threadIdx.x);
    const unsigned rank = cluster.block_rank();
    dst[2 * rank] = a;
    dst[2 * rank + 1] = b;
  }
  cluster.sync();
  a = INT_MAX;
  b = INT_MAX;
  for (unsigned s = 0; s < n; ++s) {
    a = min(a, slots[2 * s]);
    b = min(b, slots[2 * s + 1]);
  }
}

// The launch configuration of a kernel's cluster form: ``replicas``
// clusters of ``blocks`` blocks (grid R * S, cluster S x 1 x 1).  The
// configuration points at the attribute held beside it, so it is used in
// place, never copied.
struct ClusterLaunch {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1] = {};
  ClusterLaunch(int replicas, int blocks, int threads, size_t smem, cudaStream_t stream) {
    config.gridDim = dim3(static_cast<unsigned>(replicas) * blocks);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

}  // namespace pt
