// Shared pieces of the merge kernels: the op-row layout (the same fields as
// peritext_tpu_torch/ops/kernels.py) and block-wide integer reductions.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace pt {

constexpr int K_KIND = 0;
constexpr int K_CTR = 1;
constexpr int K_ACT = 2;
constexpr int K_REF_CTR = 3;
constexpr int K_REF_ACT = 4;
constexpr int K_PAYLOAD = 5;
constexpr int K_RUN_LEN = 6;
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

}  // namespace pt
