// Deterministic float32 sums of the all-Neumann mean (v2d_smooth.cu,
// zc_smooth.cu).
//
// The order is fixed, so a kernel's sum is the same on every run and
// equals the plain PyTorch version of ops/reduce.py:strided_block_sum bit
// for bit: thread t of a grid of G threads adds flat indices t, t+G,
// t+2G, ... in turn, starting from 0.0f; then each block of kSumThreads
// folds its threads' sums in shared memory with strides 512, 256, ..., 1.
#pragma once

#include <cuda_runtime.h>

namespace ndsm {

constexpr int kSumThreads = 1024;

// Thread t's strided sum of x[first + k*stride], k = 0, 1, ... while < n.
__device__ __forceinline__ float strided_sum(const float* x, long long n,
                                             long long first, long long stride) {
  float acc = 0.0f;
  for (long long i = first; i < n; i += stride) acc = acc + x[i];
  return acc;
}

// Tree fold of one block's kSumThreads values; every thread gets the
// block's sum.  `sh` holds kSumThreads floats; the block must have
// exactly kSumThreads threads and every thread must call this.
__device__ __forceinline__ float block_tree_sum(float acc, float* sh) {
  const int t = threadIdx.x;
  sh[t] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  const float total = sh[0];
  __syncthreads();  // sh may be reused by the caller
  return total;
}

// block_tree_sum's fold done by one warp that holds the kSumThreads
// values, slot lane + 32 * j in v[j]: strides 512 .. 32 pair v[j] with
// v[j + 16], .., v[j + 1] in registers, strides 16 .. 1 are shuffles.
// Lane 0 gets the block's sum, bit for bit block_tree_sum's (the same
// pairs in the same order); all 32 lanes must call it.
__device__ __forceinline__ float warp_tree_sum(float (&v)[32]) {
  // constant bounds, so that v stays in registers
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = v[j] + v[j + 16];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = v[j] + v[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + v[j + 4];
  v[0] = v[0] + v[2];
  v[1] = v[1] + v[3];
  v[0] = v[0] + v[1];
  float s = v[0];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, d);
  return s;
}

}  // namespace ndsm
