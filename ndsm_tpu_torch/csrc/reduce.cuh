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

}  // namespace ndsm
