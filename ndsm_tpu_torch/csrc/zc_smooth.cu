// The global mean of the all-Neumann 3D smoother (zc_smooth_mean_3d of
// ops/zc.py), float32: the kernels it adds to the red-black half-sweeps of
// fused_smooth.cu.
//
// Replaces (ndsm_tpu/ops/pallas_zc.py), with fused_smooth.cu's half-sweeps:
//   zc_smooth_mean_3d      -> (all-Neumann) per sweep: a half-sweep out of
//   (+ the JAX engine's       place that subtracts the previous sweep's
//   _t_smooth_zc_mean)        mean on load, one in place, then the two
//                             passes of the mean (sum_partials, sum_final)
//                             into a device scalar; sub_scalar at the end
// The mean adds one read of the level per sweep (4 bytes a point) and
// keeps its scalar on the device: no host read between sweeps.  The sum
// is taken in the fixed order of reduce.cuh (ops/reduce.strided_block_sum).

#include "reduce.cuh"
#include "stencil.cuh"

namespace ndsm {

// First pass of the mean: partials[b] = block b's strided sum of x, over a
// grid of gridDim.x * kSumThreads threads (reduce.cuh).
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const float* __restrict__ x, long long n, float* __restrict__ partials) {
  __shared__ float sh[kSumThreads];
  const long long g = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  const float s = block_tree_sum(
      strided_sum(x, n, g, (long long)gridDim.x * kSumThreads), sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Second pass, one block: out[0] = f32(sum(partials) / divisor), a true
// (correctly rounded) division as in the JAX engine's sum / f32(N).
__global__ void __launch_bounds__(kSumThreads)
sum_final(const float* __restrict__ partials, int nparts, float divisor,
          float* __restrict__ out) {
  __shared__ float sh[kSumThreads];
  const float s = block_tree_sum(strided_sum(partials, nparts, threadIdx.x, kSumThreads), sh);
  if (threadIdx.x == 0) out[0] = __fdiv_rn(s, divisor);
}

// x -= *m in place.
__global__ void sub_scalar(float* x, const float* __restrict__ m, long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) x[p] = x[p] - *m;
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); each returns cudaGetLastError()

extern "C" const char* ndsm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int ndsm_sum_partials_f32(const void* x, long long n, void* partials,
                                     int nblocks, void* stream) {
  ndsm::sum_partials<<<nblocks, ndsm::kSumThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, (float*)partials);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_sum_final_f32(const void* partials, int nparts, float divisor,
                                  void* out, void* stream) {
  ndsm::sum_final<<<1, ndsm::kSumThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, nparts, divisor, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_sub_scalar_f32(void* x, const void* m, long long n, void* stream) {
  ndsm::sub_scalar<<<ndsm::blocks_for(n), ndsm::kThreads, 0, (cudaStream_t)stream>>>(
      (float*)x, (const float*)m, n);
  return (int)cudaGetLastError();
}
