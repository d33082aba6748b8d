// Red-black Gauss-Seidel smoother of the 7-point Poisson stencil, float32,
// and its residual: the Hopper kernels behind ops/zc.py.
//
// Replaces (ndsm_tpu/ops/pallas_zc.py):
//   zc_smooth_3d           -> ns sweeps = 2*ns half-sweep launches
//   zc_smooth_residual_3d  -> the same, then one residual launch
//   zc_smooth_cor_3d       -> first half-sweep reads (u + cor) out of
//                             place, the remaining 2*ns-1 run in place
//   zc_smooth_mean_3d      -> (all-Neumann) per sweep: a half-sweep out of
//   (+ the JAX engine's       place that subtracts the previous sweep's
//   _t_smooth_zc_mean)        mean on load, one in place, then the two
//                             passes of the mean (sum_partials, sum_final)
//                             into a device scalar; sub_scalar at the end
// What they compute is the TPU kernels'; their layout is not carried over:
// no z de-interleave, no 128-lane/8-sublane alignment, no padded work
// shapes, no VMEM windows.  Any shape with every extent >= 2 is taken.
//
// What bounds them on the H100: device-memory bandwidth.  A half-sweep
// updates one colour and reads only the other, so it is race-free in
// place.  Each launch touches every 32-byte sector of u (neighbours) and
// rhs (the colour's points are every other float) and writes half of u:
// about 12 bytes per point per half-sweep, 24 per sweep, against 12/ns
// for the TPU's fused multi-sweep pass.  This first design accepts that:
// it is simple, bitwise-checkable against the plain PyTorch sweep, and
// the neighbour reads hit L1/L2.  Temporal blocking (ns sweeps per pass
// over shared-memory tiles with a 2*ns halo) is the later optimisation.
// The mean adds one read of the level per sweep (4 bytes a point) and
// keeps its scalar on the device: no host read between sweeps.

#include "reduce.cuh"
#include "stencil.cuh"

namespace ndsm {

// In-place half-sweep: one thread per point of colour `color`
// ((z+y+x) % 2 == color).  Threads are laid out over (z, y, i) with
// x = 2*i + ((color + y + z) & 1), so no thread idles on the other colour.
__global__ void rb_half_inplace(float* u, const float* __restrict__ rhs,
                                int nz, int ny, int nx, int color, int dmask,
                                float wz, float wy, float wx, float w0) {
  const int hx = (nx + 1) >> 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)nz * ny * hx) return;
  const int i = (int)(idx % hx);
  const long long row = idx / hx;
  const int y = (int)(row % ny);
  const int z = (int)(row / ny);
  const int x = 2 * i + ((color + y + z) & 1);
  if (x >= nx || on_dirichlet_face(z, y, x, nz, ny, nx, dmask)) return;
  const Neighbours n = neighbours(z, y, x, nz, ny, nx);
  const long long p = ((long long)z * ny + y) * nx + x;
  float t = (u[n.zl] + u[n.zh]) * wz;
  t = t + (u[n.yl] + u[n.yh]) * wy;
  t = t + (u[n.xl] + u[n.xh]) * wx;
  u[p] = (t - rhs[p]) * w0;
}

// Out-of-place half-sweep over v = src (+ cor) (- *sub): points of `color`
// off the Dirichlet faces get the update computed from v's neighbours,
// every other point gets v.  One thread per point.  With cor != nullptr
// this is the correction-fused first half-sweep of the V-cycle ascent;
// with sub != nullptr the all-Neumann sweep that first subtracts the
// previous sweep's mean (both on load, in the same float32 arithmetic as
// the plain `u + cor` and `u - m`).
__global__ void rb_half_oop(const float* __restrict__ src,
                            const float* __restrict__ cor,
                            const float* __restrict__ sub,
                            const float* __restrict__ rhs,
                            float* __restrict__ dst, int nz, int ny, int nx,
                            int color, int dmask, float wz, float wy, float wx,
                            float w0) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)nz * ny * nx) return;
  const int x = (int)(p % nx);
  const long long row = p / nx;
  const int y = (int)(row % ny);
  const int z = (int)(row / ny);
  const float m = sub ? *sub : 0.0f;
  auto v = [&](long long q) {
    const float a = cor ? src[q] + cor[q] : src[q];
    return sub ? a - m : a;
  };
  if (((z + y + x) & 1) != color || on_dirichlet_face(z, y, x, nz, ny, nx, dmask)) {
    dst[p] = v(p);
    return;
  }
  const Neighbours n = neighbours(z, y, x, nz, ny, nx);
  float t = (v(n.zl) + v(n.zh)) * wz;
  t = t + (v(n.yl) + v(n.yh)) * wy;
  t = t + (v(n.xl) + v(n.xh)) * wx;
  dst[p] = (t - rhs[p]) * w0;
}

// r = rhs - L[u], zero on Dirichlet faces; per axis (lo - 2u + hi) * w,
// summed z, y, x (ndsm_tpu/ops/stencils.py: poisson_residual).
__global__ void residual_f32(const float* __restrict__ u,
                             const float* __restrict__ rhs,
                             float* __restrict__ r, int nz, int ny, int nx,
                             int dmask, float wz, float wy, float wx) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)nz * ny * nx) return;
  const int x = (int)(p % nx);
  const long long row = p / nx;
  const int y = (int)(row % ny);
  const int z = (int)(row / ny);
  if (on_dirichlet_face(z, y, x, nz, ny, nx, dmask)) {
    r[p] = 0.0f;
    return;
  }
  const Neighbours n = neighbours(z, y, x, nz, ny, nx);
  const float c2 = 2.0f * u[p];
  float t = ((u[n.zl] - c2) + u[n.zh]) * wz;
  t = t + ((u[n.yl] - c2) + u[n.yh]) * wy;
  t = t + ((u[n.xl] - c2) + u[n.xh]) * wx;
  r[p] = rhs[p] - t;
}

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

extern "C" int ndsm_rb_half_inplace_f32(void* u, const void* rhs, int nz, int ny,
                                        int nx, int color, int dmask, float wz,
                                        float wy, float wx, float w0,
                                        void* stream) {
  const long long n = (long long)nz * ny * ((nx + 1) / 2);
  ndsm::rb_half_inplace<<<ndsm::blocks_for(n), ndsm::kThreads, 0,
                          (cudaStream_t)stream>>>(
      (float*)u, (const float*)rhs, nz, ny, nx, color, dmask, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_rb_half_oop_f32(const void* src, const void* cor,
                                    const void* sub, const void* rhs, void* dst,
                                    int nz, int ny, int nx, int color, int dmask,
                                    float wz, float wy, float wx, float w0,
                                    void* stream) {
  const long long n = (long long)nz * ny * nx;
  ndsm::rb_half_oop<<<ndsm::blocks_for(n), ndsm::kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)src, (const float*)cor, (const float*)sub,
      (const float*)rhs, (float*)dst, nz, ny, nx, color, dmask, wz, wy, wx, w0);
  return (int)cudaGetLastError();
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

extern "C" int ndsm_residual_f32(const void* u, const void* rhs, void* r, int nz,
                                 int ny, int nx, int dmask, float wz, float wy,
                                 float wx, void* stream) {
  const long long n = (long long)nz * ny * nx;
  ndsm::residual_f32<<<ndsm::blocks_for(n), ndsm::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)u, (const float*)rhs, (float*)r, nz, ny, nx, dmask, wz, wy,
      wx);
  return (int)cudaGetLastError();
}
