// Mixed-precision outer defect, float64: the Hopper kernel behind ops/df.py.
//
// Replaces ndsm_tpu/ops/pallas_df.py: df_residual_3d (with its zero_rhs
// and update variants).  On the TPU, f64 was software-emulated, so that
// kernel carried u as an f32 (hi, lo) pair with compensated arithmetic.
// Hopper has native f64, so this kernel computes in f64 directly:
//
//   v = u (+ (double)e)                     update variant: v is written out
//   r = rhs - L[v]                          rhs == nullptr: the zero-rhs form
//   r32 = (float)r, zero on Dirichlet faces
//   block_max[b] = max |r32| over block b   reduced by the wrapper
//
// L[v] is ndsm_tpu/ops/stencils.py's poisson_residual order in f64 with
// w = 1/(dq*dq) in f64: per axis ((lo - 2v) + hi) * w, summed z, y, x.
//
// The update writes v to a separate buffer (u_out): neighbours are read as
// u[q] + e[q] from the unmodified u, so no thread can see a neighbour that
// another thread already updated.
//
// What bounds it on the H100: device-memory bandwidth -- 8 (u) + 8 (rhs)
// + 4 (r32) bytes per point, plus 4 (e) + 8 (u_out) for the update; the
// zero-rhs update form the vector-potential solves use moves 24 B/point.
// f64 arithmetic (~190 FLOP/point in the TPU's pair form, ~20 here) is far
// below the H100's f64 rate.  The design streams each array once; the
// neighbour reads hit L1/L2.
//
// defect_sharded_f64 is the same defect on one shard of a level partitioned
// in z, or in z and y (replaces ndsm_tpu/ops/pallas_df.py:
// df_residual_sharded_3d with parts (0,) and (0, 1), its zero_rhs and
// update variants).  u (and e) are the shard's block extended by one halo
// plane a side in z and hy (0 or 1) in y, (nz + 2, ny + 2hy, nx), filled by
// the engine with the neighbours' planes or, at the ends of a line,
// node-mirror planes (z first, then y on the z-extended block, so the
// corners hold the diagonal neighbours' values); rhs and r32 are the real
// block (nz, ny, nx).  The update writes v = u + e over the whole extended
// block (the engine carries it across defect groups), the residual is
// taken over the real points only, whose z and y neighbours on the block's
// edges are halo points, and Dirichlet faces are tested in global z and y
// (z0 + kz - 1 against NZ, y0 + ky - hy against NY).  Over the real block
// r32 equals defect_f64's on the whole level bit for bit: the halo planes
// hold the values the reflection would read.  The z form passes hy = 0,
// y0 = 0, NY = ny.

#include "stencil.cuh"

namespace ndsm {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Block max of |r32| (a: this thread's), NaN-propagating like torch.max.
__device__ __forceinline__ void write_block_max(float a, float* block_max) {
  for (int off = 16; off > 0; off >>= 1)
    a = nan_max(a, __shfl_down_sync(0xffffffffu, a, off));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    block_max[blockIdx.x] = m;
  }
}

__global__ void defect_f64(const double* __restrict__ u,
                           const float* __restrict__ e,
                           double* __restrict__ u_out,
                           const double* __restrict__ rhs,
                           float* __restrict__ r32,
                           float* __restrict__ block_max, int nz, int ny,
                           int nx, int dmask, double wz, double wy, double wx) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float a = 0.0f;
  if (p < (long long)nz * ny * nx) {
    const int x = (int)(p % nx);
    const long long row = p / nx;
    const int y = (int)(row % ny);
    const int z = (int)(row / ny);
    auto v = [&](long long q) { return e ? u[q] + (double)e[q] : u[q]; };
    const double c = v(p);
    if (u_out) u_out[p] = c;
    float rv = 0.0f;
    if (!on_dirichlet_face(z, y, x, nz, ny, nx, dmask)) {
      const Neighbours n = neighbours(z, y, x, nz, ny, nx);
      const double c2 = 2.0 * c;
      double t = ((v(n.zl) - c2) + v(n.zh)) * wz;
      t = t + ((v(n.yl) - c2) + v(n.yh)) * wy;
      t = t + ((v(n.xl) - c2) + v(n.xh)) * wx;
      rv = (float)((rhs ? rhs[p] : 0.0) - t);
    }
    r32[p] = rv;
    a = fabsf(rv);
  }
  write_block_max(a, block_max);
}

__global__ void defect_sharded_f64(const double* __restrict__ u,
                                   const float* __restrict__ e,
                                   double* __restrict__ u_out,
                                   const double* __restrict__ rhs,
                                   float* __restrict__ r32,
                                   float* __restrict__ block_max, int nz,
                                   int ny, int nx, int hy, int z0, int y0,
                                   int NZ, int NY, int dmask, double wz,
                                   double wy, double wx) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nye = ny + 2 * hy;
  float a = 0.0f;
  if (p < (long long)(nz + 2) * nye * nx) {
    const int x = (int)(p % nx);
    const long long row = p / nx;
    const int ky = (int)(row % nye);
    const int kz = (int)(row / nye);
    auto v = [&](long long q) { return e ? u[q] + (double)e[q] : u[q]; };
    const double c = v(p);
    if (u_out) u_out[p] = c;
    if (kz >= 1 && kz <= nz && ky >= hy && ky < ny + hy) {
      const long long rp = ((long long)(kz - 1) * ny + (ky - hy)) * nx + x;
      float rv = 0.0f;
      if (!on_dirichlet_face(z0 + kz - 1, y0 + ky - hy, x, NZ, NY, nx, dmask)) {
        const Neighbours n = neighbours(kz, ky, x, nz + 2, nye, nx);
        const double c2 = 2.0 * c;
        double t = ((v(n.zl) - c2) + v(n.zh)) * wz;
        t = t + ((v(n.yl) - c2) + v(n.yh)) * wy;
        t = t + ((v(n.xl) - c2) + v(n.xh)) * wx;
        rv = (float)((rhs ? rhs[rp] : 0.0) - t);
      }
      r32[rp] = rv;
      a = fabsf(rv);
    }
  }
  write_block_max(a, block_max);
}

}  // namespace ndsm

extern "C" int ndsm_defect_blocks(int nz, int ny, int nx) {
  return (int)ndsm::blocks_for((long long)nz * ny * nx);
}

extern "C" int ndsm_defect_f64(const void* u, const void* e, void* u_out,
                               const void* rhs, void* r32, void* block_max,
                               int nz, int ny, int nx, int dmask, double wz,
                               double wy, double wx, void* stream) {
  const long long n = (long long)nz * ny * nx;
  ndsm::defect_f64<<<ndsm::blocks_for(n), ndsm::kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const double*)u, (const float*)e, (double*)u_out, (const double*)rhs,
      (float*)r32, (float*)block_max, nz, ny, nx, dmask, wz, wy, wx);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_defect_sharded_f64(const void* u, const void* e, void* u_out,
                                       const void* rhs, void* r32, void* block_max,
                                       int nz, int ny, int nx, int hy, int z0, int y0,
                                       int NZ, int NY, int dmask, double wz, double wy,
                                       double wx, void* stream) {
  const long long n = (long long)(nz + 2) * (ny + 2 * hy) * nx;
  ndsm::defect_sharded_f64<<<ndsm::blocks_for(n), ndsm::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const double*)u, (const float*)e, (double*)u_out, (const double*)rhs,
      (float*)r32, (float*)block_max, nz, ny, nx, hy, z0, y0, NZ, NY, dmask, wz, wy,
      wx);
  return (int)cudaGetLastError();
}
