// Red-black sweeps of one shard of a z-partitioned level, float32, on its
// halo-extended block, and the residual of the swept state over the real
// block: the Hopper kernels behind ops/zc_sharded.py.
//
// Replaces ndsm_tpu/ops/pallas_zc.py: zc_smooth_sharded_3d (its plain and
// residual forms; ext_out, halo_args and ext_y are layouts of the TPU's
// DMA windows and the 2-D mesh, not ported here).
//
// The block is (nze, ny, nx) = (nz + 2H, ny, nx): the shard's nz real
// planes with H halo planes on each side, filled by the engine with the
// neighbours' planes, or node-mirror planes at the ends of the chain
// (parallel/collectives.py).  Plane kz of the block is global plane
// zg0 + kz, zg0 = z0 - H.  Every half-sweep runs over the whole block:
//
//   colour    (gz + y + x) % 2 against the global first colour, so the
//             parity is that of the whole level, whatever z0 and H are;
//   frozen    the points of the level's Dirichlet faces, tested in global
//             z (gz == 0, gz == NZ - 1) and in local y and x;
//   edges     y and x as the unsharded sweep (index reflection); z
//             reflected at the ends of the block, whose planes go wrong
//             one plane a half-sweep -- after 2*ns half-sweeps the real
//             planes are still right when H >= 2*ns (and the residual's
//             neighbours too when H >= 2*ns + 1).
//
// So the real planes equal the unsharded zc_smooth_3d's bit for bit: each
// of their points sees the same operands in the same order (the mirror
// planes carry the reflected values, with the same colour).  The update
// and residual expressions are those of fused_smooth.cu.
//
// What bounds it on the H100: device-memory bandwidth, as fused_smooth.cu:
// about 12 bytes a point a half-sweep, over nz + 2H planes instead of nz.
// This first design is one launch a half-sweep, the first out of place
// into a new block, the rest in place on it; no temporal blocking, no
// halo DMA, no window logic, any shape and offset.

#include "stencil.cuh"

namespace ndsm {

template <typename I>
__global__ void shard_half_oop(const float* __restrict__ src,
                               const float* __restrict__ rhs,
                               float* __restrict__ dst, int nze, int ny,
                               int nx, int zg0, int NZ, int color, int dmask,
                               float wz, float wy, float wx, float w0) {
  const I p = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (I)nze * (I)ny * (I)nx) return;
  const int x = (int)(p % (I)nx);
  const I row = p / (I)nx;
  const int y = (int)(row % (I)ny);
  const int z = (int)(row / (I)ny);
  const int gz = zg0 + z;
  if (((gz + y + x) & 1) != color ||
      on_dirichlet_face(gz, y, x, NZ, ny, nx, dmask)) {
    dst[p] = src[p];
    return;
  }
  const Neighbours n = neighbours(z, y, x, nze, ny, nx);
  float t = (src[n.zl] + src[n.zh]) * wz;
  t = t + (src[n.yl] + src[n.yh]) * wy;
  t = t + (src[n.xl] + src[n.xh]) * wx;
  dst[p] = (t - rhs[p]) * w0;
}

// In place: one thread a point of the colour, x = 2*i + ((color + y + gz) & 1)
// (& 1 is the parity of a negative gz too).
template <typename I>
__global__ void shard_half_inplace(float* u, const float* __restrict__ rhs,
                                   int nze, int ny, int nx, int zg0, int NZ,
                                   int color, int dmask, float wz, float wy,
                                   float wx, float w0) {
  const I hx = (I)((nx + 1) >> 1);
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (I)nze * (I)ny * hx) return;
  const int i = (int)(idx % hx);
  const I row = idx / hx;
  const int y = (int)(row % (I)ny);
  const int z = (int)(row / (I)ny);
  const int gz = zg0 + z;
  const int x = 2 * i + ((color + y + gz) & 1);
  if (x >= nx || on_dirichlet_face(gz, y, x, NZ, ny, nx, dmask)) return;
  const Neighbours n = neighbours(z, y, x, nze, ny, nx);
  const long long p = ((long long)z * ny + y) * nx + x;
  float t = (u[n.zl] + u[n.zh]) * wz;
  t = t + (u[n.yl] + u[n.yh]) * wy;
  t = t + (u[n.xl] + u[n.xh]) * wx;
  u[p] = (t - rhs[p]) * w0;
}

// r = rhs - L[u] over the real planes (nz, ny, nx) of an extended block
// with H >= 1 halo planes a side, zero on the level's Dirichlet faces.
template <typename I>
__global__ void shard_residual(const float* __restrict__ u,
                               const float* __restrict__ rhs,
                               float* __restrict__ r, int nz, int ny, int nx,
                               int H, int z0, int NZ, int dmask, float wz,
                               float wy, float wx) {
  const I p = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (I)nz * (I)ny * (I)nx) return;
  const int x = (int)(p % (I)nx);
  const I row = p / (I)nx;
  const int y = (int)(row % (I)ny);
  const int z = (int)(row / (I)ny);
  if (on_dirichlet_face(z0 + z, y, x, NZ, ny, nx, dmask)) {
    r[p] = 0.0f;
    return;
  }
  const long long q = (long long)p + (long long)H * ny * nx;
  const Neighbours n = neighbours(z + H, y, x, nz + 2 * H, ny, nx);
  const float c2 = 2.0f * u[q];
  float t = ((u[n.zl] - c2) + u[n.zh]) * wz;
  t = t + ((u[n.yl] - c2) + u[n.yh]) * wy;
  t = t + ((u[n.xl] - c2) + u[n.xh]) * wx;
  r[p] = rhs[q] - t;
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); each returns cudaGetLastError().

extern "C" int ndsm_shard_half_oop_f32(const void* src, const void* rhs, void* dst,
                                       int nze, int ny, int nx, int zg0, int NZ,
                                       int color, int dmask, float wz, float wy,
                                       float wx, float w0, void* stream) {
  auto kern = ndsm::small_lane(nze, ny, nx) ? ndsm::shard_half_oop<unsigned>
                                            : ndsm::shard_half_oop<unsigned long long>;
  kern<<<ndsm::blocks_for((long long)nze * ny * nx), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>((const float*)src, (const float*)rhs, (float*)dst,
                                 nze, ny, nx, zg0, NZ, color, dmask, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_shard_half_inplace_f32(void* u, const void* rhs, int nze, int ny,
                                           int nx, int zg0, int NZ, int color,
                                           int dmask, float wz, float wy, float wx,
                                           float w0, void* stream) {
  auto kern = ndsm::small_lane(nze, ny, nx) ? ndsm::shard_half_inplace<unsigned>
                                            : ndsm::shard_half_inplace<unsigned long long>;
  kern<<<ndsm::blocks_for((long long)nze * ny * ((nx + 1) / 2)), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>((float*)u, (const float*)rhs, nze, ny, nx, zg0, NZ,
                                 color, dmask, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_shard_residual_f32(const void* u, const void* rhs, void* r, int nz,
                                       int ny, int nx, int H, int z0, int NZ, int dmask,
                                       float wz, float wy, float wx, void* stream) {
  auto kern = ndsm::small_lane(nz + 2 * H, ny, nx) ? ndsm::shard_residual<unsigned>
                                                   : ndsm::shard_residual<unsigned long long>;
  kern<<<ndsm::blocks_for((long long)nz * ny * nx), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>((const float*)u, (const float*)rhs, (float*)r, nz, ny,
                                 nx, H, z0, NZ, dmask, wz, wy, wx);
  return (int)cudaGetLastError();
}
