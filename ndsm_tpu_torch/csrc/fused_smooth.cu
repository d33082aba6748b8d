// Red-black Gauss-Seidel smoother of the 7-point Poisson stencil, float32,
// and its residual, over a stack of B <= 8 lanes with per-lane boundary
// conditions: the one family of 3D smoother kernels behind ops/zc.py and
// ops/fused.py.  A single (nz, ny, nx) level is the stack of one lane.
//
// Replaces (ndsm_tpu/ops/pallas_fused.py):
//   fused_smooth_3d_batched  -> ns sweeps of a stacked (B, nz, ny, nx)
//                               state = 2*ns half-sweep launches, each over
//                               every lane at once
//   fused_smooth_3d          -> the same launches with B = 1
// and (ndsm_tpu/ops/pallas_zc.py), as one-lane calls of the same kernels:
//   zc_smooth_3d             -> 2*ns half-sweep launches
//   zc_smooth_residual_3d    -> the same, then one residual launch
//   zc_smooth_cor_3d         -> first half-sweep reads (u + cor) out of
//                               place, the remaining 2*ns-1 run in place
//   zc_smooth_mean_3d        -> the half-sweeps of each all-Neumann sweep,
//                               the first subtracting the previous sweep's
//                               mean on load (the mean's own passes are in
//                               zc_smooth.cu)
// and the lane forms of the per-lane zc_smooth_residual_3d /
// zc_smooth_cor_3d calls of ndsm_tpu/mg/batched.py (one residual launch
// over all lanes; the first half-sweep reads u + cor).
//
// What they compute is the TPU kernels': lane b sweeps with its own first
// colour and its own frozen Dirichlet faces (pallas_fused.mask_code, here
// derived from the lane's parameters instead of a mask-code array); the
// lanes share dq and so the weights.  Their layout is not carried over: no
// z de-interleave, no VMEM windows, no 2*ns halo, no 8/128 alignment, no
// tiles.  Any shape with every extent >= 2 is taken.
//
// Lane freezing: a lane whose `active` flag is 0 costs no sweep work.  The
// in-place half-sweeps launch over the active lanes only; the out-of-place
// first half-sweep copies a frozen lane unchanged (without cor or sub);
// the residual writes 0 for it.  So an active lane's result never depends
// on which other lanes are active.
//
// What bounds them on the H100: device-memory bandwidth.  A half-sweep
// updates one colour and reads only the other, so it is race-free in
// place.  Each launch touches every 32-byte sector of u (neighbours) and
// rhs (the colour's points are every other float) and writes half of u:
// about 12 bytes per point per half-sweep, 24 per sweep, against 12/ns
// for the TPU's fused multi-sweep pass.  This first design accepts that:
// it is simple, bitwise-checkable against the plain PyTorch sweep, and
// the neighbour reads hit L1/L2.  Batching lanes saves launches, not
// bytes.  Temporal blocking (ns sweeps per pass over shared-memory tiles
// with a 2*ns halo) is the later optimisation.

#include "stencil.cuh"

namespace ndsm {

// The lanes of a launch arrive packed in a `Lanes` (stencil.cuh).  The
// index arithmetic within a lane is done in I: 32-bit unsigned when a
// lane has < 2^31 points (the host picks it; its divisions cost far less
// than 64-bit ones, which the GPU emulates), 64-bit otherwise.  Offsets
// into the stack are 64-bit either way.

// In-place half-sweep over the grid's lanes: one thread per point of the
// lane's colour ((z+y+x) % 2 == color); threads over (z, y, i) of grid
// lane k with x = 2*i + ((color + y + z) & 1), so no thread idles on the
// other colour.
template <typename I>
__global__ void lane_half_inplace(float* u, const float* __restrict__ rhs,
                                  int nz, int ny, int nx, Lanes L, float wz,
                                  float wy, float wx, float w0) {
  const I hx = (I)((nx + 1) >> 1);
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (I)nz * (I)ny * hx) return;
  const int k = blockIdx.y;
  const int color = (L.color >> k) & 1;
  const int i = (int)(idx % hx);
  const I row = idx / hx;
  const int y = (int)(row % (I)ny);
  const int z = (int)(row / (I)ny);
  const int x = 2 * i + ((color + y + z) & 1);
  if (x >= nx || on_dirichlet_face(z, y, x, nz, ny, nx, lane_dmask(L, k))) return;
  const long long base = (long long)((L.lane >> (4 * k)) & 15u) * nz * ny * nx;
  float* ul = u + base;
  const Neighbours n = neighbours(z, y, x, nz, ny, nx);
  const long long p = ((long long)z * ny + y) * nx + x;
  float t = (ul[n.zl] + ul[n.zh]) * wz;
  t = t + (ul[n.yl] + ul[n.yh]) * wy;
  t = t + (ul[n.xl] + ul[n.xh]) * wx;
  ul[p] = (t - rhs[base + p]) * w0;
}

// Out-of-place first half-sweep over every lane of the stack (grid lane k
// is stack lane k), over v = src (+ cor) (- *sub): points of the lane's
// colour off its Dirichlet faces get the update computed from v's
// neighbours, every other point gets v.  With cor != nullptr this is the
// correction-fused first half-sweep of the V-cycle ascent; with sub !=
// nullptr the all-Neumann sweep that first subtracts the previous sweep's
// mean (both on load, in the same float32 arithmetic as the plain
// `u + cor` and `u - m`).  A frozen lane is copied from src unchanged.
template <typename I>
__global__ void lane_half_oop(const float* __restrict__ src,
                              const float* __restrict__ cor,
                              const float* __restrict__ sub,
                              const float* __restrict__ rhs,
                              float* __restrict__ dst, int nz, int ny, int nx,
                              Lanes L, float wz, float wy, float wx, float w0) {
  const I p = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (I)nz * (I)ny * (I)nx) return;
  const int k = blockIdx.y;
  const long long base = (long long)k * nz * ny * nx;
  const float* s = src + base;
  float* d = dst + base;
  if (!((L.active >> k) & 1u)) {
    d[p] = s[p];
    return;
  }
  const int x = (int)(p % (I)nx);
  const I row = p / (I)nx;
  const int y = (int)(row % (I)ny);
  const int z = (int)(row / (I)ny);
  const float* c = cor ? cor + base : nullptr;
  const float m = sub ? *sub : 0.0f;
  auto v = [&](long long q) {
    const float a = c ? s[q] + c[q] : s[q];
    return sub ? a - m : a;
  };
  if (((z + y + x) & 1) != (int)((L.color >> k) & 1u) ||
      on_dirichlet_face(z, y, x, nz, ny, nx, lane_dmask(L, k))) {
    d[p] = v(p);
    return;
  }
  const Neighbours n = neighbours(z, y, x, nz, ny, nx);
  float t = (v(n.zl) + v(n.zh)) * wz;
  t = t + (v(n.yl) + v(n.yh)) * wy;
  t = t + (v(n.xl) + v(n.xh)) * wx;
  d[p] = (t - rhs[base + p]) * w0;
}

// r = rhs - L[u] per lane, zero on the lane's Dirichlet faces and on every
// point of a frozen lane; per axis ((lo - 2u) + hi) * w, summed z, y, x
// (ndsm_tpu/ops/stencils.py: poisson_residual).
template <typename I>
__global__ void lane_residual(const float* __restrict__ u,
                              const float* __restrict__ rhs,
                              float* __restrict__ r, int nz, int ny, int nx,
                              Lanes L, float wz, float wy, float wx) {
  const I p = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (I)nz * (I)ny * (I)nx) return;
  const int k = blockIdx.y;
  const long long base = (long long)k * nz * ny * nx;
  const int x = (int)(p % (I)nx);
  const I row = p / (I)nx;
  const int y = (int)(row % (I)ny);
  const int z = (int)(row / (I)ny);
  if (!((L.active >> k) & 1u) ||
      on_dirichlet_face(z, y, x, nz, ny, nx, lane_dmask(L, k))) {
    r[base + p] = 0.0f;
    return;
  }
  const float* ul = u + base;
  const Neighbours n = neighbours(z, y, x, nz, ny, nx);
  const float c2 = 2.0f * ul[p];
  float t = ((ul[n.zl] - c2) + ul[n.zh]) * wz;
  t = t + ((ul[n.yl] - c2) + ul[n.yh]) * wy;
  t = t + ((ul[n.xl] - c2) + ul[n.xh]) * wx;
  r[base + p] = rhs[base + p] - t;
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); each returns cudaGetLastError().
// color, dmask and active are host arrays of nb (1..8) ints.

extern "C" int ndsm_lane_half_inplace_f32(void* u, const void* rhs, int nb, int nz,
                                          int ny, int nx, const int* color,
                                          const int* dmask, const int* active,
                                          int second, float wz, float wy, float wx,
                                          float w0, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes) return (int)cudaErrorInvalidValue;
  const ndsm::Lanes L = ndsm::make_lanes(nb, color, dmask, active, second, true);
  if (L.n == 0) return 0;
  const dim3 grid = ndsm::lane_grid((long long)nz * ny * ((nx + 1) / 2), L.n);
  auto kern = ndsm::small_lane(nz, ny, nx) ? ndsm::lane_half_inplace<unsigned>
                                           : ndsm::lane_half_inplace<unsigned long long>;
  kern<<<grid, ndsm::kThreads, 0, (cudaStream_t)stream>>>(
      (float*)u, (const float*)rhs, nz, ny, nx, L, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_lane_half_oop_f32(const void* src, const void* cor,
                                      const void* sub, const void* rhs, void* dst,
                                      int nb, int nz, int ny, int nx,
                                      const int* color, const int* dmask,
                                      const int* active, float wz, float wy,
                                      float wx, float w0, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes) return (int)cudaErrorInvalidValue;
  const ndsm::Lanes L = ndsm::make_lanes(nb, color, dmask, active, 0, false);
  auto kern = ndsm::small_lane(nz, ny, nx) ? ndsm::lane_half_oop<unsigned>
                                           : ndsm::lane_half_oop<unsigned long long>;
  kern<<<ndsm::lane_grid((long long)nz * ny * nx, nb), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>(
      (const float*)src, (const float*)cor, (const float*)sub, (const float*)rhs,
      (float*)dst, nz, ny, nx, L, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_lane_residual_f32(const void* u, const void* rhs, void* r,
                                      int nb, int nz, int ny, int nx,
                                      const int* dmask, const int* active,
                                      float wz, float wy, float wx, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes) return (int)cudaErrorInvalidValue;
  const ndsm::Lanes L = ndsm::make_lanes(nb, nullptr, dmask, active, 0, false);
  auto kern = ndsm::small_lane(nz, ny, nx) ? ndsm::lane_residual<unsigned>
                                           : ndsm::lane_residual<unsigned long long>;
  kern<<<ndsm::lane_grid((long long)nz * ny * nx, nb), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>(
      (const float*)u, (const float*)rhs, (float*)r, nz, ny, nx, L, wz, wy, wx);
  return (int)cudaGetLastError();
}
