// Red-black Gauss-Seidel smoother of the 7-point Poisson stencil, float32,
// and its residual, over a stack of B <= 8 lanes with per-lane boundary
// conditions: the one family of 3D smoother kernels behind ops/zc.py and
// ops/fused.py.  A single (nz, ny, nx) level is the stack of one lane.
//
// Replaces (ndsm_tpu/ops/pallas_fused.py):
//   fused_smooth_3d_batched  -> ns sweeps of a stacked (B, nz, ny, nx)
//                               state = ceil(ns / w) launches of the
//                               multi-sweep pass `lane_pass`, each running
//                               w sweeps of every lane
//   fused_smooth_3d          -> the same launches with B = 1
// and (ndsm_tpu/ops/pallas_zc.py), as one-lane calls of the same kernels:
//   zc_smooth_3d             -> the passes
//   zc_smooth_residual_3d    -> the passes, the last also writing the
//                               residual of its final state
//   zc_smooth_cor_3d         -> the passes, the first reading u + cor
// and the lane forms of the per-lane zc_smooth_residual_3d /
// zc_smooth_cor_3d calls of ndsm_tpu/mg/batched.py.  The pass itself is in
// lane_pass.cuh, which zc_sharded.cu shares for its shard form and
// compact_smooth.cu for its halves form.
// `lane_residual` stays for the colour-split route (ops/compact.py), and
// the half-sweep kernels as the previous designs that chip_smoke.py times
// beside the pass and beside the all-Neumann kernel of zc_smooth.cu (the
// half-sweeps of its first design).
//
// What they compute is the TPU kernels': lane b sweeps with its own first
// colour and its own frozen Dirichlet faces (pallas_fused.mask_code, here
// derived from the lane's parameters instead of a mask-code array); the
// lanes share dq and so the weights.  Any shape with every extent >= 2 is
// taken: no z de-interleave, no 8/128 alignment, no padded storage.
//
// Lane freezing: a lane whose `active` flag is 0 costs no sweep work.  Its
// blocks of a pass copy src to dst (without cor) and write a zero
// residual, so an active lane's result never depends on which other lanes
// are active.
//
// What bounds them on the H100, and the design.  A half-sweep alone
// (lane_half_*) streams the whole stack through device memory: about 12
// bytes a point, 24 a sweep, where the work needs 12 (16 with cor or a
// residual) for the whole call.  The pass keeps the planes it works on in
// shared memory (temporal blocking, as the TPU kernel keeps ns sweeps in
// a VMEM window): a block owns a (cz, ty, tx) tile of one lane and loads
// the window around it, the tile grown by a halo of H = 2w (+1 with the
// residual) points on every side that is not a domain face, clamped to the
// domain, so a window at a face holds the face and its inner neighbour
// and Neumann reflection stays inside it.  It marches through the
// window's planes in z with a ring of R = 2w + 2 + kAhead (+1) planes of u
// and of rhs.  At step t plane t is complete in the ring, plane t + 1
// (kAhead = 1) is being copied in with cp.async while the stages run, and
// stage s (0-based) updates its colour on plane t - 1 - s, the stages in
// order with a barrier between them: stage s reads stage s - 1's values on
// planes t - 2 - s .. t - s, which stage s - 1 finished earlier in this
// step or before, and stage s + 1 overwrites them on plane t - 2 - s only
// after stage s.  After stage 2w - 1 a plane is final; its tile is written
// to dst, and with the residual the plane below it gets r.  Every point
// sees the inputs of the half-sweep sequence in the same order, so the
// bits are the plain version's.  A point at distance d from a cut edge of
// the window (an edge that is not a domain face) is right after stage s
// only while d >= s, so stage s skips it from then on: after 2w stages
// exactly the tile is right.  Passes run out of place (the windows of
// neighbouring tiles overlap).  A lane small enough to fit whole in shared
// memory (the plan gives the smallest levels one such pass of all ns
// sweeps) runs resident: every plane loaded, then each half-sweep over
// all planes, one barrier apart, with no march.
//
// What bounds a pass: device memory sees each point of the window read
// once (u, rhs, and cor in the first pass: cor goes through registers and
// is added when its plane has landed, so it takes no shared memory) and
// each point of the tile written once, so a call moves about
// 12 * ceil(ns / w) * (window / tile) bytes a point instead of 24 * ns;
// the window overhead is the price of the 227 KB a block may hold.  The stages are bound by the shared-memory
// pipe (eight 4-byte accesses an update) and by their barriers, so a
// shared row holds the window's even columns, then its odd ones: the
// points of one colour and each of their neighbours are consecutive words
// (no bank conflicts), and each thread's points, their reflected
// neighbours and how long they stay worth updating are computed once per
// block.  One 512-thread block an SM with up to 227 KB: a bigger window
// costs less halo than a second block would hide latency.  A step of the
// march has a cost of its own (its barriers and the latency of its
// dependent loads), which bounds the pass on the small levels: there the
// half-sweeps' device time is lower, the pass's launches fewer.
// ops/zc.py's `pass_plan` picks w, the tile and the z chunks by a rule set
// from measurements on the card (PERF.md §6).  No tensor cores: 10
// float32 operations a point-sweep.

#include "lane_pass.cuh"
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

// w sweeps of every lane in one launch (ops/zc.py: sweeps_cuda), out of
// place src (+ cor) -> dst, with r != nullptr also the residual of the
// final state.  (cz, ty, tx) is the output tile.  Refuses (returns
// cudaErrorInvalidValue) a geometry whose shared memory exceeds the
// H100's 227 KB a block or whose window exceeds 64 x 64 points in (y, x).
extern "C" int ndsm_lane_pass_f32(const void* src, const void* cor, const void* rhs,
                                  void* dst, void* r, int nb, int nz, int ny, int nx,
                                  const int* color, const int* dmask, const int* active,
                                  int w, int cz, int ty, int tx, float wz, float wy,
                                  float wx, float w0, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes || w < 1 || cz < 1 || ty < 1 || tx < 1)
    return (int)cudaErrorInvalidValue;
  const ndsm::Lanes L = ndsm::make_lanes(nb, color, dmask, active, 0, false);
  ndsm::PassTile T = ndsm::pass_tile(ny, nx, w, r != nullptr, cz, ty, tx);
  if (cz >= nz && ty >= ny && tx >= nx) {  // one tile holds the lane: resident if it fits
    ndsm::PassTile R = T;
    R.resident = 1;
    R.ring = nz;
    if (ndsm::pass_smem(R) <= ndsm::kMaxSmem) T = R;
  }
  const dim3 grid((unsigned)(((ny + ty - 1) / ty) * ((nx + tx - 1) / tx)),
                  (unsigned)((nz + cz - 1) / cz), (unsigned)nb);
  return ndsm::launch_pass<false>((const float*)src, (const float*)cor, (const float*)rhs,
                                  (float*)dst, (float*)r, ndsm::HalfB{}, nz, ny, nx, L, T,
                                  ndsm::ShardBlock{}, grid, wz, wy, wx, w0, (cudaStream_t)stream);
}
