// Red-black Gauss-Seidel smoother of the 7-point Poisson stencil, float32,
// on colour-split state, over a stack of B <= 8 lanes with per-lane
// boundary conditions; and the two passes that split a dense level into
// its colour halves and merge them back.
//
// Replaces ndsm_tpu/ops/pallas_compact.py: compact_smooth_3d (ns sweeps of
// R, B, rhs_R, rhs_B -> R, B) = ceil(ns / w) launches of the halves form of
// the multi-sweep pass `lane_pass` (lane_pass.cuh, template flag C), each
// running w sweeps of every lane; a single level is the stack of one lane.
// The split and the merge replace the tensor code the JAX engine leaves
// to XLA around that kernel (ndsm_tpu/ops/stencils_compact.py:
// split_colors, merge_colors).
//
// Layout (ops/stencils_compact.py): with hx = ceil(nx / 2) and the row
// parity rp = (z + y) & 1,
//   R[z, y, k] = u[z, y, 2k + rp],   B[z, y, k] = u[z, y, 2k + 1 - rp],
// so the half c (0 = R, 1 = B) holds x = 2k + (rp ^ c).  For odd nx the
// last entry of a row's odd-x half is a ghost (x = nx); it mirrors the
// entry before it (x = nx - 2), which is what the clamped x read of the
// other colour's point at x = nx - 1 must see.
//
// What they compute is the TPU kernel's: lane b sweeps with its own first
// colour and its own frozen Dirichlet faces, in the arithmetic order of
// the plain version, ((z pair * wz + y pair * wy) + x pair * wx - rhs) * w0.
// The TPU kernel runs all ns sweeps in one call over VMEM windows with a
// 2*ns halo; the pass is that temporal blocking in shared memory, w sweeps
// a launch over windows with a 2w halo (lane_pass.cuh and fused_smooth.cu
// say how).  There is no gate on even extents or 128-wide rows: any shape
// with nz, ny >= 2 and nx >= 4 is taken, odd nx included.
//
// Why the halves suit the pass: a shared row of the pass holds the
// window's even columns, then its odd ones, which is the halves' own
// order, so a window row is two contiguous segments of global memory
// (the dense pass gathers every other word of a row for each half).  The
// pass copies them a 4-byte word a lane; 16-byte copies of the segments
// at their rows' offsets, and float2 loads in the stages, were measured
// slower on the card (PERF.md).  What bounds it on the H100: the
// dense pass's limits (the stage barriers, the latency of a stage's dependent
// loads, the SMs' memory instructions); by bytes, 12 a point and pass
// times the window overhead, as the dense pass.
//
// The split and the merge are pure streaming passes (8 bytes a point each).
//
// Lane freezing: a frozen lane costs no sweep work.  The pass's blocks of
// a frozen lane copy its halves (ghosts included).

#include "lane_pass.cuh"
#include "stencil.cuh"

namespace ndsm {

// Dense stack u (+ cor on the lanes `active` marks) -> its halves, ghosts
// set; one thread per pair (x = 2k, 2k + 1).
template <typename I>
__global__ void compact_split(const float* __restrict__ u,
                              const float* __restrict__ cor,
                              float* __restrict__ r, float* __restrict__ b,
                              int nz, int ny, int nx, unsigned active) {
  const I hx = (I)((nx + 1) >> 1);
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (I)nz * (I)ny * hx) return;
  const int lane = blockIdx.y;
  const int k = (int)(idx % hx);
  const I row = idx / hx;
  const int rp = (int)((row % (I)ny + row / (I)ny) & 1);
  const float* ul = u + (long long)lane * nz * ny * nx;
  const float* cl =
      (cor && ((active >> lane) & 1u)) ? cor + (long long)lane * nz * ny * nx : nullptr;
  const I p = row * (I)nx + (I)(2 * k);
  const float even = cl ? ul[p] + cl[p] : ul[p];
  // x = 2k + 1, or for odd nx past the end the mirror of x = nx - 2
  const I q = 2 * k + 1 < nx ? p + 1 : p - 1;
  const float odd = cl ? ul[q] + cl[q] : ul[q];
  const long long h = (long long)lane * nz * ny * (long long)hx + idx;
  r[h] = rp ? odd : even;
  b[h] = rp ? even : odd;
}

// Halves -> dense stack; one thread per pair (x = 2k, 2k + 1).
template <typename I>
__global__ void compact_merge(const float* __restrict__ r,
                              const float* __restrict__ b,
                              float* __restrict__ u, int nz, int ny, int nx) {
  const I hx = (I)((nx + 1) >> 1);
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (I)nz * (I)ny * hx) return;
  const int lane = blockIdx.y;
  const int k = (int)(idx % hx);
  const I row = idx / hx;
  const int rp = (int)((row % (I)ny + row / (I)ny) & 1);
  const long long h = (long long)lane * nz * ny * (long long)hx + idx;
  float* ul = u + (long long)lane * nz * ny * nx;
  const I p = row * (I)nx + (I)(2 * k);
  const float vr = r[h], vb = b[h];
  ul[p] = rp ? vb : vr;
  if (2 * k + 1 < nx) ul[p + 1] = rp ? vr : vb;
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); each returns cudaGetLastError().
// color, dmask and active are host arrays of nb (1..8) ints.

extern "C" int ndsm_compact_split_f32(const void* u, const void* cor, void* r,
                                      void* b, int nb, int nz, int ny, int nx,
                                      const int* active, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes || nx < 4) return (int)cudaErrorInvalidValue;
  unsigned act = 0;
  for (int l = 0; l < nb; ++l) act |= (unsigned)(active[l] != 0) << l;
  auto kern = ndsm::small_lane(nz, ny, nx) ? ndsm::compact_split<unsigned>
                                           : ndsm::compact_split<unsigned long long>;
  kern<<<ndsm::lane_grid((long long)nz * ny * ((nx + 1) / 2), nb), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>((const float*)u, (const float*)cor, (float*)r,
                                 (float*)b, nz, ny, nx, act);
  return (int)cudaGetLastError();
}

extern "C" int ndsm_compact_merge_f32(const void* r, const void* b, void* u, int nb,
                                      int nz, int ny, int nx, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes || nx < 4) return (int)cudaErrorInvalidValue;
  auto kern = ndsm::small_lane(nz, ny, nx) ? ndsm::compact_merge<unsigned>
                                           : ndsm::compact_merge<unsigned long long>;
  kern<<<ndsm::lane_grid((long long)nz * ny * ((nx + 1) / 2), nb), ndsm::kThreads, 0,
         (cudaStream_t)stream>>>((const float*)r, (const float*)b, (float*)u, nz, ny,
                                 nx);
  return (int)cudaGetLastError();
}

// w sweeps of every lane's halves in one launch of the pass's halves form
// (ops/compact.py: compact_plan gives w and the tile), out of place from
// (src_r, src_b) into (dst_r, dst_b), each (nb, nz, ny, ceil(nx / 2)).
// Refuses (cudaErrorInvalidValue) an odd tx that does not span nx (a window must
// start on an even column), and what launch_pass refuses.
extern "C" int ndsm_compact_pass_f32(const void* src_r, const void* src_b, const void* rhs_r,
                                     const void* rhs_b, void* dst_r, void* dst_b, int nb,
                                     int nz, int ny, int nx, const int* color, const int* dmask,
                                     const int* active, int w, int cz, int ty, int tx, float wz,
                                     float wy, float wx, float w0, void* stream) {
  if (nb < 1 || nb > ndsm::kMaxLanes || nx < 4 || w < 1 || cz < 1 || ty < 1 || tx < 1 ||
      ((tx & 1) && tx < nx))
    return (int)cudaErrorInvalidValue;
  const ndsm::Lanes L = ndsm::make_lanes(nb, color, dmask, active);
  ndsm::PassTile T = ndsm::pass_tile(ny, nx, w, false, cz, ty, tx);
  if (cz >= nz && ty >= ny && tx >= nx) {  // one tile holds the lane: resident if it fits
    ndsm::PassTile R = T;
    R.resident = 1;
    R.ring = nz;
    if (ndsm::pass_smem(R) <= ndsm::kMaxSmem) T = R;
  }
  const dim3 grid((unsigned)(((ny + ty - 1) / ty) * ((nx + tx - 1) / tx)),
                  (unsigned)((nz + cz - 1) / cz), (unsigned)nb);
  return ndsm::launch_pass<false, true>(
      (const float*)src_r, nullptr, (const float*)rhs_r, (float*)dst_r, nullptr,
      ndsm::HalfB{(const float*)src_b, (const float*)rhs_b, (float*)dst_b}, nz, ny, nx, L, T,
      ndsm::ShardBlock{}, grid, wz, wy, wx, w0, (cudaStream_t)stream);
}
