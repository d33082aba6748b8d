// Shared index logic of the 7-point Poisson stencil kernels, and the lane
// packing of the kernels that take a stack of problems.
//
// Arrays are C-ordered (nz, ny, nx), x fastest.  Boundary conditions are
// static per face and arrive as a 6-bit Dirichlet mask: bit 2*ax is the
// lower face of axis ax (0 = z, 1 = y, 2 = x), bit 2*ax+1 the upper face.
// Neumann faces use index reflection (neighbour -1 reads 1, neighbour n
// reads n-2); Dirichlet-face points are frozen (never updated) and have
// zero residual -- the semantics of ndsm_tpu/ops/stencils.py.
//
// Every kernel of this directory is compiled with -fmad=false: the
// expression order below is the plain PyTorch version's, and with no
// multiply-add contraction the results are bitwise equal to it.
#pragma once

#include <cuda_runtime.h>

namespace ndsm {

__device__ __forceinline__ int reflect_lo(int i) { return i == 0 ? 1 : i - 1; }

__device__ __forceinline__ int reflect_hi(int i, int n) {
  return i == n - 1 ? n - 2 : i + 1;
}

__device__ __forceinline__ bool on_dirichlet_face(int z, int y, int x, int nz,
                                                  int ny, int nx, int dmask) {
  return ((dmask & 1) && z == 0) || ((dmask & 2) && z == nz - 1) ||
         ((dmask & 4) && y == 0) || ((dmask & 8) && y == ny - 1) ||
         ((dmask & 16) && x == 0) || ((dmask & 32) && x == nx - 1);
}

// Linear offsets of the six (reflected) neighbours of (z, y, x).
struct Neighbours {
  long long zl, zh, yl, yh, xl, xh;
};

__device__ __forceinline__ Neighbours neighbours(int z, int y, int x, int nz,
                                                 int ny, int nx) {
  const long long sz = (long long)ny * nx;
  const long long sy = nx;
  const long long zo = (long long)z * sz, yo = (long long)y * sy;
  Neighbours n;
  n.zl = (long long)reflect_lo(z) * sz + yo + x;
  n.zh = (long long)reflect_hi(z, nz) * sz + yo + x;
  n.yl = zo + (long long)reflect_lo(y) * sy + x;
  n.yh = zo + (long long)reflect_hi(y, ny) * sy + x;
  n.xl = zo + yo + reflect_lo(x);
  n.xh = zo + yo + reflect_hi(x, nx);
  return n;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// ---- lanes: a stack of B <= 8 problems of one shape, one grid row each

constexpr int kMaxLanes = 8;

// The lanes one launch covers, packed into scalars and passed by value
// (a per-lane array indexed at run time would go through local memory).
// Grid lane k = blockIdx.y is stack lane (lane >> 4k) & 15, sweeps colour
// (color >> k) & 1 with Dirichlet faces (dmask >> 6k) & 63 (the 6-bit mask
// above), and is frozen when (active >> k) & 1 is 0.
struct Lanes {
  int n;
  unsigned lane, color, active;
  unsigned long long dmask;
};

__device__ __forceinline__ int lane_dmask(const Lanes& L, int k) {
  return (int)((L.dmask >> (6 * k)) & 63ull);
}

// Lanes of a launch from the host arrays: every stack lane, or (only_active)
// the active ones; colour = first colour XOR `second`.
inline Lanes make_lanes(int nb, const int* color, const int* dmask,
                        const int* active, int second, bool only_active) {
  Lanes L{};
  for (int b = 0; b < nb; ++b) {
    if (only_active && !active[b]) continue;
    const int k = L.n++;
    L.lane |= (unsigned)b << (4 * k);
    L.color |= (unsigned)((color ? color[b] : 0) ^ second) << k;
    L.active |= (unsigned)(active[b] != 0) << k;
    L.dmask |= (unsigned long long)(dmask[b] & 63) << (6 * k);
  }
  return L;
}

inline dim3 lane_grid(long long per_lane, int lanes) {
  return dim3(blocks_for(per_lane), (unsigned)lanes);
}

// Whether a lane of nz * ny * nx points takes the 32-bit index arithmetic.
inline bool small_lane(int nz, int ny, int nx) {
  return (long long)nz * ny * nx < (1ll << 31);
}

}  // namespace ndsm
