// Shared index logic of the 7-point Poisson stencil kernels.
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

}  // namespace ndsm
