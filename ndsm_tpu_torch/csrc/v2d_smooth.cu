// Multi-sweep red-black Gauss-Seidel smoother of the 5-point Poisson
// stencil on float32 2D levels, with the all-Neumann mean after every
// sweep and fused epilogues: the Hopper kernel behind ops/v2d.py.
//
// Replaces (ndsm_tpu/ops/pallas_v2d.py, gridless and grid=(B,) forms):
//   v2d_smooth           -> one launch, ns sweeps
//   v2d_smooth_residual  -> the same, then the residual of the swept state
//   v2d_smooth_cor       -> the same on (u + cor), added on load
// The TPU kernel keeps a whole level in VMEM.  Here one block of 1024
// threads owns one lane (grid = number of lanes) and the level stays in
// global memory, where it is L2-resident (six 220^2 faces are 1.2 MB of
// the 50 MB L2): the block copies u (+ cor) into the output once, runs
// every half-sweep in place on it with a __syncthreads between halves,
// then a block reduction of the sum and the mean subtraction.  A colour's
// points read only the other colour, so the in-place half-sweeps are
// race-free.  __syncthreads makes a block's global writes visible to all
// its threads, which is all the sweep order needs.
//
// What bounds it on the H100: latency, not bandwidth.  The chi levels are
// small (48,400 points a lane at 220^2), so one block per lane leaves
// most SMs idle and every half-sweep waits on L2 round trips; the TPU
// kernel's 12 bytes a point per call (u, rhs in, u out) would take 1.5 us
// at 3.35 TB/s for six 220^2 lanes.  What the design buys is one launch
// per smoothing call instead of ~40 small PyTorch launches per sweep.
// Keeping a lane in shared memory (a 220^2 level is 194 KB of the 227 KB
// a block may use) and a thread-block cluster with distributed shared
// memory for 512^2 faces are the later optimisations.
//
// The sum's order is fixed (reduce.cuh), so the result equals the plain
// PyTorch version bit for bit; -fmad=false keeps every multiply and add
// separately rounded, as PyTorch's elementwise ops are.

#include "reduce.cuh"
#include "stencil.cuh"

namespace ndsm {

// Neumann reflection / Dirichlet freeze in 2D: dmask bit 0/1 = lower/upper
// y face, bit 2/3 = lower/upper x face (ops/zc.py:dirichlet_mask).
__device__ __forceinline__ bool on_dirichlet_face_2d(int y, int x, int ny, int nx,
                                                     int dmask) {
  return ((dmask & 1) && y == 0) || ((dmask & 2) && y == ny - 1) ||
         ((dmask & 4) && x == 0) || ((dmask & 8) && x == nx - 1);
}

// The points of one colour are walked four at a time: all loads first,
// then the stores, so a thread keeps several L2 requests in flight (the
// points of one colour never read each other).
constexpr int kUnroll = 4;

__device__ void half_sweep_2d(float* u, const float* __restrict__ rhs, int ny,
                              int nx, int color, int dmask, float wy, float wx,
                              float w0) {
  const int hx = (nx + 1) >> 1;
  const int npts = ny * hx;
  for (int base = threadIdx.x; base < npts; base += kSumThreads * kUnroll) {
    int p[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int i = base + k * kSumThreads;
      p[k] = -1;
      if (i >= npts) continue;
      const int y = i / hx;
      const int x = 2 * (i - y * hx) + ((color + y) & 1);
      if (x >= nx || on_dirichlet_face_2d(y, x, ny, nx, dmask)) continue;
      p[k] = y * nx + x;
      const int yl = reflect_lo(y) * nx + x, yh = reflect_hi(y, ny) * nx + x;
      const int xl = y * nx + reflect_lo(x), xh = y * nx + reflect_hi(x, nx);
      float t = (u[yl] + u[yh]) * wy;
      t = t + (u[xl] + u[xh]) * wx;
      val[k] = (t - rhs[p[k]]) * w0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (p[k] >= 0) u[p[k]] = val[k];
  }
}

template <bool kCor, bool kResidual>
__global__ void __launch_bounds__(kSumThreads)
v2d_smooth(const float* __restrict__ u_in, const float* __restrict__ cor,
           const float* __restrict__ rhs_all, float* out_all,
           float* __restrict__ res_all, int ny, int nx, int nsweeps, int red,
           int dmask, int all_neumann, float wy, float wx, float w0,
           float inv_n) {
  __shared__ float sh[kSumThreads];
  const int n = ny * nx;
  const long long off = (long long)blockIdx.x * n;
  const float* rhs = rhs_all + off;
  float* u = out_all + off;
  const int t = threadIdx.x;

  for (int p = t; p < n; p += kSumThreads)
    u[p] = kCor ? u_in[off + p] + cor[off + p] : u_in[off + p];
  __syncthreads();

  for (int s = 0; s < nsweeps; ++s) {
    half_sweep_2d(u, rhs, ny, nx, red, dmask, wy, wx, w0);
    __syncthreads();
    half_sweep_2d(u, rhs, ny, nx, 1 - red, dmask, wy, wx, w0);
    __syncthreads();
    if (all_neumann) {
      const float m = block_tree_sum(strided_sum(u, n, t, kSumThreads), sh) * inv_n;
      for (int p = t; p < n; p += kSumThreads) u[p] = u[p] - m;
      __syncthreads();
    }
  }

  if (kResidual) {
    // r = rhs - L[u], zero on Dirichlet faces; per axis (lo - 2u + hi) * w,
    // summed y, x (ops/stencils.py: poisson_residual).
    float* res = res_all + off;
    for (int p = t; p < n; p += kSumThreads) {
      const int y = p / nx, x = p - (p / nx) * nx;
      if (on_dirichlet_face_2d(y, x, ny, nx, dmask)) {
        res[p] = 0.0f;
        continue;
      }
      const float c2 = 2.0f * u[p];
      float lap = ((u[reflect_lo(y) * nx + x] - c2) + u[reflect_hi(y, ny) * nx + x]) * wy;
      lap = lap + ((u[y * nx + reflect_lo(x)] - c2) + u[y * nx + reflect_hi(x, nx)]) * wx;
      res[p] = rhs[p] - lap;
    }
  }
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); returns cudaGetLastError()

extern "C" int ndsm_v2d_smooth_f32(const void* u, const void* cor, const void* rhs,
                                   void* out, void* res, int lanes, int ny, int nx,
                                   int nsweeps, int red, int dmask, int all_neumann,
                                   float wy, float wx, float w0, float inv_n,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float *pu = (const float*)u, *pc = (const float*)cor, *pr = (const float*)rhs;
  float *po = (float*)out, *pres = (float*)res;
#define NDSM_V2D_LAUNCH(C, R)                                                   \
  ndsm::v2d_smooth<C, R><<<lanes, ndsm::kSumThreads, 0, st>>>(                  \
      pu, pc, pr, po, pres, ny, nx, nsweeps, red, dmask, all_neumann, wy, wx, \
      w0, inv_n)
  if (cor != nullptr && res != nullptr) return (int)cudaErrorInvalidValue;
  if (cor != nullptr)
    NDSM_V2D_LAUNCH(true, false);
  else if (res != nullptr)
    NDSM_V2D_LAUNCH(false, true);
  else
    NDSM_V2D_LAUNCH(false, false);
#undef NDSM_V2D_LAUNCH
  return (int)cudaGetLastError();
}
