// The all-Neumann 3D smoother (zc_smooth_mean_3d of ops/zc.py), float32:
// ns red-black sweeps, each followed by the subtraction of the level's
// mean m = f32(sum(u) / f32(N)), in ONE launch.
//
// Replaces (ndsm_tpu/ops/pallas_zc.py):
//   zc_smooth_mean_3d      -> one launch of mean_grid (a cooperative grid
//   (+ the JAX engine's       of co-resident blocks, grid-wide barriers
//   _t_smooth_zc_mean)        between the phases) or of mean_block (one
//                             block that holds the level in shared memory)
// The TPU engine composes one-sweep passes with per-window sums, because a
// tiled multi-sweep pass cannot hold a global sum.  A cooperative grid can:
// every block is resident, so a block may wait for all the others.
//
// The sum is the plain version's bit for bit: ops/reduce.strided_block_sum
// over mean_blocks(N) virtual blocks of kSumThreads virtual threads
// (virtual thread t adds flat indices t, t + G, t + 2G, ... in turn, G the
// virtual threads; each virtual block folds its threads' sums in a tree),
// then sum_final's fold of those partials and a true division.
//
// The design.  Per sweep k, over one output array `out`:
//   R    the red half-sweep in place: red points updated from their black
//        neighbours minus m_{k-1} (from the input u at k = 0, with no
//        mean); black points are left as they are (no red update reads
//        its own point, and a black point's next value does not read it);
//   --   grid barrier;
//   B+S  the black half-sweep in place from the final red values; in the
//        same loop each virtual thread adds the final value of each of its
//        indices, whichever colour, in its order (the black update is
//        pointwise once red is final, so following the strided map of the
//        sum is legal and coalesced), and each virtual block folds its
//        1024 sums into partials[vb];
//   --   grid barrier;
//   fold every block folds the partials itself, in sum_final's order, so
//        every block holds the same m_k, and goes on to the next R.
// After the last sweep each block subtracts m from its own points.  So a
// call is one launch and 2 * ns grid barriers, and per point and sweep
// about 24 bytes move in whole cache lines (each phase reads u and rhs and
// writes u) against ~28 in four launches for the previous design.
// A resident block stands for the virtual blocks b, b + grid, ... in turn,
// in every phase (the same map, so the final subtraction touches only
// points the block itself wrote).  The resident threads move through the
// level together, a stride of G points at a time; R and the final
// subtraction walk backwards, so each phase starts where the one before
// ended, on the part of the level still in L2.  The barrier (grid_barrier below) makes
// every write of a phase visible to the next phase's plain loads, as
// cooperative_groups' grid sync does; the partials are read through L2.
//
// mean_block, the "block" route: a level whose u and rhs fit one block's
// shared memory (up to ~29,000 points; ops/zc.py: mean_plan) runs every
// sweep there with __syncthreads between the phases; its virtual blocks
// (<= 32) are folded one a warp (reduce.cuh: warp_tree_sum).
//
// What bounds it on the H100: device memory (the level does not fit L2
// beyond ~150^3: u and rhs are 8 bytes a point), ~0.7 ms for five sweeps
// at 256^3, and on small levels the 2 * ns barriers.
// The first design (per sweep a half-sweep pair of fused_smooth.cu,
// sum_partials and sum_final, and sub_scalar at the end, 4 * ns + 1
// launches) stays below as the yardstick chip_smoke.py times beside it.

#include "reduce.cuh"
#include "stencil.cuh"

namespace ndsm {

// ---- the one-launch smoother

// Grid-wide barrier of a cooperative launch (every block resident, or the
// launch is refused).  bar[0] counts the blocks arrived, bar[1] is the
// generation: each block's thread 0 reads the generation, arrives, and the
// last to arrive resets the count and advances the generation, which
// releases the others.  The count is 0 again after every barrier, so the
// two words serve the next launch on the stream as they are.  The fences
// on both sides make every write before the barrier, by any block,
// visible to every read after it.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// m = f32(sum / nf) of `parts` partials (<= kSumThreads) in sum_final's
// order: thread t's strided sum is 0 + parts[t], then the tree.  Warp 0
// folds; `l2` reads the partials through L2 (written in this launch by
// other blocks).  Returns m to every thread (through *msh).
__device__ __forceinline__ float fold_mean(const float* parts, int nparts, float nf,
                                           float* msh, bool l2) {
  if (threadIdx.x < 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int i = threadIdx.x + 32 * j;
      v[j] = i < nparts ? 0.0f + (l2 ? __ldcg(parts + i) : parts[i]) : 0.0f;
    }
    const float s = warp_tree_sum(v);
    if (threadIdx.x == 0) *msh = __fdiv_rn(s, nf);
  }
  __syncthreads();
  const float m = *msh;
  __syncthreads();  // *msh may be written again by the next fold
  return m;
}

// The cooperative route (the header above).  Grid: the resident blocks,
// at most nvb; kSumThreads threads a block, thread t of virtual block vb
// is virtual thread vb * kSumThreads + t.
template <typename I>
__global__ void __launch_bounds__(kSumThreads)
mean_grid(const float* __restrict__ u, const float* __restrict__ rhs, float* out,
          float* partials, unsigned* bar, int nz, int ny, int nx, int nvb, int ns, int color,
          float wz, float wy, float wx, float w0, float nf) {
  __shared__ float sh[kSumThreads];
  __shared__ float msh;
  const I n = (I)nz * (I)ny * (I)nx, sz = (I)ny * (I)nx;
  const I G = (I)nvb * kSumThreads;
  // the step of G in (z, y, x): z + gz, y + gy, x + gx with carries
  const int gx = (int)(G % (I)nx);
  const I gr = G / (I)nx;
  const int gy = (int)(gr % (I)ny), gz = (int)(gr / (I)ny);
  // walk virtual thread vb * kSumThreads + threadIdx.x's indices, body(p, z, y,
  // x): in their order (the sum's), or backwards
  auto walk = [&](int vb, bool back, auto&& body) {
    I p = (I)vb * kSumThreads + threadIdx.x;
    if (p >= n) return;
    if (back) p += (n - 1 - p) / G * G;  // the last index
    int x = (int)(p % (I)nx);
    const I row = p / (I)nx;
    int y = (int)(row % (I)ny), z = (int)(row / (I)ny);
    for (;;) {
      body(p, z, y, x);
      if (back) {
        if (p < G) break;
        p -= G;
        x -= gx;
        y -= gy;
        z -= gz;
        if (x < 0) {
          x += nx;
          --y;
        }
        if (y < 0) {
          y += ny;
          --z;
        }
      } else {
        p += G;
        if (p >= n) break;
        x += gx;
        y += gy;
        z += gz;
        if (x >= nx) {
          x -= nx;
          ++y;
        }
        if (y >= ny) {
          y -= ny;
          ++z;
        }
      }
    }
  };
  // the update of point p = (z, y, x) from its six neighbours v(q)
  auto update = [&](I p, int z, int y, int x, auto&& v) {
    const I zl = z == 0 ? p + sz : p - sz, zh = z == nz - 1 ? p - sz : p + sz;
    const I yl = y == 0 ? p + nx : p - nx, yh = y == ny - 1 ? p - nx : p + nx;
    const I xl = x == 0 ? p + 1 : p - 1, xh = x == nx - 1 ? p - 1 : p + 1;
    float t = (v(zl) + v(zh)) * wz;
    t = t + (v(yl) + v(yh)) * wy;
    t = t + (v(xl) + v(xh)) * wx;
    return (t - rhs[p]) * w0;
  };
  float m = 0.0f;
  for (int k = 0; k < ns; ++k) {
    // R: red points from their black neighbours minus the previous mean
    for (int vb = blockIdx.x; vb < nvb; vb += gridDim.x)
      walk(vb, true, [&](I p, int z, int y, int x) {
        if (((z + y + x) & 1) != color) return;
        out[p] = k ? update(p, z, y, x, [&](I q) { return out[q] - m; })
                   : update(p, z, y, x, [&](I q) { return u[q]; });
      });
    grid_barrier(bar);
    // B+S: black points from the final red ones; the sums of the final values
    for (int vb = blockIdx.x; vb < nvb; vb += gridDim.x) {
      float acc = 0.0f;
      walk(vb, false, [&](I p, int z, int y, int x) {
        float val;
        if (((z + y + x) & 1) != color) {
          val = update(p, z, y, x, [&](I q) { return out[q]; });
          out[p] = val;
        } else {
          val = out[p];
        }
        acc = acc + val;
      });
      sh[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < 32) {
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = sh[threadIdx.x + 32 * j];
        const float s = warp_tree_sum(v);
        if (threadIdx.x == 0) partials[vb] = s;
      }
      __syncthreads();
    }
    grid_barrier(bar);
    m = fold_mean(partials, nvb, nf, &msh, true);
  }
  for (int vb = blockIdx.x; vb < nvb; vb += gridDim.x)
    walk(vb, true, [&](I p, int, int, int) { out[p] = out[p] - m; });
}

// Shared words of mean_block after u and rhs: the partials (<= 32) and m.
constexpr int kBlockExtra = 64;

// The block route: one block, the level (~29,000 points at most) in
// shared memory; the same phases with __syncthreads for barriers.  A
// half-sweep spreads the points of its colour over all threads; the sums
// go one warp a virtual block (each virtual thread has one index or none:
// G >= N).
__global__ void __launch_bounds__(kSumThreads)
mean_block(const float* __restrict__ u, const float* __restrict__ rhs, float* __restrict__ out,
           int nz, int ny, int nx, int nvb, int ns, int color, float wz, float wy, float wx,
           float w0, float nf) {
  extern __shared__ float sm[];
  const int n = nz * ny * nx, sz = ny * nx, rows = nz * ny, hx = (nx + 1) >> 1;
  float* U = sm;
  float* F = sm + n;
  float* P = F + n;                  // the partials of the virtual blocks
  float* msh = P + kBlockExtra / 2;  // m
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = threadIdx.x; p < n; p += kSumThreads) {
    U[p] = u[p];
    F[p] = rhs[p];
  }
  __syncthreads();
  // half-sweep of colour c, neighbours read as v(q): thread t takes the
  // points e = t, t + 1024, ... of the colour, row e / hx, x = 2 (e % hx)
  // + the row's parity
  auto half = [&](int c, auto&& v) {
    for (int e = threadIdx.x; e < rows * hx; e += kSumThreads) {
      const int row = e / hx, z = row / ny, y = row - z * ny;
      const int x = 2 * (e - row * hx) + ((c + y + z) & 1);
      if (x >= nx) continue;
      const int p = row * nx + x;
      const int zl = z == 0 ? p + sz : p - sz, zh = z == nz - 1 ? p - sz : p + sz;
      const int yl = y == 0 ? p + nx : p - nx, yh = y == ny - 1 ? p - nx : p + nx;
      const int xl = x == 0 ? p + 1 : p - 1, xh = x == nx - 1 ? p - 1 : p + 1;
      float t = (v(zl) + v(zh)) * wz;
      t = t + (v(yl) + v(yh)) * wy;
      t = t + (v(xl) + v(xh)) * wx;
      U[p] = (t - F[p]) * w0;
    }
    __syncthreads();
  };
  float m = 0.0f;
  for (int k = 0; k < ns; ++k) {
    if (k)
      half(color, [&](int q) { return U[q] - m; });
    else
      half(color, [&](int q) { return U[q]; });
    half(color ^ 1, [&](int q) { return U[q]; });
    for (int vb = warp; vb < nvb; vb += kSumThreads / 32) {
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = vb * kSumThreads + lane + 32 * j;
        v[j] = i < n ? 0.0f + U[i] : 0.0f;
      }
      const float s = warp_tree_sum(v);
      if (lane == 0) P[vb] = s;
    }
    __syncthreads();
    m = fold_mean(P, nvb, nf, msh, false);
  }
  for (int p = threadIdx.x; p < n; p += kSumThreads) out[p] = U[p] - m;
}

// ---- the first design: the mean's reduction passes between half-sweeps

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

constexpr int kDevices = 64;

// The resident blocks of mean_grid<I> on the current device (its
// occupancy times the SMs), cached per device; 0 where the device cannot
// run a cooperative launch; a negative CUDA error.
template <typename I>
int mean_resident() {
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return -(int)rc;
  if (dev < kDevices && cached[dev]) return cached[dev] > 0 ? cached[dev] : 0;
  int coop = 0, sms = 0, per_sm = 0;
  if ((rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
      (rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mean_grid<I>, kSumThreads,
                                                          0)) != cudaSuccess)
    return -(int)rc;
  const int resident = coop ? per_sm * sms : 0;
  if (dev < kDevices) cached[dev] = resident > 0 ? resident : -1;
  return resident;
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); each returns a CUDA error code

extern "C" const char* ndsm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks the grid route can use on the current device (occupancy
// x SMs; 0: no cooperative launch), or minus a CUDA error.
extern "C" int ndsm_mean_resident_blocks(int nz, int ny, int nx) {
  return ndsm::small_lane(nz, ny, nx) ? ndsm::mean_resident<unsigned>()
                                      : ndsm::mean_resident<unsigned long long>();
}

// ns all-Neumann sweeps of u in one launch (ops/zc.py: zc_smooth_mean_3d),
// into out, on the route of ops/zc.py: mean_plan ("block": block = 1, one
// block with (2 * N + kBlockExtra) floats of shared memory; "grid": a
// cooperative launch of min(resident blocks, nvb) blocks, with nvb
// partials and the two barrier words `bar`, 0 at the first launch, as
// scratch).  nvb = mean_blocks(N), nf = f32(N).  Refuses (an error, never
// another route): a geometry the route does not take, a device without
// cooperative launches, a launch the device does not take
// (cudaErrorCooperativeLaunchTooLarge among them).
extern "C" int ndsm_mean_smooth_f32(const void* u, const void* rhs, void* out, void* partials,
                                    void* bar, int nz, int ny, int nx, int nvb, int ns,
                                    int color, int block, float wz, float wy, float wx, float w0,
                                    float nf, void* stream) {
  const long long n = (long long)nz * ny * nx;
  if (nz < 2 || ny < 2 || nx < 2 || ns < 1 || nvb < 1 || nvb > ndsm::kSumThreads ||
      (long long)nvb * ndsm::kSumThreads >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (block) {
    const long long smem = (2 * n + ndsm::kBlockExtra) * (long long)sizeof(float);
    if (smem > 232448 || nvb > 32 || (long long)nvb * ndsm::kSumThreads < n)
      return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      static bool opened[ndsm::kDevices] = {};
      int dev = 0;
      cudaError_t rc = cudaGetDevice(&dev);
      if (rc != cudaSuccess) return (int)rc;
      if (dev >= ndsm::kDevices || !opened[dev]) {
        rc = cudaFuncSetAttribute(ndsm::mean_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  232448);
        if (rc != cudaSuccess) return (int)rc;
        if (dev < ndsm::kDevices) opened[dev] = true;
      }
    }
    ndsm::mean_block<<<1, ndsm::kSumThreads, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)u, (const float*)rhs, (float*)out, nz, ny, nx, nvb, ns, color, wz, wy, wx,
        w0, nf);
    return (int)cudaGetLastError();
  }
  const bool small = ndsm::small_lane(nz, ny, nx);
  const int resident = small ? ndsm::mean_resident<unsigned>()
                             : ndsm::mean_resident<unsigned long long>();
  if (resident < 0) return -resident;
  if (resident == 0) return (int)cudaErrorNotSupported;
  const int grid = resident < nvb ? resident : nvb;
  void* args[] = {(void*)&u, (void*)&rhs, &out, &partials, &bar, &nz, &ny, &nx, &nvb, &ns,
                  &color, &wz, &wy, &wx, &w0, &nf};
  const void* kern = small ? (const void*)ndsm::mean_grid<unsigned>
                           : (const void*)ndsm::mean_grid<unsigned long long>;
  return (int)cudaLaunchCooperativeKernel(kern, dim3((unsigned)grid), dim3(ndsm::kSumThreads),
                                          args, 0, (cudaStream_t)stream);
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
