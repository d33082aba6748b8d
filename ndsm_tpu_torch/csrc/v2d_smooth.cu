// Multi-sweep red-black Gauss-Seidel smoother of the 5-point Poisson
// stencil on float32 2D levels, with the all-Neumann mean after every
// sweep and fused epilogues: the Hopper kernels behind ops/v2d.py.
//
// Replaces (ndsm_tpu/ops/pallas_v2d.py, gridless and grid=(B,) forms):
//   v2d_smooth           -> one launch, ns sweeps
//   v2d_smooth_residual  -> the same, then the residual of the swept state
//   v2d_smooth_cor       -> the same on (u + cor), added on load
// The TPU kernel keeps a whole level in VMEM.  Here a lane is kept in
// shared memory for the whole call (`v2d_lane`, 512 threads a block):
//
//   * One block a lane where u and rhs fit its 227 KB (every chi-face
//     level of a 220^3 box below 220^2: 110^2 takes 101 KB).
//   * A thread-block cluster of C blocks a lane where they do not (220^2:
//     C = 2; 512^2: C = 10).  Block k of the cluster owns a band of whole
//     rows, [k*ny/C, (k+1)*ny/C), and holds one halo row a side, a copy of
//     the neighbour's edge row.  After each half-sweep a cluster barrier
//     (barrier.cluster arrive.release / wait.acquire), then each block
//     copies the half of the neighbours' edge rows that the half-sweep
//     updated, through distributed shared memory (DSMEM).  The neighbour
//     writes only the other colour until the next barrier, so the copy is
//     race-free, and the halo rows never touch L2.
//   * ops/v2d.py:v2d_plan gives C: the fewest blocks (at most 16, a
//     non-portable cluster size) whose band, halo rows and sum slots fit.
//     A lane that not even 16 blocks hold takes `v2d_smooth`, the first
//     design, one block a lane in global memory (its own route and launch
//     counter); it is also the previous design chip_smoke.py times beside
//     the lane kernel.
//
// The load copies u (+ cor) and rhs from device memory once (cp.async, all
// of a block's copies in flight); every sweep, the per-sweep mean and the
// residual epilogue then run on shared memory, and u (and r) are stored
// once.  A shared row holds the even columns, then the odd ones: a
// colour's points, and each of their x and y neighbours, are consecutive
// words (no bank conflicts).  A thread keeps one column of a colour half
// and walks every other row (so one column parity): its x neighbours'
// offsets are fixed, its rows advance by a constant stride, and only the
// domain's y faces, peeled out of the loop, take a test.
//
// The all-Neumann mean keeps the order of reduce.cuh bit for bit: slot t
// of 1024 adds the flat indices t, t+1024, ... in turn, then a tree with
// strides 512, ..., 1.  Thread t keeps slots t and t + 512.  A band is a
// contiguous flat range, so block k starts each slot from block k-1's
// partial, read through DSMEM after a cluster barrier; every block then
// folds the last block's partials itself (the same bits everywhere, no
// further barrier) and subtracts the mean from its band and its halo rows
// (the same rounded operation on the same values as the owner's).
//
// What bounds it on the H100: not device memory (six 220^2 lanes are 1.2
// MB of u; the 12 bytes a point a call would move in ~1 us at 3.35 TB/s)
// but the SMs a lane gets: a half-sweep is bound by the instructions of
// its updates (five shared loads, a store, seven float operations and the
// addressing), a sweep of a cluster by its barriers (two, and one more a
// chain step with the mean), and the mean by the serial order of its sum
// (each slot's terms added one after the other, block after block).  No
// tensor cores: 7 float32 operations an update.
//
// -fmad=false keeps every multiply and add separately rounded, as
// PyTorch's elementwise ops are, so both kernels equal the plain PyTorch
// version bit for bit.

#include <cooperative_groups.h>

#include "reduce.cuh"
#include "stencil.cuh"

namespace cg = cooperative_groups;

namespace ndsm {

// Neumann reflection / Dirichlet freeze in 2D: dmask bit 0/1 = lower/upper
// y face, bit 2/3 = lower/upper x face (ops/zc.py:dirichlet_mask).
__device__ __forceinline__ bool on_dirichlet_face_2d(int y, int x, int ny, int nx,
                                                     int dmask) {
  return ((dmask & 1) && y == 0) || ((dmask & 2) && y == ny - 1) ||
         ((dmask & 4) && x == 0) || ((dmask & 8) && x == nx - 1);
}

// ---------------------------------------------------------------------
// The one-block global-memory kernel: lanes beyond a 16-block
// cluster, and the previous design.
// ---------------------------------------------------------------------

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

// ---------------------------------------------------------------------
// The lane kept in shared memory: one block, or a cluster of C blocks.
// ---------------------------------------------------------------------

constexpr int kLaneThreads = 512;  // thread t keeps sum slots t and t + 512
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB a block
// Shared words after the rows: the 1024 slot partials a block hands on,
// the tree's 512 words, the mean (padded).
constexpr int kSlotWords = kSumThreads + kLaneThreads + 4;

// The rows block k of C owns, [r0, r1), and holds, [lo, hi): its band and
// one halo row a side that is not a domain face (none when C = 1).
struct Band {
  int r0, r1, lo, hi;
};

__host__ __device__ __forceinline__ Band band_of(int k, int C, int ny) {
  Band b;
  b.r0 = (int)((long long)k * ny / C);
  b.r1 = (int)((long long)(k + 1) * ny / C);
  b.lo = k > 0 ? b.r0 - 1 : b.r0;
  b.hi = k < C - 1 ? b.r1 + 1 : b.r1;
  return b;
}

// Words of a shared row: ceil(nx / 2) even columns, then as many odd.
__host__ __device__ __forceinline__ int row_words(int nx) { return 2 * ((nx + 1) / 2); }

// Rows of each of the two row areas of a block: the band and its halos.
__host__ __device__ __forceinline__ int area_rows(int ny, int C) {
  return (ny + C - 1) / C + (C > 1 ? 2 : 0);
}

// Shared bytes of a block: u rows (band + halos), the rhs area of as many
// rows (it stages cor on load), the slots.  Must agree with
// ops/v2d.py:lane_smem.
__host__ __forceinline__ long long lane_smem(int ny, int nx, int C) {
  return 2ll * area_rows(ny, C) * row_words(nx) * 4 + kSlotWords * 4ll;
}

// Word of column x in a row: the even half, then the odd one.
__device__ __forceinline__ int col_word(int x, int hx) { return (x & 1) * hx + (x >> 1); }

__device__ __forceinline__ void cp_async_f32(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy n consecutive values of g (rows of nx) into the split rows of s,
// with cp.async: every copy of the block in flight at once.
__device__ __forceinline__ void copy_rows(float* s, const float* g, int n, int nx, int S,
                                          int hx) {
  int q = threadIdx.x, r = q / nx, x = q - r * nx;
  const int dr = kLaneThreads / nx, dx = kLaneThreads % nx;
  for (; q < n; q += kLaneThreads) {
    cp_async_f32(s + r * S + col_word(x, hx), g + q);
    r += dr;
    x += dx;
    if (x >= nx) {
      x -= nx;
      ++r;
    }
  }
}

// The thread mapping of a half-sweep: thread t keeps column i0 (+ cw, ...)
// of a colour half and the rows j0, j0 + rstep, ... of the band.  rstep is
// even, so a thread's points all have one column parity.
struct SweepMap {
  int i0, j0, cw, rstep;
};

__device__ __forceinline__ SweepMap sweep_map(int hx) {
  SweepMap m;
  m.cw = hx < kLaneThreads / 2 ? hx : kLaneThreads / 2;
  m.rstep = 2 * (kLaneThreads / (2 * m.cw));
  m.i0 = threadIdx.x % m.cw;
  m.j0 = threadIdx.x / m.cw;
  return m;
}

// One half-sweep of `color` over the band rows [r0, r1): x = 2i + p with
// p = (color + y) & 1, column i of that parity half.  The rows inside the
// domain run a loop without tests (neighbours at -S and +S words, the
// point's x neighbours at fixed offsets); the domain's y faces, rows 0
// and ny - 1, are peeled (reflection, Dirichlet rows).  u rows are indexed
// from lo, rhs rows from r0.
__device__ __forceinline__ void lane_half(float* U, const float* F, int S, int hx,
                                          int ny, int nx, const Band& b, int color,
                                          int dmask, float wy, float wx, float w0) {
  const SweepMap m = sweep_map(hx);
  if (m.j0 >= m.rstep) return;
  const int y0 = b.r0 + m.j0;
  if (y0 >= b.r1) return;
  const int p = (color + y0) & 1;
  const int ustep = m.rstep * S;
  const int yend = b.r1 < ny - 1 ? b.r1 : ny - 1;  // rows < yend are not the top face
  for (int i = m.i0; i < hx; i += m.cw) {
    const int x = 2 * i + p;
    if (x >= nx || ((dmask & 4) && x == 0) || ((dmask & 8) && x == nx - 1)) continue;
    // the x neighbours' words relative to the point's, reflected at x = 0
    // and x = nx - 1: p = 0 reads the odd half, p = 1 the even half
    const int own = p * hx + i;
    const int dxl = p ? -hx : (i == 0 ? 0 : -1) + hx;
    const int dxh = p ? (x + 1 < nx ? 1 - hx : -hx) : (x + 1 < nx ? hx : hx - 1);
    int y = y0;
    int c = (y - b.lo) * S + own, f = m.j0 * S + own;
    if (y == 0) {  // the bottom face: row -1 reflects to row 1
      if (!(dmask & 1)) {
        float s = (U[c + S] + U[c + S]) * wy;
        s = s + (U[c + dxl] + U[c + dxh]) * wx;
        U[c] = (s - F[f]) * w0;
      }
      y += m.rstep;
      c += ustep;
      f += ustep;
    }
    // rows 1 .. ny - 2: four updates loaded before they are stored
    for (; y + 3 * m.rstep < yend; y += 4 * m.rstep, c += 4 * ustep, f += 4 * ustep) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k * ustep;
        float s = (U[ck - S] + U[ck + S]) * wy;
        s = s + (U[ck + dxl] + U[ck + dxh]) * wx;
        v[k] = (s - F[f + k * ustep]) * w0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) U[c + k * ustep] = v[k];
    }
    for (; y < yend; y += m.rstep, c += ustep, f += ustep) {
      float s = (U[c - S] + U[c + S]) * wy;
      s = s + (U[c + dxl] + U[c + dxh]) * wx;
      U[c] = (s - F[f]) * w0;
    }
    if (y == ny - 1 && y < b.r1 && !(dmask & 2)) {  // the top face: row ny reflects to ny - 2
      float s = (U[c - S] + U[c - S]) * wy;
      s = s + (U[c + dxl] + U[c + dxh]) * wx;
      U[c] = (s - F[f]) * w0;
    }
  }
}

// The terms of one sum slot in a band: the flat indices f = slot (mod 1024)
// in [r0*nx, r1*nx), in turn (reduce.cuh's order).
struct SlotWalk {
  int n, y, x, w;  // terms left; the current term's row, column and word
};

__device__ __forceinline__ SlotWalk slot_walk(int slot, const Band& b, int nx, int S,
                                              int hx) {
  const int f0 = b.r0 * nx, f1 = b.r1 * nx;
  const int f = f0 + (((slot - f0) % kSumThreads) + kSumThreads) % kSumThreads;
  SlotWalk s;
  s.n = f < f1 ? (f1 - 1 - f) / kSumThreads + 1 : 0;
  s.y = f / nx;
  s.x = f - s.y * nx;
  s.w = (s.y - b.lo) * S + col_word(s.x, hx);
  return s;
}

// The next term, 1024 flat indices on: dy rows and dx columns, a row more
// when x wraps.  With nx even a term keeps its column parity (dx and nx are
// even), so the word advances by dw (+ hx = S - nx/2 on a wrap).
__device__ __forceinline__ void slot_step(SlotWalk& s, const Band& b, int nx, int S, int hx,
                                          int dy, int dx, int dw, bool even) {
  s.x += dx;
  s.y += dy;
  if (even) {
    s.w += dw;
    if (s.x >= nx) {
      s.x -= nx;
      ++s.y;
      s.w += hx;
    }
  } else {
    if (s.x >= nx) {
      s.x -= nx;
      ++s.y;
    }
    s.w = (s.y - b.lo) * S + col_word(s.x, hx);
  }
}

// Slots t and t + 512 summed over the band from a0 and a1, their terms in
// turn, the two chains interleaved.
__device__ __forceinline__ void band_slot_sums(const float* U, int S, int hx, int nx,
                                               const Band& b, float& a0, float& a1) {
  SlotWalk s0 = slot_walk(threadIdx.x, b, nx, S, hx);
  SlotWalk s1 = slot_walk(threadIdx.x + kLaneThreads, b, nx, S, hx);
  const int dy = kSumThreads / nx, dx = kSumThreads % nx;
  const int dw = dy * S + (dx >> 1);
  const bool even = (nx & 1) == 0;
  const int n = s0.n < s1.n ? s0.n : s1.n;
#pragma unroll 4
  for (int m = 0; m < n; ++m) {
    const float v0 = U[s0.w], v1 = U[s1.w];
    slot_step(s0, b, nx, S, hx, dy, dx, dw, even);
    slot_step(s1, b, nx, S, hx, dy, dx, dw, even);
    a0 = a0 + v0;
    a1 = a1 + v1;
  }
  if (s0.n > n) a0 = a0 + U[s0.w];
  if (s1.n > n) a1 = a1 + U[s1.w];
}

// The tree of reduce.cuh over the 1024 slots, a = slot t, b = slot t + 512:
// strides 512 (in registers), 256, ..., 32 (in `sh`, 512 words), 16, ...,
// 1 (warp 0's shuffles: lane t adds lane t + s, as sh[t] + sh[t + s]).
// Every thread gets the sum.
__device__ __forceinline__ float slot_tree(float a, float b, float* sh) {
  const int t = threadIdx.x;
  sh[t] = a + b;
  __syncthreads();
  for (int s = kLaneThreads / 2; s >= 32; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  if (t < 32) {
    float v = sh[t];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, s);
    if (t == 0) sh[kLaneThreads] = v;
  }
  __syncthreads();
  const float total = sh[kLaneThreads];
  __syncthreads();  // sh is reused by the next sweep
  return total;
}

// After a cluster barrier that follows a half-sweep of `color`: copy into
// this block's halo rows the half of each neighbour's edge row that holds
// that colour, from the neighbour's shared memory.
__device__ __forceinline__ void copy_halos(cg::cluster_group& cl, float* U, int S,
                                           int hx, int ny, const Band& b, int k, int C,
                                           int color) {
  for (int w = threadIdx.x; w < 2 * hx; w += kLaneThreads) {
    const int up = w >= hx;
    const int i = w - up * hx;
    if ((!up && k == 0) || (up && k == C - 1)) continue;
    const int nbr = up ? k + 1 : k - 1;
    const int g = up ? b.r1 : b.r0 - 1;  // the neighbour's edge row
    const Band nb = band_of(nbr, C, ny);
    const int word = ((color + g) & 1) * hx + i;
    const float* src = cl.map_shared_rank(U, nbr);
    U[(g - b.lo) * S + word] = src[(g - nb.lo) * S + word];
  }
}

// grid = (C, lanes), cluster = (C, 1, 1); block k = blockIdx.x owns the
// band_of(k, C, ny).  Dynamic shared memory: U (rows lo..hi), F (rhs rows
// r0..r1; cor rows lo..hi while loading), the slots, the tree (lane_smem).
template <bool kCor, bool kResidual>
__global__ void __launch_bounds__(kLaneThreads, 1)
v2d_lane(const float* __restrict__ u_in, const float* __restrict__ cor,
         const float* __restrict__ rhs_all, float* __restrict__ out_all,
         float* __restrict__ res_all, int ny, int nx, int C, int nsweeps, int red,
         int dmask, int all_neumann, float wy, float wx, float w0, float inv_n) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int k = blockIdx.x;
  const int hx = (nx + 1) >> 1, S = row_words(nx);
  const Band b = band_of(k, C, ny);
  float* U = smem;
  float* F = U + area_rows(ny, C) * S;
  float* slots = F + area_rows(ny, C) * S;
  float* sh = slots + kSumThreads;
  const long long off = (long long)blockIdx.y * ny * nx;
  cg::cluster_group cl = cg::this_cluster();

  // load: u (+ cor) rows lo..hi, rhs rows r0..r1, into the split layout
  const int nu = (b.hi - b.lo) * nx;
  copy_rows(U, u_in + off + (long long)b.lo * nx, nu, nx, S, hx);
  if (kCor) {
    copy_rows(F, cor + off + (long long)b.lo * nx, nu, nx, S, hx);
    cp_async_wait_all();
    __syncthreads();
    for (int w = t; w < (b.hi - b.lo) * S; w += kLaneThreads) U[w] = U[w] + F[w];
    __syncthreads();
  }
  copy_rows(F, rhs_all + off + (long long)b.r0 * nx, (b.r1 - b.r0) * nx, nx, S, hx);
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < nsweeps; ++s) {
    lane_half(U, F, S, hx, ny, nx, b, red, dmask, wy, wx, w0);
    if (C > 1) {
      cl.sync();
      copy_halos(cl, U, S, hx, ny, b, k, C, red);
    }
    __syncthreads();
    lane_half(U, F, S, hx, ny, nx, b, 1 - red, dmask, wy, wx, w0);
    if (!all_neumann) {
      if (C > 1) {
        cl.sync();
        copy_halos(cl, U, S, hx, ny, b, k, C, 1 - red);
      }
      __syncthreads();
      continue;
    }
    __syncthreads();  // the band is swept
    float lo_slot = 0.0f, hi_slot = 0.0f;  // slots t and t + 512 over the lane
    if (C == 1) {
      band_slot_sums(U, S, hx, nx, b, lo_slot, hi_slot);
    } else {
      // the slot partials chained through the cluster in rank order; the
      // first barrier also publishes the black edge rows
      for (int j = 0; j < C; ++j) {
        if (k == j) {
          if (j > 0) {
            const float* prev = cl.map_shared_rank(slots, j - 1);
            lo_slot = prev[t];
            hi_slot = prev[t + kLaneThreads];
          }
          band_slot_sums(U, S, hx, nx, b, lo_slot, hi_slot);
          slots[t] = lo_slot;
          slots[t + kLaneThreads] = hi_slot;
        }
        cl.sync();
        if (j == 0) copy_halos(cl, U, S, hx, ny, b, k, C, 1 - red);
      }
      // every block folds the last block's partials itself (the same bits)
      const float* last = cl.map_shared_rank(slots, C - 1);
      lo_slot = last[t];
      hi_slot = last[t + kLaneThreads];
    }
    const float m = slot_tree(lo_slot, hi_slot, sh) * inv_n;
    float2* U2 = reinterpret_cast<float2*>(U);  // S is even
    for (int w = t, n2 = (b.hi - b.lo) * S / 2; w < n2; w += kLaneThreads) {
      float2 v = U2[w];
      v.x = v.x - m;
      v.y = v.y - m;
      U2[w] = v;
    }
    __syncthreads();
  }
  // no block leaves while a neighbour may still read its shared memory
  if (C > 1) cl.sync();

  // store u (and r) of the band: q = r * nx + x, walked as copy_rows does
  float* out = out_all + off + (long long)b.r0 * nx;
  float* res = kResidual ? res_all + off + (long long)b.r0 * nx : nullptr;
  const int dr = kLaneThreads / nx, dx = kLaneThreads % nx;
  int r = t / nx, x = t - (t / nx) * nx;
  for (int q = t, n = (b.r1 - b.r0) * nx; q < n; q += kLaneThreads) {
    const int y = b.r0 + r, cw = col_word(x, hx);
    const float* row = U + (y - b.lo) * S;
    out[q] = row[cw];
    if (kResidual) {
      // r = rhs - L[u], zero on Dirichlet faces; per axis (lo - 2u + hi) * w,
      // summed y, x (ops/stencils.py: poisson_residual).
      float v = 0.0f;
      if (!on_dirichlet_face_2d(y, x, ny, nx, dmask)) {
        const float c2 = 2.0f * row[cw];
        float lap = ((U[(reflect_lo(y) - b.lo) * S + cw] - c2) +
                     U[(reflect_hi(y, ny) - b.lo) * S + cw]) * wy;
        lap = lap + ((row[col_word(reflect_lo(x), hx)] - c2) +
                     row[col_word(reflect_hi(x, nx), hx)]) * wx;
        v = F[r * S + cw] - lap;
      }
      res[q] = v;
    }
    r += dr;
    x += dx;
    if (x >= nx) {
      x -= nx;
      ++r;
    }
  }
}

template <bool kCor, bool kResidual>
int launch_lane(const float* u, const float* cor, const float* rhs, float* out,
                float* res, int lanes, int ny, int nx, int C, int nsweeps, int red,
                int dmask, int all_neumann, float wy, float wx, float w0, float inv_n,
                cudaStream_t st) {
  auto kern = v2d_lane<kCor, kResidual>;
  const long long smem = lane_smem(ny, nx, C);
  if (C < 1 || C > kMaxCluster || C > ny || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool opened = false;  // once per instantiation
  if (!opened) {
    cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kMaxSmem);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return (int)rc;
    opened = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, (unsigned)lanes, 1);
  cfg.blockDim = dim3(kLaneThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once per cluster size and shared size: can the card hold one such
  // cluster at all?  A configuration it cannot schedule raises.
  static long long checked[kMaxCluster + 1] = {};
  if (checked[C] != smem) {
    int clusters = 0;
    const cudaError_t rc = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
    if (rc != cudaSuccess) return (int)rc;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked[C] = smem;
  }
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kern, u, cor, rhs, out, res, ny, nx, C,
                                            nsweeps, red, dmask, all_neumann, wy, wx, w0,
                                            inv_n);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace ndsm

// ---- plain C interface (loaded with ctypes); returns cudaGetLastError()

// The one-block global-memory kernel: one block a lane.
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

// The lane kept in shared memory: `cluster` blocks a lane (1: one block).
// Refuses (cudaErrorInvalidValue) a cluster above 16 or above ny, or a
// band whose shared memory exceeds 227 KB; cudaErrorInvalidConfiguration
// when the card cannot hold one such cluster.
extern "C" int ndsm_v2d_lane_f32(const void* u, const void* cor, const void* rhs,
                                 void* out, void* res, int lanes, int ny, int nx,
                                 int cluster, int nsweeps, int red, int dmask,
                                 int all_neumann, float wy, float wx, float w0,
                                 float inv_n, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float *pu = (const float*)u, *pc = (const float*)cor, *pr = (const float*)rhs;
  float *po = (float*)out, *pres = (float*)res;
  if (cor != nullptr && res != nullptr) return (int)cudaErrorInvalidValue;
#define NDSM_LANE_LAUNCH(C, R)                                                      \
  ndsm::launch_lane<C, R>(pu, pc, pr, po, pres, lanes, ny, nx, cluster, nsweeps, \
                          red, dmask, all_neumann, wy, wx, w0, inv_n, st)
  if (cor != nullptr) return NDSM_LANE_LAUNCH(true, false);
  if (res != nullptr) return NDSM_LANE_LAUNCH(false, true);
  return NDSM_LANE_LAUNCH(false, false);
#undef NDSM_LANE_LAUNCH
}
