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
//   zc_smooth_mean_3d        -> the half-sweep kernels of each all-Neumann
//                               sweep, the first subtracting the previous
//                               sweep's mean on load (the mean's own passes
//                               are in zc_smooth.cu; a mean between sweeps
//                               cannot be fused into a pass)
// and the lane forms of the per-lane zc_smooth_residual_3d /
// zc_smooth_cor_3d calls of ndsm_tpu/mg/batched.py.  `lane_residual` stays
// for the colour-split route (ops/compact.py), and the half-sweep kernels
// for the mean smoother and as the previous design that chip_smoke.py
// times beside the pass.
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


// ---- the multi-sweep pass

constexpr int kPassThreads = 512;
// Shared memory one block can use on the H100 (227 KB).
constexpr int kMaxSmem = 232448;
// Planes copied ahead of the one a step needs (cp.async groups in flight).
constexpr int kAhead = 1;
// Rows a warp updates between its loads and its stores (independent
// updates in flight: a half-sweep reads only the other colour, so all its
// loads may go before its stores).
constexpr int kRows = 4;

// Geometry of a pass: w sweeps; the output tile (cz, ty, tx); the halo H;
// the shared plane's extents (sy, sx): the largest window, min(n, t + 2H)
// along each axis; the planes of each ring; whether the pass is resident:
// one tile holds the whole lane and all its planes fit in shared memory,
// so there is no march (ring = nz).
struct PassTile {
  int w, halo, cz, ty, tx, sy, sx, ring, resident;
};

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kAhead - 1 groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// w red-black sweeps of every lane, out of place from v = src (+ cor) into
// dst, and with res != nullptr the residual of the final state into res
// (the header above says how).  Grid: (tiles in y x x, z chunks, lanes);
// kPassThreads threads, warp j of a plane's rows, lane i of a row's points.
template <typename I>
__global__ void __launch_bounds__(kPassThreads, 1)
lane_pass(const float* __restrict__ src, const float* __restrict__ cor,
          const float* __restrict__ rhs, float* __restrict__ dst,
          float* __restrict__ res, int nz, int ny, int nx, Lanes L, PassTile T,
          float wz, float wy, float wx, float w0) {
  extern __shared__ float sm[];
  const int k = blockIdx.z;
  const long long base = (long long)k * nz * ny * nx;
  const int ntx = (nx + T.tx - 1) / T.tx;
  const int oy0 = (int)(blockIdx.x / ntx) * T.ty, ox0 = (int)(blockIdx.x % ntx) * T.tx;
  const int oz0 = (int)blockIdx.y * T.cz;
  const int oy1 = min(ny, oy0 + T.ty), ox1 = min(nx, ox0 + T.tx), oz1 = min(nz, oz0 + T.cz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int nw = kPassThreads / 32;
  static_assert(nw % 2 == 0, "the rows of a warp must share their parity");
  const float* s = src + base;
  float* d = dst + base;
  float* r = res ? res + base : nullptr;
  auto at = [&](int z, int y, int x) { return ((I)z * (I)ny + (I)y) * (I)nx + (I)x; };
  if (!((L.active >> k) & 1u)) {  // a frozen lane: unchanged, zero residual
    for (int z = oz0; z < oz1; ++z)
      for (int y = oy0 + warp; y < oy1; y += nw)
        for (int x = ox0 + lane; x < ox1; x += 32) {
          const I p = at(z, y, x);
          d[p] = s[p];
          if (r) r[p] = 0.0f;
        }
    return;
  }
  const float* f = rhs + base;
  const float* c = cor ? cor + base : nullptr;
  const int H = T.halo;
  const int wz0 = max(0, oz0 - H), wz1 = min(nz, oz1 + H);
  const int wy0 = max(0, oy0 - H), wy1 = min(ny, oy1 + H);
  const int wx0 = max(0, ox0 - H), wx1 = min(nx, ox1 + H);
  const int NZ = wz1 - wz0, WY = wy1 - wy0, WX = wx1 - wx0;
  // A shared row holds the window's even columns, then its odd ones: the
  // points of one colour in a row, and each of their x neighbours, are
  // then consecutive words (no bank conflicts).
  const int HX = (T.sx + 1) >> 1, SX = 2 * HX;
  auto col = [&](int i) { return (i & 1) * HX + (i >> 1); };
  const int plane = T.sy * SX;
  float* U = sm;                   // ring of u planes
  float* F = sm + T.ring * plane;  // ring of rhs planes
  const int color = (int)((L.color >> k) & 1u), dm = lane_dmask(L, k);

  // Copy window plane q of u and rhs into its ring slot, as one cp.async
  // group (empty past the window): thread (warp, lane) copies rows
  // warp + nw * m and columns lane + 32 * n.  The first pass also loads
  // the same elements of cor into registers, and adds them once the plane
  // has landed (one plane is in flight: kAhead = 1).
  static_assert(kAhead == 1, "cor is held in registers for one plane");
  float cr[kRows][2];
  auto load = [&](int q) {
    if (q < NZ) {
      const int o = (q % T.ring) * plane;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int j = warp + nw * m;
        if (j >= WY) continue;
        const I row = at(wz0 + q, wy0 + j, wx0);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int i = lane + 32 * n;
          if (i >= WX) continue;
          const int e = j * SX + col(i);
          cp_async4(U + o + e, s + row + i);
          cp_async4(F + o + e, f + row + i);
          if (c) cr[m][n] = c[row + i];
        }
      }
    }
    cp_async_commit();
  };
  auto add_cor = [&](int q) {
    float* u = U + (q % T.ring) * plane;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int j = warp + nw * m;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i = lane + 32 * n, e = j * SX + col(i);
        if (j < WY && i < WX) u[e] = u[e] + cr[m][n];
      }
    }
  };
  // How many stages a point of the window is worth updating: a point at
  // distance d from a cut edge (a window edge that is not a domain face)
  // is right after stage s only while d >= s, so stage st (0-based)
  // updates it only when d > st; never a point outside the window or on a
  // Dirichlet face (-1).
  constexpr int kFar = 1 << 20;
  auto reach = [&](int i, int n, int w0_, int w1_, int W, bool dlo, bool dhi) {
    const int g = w0_ + i;
    if (i >= W || (dlo && g == 0) || (dhi && g == n - 1)) return -1;
    return min(w0_ > 0 ? i : kFar, w1_ < n ? W - 1 - i : kFar);
  };
  // The points a thread updates, fixed for the block: lane l owns window
  // columns 2l and 2l + 1 (one of them has the stage's colour), warp w
  // owns rows w + nw * a, a < kRows (the plan keeps the window within 64
  // x 64).  Their offsets, reflected neighbours and reach are computed
  // once; a stage then costs its loads, its arithmetic and one parity
  // select.
  int xo[2], xl[2], xh[2], xr[2];  // shared-row offsets of the column and its neighbours
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = 2 * lane + e, gx = wx0 + i;
    xr[e] = reach(i, nx, wx0, wx1, WX, dm & 16, dm & 32);
    xo[e] = col(i);
    xl[e] = col(gx == 0 ? i + 1 : i - 1);
    xh[e] = col(gx == nx - 1 ? i - 1 : i + 1);
  }
  int yo[kRows], yl[kRows], yh[kRows], yr[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int j = warp + nw * a, gy = wy0 + j;
    yr[a] = reach(j, ny, wy0, wy1, WY, dm & 4, dm & 8);
    yo[a] = j * SX;
    yl[a] = (gy == 0 ? j + 1 : j - 1) * SX;
    yh[a] = (gy == ny - 1 ? j - 1 : j + 1) * SX;
  }
  // Half-sweep st (0-based: colour = first colour ^ (st & 1)) on plane q
  // in ring slot sq (its z neighbours in slots sl, sh): all the thread's
  // loads before its stores (the stage reads only the other colour).
  auto sweep = [&](int st, int q, int sq, int sl, int sh) {
    const int gz = wz0 + q;
    if (reach(q, nz, wz0, wz1, NZ, dm & 1, dm & 2) <= st) return;
    if (gz == 0) sl = sh;       // reflection: plane -1 reads plane 1
    if (gz == nz - 1) sh = sl;  // and plane nz reads plane nz - 2
    // column 2l + e has the colour: (gz + gy + gx) & 1 == colour, with
    // gy = wy0 + warp (mod 2) and gx = wx0 + e (mod 2)
    const int e = (color ^ (st & 1) ^ gz ^ wy0 ^ warp ^ wx0) & 1;
    if ((e ? xr[1] : xr[0]) <= st) return;
    const int i = e ? xo[1] : xo[0], il = e ? xl[1] : xl[0], ih = e ? xh[1] : xh[0];
    float* u = U + sq * plane;
    const float* ul = U + sl * plane;
    const float* uh = U + sh * plane;
    const float* fr = F + sq * plane;
    float v[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      if (yr[a] <= st) continue;
      const int p = yo[a] + i;
      float t = (ul[p] + uh[p]) * wz;
      t = t + (u[yl[a] + i] + u[yh[a] + i]) * wy;
      t = t + (u[yo[a] + il] + u[yo[a] + ih]) * wx;
      v[a] = (t - fr[p]) * w0;
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
      if (yr[a] > st) u[yo[a] + i] = v[a];
  };
  auto store = [&](int q) {
    const float* u = U + (q % T.ring) * plane;
    for (int y = oy0 + warp; y < oy1; y += nw) {
      const I row = at(wz0 + q, y, 0);
      for (int x = ox0 + lane; x < ox1; x += 32) d[row + x] = u[(y - wy0) * SX + col(x - wx0)];
    }
  };
  // r = rhs - L[u] on the tile of final plane q (lane_residual's order).
  auto residual = [&](int q) {
    const int gz = wz0 + q;
    const float* u = U + (q % T.ring) * plane;
    const float* ul = U + ((gz == 0 ? q + 1 : q - 1) % T.ring) * plane;
    const float* uh = U + ((gz == nz - 1 ? q - 1 : q + 1) % T.ring) * plane;
    const float* fr = F + (q % T.ring) * plane;
    for (int y = oy0 + warp; y < oy1; y += nw) {
      const I row = at(gz, y, 0);
      const int j = y - wy0;
      const int rl = (y == 0 ? j + 1 : j - 1) * SX, rh = (y == ny - 1 ? j - 1 : j + 1) * SX;
      for (int x = ox0 + lane; x < ox1; x += 32) {
        if (on_dirichlet_face(gz, y, x, nz, ny, nx, dm)) {
          r[row + x] = 0.0f;
          continue;
        }
        const int i = col(x - wx0), p = j * SX + i;
        const int il = col(x == 0 ? x - wx0 + 1 : x - wx0 - 1);
        const int ih = col(x == nx - 1 ? x - wx0 - 1 : x - wx0 + 1);
        const float c2 = 2.0f * u[p];
        float t = ((ul[p] - c2) + uh[p]) * wz;
        t = t + ((u[rl + i] - c2) + u[rh + i]) * wy;
        t = t + ((u[j * SX + il] - c2) + u[j * SX + ih]) * wx;
        r[row + x] = fr[p] - t;
      }
    }
  };

  const int ns = 2 * T.w, rs = r ? 1 : 0;
  if (T.resident) {
    // The whole lane in shared memory: load every plane (u + cor added on
    // the way), then the half-sweeps in order, each over every plane (a
    // half-sweep reads only the other colour, so its planes need no
    // barrier between them), then the stores and the residual.
    for (int q = 0; q < NZ; ++q)
      for (int j = warp; j < WY; j += nw)
        for (int i = lane; i < WX; i += 32) {
          const I g = at(q, j, i);
          const int e = q * plane + j * SX + col(i);
          U[e] = c ? s[g] + c[g] : s[g];
          F[e] = f[g];
        }
    __syncthreads();
    for (int st = 0; st < ns; ++st) {
      for (int q = 0; q < NZ; ++q) sweep(st, q, q, q - 1, q + 1);
      __syncthreads();
    }
    for (int q = 0; q < NZ; ++q) {
      store(q);
      if (rs) residual(q);
    }
    return;
  }
  const int qo0 = oz0 - wz0, qo1 = oz1 - wz0;  // the tile's planes, window-local
  const int steps = qo1 + ns + rs;
  for (int q = 0; q < kAhead; ++q) load(q);
  int slot = 0;  // t % ring
  for (int t = 0; t < steps; ++t, slot = slot + 1 == T.ring ? 0 : slot + 1) {
    cp_async_wait_ahead();  // plane t has landed (this thread's copies)
    if (c && t < NZ) add_cor(t);
    __syncthreads();
    load(t + kAhead);
    for (int st = 0; st < ns; ++st) {
      const int q = t - 1 - st;
      if (q >= 0 && q < NZ) {
        const int sq = slot - 1 - st < 0 ? slot - 1 - st + T.ring : slot - 1 - st;
        sweep(st, q, sq, sq == 0 ? T.ring - 1 : sq - 1, sq + 1 == T.ring ? 0 : sq + 1);
      }
      __syncthreads();
    }
    if (t - ns >= qo0 && t - ns < qo1) store(t - ns);
    if (rs && t - ns - 1 >= qo0 && t - ns - 1 < qo1) residual(t - ns - 1);
  }
}

// The pass's geometry from the host's arguments (ops/zc.py: pass_tile
// computes the same).
inline PassTile pass_tile(int ny, int nx, int w, bool residual, int cz, int ty, int tx) {
  PassTile T;
  T.w = w;
  T.halo = 2 * w + (residual ? 1 : 0);
  T.cz = cz;
  T.ty = ty;
  T.tx = tx;
  T.sy = ty + 2 * T.halo < ny ? ty + 2 * T.halo : ny;
  T.sx = tx + 2 * T.halo < nx ? tx + 2 * T.halo : nx;
  T.ring = 2 * w + 2 + kAhead + (residual ? 1 : 0);
  T.resident = 0;
  return T;
}

// Two rings (u, rhs) of sy rows; a shared row holds the even columns,
// then the odd ones (2 * ceil(sx / 2) words).  cor goes through registers.
inline long long pass_smem(const PassTile& T) {
  return 2ll * T.ring * T.sy * ((T.sx + 1) / 2 * 2) * (long long)sizeof(float);
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
  const long long smem = ndsm::pass_smem(T);
  if (smem > ndsm::kMaxSmem || T.sx > 64 || T.sy > ndsm::kRows * ndsm::kPassThreads / 32)
    return (int)cudaErrorInvalidValue;
  const bool small = ndsm::small_lane(nz, ny, nx);
  auto kern = small ? ndsm::lane_pass<unsigned> : ndsm::lane_pass<unsigned long long>;
  static int opened[2] = {48 * 1024, 48 * 1024};  // dynamic smem allowed so far
  int& limit = opened[small ? 0 : 1];
  if (smem > limit) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ndsm::kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    limit = ndsm::kMaxSmem;
  }
  const dim3 grid((unsigned)(((ny + ty - 1) / ty) * ((nx + tx - 1) / tx)),
                  (unsigned)((nz + cz - 1) / cz), (unsigned)nb);
  kern<<<grid, ndsm::kPassThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)cor, (const float*)rhs, (float*)dst, (float*)r, nz, ny,
      nx, L, T, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}
