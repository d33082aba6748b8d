// The multi-sweep red-black pass `lane_pass`, float32: w sweeps of a stack
// of lanes over a shared-memory ring of planes, with the residual of the
// final state fused into it.  fused_smooth.cu launches it over whole
// lanes (the 3D smoothers of ops/zc.py and ops/fused.py); zc_sharded.cu
// launches its shard form over the halo-extended block of one shard of a
// partitioned level (ops/zc_sharded.py); compact_smooth.cu launches its
// halves form over the colour halves of a stack (ops/compact.py).
// fused_smooth.cu's header says how a pass runs and what bounds it.
//
// The shard form (template flag S).  The block (nz, ny, nx) holds the
// shard's real rz x ry points of each x row with hz halo planes a side in
// z and hy rows a side in y (hy = 0 on a z mesh); its index (z, y) is the
// level's (gz0 + z, gy0 + y).  The pass then:
//   - tiles the real block only, and writes u (and r) of the real block,
//     a (rz, ry, nx) array;
//   - takes each point's colour and its Dirichlet freezing from its
//     global index against the level's extents (nzg, nyg), so a Dirichlet
//     face of the level may be an interior plane of the block, with the
//     node-mirror planes beyond it swept as ordinary points;
//   - treats the block's ends along a partitioned axis (z, and y when
//     cuty) as cut edges, never as faces: a point at distance d from one
//     is right after stage s only while d >= s, as at the window's own cut
//     edges.  The real points lie at least hz (hy) >= 2w (+1 with the
//     residual) from them, so they come out as the unsharded sweeps give
//     them, bit for bit;
//   - is never resident (the whole block would have to fit).
// Along an axis that is not partitioned (x; y on a z mesh) the block is
// the level and the pass is the lane pass.
//
// The halves form (template flag C; compact_smooth.cu launches it for
// ops/compact.py).  Each lane is the pair of colour halves of
// ops/stencils_compact.py, R and B of (nz, ny, hx), hx = ceil(nx / 2), with
// rhs_R and rhs_B beside them: row (z, y) of parity rp = (z + y) & 1 holds
// x = 2k + rp in R and x = 2k + 1 - rp in B.  A shared row already holds the
// window's even columns, then its odd ones, so with an even window start
// wx0 (the tiles' tx is even, or one tile spans nx, and the halo 2w is
// even) the even half of a window row is the segment (rp ? B : R)[z, y,
// wx0/2 ...] and the odd half (rp ? R : B)[z, y, wx0/2 ...]: the window
// load copies two contiguous segments a row, the stages run unchanged on
// the same shared layout, and the store writes the tile's two segments
// back, one 4-byte copy a word.  So every point sees the operands of the
// dense pass, whose bits are the plain sweeps'.  What differs:
//   - the ghost of odd nx: the last entry of the odd-x half of a row is
//     x = nx, the mirror of x = nx - 2.  The tile that owns x = nx - 2
//     writes it from that point's final value; no stage reads it, and it
//     is never loaded;
//   - a frozen lane's blocks copy the tile's entries of both halves (its
//     ghosts included);
//   - no residual and no correction (the TPU kernel has neither; the
//     multigrid engines split u + cor before the sweeps).

#pragma once

#include "stencil.cuh"

namespace ndsm {

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

// The B half of each array in the halves form (src, rhs and dst are then
// the R halves); null otherwise.
struct HalfB {
  const float* src;
  const float* rhs;
  float* dst;
};

// Where a shard's halo-extended block lies in its level (the shard form;
// the header above): halo planes hz and rows hy before the real block of
// rz x ry, the global index (gz0, gy0) of the block's (0, 0), the level's
// extents (nzg, nyg), and whether the y ends are cut (the (z, y) mesh).
struct ShardBlock {
  int hz, hy, rz, ry, gz0, gy0, nzg, nyg, cuty;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// w red-black sweeps of every lane, out of place from v = src (+ cor) into
// dst, and with res != nullptr the residual of the final state into res
// (fused_smooth.cu's header says how; with S the shard form above, G its
// block; with C the halves form above, Hb the B halves).
// Grid: (tiles in y x x, z chunks, lanes); kPassThreads threads, warp j of
// a plane's rows, lane i of a row's points.
template <typename I, bool S, bool C>
__global__ void __launch_bounds__(kPassThreads, 1)
lane_pass(const float* __restrict__ src, const float* __restrict__ cor,
          const float* __restrict__ rhs, float* __restrict__ dst,
          float* __restrict__ res, HalfB Hb, int nz, int ny, int nx, Lanes L, PassTile T,
          ShardBlock G, float wz, float wy, float wx, float w0) {
  static_assert(!(S && C), "the halves form is not sharded");
  extern __shared__ float sm[];
  // The output's extents and where it starts in the array, the global
  // index of the array's (0, 0) and the level's extents: the whole lane,
  // or (S) the shard's real block within its extended block.
  const int hz = S ? G.hz : 0, hy = S ? G.hy : 0;
  const int nzo = S ? G.rz : nz, nyo = S ? G.ry : ny;
  const int gz0 = S ? G.gz0 : 0, gy0 = S ? G.gy0 : 0;
  const int nzg = S ? G.nzg : nz, nyg = S ? G.nyg : ny;
  const bool cutz = S, cuty = S && G.cuty;
  const int k = blockIdx.z;
  const int hxa = (nx + 1) >> 1;  // entries of a half row (C)
  const long long base = (long long)k * nz * ny * (C ? hxa : nx);
  const int ntx = (nx + T.tx - 1) / T.tx;
  const int oy0 = hy + (int)(blockIdx.x / ntx) * T.ty, ox0 = (int)(blockIdx.x % ntx) * T.tx;
  const int oz0 = hz + (int)blockIdx.y * T.cz;
  const int oy1 = min(hy + nyo, oy0 + T.ty), ox1 = min(nx, ox0 + T.tx);
  const int oz1 = min(hz + nzo, oz0 + T.cz);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int nw = kPassThreads / 32;
  static_assert(nw % 2 == 0, "the rows of a warp must share their parity");
  const float* s = src + base;
  const long long obase = C ? base : (long long)k * nzo * nyo * nx;
  float* d = dst + obase;
  float* r = res ? res + obase : nullptr;
  auto at = [&](int z, int y, int x) { return ((I)z * (I)ny + (I)y) * (I)nx + (I)x; };
  // array point (z, y, x) in the output
  auto ot = [&](int z, int y, int x) {
    return ((I)(z - hz) * (I)nyo + (I)(y - hy)) * (I)nx + (I)x;
  };
  // C: entry (z, y, 0) of a half; the B halves; the tile's entries of each
  // half of a row: ox0 / 2 + [0, ne) of the even columns, ox0 / 2 + [0, no)
  // of the odd ones, the ghost last where the tile owns x = nx - 2.  The
  // rows of a thread lie nw apart, so they share their parity.
  auto hrow = [&](int z, int y) { return ((I)z * (I)ny + (I)y) * (I)hxa; };
  const float* sb = C ? Hb.src + base : nullptr;
  float* db = C ? Hb.dst + base : nullptr;
  auto segments = [&](int& ne, int& no, bool& ghost) {
    ne = (ox1 - ox0 + 1) >> 1;
    ghost = (nx & 1) && ox0 <= nx - 2 && nx - 2 < ox1;
    no = ((ox1 - ox0) >> 1) + (ghost ? 1 : 0);
  };
  if (!((L.active >> k) & 1u)) {  // a frozen lane: unchanged, zero residual
    if (C) {
      int ne, no;
      bool ghost;
      segments(ne, no, ghost);
      for (int z = oz0; z < oz1; ++z) {
        const int rp = (z + oy0 + warp) & 1;
        for (int y = oy0 + warp; y < oy1; y += nw) {
          const I row = hrow(z, y) + (I)(ox0 >> 1);
          for (int l = lane; l < ne; l += 32) (rp ? db : d)[row + l] = (rp ? sb : s)[row + l];
          for (int l = lane; l < no; l += 32) (rp ? d : db)[row + l] = (rp ? s : sb)[row + l];
        }
      }
      return;
    }
    for (int z = oz0; z < oz1; ++z)
      for (int y = oy0 + warp; y < oy1; y += nw)
        for (int x = ox0 + lane; x < ox1; x += 32) {
          d[ot(z, y, x)] = s[at(z, y, x)];
          if (r) r[ot(z, y, x)] = 0.0f;
        }
    return;
  }
  const float* f = rhs + base;
  const float* fb = C ? Hb.rhs + base : nullptr;
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
    if (C && q < NZ) {
      // one 4-byte copy a lane and half of a row (WX <= 64); the thread's
      // rows share their parity
      const int o = (q % T.ring) * plane, gz = wz0 + q, rp = (gz + wy0 + warp) & 1;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int j = warp + nw * m;
        if (j >= WY) continue;
        const I row = hrow(gz, wy0 + j) + (I)(wx0 >> 1);
        float* su = U + o + j * SX;
        float* sf = F + o + j * SX;
        if (lane < (WX + 1) >> 1) {
          cp_async4(su + lane, (rp ? sb : s) + row + lane);
          cp_async4(sf + lane, (rp ? fb : f) + row + lane);
        }
        if (lane < WX >> 1) {
          cp_async4(su + HX + lane, (rp ? s : sb) + row + lane);
          cp_async4(sf + HX + lane, (rp ? f : fb) + row + lane);
        }
      }
    } else if (q < NZ) {
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
  // distance d from a cut edge (a window edge that is not a domain face;
  // with `cut`, the array's ends too) is right after stage s only while
  // d >= s, so stage st (0-based) updates it only when d > st; never a
  // point outside the window or on a Dirichlet face of the level (-1; g0
  // and ng place the array in the level).
  constexpr int kFar = 1 << 20;
  auto reach = [&](int i, int n, int w0_, int w1_, int W, bool dlo, bool dhi, int g0, int ng,
                   bool cut) {
    const int g = g0 + w0_ + i;
    if (i >= W || (dlo && g == 0) || (dhi && g == ng - 1)) return -1;
    return min(cut || w0_ > 0 ? i : kFar, cut || w1_ < n ? W - 1 - i : kFar);
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
    xr[e] = reach(i, nx, wx0, wx1, WX, dm & 16, dm & 32, 0, nx, false);
    xo[e] = col(i);
    xl[e] = col(gx == 0 ? i + 1 : i - 1);
    xh[e] = col(gx == nx - 1 ? i - 1 : i + 1);
  }
  int yo[kRows], yl[kRows], yh[kRows], yr[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int j = warp + nw * a, gy = wy0 + j;
    yr[a] = reach(j, ny, wy0, wy1, WY, dm & 4, dm & 8, gy0, nyg, cuty);
    yo[a] = j * SX;
    yl[a] = (gy == 0 ? j + 1 : j - 1) * SX;  // the array's ends: never updated when cut
    yh[a] = (gy == ny - 1 ? j - 1 : j + 1) * SX;
  }
  // Half-sweep st (0-based: colour = first colour ^ (st & 1)) on plane q
  // in ring slot sq (its z neighbours in slots sl, sh): all the thread's
  // loads before its stores (the stage reads only the other colour).
  auto sweep = [&](int st, int q, int sq, int sl, int sh) {
    const int gz = wz0 + q;
    if (reach(q, nz, wz0, wz1, NZ, dm & 1, dm & 2, gz0, nzg, cutz) <= st) return;
    if (gz == 0) sl = sh;       // reflection: plane -1 reads plane 1
    if (gz == nz - 1) sh = sl;  // and plane nz reads plane nz - 2
    // column 2l + e has the colour: (Gz + Gy + gx) & 1 == colour, with
    // Gz the plane's global index, Gy = gy0 + wy0 + warp (mod 2) and
    // gx = wx0 + e (mod 2)
    const int e = (color ^ (st & 1) ^ (gz0 + gz) ^ (gy0 + wy0) ^ warp ^ wx0) & 1;
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
    if (C) {  // the tile's two segments of each row, the ghost from x = nx - 2
      int ne, no;
      bool ghost;
      segments(ne, no, ghost);
      const int gz = wz0 + q, rp = (gz + oy0 + warp) & 1;
      const int s0 = (ox0 - wx0) >> 1;
      float* de = rp ? db : d;
      float* dd = rp ? d : db;
      for (int y = oy0 + warp; y < oy1; y += nw) {
        const I row = hrow(gz, y) + (I)(ox0 >> 1);
        const float* ue = u + (y - wy0) * SX + s0;
        for (int l = lane; l < ne; l += 32) de[row + l] = ue[l];
        for (int l = lane; l < no; l += 32)
          dd[row + l] = ue[HX + (ghost && l == no - 1 ? l - 1 : l)];
      }
      return;
    }
    for (int y = oy0 + warp; y < oy1; y += nw) {
      const I row = ot(wz0 + q, y, 0);
      for (int x = ox0 + lane; x < ox1; x += 32) d[row + x] = u[(y - wy0) * SX + col(x - wx0)];
    }
  };
  // r = rhs - L[u] on the tile of final plane q (lane_residual's order).
  // The reflections at the array's ends never meet a real point of a
  // shard (its halo is >= 1 a side).
  auto residual = [&](int q) {
    const int gz = wz0 + q;
    const float* u = U + (q % T.ring) * plane;
    const float* ul = U + ((gz == 0 ? q + 1 : q - 1) % T.ring) * plane;
    const float* uh = U + ((gz == nz - 1 ? q - 1 : q + 1) % T.ring) * plane;
    const float* fr = F + (q % T.ring) * plane;
    for (int y = oy0 + warp; y < oy1; y += nw) {
      const I row = ot(gz, y, 0);
      const int j = y - wy0;
      const int rl = (y == 0 ? j + 1 : j - 1) * SX, rh = (y == ny - 1 ? j - 1 : j + 1) * SX;
      for (int x = ox0 + lane; x < ox1; x += 32) {
        if (on_dirichlet_face(gz0 + gz, gy0 + y, x, nzg, nyg, nx, dm)) {
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
  if (!S && T.resident) {
    // The whole lane in shared memory: load every plane (u + cor added on
    // the way), then the half-sweeps in order, each over every plane (a
    // half-sweep reads only the other colour, so its planes need no
    // barrier between them), then the stores and the residual.
    if (C) {
      for (int q = 0; q < NZ; ++q) load(q);
      cp_async_wait_all();
    } else {
      for (int q = 0; q < NZ; ++q)
        for (int j = warp; j < WY; j += nw)
          for (int i = lane; i < WX; i += 32) {
            const I g = at(q, j, i);
            const int e = q * plane + j * SX + col(i);
            U[e] = c ? s[g] + c[g] : s[g];
            F[e] = f[g];
          }
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
// computes the same; ny is the array's extent, the shard's extended one).
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

// Launch one pass over a grid of (tiles in y x x, z chunks, lanes) blocks.
// Refuses (cudaErrorInvalidValue) a geometry whose shared memory exceeds
// the H100's 227 KB a block or whose window exceeds 64 x 64 points in
// (y, x); opens the dynamic shared memory of the kernel on the current
// device at its first launch there that needs more than 48 KB.
template <bool S, bool C = false>
inline int launch_pass(const float* src, const float* cor, const float* rhs, float* dst,
                       float* r, const HalfB& Hb, int nz, int ny, int nx, const Lanes& L,
                       const PassTile& T, const ShardBlock& G, dim3 grid, float wz, float wy,
                       float wx, float w0, cudaStream_t stream) {
  const long long smem = pass_smem(T);
  if (smem > kMaxSmem || T.sx > 64 || T.sy > kRows * kPassThreads / 32)
    return (int)cudaErrorInvalidValue;
  const bool small = small_lane(nz, ny, nx);
  auto kern = small ? lane_pass<unsigned, S, C> : lane_pass<unsigned long long, S, C>;
  constexpr int kDevices = 64;
  static bool opened[2][kDevices] = {};  // dynamic smem opened, per index type and device
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    bool& done = opened[small ? 0 : 1][dev < kDevices ? dev : kDevices - 1];
    if (!done || dev >= kDevices) {
      rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (rc != cudaSuccess) return (int)rc;
      done = true;
    }
  }
  kern<<<grid, kPassThreads, (size_t)smem, stream>>>(src, cor, rhs, dst, r, Hb, nz, ny, nx, L, T,
                                                      G, wz, wy, wx, w0);
  return (int)cudaGetLastError();
}

}  // namespace ndsm
