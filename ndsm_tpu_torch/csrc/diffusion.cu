// DiffusionOperator's relax and residual on 3D levels: the Hopper kernels
// behind ops/diffusion.py (mg/operator.py's DiffusionOperator calls them).
//
// Replaces no TPU kernel: the JAX package runs this operator on XLA (plain
// jnp code, ndsm_tpu/mg/operator.py), and the port ran it as plain tensor
// code, ~51 elementwise launches a sweep, each streaming a whole level.
// Both the operator's docstrings name this route: an operator whose relax
// launches a kernel of its own gets kernel speed with no engine change.
//
// What the kernels compute (ops/diffusion.py's plain version, in its order):
//
//   a          the coefficient at the level's nodes (one array of u's shape)
//   alo, ahi   per axis 0.5 * (a + a[lo]), 0.5 * (a + a[hi]), the neighbours
//              taken with the stencil's Neumann index reflection, for a as
//              for u (csrc/stencil.cuh)
//   sweep      the first colour (points whose index sum has parity c0), then
//              the second, each point off the Dirichlet faces set to
//                (num - rhs) / den,
//                num = ((alo*u[lo] + ahi*u[hi])*wz + (...)*wy) + (...)*wx,
//                den = ((alo + ahi)*wz + (alo + ahi)*wy) + (alo + ahi)*wx,
//              the second colour reading the first's new values
//   residual   rhs - (((ahi*(u[hi] - u) - alo*(u - u[lo]))*wz + (...)*wy)
//              + (...)*wx), zero on the Dirichlet faces
//
// The face coefficients and den are formed in registers from a, so a level
// keeps one coefficient array, not six half arrays and den.  Every product
// and sum is rounded on its own (-fmad=false) and the division is IEEE: the
// kernels equal the plain version bit for bit, in float32 and float64.
//
// What bounds them on the H100: device-memory bandwidth.  A sweep moves u in
// and out, rhs and a: 16 B/point in float32, 32 in float64; a residual u, rhs,
// a and r: 16 / 32 B/point.  The arithmetic (~40 operations a point) is far
// below the card's rates.  The plain version moved ~51 whole levels a sweep.
//
// The design: a z-marching column tile, as csrc/defect.cu's defect_tile_f64.
// A block owns a (kTY, kTX) column tile and marches z over a chunk of
// planes, with a ring of kRing planes of u and a in shared memory.
//   * The sweep is one launch, out of place.  Its planes hold the tile and a
//     two-point y/x halo.  At each step the block loads plane k + 2, updates
//     the first colour of plane k + 1 in place in the ring over the tile and
//     a one-point halo (the halo points are a neighbour block's, recomputed
//     here from the same inputs, so with the same bits), then the second
//     colour of plane k over the tile, which reads the first colour's new
//     values, and writes plane k of the result.  A first-colour point reads
//     only second-colour points, which are still the input's, so updating
//     in place is safe.  A chunk starts by loading two planes below it and
//     updating the first colour of the plane below it.
//   * The residual loads the tile and a one-point halo, one plane a step.
//   * A step's global loads (the next plane of u and a, the rhs of the
//     next step's points) are issued into registers a step ahead of their
//     use, so they are in flight across the step's barriers and arithmetic;
//     the registers go into the ring at the top of the next step.  Loads
//     and stores of a row are coalesced; the chunks fill the card's
//     resident blocks (one wave), up to kMaxPlanes planes (tile_grid).

#include "stencil.cuh"

namespace ndsm {
namespace diffusion {

constexpr int kTX = 32, kTY = 16;  // the output tile of a block (x, y)
constexpr int kBlock = 256;        // threads a block: one pair of x a thread
constexpr int kRing = 4;           // planes of u and a in shared memory
constexpr int kMinPlanes = 4;      // least planes a chunk of the sweep marches
constexpr int kMaxPlanes = 32;     // most planes a chunk marches
static_assert(kBlock * 2 == kTX * kTY, "the second colour takes one x pair a thread");

// Tiles and z chunks of a level (as defect.cu's TileGrid).
struct Grid {
  int tiles_x, tiles_y, cz, blocks;
};

// One red-black sweep of div(a grad u) = rhs over the level (nz, ny, nx),
// out of place: u and a of the tile's planes in the ring, the first colour
// of parity c0 (of z + y + x), Dirichlet faces in dmask (csrc/stencil.cuh).
template <typename T>
__global__ void __launch_bounds__(kBlock)
sweep_tile(const T* __restrict__ u, const T* __restrict__ rhs, const T* __restrict__ a,
           T* __restrict__ out, int nz, int ny, int nx, int dmask, int c0, T wz, T wy,
           T wx, int tiles_x, int cz) {
  constexpr int H = kTY + 4, W = kTX + 4;                      // the tile, a two-point halo
  constexpr int kLoads = (H * W + kBlock - 1) / kBlock;        // a thread's points of a plane
  constexpr int kPairs = kTX / 2 + 1;                          // x pairs a row, one-point halo
  constexpr int kFirst = ((kTY + 2) * kPairs + kBlock - 1) / kBlock;  // first-colour points
  __shared__ T su[kRing][H][W];
  __shared__ T sa[kRing][H][W];
  const int tiles = tiles_x * ((ny + kTY - 1) / kTY);
  const int tile = blockIdx.x % tiles, chunk = blockIdx.x / tiles;
  const int x0 = (tile % tiles_x) * kTX, y0 = (tile / tiles_x) * kTY;
  const int z0 = chunk * cz, z1 = min(nz, z0 + cz);
  const long long sp = (long long)ny * nx;

  // this thread's points of a plane's load (slot index threadIdx.x + m *
  // kBlock): their offset in the plane, -1 outside the level
  int lq[kLoads];
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int i = threadIdx.x + m * kBlock;
    const int y = y0 - 2 + i / W, x = x0 - 2 + i % W;
    lq[m] = i < H * W && y >= 0 && y < ny && x >= 0 && x < nx ? y * nx + x : -1;
  }
  // a plane of u and a in registers (the next to go into the ring), and rhs
  // at this thread's points of the next first-colour and second-colour steps
  T ru[kLoads], ra[kLoads], rf[kFirst], rs = T(0);
  auto fetch = [&](int p) {
#pragma unroll
    for (int m = 0; m < kLoads; ++m)
      if (lq[m] >= 0) {
        ru[m] = u[p * sp + lq[m]];
        ra[m] = a[p * sp + lq[m]];
      }
  };
  auto stash = [&](int p) {
    T* pu = &su[p & (kRing - 1)][0][0];
    T* pa = &sa[p & (kRing - 1)][0][0];
#pragma unroll
    for (int m = 0; m < kLoads; ++m)
      if (lq[m] >= 0) {
        pu[threadIdx.x + m * kBlock] = ru[m];
        pa[threadIdx.x + m * kBlock] = ra[m];
      }
  };
  // the thread's m-th first-colour point of plane p over the tile and a
  // one-point halo (row r, column c of that region; false: none to update)
  auto first_at = [&](int p, int m, int& r, int& c, int& y, int& x) {
    const int i = threadIdx.x + m * kBlock;
    r = i / kPairs;
    y = y0 - 1 + r;
    c = 2 * (i - r * kPairs) + ((c0 ^ (p + y + x0 - 1)) & 1);
    x = x0 - 1 + c;
    return i < (kTY + 2) * kPairs && y >= 0 && y < ny && x >= 0 && x < nx &&
           !on_dirichlet_face(p, y, x, nz, ny, nx, dmask);
  };
  // the thread's second-colour point of plane k: row r, the h-th of its x pair
  const int r2 = threadIdx.x / (kTX / 2), j2 = threadIdx.x % (kTX / 2), y2 = y0 + r2;
  auto second_at = [&](int k, int& x) {
    x = x0 + 2 * j2 + ((c0 ^ 1 ^ (k + y2 + x0)) & 1);
    return y2 < ny && x < nx && !on_dirichlet_face(k, y2, x, nz, ny, nx, dmask);
  };
  auto fetch_first = [&](int p) {
#pragma unroll
    for (int m = 0; m < kFirst; ++m) {
      int r, c, y, x;
      if (first_at(p, m, r, c, y, x)) rf[m] = rhs[p * sp + (long long)y * nx + x];
    }
  };
  auto fetch_second = [&](int k) {
    int x;
    if (second_at(k, x)) rs = rhs[k * sp + (long long)y2 * nx + x];
  };
  // the new value of point (p, y, x) of the level, at (ly, lx) of its slot
  auto update = [&](int p, int y, int x, int ly, int lx, T b) -> T {
    const int s = p & (kRing - 1);
    const int zl = reflect_lo(p) & (kRing - 1), zh = reflect_hi(p, nz) & (kRing - 1);
    const int yl = reflect_lo(y) - y0 + 2, yh = reflect_hi(y, ny) - y0 + 2;
    const int xl = reflect_lo(x) - x0 + 2, xh = reflect_hi(x, nx) - x0 + 2;
    const T ac = sa[s][ly][lx];
    T alo = T(0.5) * (ac + sa[zl][ly][lx]), ahi = T(0.5) * (ac + sa[zh][ly][lx]);
    T num = (alo * su[zl][ly][lx] + ahi * su[zh][ly][lx]) * wz;
    T den = (alo + ahi) * wz;
    alo = T(0.5) * (ac + sa[s][yl][lx]);
    ahi = T(0.5) * (ac + sa[s][yh][lx]);
    num = num + (alo * su[s][yl][lx] + ahi * su[s][yh][lx]) * wy;
    den = den + (alo + ahi) * wy;
    alo = T(0.5) * (ac + sa[s][ly][xl]);
    ahi = T(0.5) * (ac + sa[s][ly][xh]);
    num = num + (alo * su[s][ly][xl] + ahi * su[s][ly][xh]) * wx;
    den = den + (alo + ahi) * wx;
    return (num - b) / den;
  };
  // the first colour of plane p over the tile and its one-point halo, in
  // place, from the rhs in rf
  auto first = [&](int p) {
#pragma unroll
    for (int m = 0; m < kFirst; ++m) {
      int r, c, y, x;
      if (first_at(p, m, r, c, y, x)) su[p & (kRing - 1)][r + 1][c + 1] =
          update(p, y, x, r + 1, c + 1, rf[m]);
    }
  };
  // the second colour of plane k over the tile, from the rhs in rs, and
  // plane k of the result: the thread's x pair of row r2
  auto second = [&](int k) {
    if (y2 >= ny) return;
    int xs;
    const bool upd = second_at(k, xs);
    const T v = upd ? update(k, y2, xs, r2 + 2, xs - x0 + 2, rs) : T(0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + 2 * j2 + h;
      if (x < nx)
        out[k * sp + (long long)y2 * nx + x] =
            upd && x == xs ? v : su[k & (kRing - 1)][r2 + 2][2 * j2 + h + 2];
    }
  };

  // The march.  On entering step k the ring holds planes k - 1 to k + 1
  // with the first colour updated up to plane k, the registers plane k + 2
  // and the rhs of first(k + 1) and second(k).  Each step's loads are
  // issued a step ahead of their use.
  for (int p = max(z0 - 2, 0); p <= min(z0 + 1, nz - 1); ++p) {
    fetch(p);
    stash(p);
  }
  __syncthreads();
  for (int p = max(z0 - 1, 0); p <= z0; ++p) {
    fetch_first(p);
    first(p);
  }
  if (z0 + 2 < nz) fetch(z0 + 2);
  if (z0 + 1 < nz) fetch_first(z0 + 1);
  fetch_second(z0);
  __syncthreads();
  for (int k = z0; k < z1; ++k) {
    const bool more = k + 1 < z1;  // another step follows
    if (k + 2 < nz) {
      stash(k + 2);  // into the slot of plane k - 2, no longer read
      if (more && k + 3 < nz) fetch(k + 3);
    }
    __syncthreads();
    if (k + 1 < nz) {
      first(k + 1);
      if (more && k + 2 < nz) fetch_first(k + 2);
    }
    __syncthreads();
    second(k);
    if (more) fetch_second(k + 1);
    __syncthreads();  // the next stash takes the slot of plane k - 1
  }
}

// The residual rhs - L[u] over the level, zero on the Dirichlet faces.
template <typename T>
__global__ void __launch_bounds__(kBlock)
residual_tile(const T* __restrict__ u, const T* __restrict__ rhs, const T* __restrict__ a,
              T* __restrict__ out, int nz, int ny, int nx, int dmask, T wz, T wy, T wx,
              int tiles_x, int cz) {
  constexpr int H = kTY + 2, W = kTX + 2;                // the tile and a one-point halo
  constexpr int kLoads = (H * W + kBlock - 1) / kBlock;  // a thread's points of a plane
  constexpr int kOwn = kTY * kTX / kBlock;               // its points of the tile
  __shared__ T su[kRing][H][W];
  __shared__ T sa[kRing][H][W];
  const int tiles = tiles_x * ((ny + kTY - 1) / kTY);
  const int tile = blockIdx.x % tiles, chunk = blockIdx.x / tiles;
  const int x0 = (tile % tiles_x) * kTX, y0 = (tile / tiles_x) * kTY;
  const int z0 = chunk * cz, z1 = min(nz, z0 + cz);
  const long long sp = (long long)ny * nx;

  int lq[kLoads];
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int i = threadIdx.x + m * kBlock;
    const int y = y0 - 1 + i / W, x = x0 - 1 + i % W;
    lq[m] = i < H * W && y >= 0 && y < ny && x >= 0 && x < nx ? y * nx + x : -1;
  }
  T ru[kLoads], ra[kLoads], rr[kOwn];
  auto fetch = [&](int p) {
#pragma unroll
    for (int m = 0; m < kLoads; ++m)
      if (lq[m] >= 0) {
        ru[m] = u[p * sp + lq[m]];
        ra[m] = a[p * sp + lq[m]];
      }
  };
  auto stash = [&](int p) {
    T* pu = &su[p & (kRing - 1)][0][0];
    T* pa = &sa[p & (kRing - 1)][0][0];
#pragma unroll
    for (int m = 0; m < kLoads; ++m)
      if (lq[m] >= 0) {
        pu[threadIdx.x + m * kBlock] = ru[m];
        pa[threadIdx.x + m * kBlock] = ra[m];
      }
  };
  // the thread's own points: rows r = (threadIdx.x + m * kBlock) / kTX
  auto fetch_rhs = [&](int k) {
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      const int i = threadIdx.x + m * kBlock, y = y0 + i / kTX, x = x0 + i % kTX;
      if (y < ny && x < nx) rr[m] = rhs[k * sp + (long long)y * nx + x];
    }
  };

  // On entering step k the ring holds planes k - 2 to k, the registers
  // plane k + 1 and the rhs of plane k.
  for (int p = max(z0 - 1, 0); p <= z0; ++p) {
    fetch(p);
    stash(p);
  }
  if (z0 + 1 < nz) fetch(z0 + 1);
  fetch_rhs(z0);
  for (int k = z0; k < z1; ++k) {
    if (k + 1 < nz) {
      stash(k + 1);  // into the slot of plane k - 3, no longer read
      if (k + 2 < nz && k + 1 < z1) fetch(k + 2);
    }
    __syncthreads();
    const int s = k & (kRing - 1);
    const int zl = reflect_lo(k) & (kRing - 1), zh = reflect_hi(k, nz) & (kRing - 1);
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      const int i = threadIdx.x + m * kBlock, r = i / kTX, c = i % kTX;
      const int y = y0 + r, x = x0 + c;
      if (y >= ny || x >= nx) continue;
      const long long q = k * sp + (long long)y * nx + x;
      if (on_dirichlet_face(k, y, x, nz, ny, nx, dmask)) {
        out[q] = T(0);
        continue;
      }
      const int ly = r + 1, lx = c + 1;
      const int yl = reflect_lo(y) - y0 + 1, yh = reflect_hi(y, ny) - y0 + 1;
      const int xl = reflect_lo(x) - x0 + 1, xh = reflect_hi(x, nx) - x0 + 1;
      const T uc = su[s][ly][lx], ac = sa[s][ly][lx];
      T alo = T(0.5) * (ac + sa[zl][ly][lx]), ahi = T(0.5) * (ac + sa[zh][ly][lx]);
      T t = (ahi * (su[zh][ly][lx] - uc) - alo * (uc - su[zl][ly][lx])) * wz;
      alo = T(0.5) * (ac + sa[s][yl][lx]);
      ahi = T(0.5) * (ac + sa[s][yh][lx]);
      t = t + (ahi * (su[s][yh][lx] - uc) - alo * (uc - su[s][yl][lx])) * wy;
      alo = T(0.5) * (ac + sa[s][ly][xl]);
      ahi = T(0.5) * (ac + sa[s][ly][xh]);
      t = t + (ahi * (su[s][ly][xh] - uc) - alo * (uc - su[s][ly][xl])) * wx;
      out[q] = rr[m] - t;
    }
    if (k + 1 < z1) fetch_rhs(k + 1);
  }
}

// The launch's grid: z chunks so that every block is resident at once (the
// card's SMs times the blocks an SM holds), each of at least `least` planes
// and at most kMaxPlanes.  The cap gives a large level several waves of
// short chunks: at 257^3 a one-wave chunk is 86 planes, and the blocks of
// the one-point edge tiles (257 = 8 * 32 + 1) hold their slots as long as
// full tiles' blocks.  On the H100 the 257^3 float32 sweep took 0.30 ms
// with 32-plane chunks against 0.33-0.35 ms in one wave (CUDA events, in
// turns in one call); its device busy time moved less, 0.2825 against
// 0.2881 ms (two runs on two machines).
template <typename K>
inline Grid tile_grid(K kernel, int& dev_seen, int& slots, int nz, int ny, int nx, int least) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != dev_seen) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
    slots = sms * per_sm;
    dev_seen = dev;
  }
  Grid g;
  g.tiles_x = (nx + kTX - 1) / kTX;
  g.tiles_y = (ny + kTY - 1) / kTY;
  const int tiles = g.tiles_x * g.tiles_y;
  int chunks = slots / tiles;
  chunks = chunks < 1 ? 1 : (chunks > nz ? nz : chunks);
  g.cz = (nz + chunks - 1) / chunks;
  if (g.cz > kMaxPlanes) g.cz = kMaxPlanes;
  if (g.cz < least) g.cz = least < nz ? least : nz;
  g.blocks = tiles * ((nz + g.cz - 1) / g.cz);
  return g;
}

template <typename T>
int sweep(const void* u, const void* rhs, const void* a, void* out, int nz, int ny, int nx,
          int dmask, int c0, T wz, T wy, T wx, void* stream) {
  static int dev_seen = -1, slots = 0;
  const Grid g = tile_grid(sweep_tile<T>, dev_seen, slots, nz, ny, nx, kMinPlanes);
  sweep_tile<T><<<g.blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)rhs, (const T*)a, (T*)out, nz, ny, nx, dmask, c0 & 1, wz, wy,
      wx, g.tiles_x, g.cz);
  return (int)cudaGetLastError();
}

template <typename T>
int residual(const void* u, const void* rhs, const void* a, void* out, int nz, int ny, int nx,
             int dmask, T wz, T wy, T wx, void* stream) {
  static int dev_seen = -1, slots = 0;
  const Grid g = tile_grid(residual_tile<T>, dev_seen, slots, nz, ny, nx, 1);
  residual_tile<T><<<g.blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)rhs, (const T*)a, (T*)out, nz, ny, nx, dmask, wz, wy, wx,
      g.tiles_x, g.cz);
  return (int)cudaGetLastError();
}

}  // namespace diffusion
}  // namespace ndsm

// One red-black sweep (no mean pinning) into out, which must not alias u;
// c0 the parity of the first colour's z + y + x.
extern "C" int ndsm_diffusion_sweep_f32(const void* u, const void* rhs, const void* a,
                                        void* out, int nz, int ny, int nx, int dmask, int c0,
                                        float wz, float wy, float wx, void* stream) {
  return ndsm::diffusion::sweep<float>(u, rhs, a, out, nz, ny, nx, dmask, c0, wz, wy, wx,
                                       stream);
}

extern "C" int ndsm_diffusion_sweep_f64(const void* u, const void* rhs, const void* a,
                                        void* out, int nz, int ny, int nx, int dmask, int c0,
                                        double wz, double wy, double wx, void* stream) {
  return ndsm::diffusion::sweep<double>(u, rhs, a, out, nz, ny, nx, dmask, c0, wz, wy, wx,
                                        stream);
}

extern "C" int ndsm_diffusion_residual_f32(const void* u, const void* rhs, const void* a,
                                           void* out, int nz, int ny, int nx, int dmask,
                                           float wz, float wy, float wx, void* stream) {
  return ndsm::diffusion::residual<float>(u, rhs, a, out, nz, ny, nx, dmask, wz, wy, wx,
                                          stream);
}

extern "C" int ndsm_diffusion_residual_f64(const void* u, const void* rhs, const void* a,
                                           void* out, int nz, int ny, int nx, int dmask,
                                           double wz, double wy, double wx, void* stream) {
  return ndsm::diffusion::residual<double>(u, rhs, a, out, nz, ny, nx, dmask, wz, wy, wx,
                                           stream);
}
