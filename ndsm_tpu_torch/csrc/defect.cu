// Mixed-precision outer defect, float64: the Hopper kernels behind ops/df.py
// and ops/df_sharded.py.
//
// Replaces ndsm_tpu/ops/pallas_df.py: df_residual_3d (with its zero_rhs
// and update variants).  On the TPU, f64 was software-emulated, so that
// kernel carried u as an f32 (hi, lo) pair with compensated arithmetic.
// Hopper has native f64, so these kernels compute in f64 directly:
//
//   v = u (+ (double)e)                     update variant: v is written out
//   r = rhs - L[v]                          rhs == nullptr: the zero-rhs form
//   r32 = (float)r, zero on Dirichlet faces
//   block_max[b] = max |r32| over block b   reduced by the wrapper
//
// L[v] is ndsm_tpu/ops/stencils.py's poisson_residual order in f64 with
// w = 1/(dq*dq) in f64: per axis ((lo - 2v) + hi) * w, summed z, y, x.
//
// defect_tile_f64, the z-marching tile (the kernel of df_residual_3d): a
// block owns a (kTileY, kTileX) column tile and marches z over a chunk of
// planes.  Each point's v is formed once a block: into registers for the
// thread's own points (the planes below, at and above, rotated as the
// march goes), and into a shared-memory plane with a one-point y/x halo
// (Neumann reflection applied when the halo is loaded), from which the y
// and x neighbours are read.  The next plane's loads are issued before
// the current plane's barrier, the plane is double-buffered (one barrier
// a step), and u_out and r32 are written coalesced.  The chunks are chosen
// so that every block of the launch is resident at once (one wave), and
// each block writes one maximum.
//
// What bounds it on the H100: device-memory bandwidth -- 8 (u) + 8 (rhs)
// + 4 (r32) bytes per point, plus 4 (e) + 8 (u_out) for the update; the
// zero-rhs update form the vector-potential solves use moves 24 B/point,
// plus the re-read of the tile's halo (1/8 of u and e at 32 x 16) and of a
// chunk's two end planes.  f64 arithmetic (~20 operations a point) is far
// below the H100's f64 rate.
//
// The same defect on one shard of a level partitioned in z, or in z and y
// (replaces ndsm_tpu/ops/pallas_df.py: df_residual_sharded_3d with parts
// (0,) and (0, 1), its zero_rhs and update variants).  u (and e) are the
// shard's block extended by one halo plane a side in z and hy (0 or 1) in
// y, (nz + 2, ny + 2hy, nx), filled by the engine with the neighbours'
// planes or, at the ends of a line, node-mirror planes (z first, then y on
// the z-extended block, so the corners hold the diagonal neighbours'
// values); rhs and r32 are the real block (nz, ny, nx).  The update writes
// v = u + e over the whole extended block (the engine carries it across
// defect groups), the residual is taken over the real points only, whose z
// and y neighbours on the block's edges are halo points, and Dirichlet
// faces are tested in global z and y (z0 + kz - 1 against NZ, y0 + ky - hy
// against NY).  Over the real block r32 equals defect_f64's on the whole
// level bit for bit: the halo planes hold the values the reflection would
// read.  The z form passes hy = 0, y0 = 0, NY = ny.
//
// Its kernel is the shard form of the tile (template flag S): the tiles
// and z chunks cover the real block (tile_grid on its extents), a point's
// z neighbours on the chunk's ends and its y neighbours on the tile's
// edges are read from u, where along a partitioned axis the block's ends
// are halo planes (rows), read as data; along x, and along y on a z mesh,
// the tile's reflection stays.  The update's halo points are written by
// their owners: a halo plane by the first (last) z chunk of each tile
// column, a halo row by the y-halo threads of the edge tiles at every
// plane of their chunk, a corner by those threads of the first (last)
// chunk.

#include "stencil.cuh"

namespace ndsm {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Block max of |r32| (a: this thread's), NaN-propagating like torch.max.
__device__ __forceinline__ void write_block_max(float a, float* block_max) {
  for (int off = 16; off > 0; off >>= 1)
    a = nan_max(a, __shfl_down_sync(0xffffffffu, a, off));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    block_max[blockIdx.x] = m;
  }
}

// ---- the z-marching tile

constexpr int kTileX = 32, kTileY = 16;
constexpr int kTileRows = kTileY / (kThreads / kTileX);  // own points a thread a plane
constexpr int kHaloPoints = 2 * (kTileX + kTileY);       // the plane's y and x halo

// Tiles and z chunks of a level: the chunks fill the card's resident blocks
// (one wave), as a block's z chunk of cz planes.
struct TileGrid {
  int tiles_x, tiles_y, cz, blocks;
};

// Where a shard's real block lies (the shard form): hy halo rows a side in
// y (0 or 1; one halo plane a side in z), the level's index (z0, y0) of its
// (0, 0), the level's extents (NZ, NY).
struct ShardDefect {
  int hy, z0, y0, NZ, NY;
};

// The defect of a (kTileY, kTileX) column tile over a z chunk; with S the
// shard form (D its block): nz, ny, nx are the real block's extents.
template <bool S>
__global__ void __launch_bounds__(kThreads)
defect_tile_f64(const double* __restrict__ u, const float* __restrict__ e,
                double* __restrict__ u_out, const double* __restrict__ rhs,
                float* __restrict__ r32, float* __restrict__ block_max, int nz, int ny,
                int nx, int dmask, double wz, double wy, double wx, int tiles_x,
                int tiles_y, int cz, ShardDefect D) {
  // v of the current plane over the tile and its halo, double-buffered
  __shared__ double plane[2][kTileY + 2][kTileX + 2];
  // u's plane and row of the real block's (0, 0); the level's index of it
  // and its extents (the whole level without S)
  const int zo = S ? 1 : 0, yo = S ? D.hy : 0;
  const int gz0 = S ? D.z0 : 0, gy0 = S ? D.y0 : 0;
  const int NZ = S ? D.NZ : nz, NY = S ? D.NY : ny;
  const int tiles = tiles_x * tiles_y;
  const int tile = blockIdx.x % tiles, chunk = blockIdx.x / tiles;
  const int x0 = (tile % tiles_x) * kTileX, y0 = (tile / tiles_x) * kTileY;
  const int ex = min(kTileX, nx - x0), ey = min(kTileY, ny - y0);
  const int z0 = chunk * cz, z1 = min(nz, z0 + cz);
  const int lx = threadIdx.x % kTileX, ly = threadIdx.x / kTileX;
  const long long sz = (long long)ny * nx;               // a plane of rhs and r32
  const long long su = (long long)(ny + 2 * yo) * nx;    // a plane of u, e, u_out
  auto v = [&](long long q) { return e ? u[q] + (double)e[q] : u[q]; };
  // u's plane below and above real plane z: the halo planes (S), or the
  // reflection at the level's faces
  auto zlo = [&](int z) { return S ? z : reflect_lo(z); };
  auto zhi = [&](int z) { return S ? z + 2 : reflect_hi(z, nz); };

  // own points: (y0 + ly + 8j, x0 + lx), j < kTileRows
  const int x = x0 + lx;
  bool own[kTileRows];
  long long at[kTileRows], au[kTileRows];  // offset of the point in plane 0 of rhs / of u
#pragma unroll
  for (int j = 0; j < kTileRows; ++j) {
    const int y = y0 + ly + j * (kThreads / kTileX);
    own[j] = lx < ex && ly + j * (kThreads / kTileX) < ey;
    at[j] = (long long)y * nx + x;
    au[j] = (long long)(y + yo) * nx + x;
  }
  // this thread's halo point (threads < kHaloPoints): the rows below and
  // above the tile, then the columns left and right of it, reflected at the
  // domain's faces, or (S, hy = 1) the block's halo rows beyond its y ends;
  // (hy, hx) is its slot in the plane, hat its offset in plane 0 of u.
  // `edge`: the point lies on a halo row of the block (S, hy = 1, the tile
  // at that end), which the update writes
  const int t = threadIdx.x;
  bool halo = false, edge = false;
  long long hat = 0;
  int hy = 0, hx = 0;
  if (t < 2 * kTileX) {
    const int i = t % kTileX, up = t / kTileX;
    halo = i < ex;
    const int yr = up ? y0 + ey : y0 - 1;  // the real row, -1 or ny past the ends
    const int y = yo ? yr + yo : (up ? (yr < ny ? yr : ny - 2) : (yr >= 0 ? yr : 1));
    edge = S && yo && halo && (yr < 0 || yr >= ny);
    hat = (long long)y * nx + x0 + i;
    hy = up ? ey + 1 : 0;
    hx = i + 1;
  } else if (t < kHaloPoints) {
    const int i = (t - 2 * kTileX) % kTileY, right = (t - 2 * kTileX) / kTileY;
    halo = i < ey;
    const int xx = right ? (x0 + ex < nx ? x0 + ex : nx - 2) : (x0 > 0 ? x0 - 1 : 1);
    hat = (long long)(y0 + i + yo) * nx + xx;
    hy = i + 1;
    hx = right ? ex + 1 : 0;
  }

  // the march: registers hold v below (vp), at (vc) and above (vn) plane z
  double vp[kTileRows], vc[kTileRows], vn[kTileRows], rh[kTileRows];
  double hv = 0.0;
#pragma unroll
  for (int j = 0; j < kTileRows; ++j) {
    vp[j] = vc[j] = vn[j] = rh[j] = 0.0;
    if (!own[j]) continue;
    vp[j] = v(zlo(z0) * su + au[j]);
    vc[j] = v((z0 + zo) * su + au[j]);
    vn[j] = v(zhi(z0) * su + au[j]);
    if (rhs) rh[j] = rhs[z0 * sz + at[j]];
  }
  if (halo) hv = v((z0 + zo) * su + hat);
  if (S && u_out && z0 == 0) {  // the lower halo plane (the first chunk)
#pragma unroll
    for (int j = 0; j < kTileRows; ++j)
      if (own[j]) u_out[au[j]] = vp[j];
    if (edge) u_out[hat] = v(hat);
  }

  float a = 0.0f;
  for (int z = z0; z < z1; ++z) {
    double(*pl)[kTileX + 2] = plane[(z - z0) & 1];
#pragma unroll
    for (int j = 0; j < kTileRows; ++j)
      if (own[j]) pl[ly + 1 + j * (kThreads / kTileX)][lx + 1] = vc[j];
    if (halo) pl[hy][hx] = hv;
    // the next plane's loads, in flight across the barrier and the update
    const bool next = z + 1 < z1;
    double nu[kTileRows], nr[kTileRows];
    float ne[kTileRows];
    double nhu = 0.0;
    float nhe = 0.0f;
#pragma unroll
    for (int j = 0; j < kTileRows; ++j) {
      nu[j] = nr[j] = 0.0;
      ne[j] = 0.0f;
      if (!next || !own[j]) continue;
      const long long q = zhi(z + 1) * su + au[j];
      nu[j] = u[q];
      if (e) ne[j] = e[q];
      if (rhs) nr[j] = rhs[(z + 1) * sz + at[j]];
    }
    if (next && halo) {
      nhu = u[(z + 1 + zo) * su + hat];
      if (e) nhe = e[(z + 1 + zo) * su + hat];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTileRows; ++j) {
      if (!own[j]) continue;
      const int py = ly + 1 + j * (kThreads / kTileX), px = lx + 1;
      const int y = y0 + py - 1;
      const long long p = z * sz + at[j];
      if (u_out) u_out[(z + zo) * su + au[j]] = vc[j];
      float rv = 0.0f;
      if (!on_dirichlet_face(gz0 + z, gy0 + y, x, NZ, NY, nx, dmask)) {
        const double c2 = 2.0 * vc[j];
        double s = ((vp[j] - c2) + vn[j]) * wz;
        s = s + ((pl[py - 1][px] - c2) + pl[py + 1][px]) * wy;
        s = s + ((pl[py][px - 1] - c2) + pl[py][px + 1]) * wx;
        rv = (float)(rh[j] - s);
      }
      r32[p] = rv;
      a = nan_max(a, fabsf(rv));
    }
    if (S && u_out && edge) u_out[(z + zo) * su + hat] = hv;  // a halo row
    if (next) {
#pragma unroll
      for (int j = 0; j < kTileRows; ++j) {
        vp[j] = vc[j];
        vc[j] = vn[j];
        vn[j] = e ? nu[j] + (double)ne[j] : nu[j];
        rh[j] = nr[j];
      }
      hv = e ? nhu + (double)nhe : nhu;
    }
  }
  if (S && u_out && z1 == nz) {  // the upper halo plane (the last chunk)
    const long long top = (long long)(nz + 1) * su;
#pragma unroll
    for (int j = 0; j < kTileRows; ++j)
      if (own[j]) u_out[top + au[j]] = vn[j];
    if (edge) u_out[top + hat] = v(top + hat);
  }
  write_block_max(a, block_max);
}

// The tile kernel's grid: z chunks so that tiles * chunks blocks are all
// resident at once (the card's SMs times the blocks an SM holds), each at
// least one plane; (nz, ny, nx) the real block with S.
template <bool S>
inline TileGrid tile_grid(int nz, int ny, int nx) {
  static int dev_seen = -1, slots = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != dev_seen) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, defect_tile_f64<S>, kThreads, 0);
    slots = sms * per_sm;
    dev_seen = dev;
  }
  TileGrid g;
  g.tiles_x = (nx + kTileX - 1) / kTileX;
  g.tiles_y = (ny + kTileY - 1) / kTileY;
  const int tiles = g.tiles_x * g.tiles_y;
  int chunks = slots / tiles;
  chunks = chunks < 1 ? 1 : (chunks > nz ? nz : chunks);
  g.cz = (nz + chunks - 1) / chunks;
  g.blocks = tiles * ((nz + g.cz - 1) / g.cz);
  return g;
}

}  // namespace ndsm

// Block maxima the tile kernel writes.
extern "C" int ndsm_defect_tile_blocks(int nz, int ny, int nx) {
  return ndsm::tile_grid<false>(nz, ny, nx).blocks;
}

// Block maxima the shard form of the tile writes, (nz, ny, nx) the real
// block.
extern "C" int ndsm_defect_sharded_tile_blocks(int nz, int ny, int nx) {
  return ndsm::tile_grid<true>(nz, ny, nx).blocks;
}

extern "C" int ndsm_defect_f64(const void* u, const void* e, void* u_out,
                               const void* rhs, void* r32, void* block_max,
                               int nz, int ny, int nx, int dmask, double wz,
                               double wy, double wx, void* stream) {
  const ndsm::TileGrid g = ndsm::tile_grid<false>(nz, ny, nx);
  ndsm::defect_tile_f64<false><<<g.blocks, ndsm::kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)u, (const float*)e, (double*)u_out, (const double*)rhs,
      (float*)r32, (float*)block_max, nz, ny, nx, dmask, wz, wy, wx, g.tiles_x,
      g.tiles_y, g.cz, ndsm::ShardDefect{});
  return (int)cudaGetLastError();
}

// The defect of a shard's real block (nz, ny, nx) from its extended block
// (nz + 2, ny + 2hy, nx): one launch of the shard form of the tile,
// ndsm_defect_sharded_tile_blocks maxima.  (z0, y0) is the level's index
// of the real block's (0, 0), (NZ, NY) the level's extents.
extern "C" int ndsm_defect_sharded_tile_f64(const void* u, const void* e, void* u_out,
                                            const void* rhs, void* r32, void* block_max,
                                            int nz, int ny, int nx, int hy, int z0, int y0,
                                            int NZ, int NY, int dmask, double wz, double wy,
                                            double wx, void* stream) {
  if (hy != 0 && hy != 1) return (int)cudaErrorInvalidValue;
  const ndsm::TileGrid g = ndsm::tile_grid<true>(nz, ny, nx);
  ndsm::defect_tile_f64<true><<<g.blocks, ndsm::kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)u, (const float*)e, (double*)u_out, (const double*)rhs,
      (float*)r32, (float*)block_max, nz, ny, nx, dmask, wz, wy, wx, g.tiles_x,
      g.tiles_y, g.cz, ndsm::ShardDefect{hy, z0, y0, NZ, NY});
  return (int)cudaGetLastError();
}
