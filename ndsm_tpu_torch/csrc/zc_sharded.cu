// Red-black sweeps of one shard of a level partitioned in z, or in z and y,
// float32, on its halo-extended block, and the residual of the swept state
// over the real block: the Hopper kernels behind ops/zc_sharded.py.
//
// Replaces ndsm_tpu/ops/pallas_zc.py: zc_smooth_sharded_3d, its plain and
// residual forms, with ext_y False (a z-partitioned 1-D mesh) and True
// (the 2-D (z, y) mesh).  Its ext_out and halo_args forms are layouts of
// the TPU's DMA windows over the same sweeps and are not ported.
//
// The block is (nze, nye, nx) = (nz + 2Hz, ny + 2Hy, nx): the shard's
// nz x ny real points of each x row with Hz halo planes on each side in z
// and Hy in y (Hy = 0 on the 1-D mesh), filled by the engine with the
// neighbours' planes, or node-mirror planes at the ends of a line, z first
// and then y on the z-extended blocks, so the corners hold the diagonal
// neighbours' values (parallel/collectives.py).  Index (kz, ky) of the
// block is global (zg0 + kz, yg0 + ky), zg0 = z0 - Hz, yg0 = y0 - Hy.
//
// The design: a call is ONE launch of the shard form of the multi-sweep
// pass (lane_pass.cuh, template flag S), all ns sweeps in one pass (w =
// ns), the residual of the real block fused into it.  The extended block
// is what the pass calls a window: its partitioned ends are cut edges,
// and the real points lie Hz, Hy >= 2*ns (+1) from them, which is the
// pass's own rule for a window's halo.  So the pass tiles the real block,
// each block's window is its tile grown by 2*ns (+1) points, inside the
// extended block, and every real point sees the operands of the
// half-sweep sequence in the same order: colour (gz + gy + x) % 2 against
// the global first colour, the level's Dirichlet faces frozen in global z
// and y (the node-mirror planes beyond a Dirichlet face are swept as
// ordinary points and never read by a real one), x as the unsharded sweep.
// The update and residual expressions are fused_smooth.cu's.  The z form
// is the pass with hy = 0 and y not cut.  u and r are written for the
// real block only.
//
// What bounds it on the H100: the pass's, per real point about 12 bytes
// (16 with the residual) times the window overhead (tile + 4*ns (+2)) /
// tile along each partitioned axis, and on one card the host, which
// issues one launch a block and call (PERF.md).

#include "lane_pass.cuh"
#include "stencil.cuh"

// ---- plain C interface (loaded with ctypes); returns a CUDA error code.

// ns sweeps of a shard's halo-extended block (nze, nye, nx) in one launch of
// the pass's shard form (ops/zc.py: shard_pass_plan gives the tile), out
// of place into dst, the (rz, ry, nx) real block at (hz, hy), and with
// r != nullptr the residual of the real block.  (zg0, yg0) is the global
// index of the block's (0, 0), (NZ, NY) the level's extents, cuty whether
// the y ends are cut; color the first colour, dmask the level's Dirichlet
// faces.  Refuses (cudaErrorInvalidValue) a halo thinner than the pass
// needs, and what launch_pass refuses.
extern "C" int ndsm_shard_pass_f32(const void* src, const void* rhs, void* dst, void* r,
                                   int nze, int nye, int nx, int rz, int ry, int hz, int hy,
                                   int zg0, int yg0, int NZ, int NY, int cuty, int color,
                                   int dmask, int w, int cz, int ty, int tx, float wz, float wy,
                                   float wx, float w0, void* stream) {
  const int need = 2 * w + (r ? 1 : 0);
  if (w < 1 || cz < 1 || ty < 1 || tx < 1 || rz < 1 || ry < 1 || hz < need ||
      (cuty ? hy < need : hy != 0) || nze != rz + 2 * hz || nye != ry + 2 * hy)
    return (int)cudaErrorInvalidValue;
  const int active = 1;
  const ndsm::Lanes L = ndsm::make_lanes(1, &color, &dmask, &active);
  const ndsm::PassTile T = ndsm::pass_tile(nye, nx, w, r != nullptr, cz, ty, tx);
  const ndsm::ShardBlock G{hz, hy, rz, ry, zg0, yg0, NZ, NY, cuty ? 1 : 0};
  const dim3 grid((unsigned)(((ry + ty - 1) / ty) * ((nx + tx - 1) / tx)),
                  (unsigned)((rz + cz - 1) / cz), 1u);
  return ndsm::launch_pass<true>((const float*)src, nullptr, (const float*)rhs, (float*)dst,
                                 (float*)r, ndsm::HalfB{}, nze, nye, nx, L, T, G, grid, wz, wy,
                                 wx, w0, (cudaStream_t)stream);
}
