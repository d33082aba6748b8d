"""Red-black sweeps of one shard of a z-partitioned float32 3D level, on its
halo-extended block (port of ``ndsm_tpu/ops/pallas_zc.py:
zc_smooth_sharded_3d``, plain and residual forms).

``zc_smooth_sharded_3d(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global,
halo)`` takes the shard's (nz + 2H, ny, nx) blocks of u and rhs, where
``halo`` = H planes on each side were filled by the engine (neighbour
planes, or node-mirror planes at the ends of the chain), ``z0`` is the
global index of the first real plane and ``nz_global`` the level's extent.
It runs ``2 * nsweeps`` half-sweeps over the whole extended block, with the
colour of global plane ``z0 - H + kz`` and the Dirichlet faces of the
level frozen in global coordinates, and returns u over the real block
(a view of the swept extended block).  ``zc_smooth_residual_sharded_3d``
also returns ``r = rhs - L[u]`` of the swept state over the real block,
zero on Dirichlet points.  H must be >= 2*nsweeps (>= 2*nsweeps + 1 for
the residual): then the real planes equal the unsharded ``zc_smooth_3d``
on those planes bit for bit.

On a CUDA tensor the wrappers launch ``csrc/zc_sharded.cu`` (one launch a
half-sweep, the first out of place, plus one residual launch) and add one
to ``launches``, or raise; on a CPU tensor they run the plain version
below, built from ``stencils.masked_red_black``.  There is no shape or
offset gate: odd extents and odd offsets are taken.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import stencils
from .zc import check_config, check_level, count_plain, dirichlet_mask

__all__ = [
    "zc_smooth_sharded_3d",
    "zc_smooth_residual_sharded_3d",
    "zc_smooth_sharded_3d_plain",
    "zc_smooth_residual_sharded_3d_plain",
]


def _check(name, u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo, residual):
    check_level(name, (u_ext, rhs_ext), torch.float32)
    bcs = check_config(name, dq, bcs, nsweeps)
    need = 2 * int(nsweeps) + (1 if residual else 0)
    nz = u_ext.shape[0] - 2 * int(halo)
    if int(halo) < need or nz < 1 or not 0 <= int(z0) <= int(nz_global) - nz:
        raise ValueError(
            f"{name}: an extended block of {u_ext.shape[0]} planes with halo {halo} "
            f"at z0={z0} of {nz_global} (needs halo >= {need} and the real planes inside "
            "the level)"
        )
    return bcs, nz


# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def _sweeps_plain(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo):
    first, second, interior = stencils.shard_masks(tuple(u_ext.shape), z0 - halo, nz_global,
                                                   bcs, u_ext.device)
    for _ in range(int(nsweeps)):
        u_ext = stencils.masked_red_black(u_ext, rhs_ext, dq, first, second)
    return u_ext, interior


def zc_smooth_sharded_3d_plain(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int,
                               nz_global: int, halo: int) -> torch.Tensor:
    count_plain(zc_smooth_sharded_3d_plain, u_ext)
    u_ext, _ = _sweeps_plain(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo)
    return u_ext.narrow(0, halo, u_ext.shape[0] - 2 * halo)


def zc_smooth_residual_sharded_3d_plain(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int,
                                        nz_global: int, halo: int):
    count_plain(zc_smooth_residual_sharded_3d_plain, u_ext)
    u_ext, interior = _sweeps_plain(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo)
    nz = u_ext.shape[0] - 2 * halo
    r = stencils.masked_residual(u_ext, rhs_ext, dq, interior)
    return u_ext.narrow(0, halo, nz), r.narrow(0, halo, nz).contiguous()


for _f in (zc_smooth_sharded_3d_plain, zc_smooth_residual_sharded_3d_plain):
    _f.plain_cuda_calls = 0


# ----------------------------------------------------------------------
# CUDA launches and wrappers
# ----------------------------------------------------------------------


def _sweeps_cuda(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo, what):
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nze, ny, nx = (int(s) for s in u_ext.shape)
    (wz, wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    red, dm, zg0 = stencils.first_color_parity(bcs), dirichlet_mask(bcs), z0 - halo
    out = torch.empty_like(u_ext)
    with torch.cuda.device(u_ext.device):
        stream = torch.cuda.current_stream(u_ext.device).cuda_stream
        cuda_build.check(lib.ndsm_shard_half_oop_f32(
            u_ext.data_ptr(), rhs_ext.data_ptr(), out.data_ptr(), nze, ny, nx, zg0,
            nz_global, red, dm, wz, wy, wx, w0, stream), what)
        for k in range(1, 2 * int(nsweeps)):
            cuda_build.check(lib.ndsm_shard_half_inplace_f32(
                out.data_ptr(), rhs_ext.data_ptr(), nze, ny, nx, zg0, nz_global,
                red ^ (k % 2), dm, wz, wy, wx, w0, stream), what)
    return out


def zc_smooth_sharded_3d(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int, nz_global: int,
                         halo: int) -> torch.Tensor:
    """``nsweeps`` sweeps of a shard's extended block; u over the real
    block.  Replaces ndsm_tpu/ops/pallas_zc.py:zc_smooth_sharded_3d."""
    name = "zc_smooth_sharded_3d"
    bcs, nz = _check(name, u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo, False)
    if u_ext.device.type == "cpu":
        return zc_smooth_sharded_3d_plain(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global,
                                          halo)
    out = _sweeps_cuda(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo, name)
    zc_smooth_sharded_3d.launches += 1
    return out.narrow(0, halo, nz)


def zc_smooth_residual_sharded_3d(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int,
                                  nz_global: int, halo: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, r) over the real block: ``nsweeps`` sweeps of the extended
    block, then the residual of the swept state.  Replaces the residual
    form of ndsm_tpu/ops/pallas_zc.py:zc_smooth_sharded_3d."""
    name = "zc_smooth_residual_sharded_3d"
    bcs, nz = _check(name, u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo, True)
    if u_ext.device.type == "cpu":
        return zc_smooth_residual_sharded_3d_plain(u_ext, rhs_ext, dq, bcs, nsweeps, z0,
                                                   nz_global, halo)
    from ..utils import cuda_build

    out = _sweeps_cuda(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global, halo, name)
    ny, nx = int(u_ext.shape[1]), int(u_ext.shape[2])
    (wz, wy, wx), _ = stencils.stencil_weights(dq, torch.float32)
    r = torch.empty((nz, ny, nx), dtype=torch.float32, device=u_ext.device)
    with torch.cuda.device(u_ext.device):
        stream = torch.cuda.current_stream(u_ext.device).cuda_stream
        cuda_build.check(cuda_build.kernels().ndsm_shard_residual_f32(
            out.data_ptr(), rhs_ext.data_ptr(), r.data_ptr(), nz, ny, nx, halo, z0,
            nz_global, dirichlet_mask(bcs), wz, wy, wx, stream), name)
    zc_smooth_residual_sharded_3d.launches += 1
    return out.narrow(0, halo, nz), r


for _f in (zc_smooth_sharded_3d, zc_smooth_residual_sharded_3d):
    _f.launches = 0
del _f
