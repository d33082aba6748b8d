"""Mixed-precision outer defect of one shard of a z-partitioned 3D level
(port of ``ndsm_tpu/ops/pallas_df.py: df_residual_sharded_3d`` with its
``zero_rhs`` and ``update`` variants).

``df_residual_sharded_3d(u_ext, rhs, dq, bcs, z0, nz_global)`` takes the
shard's float64 iterate extended by one halo plane a side, (nz + 2, ny,
nx), filled by the engine (neighbour planes; node-mirror planes at the
ends of the chain), and the real block of rhs (float64, or None for the
zero-rhs form).  It returns ``(r32, mx)``: ``r32 = f32(rhs - L[u])`` over
the real block, zero on the level's Dirichlet points (global z), and
``mx = max|r32|`` as a 0-d float32 tensor on the device.

``df_update_residual_sharded_3d(u_ext, rhs, e_ext, ...)`` first applies
the previous defect group's pending correction: ``v = u_ext + f64(e_ext)``
over the whole extended block (``e_ext`` float32, extended like u), and
returns ``(r32, mx, v)`` with the residual taken of v.  Carrying v
extended, the engine exchanges only e in each later group.

Over the real block r32 equals the unsharded ``df_residual_3d`` of the
whole level bit for bit.  The TPU kernel carried u and rhs as f32 (hi, lo)
pairs because f64 was emulated there; the port carries one float64 array,
as ops/df.py does.  rhs is the real block only: the residual reads no halo
of it (the TPU kernel took it extended because its DMA windows are laid
out on the extended block).

On a CUDA tensor the wrappers launch ``defect_sharded_f64`` of
``csrc/defect.cu`` (one launch; per-block maxima reduced here) and add one
to ``launches``, or raise; on a CPU tensor they run the plain versions
below, built from ``stencils.masked_residual`` in float64.  Inputs are
never modified.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import stencils
from .zc import check_level, dirichlet_mask

__all__ = [
    "df_residual_sharded_3d",
    "df_update_residual_sharded_3d",
    "df_residual_sharded_3d_plain",
    "df_update_residual_sharded_3d_plain",
]


def _check(name, u_ext, rhs, e_ext, dq, bcs, z0, nz_global):
    check_level(name, (u_ext,), torch.float64)
    nz, ny, nx = u_ext.shape[0] - 2, u_ext.shape[1], u_ext.shape[2]
    if rhs is not None:
        check_level(name, (rhs,), torch.float64, shape=(nz, ny, nx))
    if e_ext is not None:
        check_level(name, (e_ext,), torch.float32, shape=u_ext.shape)
    for t in (rhs, e_ext):
        if t is not None and t.device != u_ext.device:
            raise ValueError(f"{name}: rhs or e on another device than u")
    if nz < 1 or not 0 <= int(z0) <= int(nz_global) - nz:
        raise ValueError(f"{name}: {nz} real planes at z0={z0} do not lie in a level of "
                         f"{nz_global}")
    if len(dq) != 3:
        raise ValueError(f"{name}: dq must have 3 entries")
    return stencils.validate_bcs(bcs, 3), nz


def _defect_plain(u_ext, rhs, dq, bcs, z0, nz_global):
    nz = u_ext.shape[0] - 2
    _, _, interior = stencils.shard_masks(tuple(u_ext.shape), z0 - 1, nz_global, bcs,
                                          u_ext.device)
    rhs_ext = torch.zeros_like(u_ext)
    if rhs is not None:
        rhs_ext[1:-1] = rhs
    r = stencils.masked_residual(u_ext, rhs_ext, dq, interior).narrow(0, 1, nz)
    r32 = r.to(torch.float32)
    return r32, torch.max(torch.abs(r32))


def df_residual_sharded_3d_plain(u_ext, rhs: Optional[torch.Tensor], dq, bcs, z0: int,
                                 nz_global: int):
    if u_ext.device.type == "cuda":
        df_residual_sharded_3d_plain.plain_cuda_calls += 1
    return _defect_plain(u_ext, rhs, dq, bcs, z0, nz_global)


def df_update_residual_sharded_3d_plain(u_ext, rhs: Optional[torch.Tensor], e_ext, dq, bcs,
                                        z0: int, nz_global: int):
    if u_ext.device.type == "cuda":
        df_update_residual_sharded_3d_plain.plain_cuda_calls += 1
    v = u_ext + e_ext.to(torch.float64)
    return _defect_plain(v, rhs, dq, bcs, z0, nz_global) + (v,)


for _f in (df_residual_sharded_3d_plain, df_update_residual_sharded_3d_plain):
    _f.plain_cuda_calls = 0


def _defect_cuda(u_ext, rhs, e_ext, dq, bcs, z0, nz_global, nz, what):
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    ny, nx = int(u_ext.shape[1]), int(u_ext.shape[2])
    (wz, wy, wx), _ = stencils.stencil_weights(dq, torch.float64)
    r32 = torch.empty((nz, ny, nx), dtype=torch.float32, device=u_ext.device)
    v = torch.empty_like(u_ext) if e_ext is not None else None
    block_max = torch.empty(lib.ndsm_defect_blocks(nz + 2, ny, nx), dtype=torch.float32,
                            device=u_ext.device)
    with torch.cuda.device(u_ext.device):
        stream = torch.cuda.current_stream(u_ext.device).cuda_stream
        cuda_build.check(lib.ndsm_defect_sharded_f64(
            u_ext.data_ptr(), None if e_ext is None else e_ext.data_ptr(),
            None if v is None else v.data_ptr(), None if rhs is None else rhs.data_ptr(),
            r32.data_ptr(), block_max.data_ptr(), nz, ny, nx, int(z0), int(nz_global),
            dirichlet_mask(bcs), wz, wy, wx, stream), what)
    return r32, torch.max(block_max), v


def df_residual_sharded_3d(u_ext, rhs: Optional[torch.Tensor], dq, bcs, z0: int,
                           nz_global: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r32, mx) of a shard (see module docstring).  Replaces
    ndsm_tpu/ops/pallas_df.py:df_residual_sharded_3d (plain, zero_rhs)."""
    name = "df_residual_sharded_3d"
    bcs, nz = _check(name, u_ext, rhs, None, dq, bcs, z0, nz_global)
    if u_ext.device.type == "cpu":
        return df_residual_sharded_3d_plain(u_ext, rhs, dq, bcs, z0, nz_global)
    r32, mx, _ = _defect_cuda(u_ext, rhs, None, dq, bcs, z0, nz_global, nz, name)
    df_residual_sharded_3d.launches += 1
    return r32, mx


def df_update_residual_sharded_3d(u_ext, rhs: Optional[torch.Tensor], e_ext, dq, bcs,
                                  z0: int, nz_global: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r32, mx, u_ext + e_ext) of a shard (see module docstring).
    Replaces the update variants of
    ndsm_tpu/ops/pallas_df.py:df_residual_sharded_3d."""
    name = "df_update_residual_sharded_3d"
    bcs, nz = _check(name, u_ext, rhs, e_ext, dq, bcs, z0, nz_global)
    if e_ext is None:
        raise ValueError(f"{name}: takes the pending correction e_ext")
    if u_ext.device.type == "cpu":
        return df_update_residual_sharded_3d_plain(u_ext, rhs, e_ext, dq, bcs, z0,
                                                   nz_global)
    out = _defect_cuda(u_ext, rhs, e_ext, dq, bcs, z0, nz_global, nz, name)
    df_update_residual_sharded_3d.launches += 1
    return out


for _f in (df_residual_sharded_3d, df_update_residual_sharded_3d):
    _f.launches = 0
del _f
