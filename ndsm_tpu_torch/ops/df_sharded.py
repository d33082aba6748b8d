"""Mixed-precision outer defect of one shard of a 3D level partitioned in z,
or in z and y (port of ``ndsm_tpu/ops/pallas_df.py:
df_residual_sharded_3d`` with ``parts`` (0,) and (0, 1), and its
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

The ``_zy`` forms (B11y) take a block of the 2-D (z, y) mesh, extended by
one plane a side in z and in y, (nz + 2, ny + 2, nx), with ``offsets =
(z0, y0)`` and ``extents = (nz_global, ny_global)``: Dirichlet faces in
global z and y, r32 over the real nz x ny block, the update over the whole
extended block.  JAX's kernel takes a y halo of 8 planes (the TPU's
sublanes) and reads one, and carries the Dirichlet faces of the
partitioned axes in a streamed mask code (``_df_with_c``); here the halo
is the one plane read and the faces are the global-index test of the z
form.

Over the real block r32 equals the unsharded ``df_residual_3d`` of the
whole level bit for bit.  The TPU kernel carried u and rhs as f32 (hi, lo)
pairs because f64 was emulated there; the port carries one float64 array,
as ops/df.py does.  rhs is the real block only: the residual reads no halo
of it (the TPU kernel took it extended because its DMA windows are laid
out on the extended block).

On a CUDA tensor the wrappers launch ``defect_sharded_f64`` of
``csrc/defect.cu`` (one launch; per-block maxima reduced here; the z form
is the y form with no y halo) and add one to their own ``launches``, or
raise; on a CPU tensor they run the plain versions below, built from
``stencils.masked_residual`` in float64.  Inputs are never modified.
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
    "df_residual_sharded_3d_zy",
    "df_update_residual_sharded_3d_zy",
    "df_residual_sharded_3d_zy_plain",
    "df_update_residual_sharded_3d_zy_plain",
]


def _check(name, u_ext, rhs, e_ext, dq, bcs, offsets, extents):
    """(bcs, real shape) of a block extended by one plane a side along its
    leading ``len(offsets)`` axes."""
    check_level(name, (u_ext,), torch.float64)
    real = tuple(s - 2 for s in u_ext.shape[:len(offsets)]) + tuple(u_ext.shape[len(offsets):])
    if rhs is not None:
        check_level(name, (rhs,), torch.float64, shape=real)
    if e_ext is not None:
        check_level(name, (e_ext,), torch.float32, shape=u_ext.shape)
    for t in (rhs, e_ext):
        if t is not None and t.device != u_ext.device:
            raise ValueError(f"{name}: rhs or e on another device than u")
    for ax, (o, e) in enumerate(zip(offsets, extents)):
        if real[ax] < 1 or not 0 <= int(o) <= int(e) - real[ax]:
            raise ValueError(f"{name}: {real[ax]} real points on axis {ax} at offset {o} do "
                             f"not lie in a level of {e}")
    if len(dq) != 3:
        raise ValueError(f"{name}: dq must have 3 entries")
    return stencils.validate_bcs(bcs, 3), real


def _defect_plain(u_ext, rhs, dq, bcs, offsets, extents):
    k = len(offsets)
    _, _, interior = stencils.shard_masks(tuple(u_ext.shape), tuple(int(o) - 1 for o in offsets),
                                          extents, bcs, u_ext.device)
    rhs_ext = torch.zeros_like(u_ext)
    core = (slice(1, -1),) * k
    if rhs is not None:
        rhs_ext[core] = rhs
    r = stencils.masked_residual(u_ext, rhs_ext, dq, interior)[core]
    r32 = r.to(torch.float32).contiguous()
    return r32, torch.max(torch.abs(r32))


def _plain(fn, u_ext, rhs, e_ext, dq, bcs, offsets, extents):
    if u_ext.device.type == "cuda":
        fn.plain_cuda_calls += 1
    if e_ext is None:
        return _defect_plain(u_ext, rhs, dq, bcs, offsets, extents)
    v = u_ext + e_ext.to(torch.float64)
    return _defect_plain(v, rhs, dq, bcs, offsets, extents) + (v,)


def df_residual_sharded_3d_plain(u_ext, rhs: Optional[torch.Tensor], dq, bcs, z0: int,
                                 nz_global: int):
    return _plain(df_residual_sharded_3d_plain, u_ext, rhs, None, dq, bcs, (z0,),
                  (nz_global,))


def df_update_residual_sharded_3d_plain(u_ext, rhs: Optional[torch.Tensor], e_ext, dq, bcs,
                                        z0: int, nz_global: int):
    return _plain(df_update_residual_sharded_3d_plain, u_ext, rhs, e_ext, dq, bcs, (z0,),
                  (nz_global,))


def df_residual_sharded_3d_zy_plain(u_ext, rhs: Optional[torch.Tensor], dq, bcs, offsets,
                                    extents):
    return _plain(df_residual_sharded_3d_zy_plain, u_ext, rhs, None, dq, bcs, offsets,
                  extents)


def df_update_residual_sharded_3d_zy_plain(u_ext, rhs: Optional[torch.Tensor], e_ext, dq,
                                           bcs, offsets, extents):
    return _plain(df_update_residual_sharded_3d_zy_plain, u_ext, rhs, e_ext, dq, bcs,
                  offsets, extents)


for _f in (df_residual_sharded_3d_plain, df_update_residual_sharded_3d_plain,
           df_residual_sharded_3d_zy_plain, df_update_residual_sharded_3d_zy_plain):
    _f.plain_cuda_calls = 0


def _defect_cuda(u_ext, rhs, e_ext, dq, bcs, offsets, extents, real, what):
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nz, ny, nx = real
    hy = 1 if len(offsets) == 2 else 0
    y0, NY = (int(offsets[1]), int(extents[1])) if hy else (0, ny)
    (wz, wy, wx), _ = stencils.stencil_weights(dq, torch.float64)
    r32 = torch.empty(real, dtype=torch.float32, device=u_ext.device)
    v = torch.empty_like(u_ext) if e_ext is not None else None
    block_max = torch.empty(lib.ndsm_defect_blocks(nz + 2, ny + 2 * hy, nx),
                            dtype=torch.float32, device=u_ext.device)
    with torch.cuda.device(u_ext.device):
        stream = torch.cuda.current_stream(u_ext.device).cuda_stream
        cuda_build.check(lib.ndsm_defect_sharded_f64(
            u_ext.data_ptr(), None if e_ext is None else e_ext.data_ptr(),
            None if v is None else v.data_ptr(), None if rhs is None else rhs.data_ptr(),
            r32.data_ptr(), block_max.data_ptr(), nz, ny, nx, hy, int(offsets[0]), y0,
            int(extents[0]), NY, dirichlet_mask(bcs), wz, wy, wx, stream), what)
    return (r32, torch.max(block_max)) + (() if v is None else (v,))


def _defect(fn, name, u_ext, rhs, e_ext, dq, bcs, offsets, extents, plain):
    bcs, real = _check(name, u_ext, rhs, e_ext, dq, bcs, offsets, extents)
    if e_ext is None and fn.__name__.startswith("df_update"):
        raise ValueError(f"{name}: takes the pending correction e_ext")
    if u_ext.device.type == "cpu":
        return _plain(plain, u_ext, rhs, e_ext, dq, bcs, offsets, extents)
    out = _defect_cuda(u_ext, rhs, e_ext, dq, bcs, offsets, extents, real, name)
    fn.launches += 1
    return out


def df_residual_sharded_3d(u_ext, rhs: Optional[torch.Tensor], dq, bcs, z0: int,
                           nz_global: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r32, mx) of a z-partitioned shard (see module docstring).  Replaces
    ndsm_tpu/ops/pallas_df.py:df_residual_sharded_3d (plain, zero_rhs)."""
    return _defect(df_residual_sharded_3d, "df_residual_sharded_3d", u_ext, rhs, None, dq, bcs,
                   (z0,), (nz_global,), df_residual_sharded_3d_plain)


def df_update_residual_sharded_3d(u_ext, rhs: Optional[torch.Tensor], e_ext, dq, bcs,
                                  z0: int, nz_global: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r32, mx, u_ext + e_ext) of a z-partitioned shard (see module
    docstring).  Replaces the update variants of
    ndsm_tpu/ops/pallas_df.py:df_residual_sharded_3d."""
    return _defect(df_update_residual_sharded_3d, "df_update_residual_sharded_3d", u_ext, rhs,
                   e_ext, dq, bcs, (z0,), (nz_global,), df_update_residual_sharded_3d_plain)


def df_residual_sharded_3d_zy(u_ext, rhs: Optional[torch.Tensor], dq, bcs, offsets, extents
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r32, mx) of a shard of the (z, y) mesh, extended by one plane in z
    and y.  Replaces ndsm_tpu/ops/pallas_df.py:df_residual_sharded_3d with
    parts=(0, 1) (plain, zero_rhs)."""
    return _defect(df_residual_sharded_3d_zy, "df_residual_sharded_3d_zy", u_ext, rhs, None,
                   dq, bcs, offsets, extents, df_residual_sharded_3d_zy_plain)


def df_update_residual_sharded_3d_zy(u_ext, rhs: Optional[torch.Tensor], e_ext, dq, bcs,
                                     offsets, extents
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r32, mx, u_ext + e_ext) of a shard of the (z, y) mesh.  Replaces
    the update variants of ndsm_tpu/ops/pallas_df.py:df_residual_sharded_3d
    with parts=(0, 1)."""
    return _defect(df_update_residual_sharded_3d_zy, "df_update_residual_sharded_3d_zy", u_ext,
                   rhs, e_ext, dq, bcs, offsets, extents,
                   df_update_residual_sharded_3d_zy_plain)


for _f in (df_residual_sharded_3d, df_update_residual_sharded_3d, df_residual_sharded_3d_zy,
           df_update_residual_sharded_3d_zy):
    _f.launches = 0
del _f
