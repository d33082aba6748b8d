"""Red-black sweeps of one shard of a float32 3D level partitioned in z, or
in z and y, on its halo-extended block (port of
``ndsm_tpu/ops/pallas_zc.py: zc_smooth_sharded_3d``, plain and residual
forms, with ``ext_y`` False and True).

``zc_smooth_sharded_3d(u_ext, rhs_ext, dq, bcs, nsweeps, z0, nz_global,
halo)`` takes the shard's (nz + 2H, ny, nx) blocks of u and rhs, where
``halo`` = H planes on each side were filled by the engine (neighbour
planes, or node-mirror planes at the ends of the chain), ``z0`` is the
global index of the first real plane and ``nz_global`` the level's extent.
It runs ``2 * nsweeps`` half-sweeps over the whole extended block, with the
colour of global plane ``z0 - H + kz`` and the Dirichlet faces of the
level frozen in global coordinates, and returns u over the real block
(the plain version: a view of the swept extended block).
``zc_smooth_residual_sharded_3d`` also returns ``r = rhs - L[u]`` of the
swept state over the real block,
zero on Dirichlet points.  H must be >= 2*nsweeps (>= 2*nsweeps + 1 for
the residual): then the real planes equal the unsharded ``zc_smooth_3d``
on those planes bit for bit.

The ``_zy`` forms (B10y) take a block of the 2-D (z, y) mesh, extended in
z and in y: (nz + 2Hz, ny + 2Hy, nx), with ``offsets = (z0, y0)``,
``extents = (nz_global, ny_global)`` and ``halos = (Hz, Hy)``; colour and
Dirichlet faces are global in z and y, both halos must be >= 2*nsweeps
(+1), and u (and r) cover the real nz x ny block.  The engine fills the
corners with the diagonal neighbours' values (z extended first, then y on
the z-extended blocks), so stitched, the real blocks again equal the
unsharded kernel bit for bit.  JAX rounds the y halo up to 8 planes (the
TPU's sublanes); the kernels here take any halo of at least the need.

On a CUDA tensor the wrappers make ONE launch of ``csrc/zc_sharded.cu``:
the shard form of the multi-sweep pass (``csrc/lane_pass.cuh``), all
``nsweeps`` sweeps and the residual in one pass, tiled over the real block
by ``zc.shard_pass_plan`` (the extended block's partitioned ends are the
pass's cut edges; the z form is the y form with Hy = 0 and y not cut); u
and r come back as contiguous real blocks.  Each wrapper adds one to its
own ``launches``, or raises (a failed build, a refused launch, a pass
whose window does not fit a block's shared memory).  On a CPU tensor they
run the plain versions below, built from ``stencils.shard_masks`` and
``stencils.masked_red_black``.  There is no shape or offset gate: odd
extents and odd offsets are taken.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import stencils
from .zc import call_args, check_config, check_level, count_plain, shard_pass_plan

__all__ = [
    "zc_smooth_sharded_3d",
    "zc_smooth_residual_sharded_3d",
    "zc_smooth_sharded_3d_plain",
    "zc_smooth_residual_sharded_3d_plain",
    "zc_smooth_sharded_3d_zy",
    "zc_smooth_residual_sharded_3d_zy",
    "zc_smooth_sharded_3d_zy_plain",
    "zc_smooth_residual_sharded_3d_zy_plain",
]


def _check(name, u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, residual):
    """(bcs, real shape) of a block extended along its leading
    ``len(halos)`` axes."""
    check_level(name, (u_ext, rhs_ext), torch.float32)
    bcs = check_config(name, dq, bcs, nsweeps)
    need = 2 * int(nsweeps) + (1 if residual else 0)
    real = list(u_ext.shape)
    for ax, (o, e, h) in enumerate(zip(offsets, extents, halos)):
        real[ax] -= 2 * int(h)
        if int(h) < need or real[ax] < 1 or not 0 <= int(o) <= int(e) - real[ax]:
            raise ValueError(
                f"{name}: an extended block of {u_ext.shape[ax]} points on axis {ax} with "
                f"halo {h} at offset {o} of {e} (needs halo >= {need} and the real points "
                "inside the level)"
            )
    return bcs, tuple(real)


def _real(u_ext, halos, real):
    for ax, h in enumerate(halos):
        u_ext = u_ext.narrow(ax, int(h), real[ax])
    return u_ext


# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def _sweeps_plain(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos):
    starts = tuple(int(o) - int(h) for o, h in zip(offsets, halos))
    first, second, interior = stencils.shard_masks(tuple(u_ext.shape), starts, extents, bcs,
                                                   u_ext.device)
    for _ in range(int(nsweeps)):
        u_ext = stencils.masked_red_black(u_ext, rhs_ext, dq, first, second)
    return u_ext, interior


def _smooth_plain(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, residual):
    u_ext, interior = _sweeps_plain(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos)
    real = [s - 2 * int(h) for s, h in zip(u_ext.shape, halos)] + list(u_ext.shape[len(halos):])
    u = _real(u_ext, halos, real)
    if not residual:
        return u
    r = stencils.masked_residual(u_ext, rhs_ext, dq, interior)
    return u, _real(r, halos, real).contiguous()


def zc_smooth_sharded_3d_plain(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int,
                               nz_global: int, halo: int) -> torch.Tensor:
    count_plain(zc_smooth_sharded_3d_plain, u_ext)
    return _smooth_plain(u_ext, rhs_ext, dq, bcs, nsweeps, (z0,), (nz_global,), (halo,),
                         False)


def zc_smooth_residual_sharded_3d_plain(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int,
                                        nz_global: int, halo: int):
    count_plain(zc_smooth_residual_sharded_3d_plain, u_ext)
    return _smooth_plain(u_ext, rhs_ext, dq, bcs, nsweeps, (z0,), (nz_global,), (halo,), True)


def zc_smooth_sharded_3d_zy_plain(u_ext, rhs_ext, dq, bcs, nsweeps: int, offsets, extents,
                                  halos) -> torch.Tensor:
    count_plain(zc_smooth_sharded_3d_zy_plain, u_ext)
    return _smooth_plain(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, False)


def zc_smooth_residual_sharded_3d_zy_plain(u_ext, rhs_ext, dq, bcs, nsweeps: int, offsets,
                                           extents, halos):
    count_plain(zc_smooth_residual_sharded_3d_zy_plain, u_ext)
    return _smooth_plain(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, True)


for _f in (zc_smooth_sharded_3d_plain, zc_smooth_residual_sharded_3d_plain,
           zc_smooth_sharded_3d_zy_plain, zc_smooth_residual_sharded_3d_zy_plain):
    _f.plain_cuda_calls = 0


# ----------------------------------------------------------------------
# CUDA launches and wrappers
# ----------------------------------------------------------------------


def _zy(u_ext, offsets, extents, halos):
    """(z0, y0), (NZ, NY), (Hz, Hy) of either form: the z form's y is the
    block's own (y0 = 0, NY = ny, Hy = 0)."""
    if len(halos) == 2:
        return tuple(map(int, offsets)), tuple(map(int, extents)), tuple(map(int, halos))
    return (int(offsets[0]), 0), (int(extents[0]), int(u_ext.shape[1])), (int(halos[0]), 0)


def _smooth_cuda(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, residual, what,
                 previous=False):
    """One launch of the pass's shard form (csrc/zc_sharded.cu:
    ndsm_shard_pass_f32) with the plan of ``zc.shard_pass_plan``; u (and
    r) of the real block, contiguous.  ``previous``: the first design
    instead, 2 * nsweeps half-sweep launches over the whole block (+1
    residual launch), u a view of the swept block (chip_smoke.py times it
    beside the pass)."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nze, nye, nx = (int(s) for s in u_ext.shape)
    (z0, y0), (NZ, NY), (Hz, Hy) = _zy(u_ext, offsets, extents, halos)
    (wz, wy, wx), w0, red, dm = call_args(tuple(float(q) for q in dq), bcs)
    zg0, yg0 = z0 - Hz, y0 - Hy
    nz, ny = nze - 2 * Hz, nye - 2 * Hy
    out = torch.empty_like(u_ext) if previous else \
        torch.empty((nz, ny, nx), dtype=torch.float32, device=u_ext.device)
    r = torch.empty((nz, ny, nx), dtype=torch.float32, device=u_ext.device) if residual \
        else None
    with torch.cuda.device(u_ext.device):
        stream = torch.cuda.current_stream(u_ext.device).cuda_stream
        if not previous:
            plan = shard_pass_plan((nze, nye, nx), (Hz, Hy), nsweeps, residual)
            cuda_build.check(lib.ndsm_shard_pass_f32(
                u_ext.data_ptr(), rhs_ext.data_ptr(), out.data_ptr(),
                r.data_ptr() if residual else None, nze, nye, nx, nz, ny, Hz, Hy, zg0, yg0,
                NZ, NY, 1 if len(halos) == 2 else 0, red, dm, int(nsweeps), *plan.tile,
                wz, wy, wx, w0, stream), what)
            return (out, r) if residual else out
        cuda_build.check(lib.ndsm_shard_half_oop_f32(
            u_ext.data_ptr(), rhs_ext.data_ptr(), out.data_ptr(), nze, nye, nx, zg0, yg0,
            NZ, NY, red, dm, wz, wy, wx, w0, stream), what)
        for k in range(1, 2 * int(nsweeps)):
            cuda_build.check(lib.ndsm_shard_half_inplace_f32(
                out.data_ptr(), rhs_ext.data_ptr(), nze, nye, nx, zg0, yg0, NZ, NY,
                red ^ (k % 2), dm, wz, wy, wx, w0, stream), what)
        if residual:
            cuda_build.check(lib.ndsm_shard_residual_f32(
                out.data_ptr(), rhs_ext.data_ptr(), r.data_ptr(), nz, ny, nx, Hz, Hy, z0, y0,
                NZ, NY, dm, wz, wy, wx, stream), what)
    u = _real(out, (Hz, Hy), (nz, ny, nx))
    return (u, r) if residual else u


def _smooth(fn, plain, name, u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos,
            residual, plain_args):
    bcs, _ = _check(name, u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, residual)
    if u_ext.device.type == "cpu":
        return plain(u_ext, rhs_ext, dq, bcs, nsweeps, *plain_args)
    out = _smooth_cuda(u_ext, rhs_ext, dq, bcs, nsweeps, offsets, extents, halos, residual,
                       name)
    fn.launches += 1
    return out


def zc_smooth_sharded_3d(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int, nz_global: int,
                         halo: int) -> torch.Tensor:
    """``nsweeps`` sweeps of a shard's z-extended block; u over the real
    block.  Replaces ndsm_tpu/ops/pallas_zc.py:zc_smooth_sharded_3d."""
    return _smooth(zc_smooth_sharded_3d, zc_smooth_sharded_3d_plain, "zc_smooth_sharded_3d",
                   u_ext, rhs_ext, dq, bcs, nsweeps, (z0,), (nz_global,), (halo,), False,
                   (z0, nz_global, halo))


def zc_smooth_residual_sharded_3d(u_ext, rhs_ext, dq, bcs, nsweeps: int, z0: int,
                                  nz_global: int, halo: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, r) over the real block: ``nsweeps`` sweeps of the z-extended
    block, then the residual of the swept state.  Replaces the residual
    form of ndsm_tpu/ops/pallas_zc.py:zc_smooth_sharded_3d."""
    return _smooth(zc_smooth_residual_sharded_3d, zc_smooth_residual_sharded_3d_plain,
                   "zc_smooth_residual_sharded_3d", u_ext, rhs_ext, dq, bcs, nsweeps, (z0,),
                   (nz_global,), (halo,), True, (z0, nz_global, halo))


def zc_smooth_sharded_3d_zy(u_ext, rhs_ext, dq, bcs, nsweeps: int, offsets, extents,
                            halos) -> torch.Tensor:
    """``nsweeps`` sweeps of a shard's block extended in z and y; u over
    the real block.  Replaces ndsm_tpu/ops/pallas_zc.py:
    zc_smooth_sharded_3d(ext_y=True)."""
    return _smooth(zc_smooth_sharded_3d_zy, zc_smooth_sharded_3d_zy_plain,
                   "zc_smooth_sharded_3d_zy", u_ext, rhs_ext, dq, bcs, nsweeps, offsets,
                   extents, halos, False, (offsets, extents, halos))


def zc_smooth_residual_sharded_3d_zy(u_ext, rhs_ext, dq, bcs, nsweeps: int, offsets, extents,
                                     halos) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, r) over the real block of a shard extended in z and y.
    Replaces the residual form of ndsm_tpu/ops/pallas_zc.py:
    zc_smooth_sharded_3d(ext_y=True)."""
    return _smooth(zc_smooth_residual_sharded_3d_zy, zc_smooth_residual_sharded_3d_zy_plain,
                   "zc_smooth_residual_sharded_3d_zy", u_ext, rhs_ext, dq, bcs, nsweeps,
                   offsets, extents, halos, True, (offsets, extents, halos))


for _f in (zc_smooth_sharded_3d, zc_smooth_residual_sharded_3d, zc_smooth_sharded_3d_zy,
           zc_smooth_residual_sharded_3d_zy):
    _f.launches = 0
del _f
