"""Lane-batched red-black smoother kernels for float32 3D levels (port of
``ndsm_tpu/ops/pallas_fused.py``: ``fused_smooth_3d_batched`` and its
one-lane form ``fused_smooth_3d``), with the residual and correction lane
forms that ``ndsm_tpu/mg/batched.py`` gets from per-lane zc kernel calls.

The state is a stack ``(B, nz, ny, nx)`` of B <= 8 problems that share the
grid and dq but not their boundary conditions: lane b sweeps with
``bcs_list[b]`` (its own first colour, ``stencils.first_color_parity``, and
its own frozen Dirichlet faces).  Per lane, a call equals ``nsweeps`` calls
of ``stencils.rb_sweep`` with that lane's BCs, in the same arithmetic
order, so lane b of every form equals the matching ops/zc.py call on that
lane bit for bit.

``active`` (a sequence of B bools, default all True) freezes lanes: a
frozen lane comes back unchanged (the correction form ignores its
``cor``), its residual is zero, and it costs no sweep work.  An active
lane's result does not depend on which other lanes are active.

The port has one family of 3D red-black kernels, ``csrc/fused_smooth.cu``,
whose multi-sweep pass ops/zc.py's ``sweeps_cuda`` launches: the wrappers
here call it with B lanes, ops/zc.py's with one.  ``fused_smooth_3d`` (one
level, one BC set) is therefore ops/zc.py's ``zc_smooth_3d`` itself: the
two TPU kernels it replaces compute the same sweeps on two TPU layouts,
and the port keeps neither layout.

Each lane wrapper, like ops/zc.py's:

  * on a CUDA tensor launches the pass kernel (``ceil(nsweeps / w)``
    launches for all lanes, out of place, the first reading u + cor, the
    last writing the residual; ``zc.pass_plan`` gives w) and adds one to
    its ``launches`` count, or raises;
  * on a CPU tensor runs its plain PyTorch version below: per-lane masked
    sweeps from ops/stencils.py (``plain_cuda_calls`` counts any call of a
    plain version on a CUDA tensor).

The wrappers are functional: inputs are never modified.  Unlike the TPU
kernel there is no mask-code array and no tile gate: every 3D shape with
extents >= 2 is taken.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..utils.caching import BoundedCache
from . import stencils
from .zc import (
    check_config,
    check_level,
    count_plain,
    sweeps_cuda,
    zc_smooth_3d,
    zc_smooth_3d_plain,
)

__all__ = [
    "MAX_LANES",
    "lane_masks",
    "lane_sweeps",
    "lane_residual",
    "fused_smooth_3d_batched",
    "fused_smooth_residual_3d_batched",
    "fused_smooth_cor_3d_batched",
    "fused_smooth_3d",
    "fused_smooth_3d_batched_plain",
    "fused_smooth_residual_3d_batched_plain",
    "fused_smooth_cor_3d_batched_plain",
    "fused_smooth_3d_plain",
]

#: Most lanes one launch takes (kMaxLanes of csrc/fused_smooth.cu).
MAX_LANES = 8

_MASKS: BoundedCache = BoundedCache(maxsize=64)


def lane_masks(shape, bcs_list, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(first, second, interior): ``(B,) + shape`` bool stacks; lane b holds
    ``stencils.color_masks`` and ``interior_mask`` of ``bcs_list[b]``."""
    shape = tuple(int(s) for s in shape)
    bcs_list = tuple(stencils.validate_bcs(b, len(shape)) for b in bcs_list)
    key = (shape, bcs_list, str(device))
    m = _MASKS.get(key)
    if m is None:
        cols = [stencils.color_masks(shape, b, device) for b in bcs_list]
        m = (
            torch.stack([c[0] for c in cols]),
            torch.stack([c[1] for c in cols]),
            torch.stack([stencils.interior_mask(shape, b, device) for b in bcs_list]),
        )
        _MASKS.put(key, m)
    return m


def _active_view(active, device, ndim: int):
    """The active flags as a (B, 1, ..., 1) bool tensor, or None if all are."""
    if active is None or all(active):
        return None
    return torch.tensor([bool(a) for a in active], device=device).view((-1,) + (1,) * ndim)


def _freeze(masks, active, device):
    act = _active_view(active, device, masks[0].ndim - 1)
    return masks if act is None else tuple(m & act for m in masks)


def lane_sweeps(u, rhs, dq, masks, nsweeps: int, active=None) -> torch.Tensor:
    """``nsweeps`` masked red-black sweeps of a lane stack (any float
    dtype), ``masks`` from :func:`lane_masks`; frozen lanes unchanged."""
    first, second, _ = _freeze(masks, active, u.device)
    for _ in range(int(nsweeps)):
        u = stencils.masked_red_black(u, rhs, dq, first, second)
    return u


def lane_residual(u, rhs, dq, masks, active=None) -> torch.Tensor:
    """Per-lane ``rhs - L[u]``, zero on each lane's Dirichlet faces and on
    frozen lanes."""
    return stencils.masked_residual(u, rhs, dq, _freeze(masks, active, u.device)[2])


# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def fused_smooth_3d_batched_plain(u, rhs, dq, bcs_list, nsweeps: int, active=None):
    """``nsweeps`` sweeps per lane with the lane's BCs."""
    count_plain(fused_smooth_3d_batched_plain, u)
    return lane_sweeps(u, rhs, dq, lane_masks(u.shape[1:], bcs_list, u.device),
                       nsweeps, active)


def fused_smooth_residual_3d_batched_plain(u, rhs, dq, bcs_list, nsweeps: int,
                                           active=None):
    """(u', r): the sweeps, then each lane's residual of its swept state."""
    count_plain(fused_smooth_residual_3d_batched_plain, u)
    masks = lane_masks(u.shape[1:], bcs_list, u.device)
    u = lane_sweeps(u, rhs, dq, masks, nsweeps, active)
    return u, lane_residual(u, rhs, dq, masks, active)


def fused_smooth_cor_3d_batched_plain(u, cor, rhs, dq, bcs_list, nsweeps: int,
                                      active=None):
    """The sweeps on ``u + cor`` (a frozen lane: ``u`` unchanged)."""
    count_plain(fused_smooth_cor_3d_batched_plain, u)
    act = _active_view(active, u.device, 3)
    v = u + cor if act is None else torch.where(act, u + cor, u)
    return lane_sweeps(v, rhs, dq, lane_masks(u.shape[1:], bcs_list, u.device),
                       nsweeps, active)


for _f in (fused_smooth_3d_batched_plain, fused_smooth_residual_3d_batched_plain,
           fused_smooth_cor_3d_batched_plain):
    _f.plain_cuda_calls = 0


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------


def check_lanes(name: str, tensors, dq, bcs_list, nsweeps: int,
                 active: Optional[Sequence[bool]]):
    check_level(name, tensors, torch.float32, lanes=True)
    nb = int(tensors[0].shape[0]) if tensors[0].ndim == 4 else 0
    if tensors[0].ndim != 4 or not 1 <= nb <= MAX_LANES or len(bcs_list) != nb:
        raise ValueError(
            f"{name}: expected a (B, nz, ny, nx) stack with 1 <= B <= {MAX_LANES} "
            f"and one BC set per lane, got {tuple(tensors[0].shape)} and "
            f"{len(bcs_list)} BC sets"
        )
    bcs_list = tuple(check_config(name, dq, b, nsweeps) for b in bcs_list)
    active = [True] * nb if active is None else [bool(a) for a in active]
    if len(active) != nb:
        raise ValueError(f"{name}: {len(active)} active flags for {nb} lanes")
    return bcs_list, active


def fused_smooth_3d_batched(u, rhs, dq, bcs_list, nsweeps: int, active=None):
    """``nsweeps`` red-black sweeps of every lane of a (B, nz, ny, nx)
    float32 stack, lane b with ``bcs_list[b]``.  Replaces
    ndsm_tpu/ops/pallas_fused.py:fused_smooth_3d_batched."""
    bcs_list, active = check_lanes("fused_smooth_3d_batched", (u, rhs), dq, bcs_list,
                                    nsweeps, active)
    if u.device.type == "cpu":
        return fused_smooth_3d_batched_plain(u, rhs, dq, bcs_list, nsweeps, active)
    out = sweeps_cuda(u, None, rhs, dq, bcs_list, nsweeps, active, "fused_smooth_3d_batched")
    fused_smooth_3d_batched.launches += 1
    return out


def fused_smooth_residual_3d_batched(u, rhs, dq, bcs_list, nsweeps: int, active=None):
    """(u', r): the lane sweeps, then every lane's residual of its swept
    state (the lane form of ndsm_tpu/ops/pallas_zc.py:zc_smooth_residual_3d
    as ndsm_tpu/mg/batched.py calls it per lane)."""
    name = "fused_smooth_residual_3d_batched"
    bcs_list, active = check_lanes(name, (u, rhs), dq, bcs_list, nsweeps, active)
    if u.device.type == "cpu":
        return fused_smooth_residual_3d_batched_plain(u, rhs, dq, bcs_list, nsweeps, active)
    out, r = sweeps_cuda(u, None, rhs, dq, bcs_list, nsweeps, active, name, residual=True)
    fused_smooth_residual_3d_batched.launches += 1
    return out, r


def fused_smooth_cor_3d_batched(u, cor, rhs, dq, bcs_list, nsweeps: int, active=None):
    """The lane sweeps on ``u + cor`` (the V-cycle ascent's
    correct-then-relax; the lane form of
    ndsm_tpu/ops/pallas_zc.py:zc_smooth_cor_3d)."""
    name = "fused_smooth_cor_3d_batched"
    bcs_list, active = check_lanes(name, (u, cor, rhs), dq, bcs_list, nsweeps, active)
    if u.device.type == "cpu":
        return fused_smooth_cor_3d_batched_plain(u, cor, rhs, dq, bcs_list, nsweeps, active)
    out = sweeps_cuda(u, cor, rhs, dq, bcs_list, nsweeps, active, name)
    fused_smooth_cor_3d_batched.launches += 1
    return out


#: ``nsweeps`` red-black sweeps of one (nz, ny, nx) float32 level: the
#: one-lane call of the lane kernels, which is ops/zc.py's zc_smooth_3d
#: (one wrapper, one launch counter).  Replaces
#: ndsm_tpu/ops/pallas_fused.py:fused_smooth_3d.
fused_smooth_3d = zc_smooth_3d
fused_smooth_3d_plain = zc_smooth_3d_plain


for _f in (fused_smooth_3d_batched, fused_smooth_residual_3d_batched,
           fused_smooth_cor_3d_batched):
    _f.launches = 0
del _f
