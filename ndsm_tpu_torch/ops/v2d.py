"""Multi-sweep red-black smoother for float32 2D levels (port of
``ndsm_tpu/ops/pallas_v2d.py``: ``v2d_smooth``, ``v2d_smooth_residual``,
``v2d_smooth_cor`` and their lane-batched form).

These smooth the chi faces of the vector-potential pipeline: six
all-Neumann 2D solves, lane-batched in ``PoissonBVP.solve_batch``.  Each
wrapper takes a ``(ny, nx)`` level or a lane stack ``(B, ny, nx)`` and its
static configuration (dq, bcs, number of sweeps):

  * on a CUDA tensor it launches the kernel of ``csrc/v2d_smooth.cu``
    (built at first use) once and adds one to its ``launches`` count, or
    raises;
  * on a CPU tensor it runs its plain PyTorch version below.

Semantics (the JAX kernel's ``_sweep_body``): ``nsweeps`` times the red
then black half-update of ``stencils.red_black``; after each sweep of an
all-Neumann level, ``u - sum(u) * inv_n`` with ``inv_n = f32(1/(ny*nx))``
(a multiply by the rounded reciprocal, not ``torch.mean``).  The sum is
taken per lane in the kernel's fixed order (``reduce.strided_block_sum``),
so the kernel equals its plain version bit for bit.  The correction form
adds ``cor`` on load; the residual form returns ``poisson_residual`` of the
swept state.  Dirichlet faces are frozen.  The wrappers are functional:
inputs are never modified; each lane's result does not depend on B.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import stencils
from .reduce import strided_block_sum
from .zc import check_level, count_plain, dirichlet_mask

__all__ = [
    "v2d_smooth",
    "v2d_smooth_residual",
    "v2d_smooth_cor",
    "v2d_smooth_plain",
    "v2d_smooth_residual_plain",
    "v2d_smooth_cor_plain",
]


def _check(name: str, tensors, dq, bcs, nsweeps: int):
    """Raise unless the tensors are contiguous float32 ``(ny, nx)`` or
    ``(B, ny, nx)`` levels of one shape on one device; returns the
    validated bcs."""
    check_level(name, tensors, torch.float32, ndim=2, lanes=True)
    if int(nsweeps) < 1:
        raise ValueError(f"{name}: nsweeps must be >= 1, got {nsweeps}")
    if len(dq) != 2:
        raise ValueError(f"{name}: dq must have 2 entries")
    return stencils.validate_bcs(bcs, 2)


def _inv_n(shape) -> float:
    return float(np.float32(1.0 / (int(shape[-2]) * int(shape[-1]))))


# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def _sweeps_plain(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    all_neumann = stencils.is_all_neumann(bcs)
    inv_n = _inv_n(u.shape)
    lanes = tuple(u.shape[:-2])
    for _ in range(int(nsweeps)):
        u = stencils.red_black(u, rhs, dq, bcs)
        if all_neumann:
            s = strided_block_sum(u.reshape(lanes + (-1,)))  # (..., 1)
            u = u - (s * inv_n).reshape(lanes + (1, 1))
    return u


def v2d_smooth_plain(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` sweeps (with the per-sweep mean when all-Neumann)."""
    count_plain(v2d_smooth_plain, u)
    return _sweeps_plain(u, rhs, dq, bcs, nsweeps)


def v2d_smooth_residual_plain(u, rhs, dq, bcs, nsweeps: int):
    """(u', r): the sweeps, then ``poisson_residual`` of u'."""
    count_plain(v2d_smooth_residual_plain, u)
    u = _sweeps_plain(u, rhs, dq, bcs, nsweeps)
    return u, stencils.poisson_residual(u, rhs, dq, bcs)


def v2d_smooth_cor_plain(u, cor, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """The sweeps on ``u + cor``."""
    count_plain(v2d_smooth_cor_plain, u)
    return _sweeps_plain(u + cor, rhs, dq, bcs, nsweeps)


for _f in (v2d_smooth_plain, v2d_smooth_residual_plain, v2d_smooth_cor_plain):
    _f.plain_cuda_calls = 0


# ----------------------------------------------------------------------
# CUDA launch
# ----------------------------------------------------------------------


def _v2d_cuda(u, cor, rhs, dq, bcs, nsweeps: int, residual: bool, what: str):
    """One launch: one block per lane runs every sweep (and the epilogue)."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    ny, nx = (int(s) for s in u.shape[-2:])
    lanes = int(np.prod(u.shape[:-2], dtype=np.int64))
    (wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    out = torch.empty_like(u)
    res = torch.empty_like(u) if residual else None
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.ndsm_v2d_smooth_f32(
            u.data_ptr(), None if cor is None else cor.data_ptr(), rhs.data_ptr(),
            out.data_ptr(), None if res is None else res.data_ptr(),
            lanes, ny, nx, int(nsweeps), stencils.first_color_parity(bcs),
            dirichlet_mask(bcs), int(stencils.is_all_neumann(bcs)),
            wy, wx, w0, _inv_n(u.shape), stream,
        )
        cuda_build.check(rc, what)
    return out, res


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------


def v2d_smooth(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` red-black sweeps of ``laplace(u) = rhs`` on a float32 2D
    level (per lane).  Replaces ndsm_tpu/ops/pallas_v2d.py:v2d_smooth."""
    bcs = _check("v2d_smooth", (u, rhs), dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return v2d_smooth_plain(u, rhs, dq, bcs, nsweeps)
    out, _ = _v2d_cuda(u, None, rhs, dq, bcs, nsweeps, False, "v2d_smooth")
    v2d_smooth.launches += 1
    return out


def v2d_smooth_residual(u, rhs, dq, bcs, nsweeps: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u', r): the sweeps, then the residual of the swept state.  Replaces
    ndsm_tpu/ops/pallas_v2d.py:v2d_smooth_residual."""
    bcs = _check("v2d_smooth_residual", (u, rhs), dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return v2d_smooth_residual_plain(u, rhs, dq, bcs, nsweeps)
    out, res = _v2d_cuda(u, None, rhs, dq, bcs, nsweeps, True, "v2d_smooth_residual")
    v2d_smooth_residual.launches += 1
    return out, res


def v2d_smooth_cor(u, cor, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """The sweeps on ``u + cor`` (the V-cycle ascent's correct-then-relax).
    Replaces ndsm_tpu/ops/pallas_v2d.py:v2d_smooth_cor."""
    bcs = _check("v2d_smooth_cor", (u, cor, rhs), dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return v2d_smooth_cor_plain(u, cor, rhs, dq, bcs, nsweeps)
    out, _ = _v2d_cuda(u, cor, rhs, dq, bcs, nsweeps, False, "v2d_smooth_cor")
    v2d_smooth_cor.launches += 1
    return out


for _f in (v2d_smooth, v2d_smooth_residual, v2d_smooth_cor):
    _f.launches = 0
del _f
