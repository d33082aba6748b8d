"""Second-order finite differences and curl on the device (port of
``ndsm_tpu/ops/deriv.py:deriv_axis/curl``): central differences in the
interior, one-sided [-3, +4, -1]/(2h) at both ends (reference derivq,
ndsm_vector_potential.f90:825-872).  Same operand order as the JAX
functions."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["deriv_axis", "curl"]


def deriv_axis(u: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """du/dq along ``axis`` with uniform spacing ``h``."""
    npdt = np.float32 if u.dtype == torch.float32 else np.float64
    inv2h = float(npdt(0.5) / npdt(h))  # h rounded to u's dtype first, as in JAX
    n = u.shape[axis]

    def sl(lo, hi):
        return u.narrow(axis, lo, hi - lo)

    interior = (sl(2, n) - sl(0, n - 2)) * inv2h
    lo = (-3.0 * sl(0, 1) + 4.0 * sl(1, 2) - sl(2, 3)) * inv2h
    hi = (3.0 * sl(n - 1, n) - 4.0 * sl(n - 2, n - 1) + sl(n - 3, n - 2)) * inv2h
    return torch.cat([lo, interior, hi], dim=axis)


def curl(A: torch.Tensor, dq) -> torch.Tensor:
    """B = curl(A) for ``A`` of shape (3, nz, ny, nx) holding (Ax, Ay, Az),
    with ``dq = (dx, dy, dz)`` (reference curl, ndsm_vector_potential.f90:
    759-811).  d/dx is the last axis of each component, d/dz the first."""
    Ax, Ay, Az = A[0], A[1], A[2]
    dx, dy, dz = (float(v) for v in dq)
    dAz_dy = deriv_axis(Az, dy, -2)
    dAy_dz = deriv_axis(Ay, dz, -3)
    dAx_dz = deriv_axis(Ax, dz, -3)
    dAz_dx = deriv_axis(Az, dx, -1)
    dAy_dx = deriv_axis(Ay, dx, -1)
    dAx_dy = deriv_axis(Ax, dy, -2)
    return torch.stack([dAz_dy - dAy_dz, dAx_dz - dAz_dx, dAy_dx - dAx_dy])
