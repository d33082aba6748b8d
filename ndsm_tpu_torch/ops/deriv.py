"""Second-order finite differences and curl on the device (port of
``ndsm_tpu/ops/deriv.py:deriv_axis/curl``): central differences in the
interior, one-sided [-3, +4, -1]/(2h) at both ends (reference derivq,
ndsm_vector_potential.f90:825-872).  Same operand order as the JAX
functions.

``deriv_axis_np``, ``curl_np`` and ``curl_np_into`` are their numpy
mirrors on the host (JAX ``ops/deriv.py:87-188``), the host curl of
``Options.host_curl``: ``curl_np_into`` writes rows [z0, z1) of the curl
reading only A's rows z0 - 1 .. z1, so the curl of a z slab can run as
soon as it and its neighbours have reached the host, and any split of z
into slabs gives the whole call's bits."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["deriv_axis", "curl", "deriv_axis_np", "curl_np", "curl_np_into"]


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


def deriv_axis_np(u, h, axis: int) -> np.ndarray:
    """numpy mirror of :func:`deriv_axis`, in the same operand order."""
    u = np.asarray(u)
    inv2h = np.asarray(0.5 / np.asarray(h), dtype=u.dtype)
    n = u.shape[axis]

    def sl(lo, hi):
        idx = [slice(None)] * u.ndim
        idx[axis] = slice(lo, hi)
        return u[tuple(idx)]

    interior = (sl(2, n) - sl(0, n - 2)) * inv2h
    lo = (-3.0 * sl(0, 1) + 4.0 * sl(1, 2) - sl(2, 3)) * inv2h
    hi = (3.0 * sl(n - 1, n) - 4.0 * sl(n - 2, n - 1) + sl(n - 3, n - 2)) * inv2h
    return np.concatenate([lo, interior, hi], axis=axis)


def curl_np(A, dq) -> np.ndarray:
    """numpy mirror of :func:`curl`, the same component expressions."""
    A = np.asarray(A)
    Ax, Ay, Az = A[0], A[1], A[2]
    dx, dy, dz = dq[0], dq[1], dq[2]
    dAz_dy = deriv_axis_np(Az, dy, -2)
    dAy_dz = deriv_axis_np(Ay, dz, -3)
    dAx_dz = deriv_axis_np(Ax, dz, -3)
    dAz_dx = deriv_axis_np(Az, dx, -1)
    dAy_dx = deriv_axis_np(Ay, dx, -1)
    dAx_dy = deriv_axis_np(Ax, dy, -2)
    return np.stack([dAz_dy - dAy_dz, dAx_dz - dAz_dx, dAy_dx - dAx_dy])


def _deriv_z_rows_np(F, h, z0: int, z1: int) -> np.ndarray:
    """Rows [z0, z1) of ``deriv_axis_np(F, h, -3)`` in float64: the same
    per-row expressions (central inside, one-sided at the two global
    faces), reading only F's rows z0 - 1 .. z1 and the one-sided
    stencils' three rows where the range touches a face."""
    n = F.shape[0]
    inv2h = np.asarray(0.5 / np.asarray(h), dtype=np.float64)

    def rows(a, b):
        return F[a:b].astype(np.float64, copy=False)

    parts = []
    if z0 == 0:
        parts.append((-3.0 * rows(0, 1) + 4.0 * rows(1, 2) - rows(2, 3)) * inv2h)
    a, b = max(z0, 1), min(z1, n - 1)
    if b > a:
        parts.append((rows(a + 1, b + 1) - rows(a - 1, b - 1)) * inv2h)
    if z1 == n:
        parts.append((3.0 * rows(n - 1, n) - 4.0 * rows(n - 2, n - 1) + rows(n - 3, n - 2))
                     * inv2h)
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)


def curl_np_into(A, dq, out, z0: int = 0, z1=None):
    """Write ``out[:, z0:z1] = curl_np(A)[:, z0:z1]`` bit for bit, reading
    only A[:, z0 - 1 : z1 + 1] (and the one-sided stencils' rows at the
    global z faces).  The differences are taken in float64 whatever the
    dtypes of ``A`` and ``out``, as the device path differences before it
    casts.  Returns ``out``."""
    A = np.asarray(A)
    z1 = A.shape[1] if z1 is None else z1
    Ax, Ay, Az = A[0], A[1], A[2]
    dx, dy, dz = dq[0], dq[1], dq[2]

    def chunk(F):
        return F[z0:z1].astype(np.float64, copy=False)

    dAz_dy = deriv_axis_np(chunk(Az), dy, -2)
    dAy_dz = _deriv_z_rows_np(Ay, dz, z0, z1)
    dAx_dz = _deriv_z_rows_np(Ax, dz, z0, z1)
    dAz_dx = deriv_axis_np(chunk(Az), dx, -1)
    dAy_dx = deriv_axis_np(chunk(Ay), dx, -1)
    dAx_dy = deriv_axis_np(chunk(Ax), dy, -2)
    out[0, z0:z1] = dAz_dy - dAy_dz
    out[1, z0:z1] = dAx_dz - dAz_dx
    out[2, z0:z1] = dAy_dx - dAx_dy
    return out
