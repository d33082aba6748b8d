"""Plain reference of ``vector_potential``: the same discrete pipeline,
with every Poisson problem solved exactly (``spectral.solve``) in float64.

The pipeline is the reference code's (sag2021/ndsm,
``fortran/ndsm_vector_potential.f90``; Yang, Wheatland & Gilchrist 2020),
with the options of ``integration_test1.py`` that pose the problem
(``flux_correction_order 0``, no flux quirk; see ``PROBLEM``):

  1. Bn on the six faces, each face's trapezoid flux phi, and the
     flux-balanced right-hand side ``Bn - phi / area``;
  2. chi on each face: the all-Neumann 2D problem ``L chi = Bn - phi/area``;
  3. the tangential boundary data ``At = -grad(chi) x n`` (central
     differences, zero on a face's edge lines), scattered into the
     Dirichlet faces of the three component problems, face by face in the
     order x0, x1, y0, y1, z0, z1;
  4. the three 3D problems ``L A_c = 0``, Neumann on the two faces normal
     to component c and Dirichlet (from step 3) on the other four;
  5. the analytic flux-balance potential added to A, and ``B = curl A``
     (second-order central differences, one-sided at the faces).

The program iterates each of the nine problems to a tolerance; this
solves them exactly, so the two differ by the program's iteration and
rounding error alone.  Arrays are C-ordered (3, nz, ny, nx); the face
tables below follow the reference's S1..S6.

Plain PyTorch and NumPy; it imports nothing of the program it judges.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spectral

# Face f = (x0, x1, y0, y1, z0, z1): its normal component, its side, its
# in-plane components (Fortran order, d1 < d2), and its tangent and normal
# vectors (reference ndsm_vector_potential.f90:81-116).
FACE_COMP = (0, 0, 1, 1, 2, 2)
FACE_SIDE = (0, 1, 0, 1, 0, 1)
FACE_DIMS = ((1, 2), (1, 2), (0, 2), (0, 2), (0, 1), (0, 1))
TVECS1 = np.array([[0, 1, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]], float)
TVECS2 = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 1, 0]], float)
NVECS = np.array([[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]], float)

#: The options that change the discrete problem, at the values this
#: reference computes; a configuration that states others is refused rather
#: than judged against the wrong problem.  Every other option (tolerances,
#: sweeps, precision, the du metric, host_curl, batching) changes only how
#: the program reaches the same exact answer.
PROBLEM = {"flux_correction_order": 0, "reference_flux_quirk": False}


def face_index(face: int, shape):
    """Index of the face layer of a (nz, ny, nx) volume."""
    comp = FACE_COMP[face]
    n = (shape[2], shape[1], shape[0])[comp]
    idx = [slice(None)] * 3
    idx[2 - comp] = 0 if FACE_SIDE[face] == 0 else n - 1
    return tuple(idx)


def _trapz(f: torch.Tensor, h0: float, h1: float) -> torch.Tensor:
    w0 = torch.ones(f.shape[0], dtype=f.dtype, device=f.device)
    w1 = torch.ones(f.shape[1], dtype=f.dtype, device=f.device)
    w0[0] = w0[-1] = w1[0] = w1[-1] = 0.5
    return torch.sum(f * (w0[:, None] * w1[None, :])) * (h0 * h1)


def _diff_zero_edges(c: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    n = c.shape[axis]
    d = (c.narrow(axis, 2, n - 2) - c.narrow(axis, 0, n - 2)) * (0.5 / h)
    z = torch.zeros_like(c.narrow(axis, 0, 1))
    return torch.cat([z, d, z], dim=axis)


def _deriv(u: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    n = u.shape[axis]
    s = lambda a, b: u.narrow(axis, a, b - a)  # noqa: E731
    inv2h = 0.5 / h
    mid = (s(2, n) - s(0, n - 2)) * inv2h
    lo = (-3.0 * s(0, 1) + 4.0 * s(1, 2) - s(2, 3)) * inv2h
    hi = (3.0 * s(n - 1, n) - 4.0 * s(n - 2, n - 1) + s(n - 3, n - 2)) * inv2h
    return torch.cat([lo, mid, hi], dim=axis)


def curl(A: torch.Tensor, dx: float, dy: float, dz: float) -> torch.Tensor:
    Ax, Ay, Az = A[0], A[1], A[2]
    return torch.stack([
        _deriv(Az, dy, -2) - _deriv(Ay, dz, -3),
        _deriv(Ax, dz, -3) - _deriv(Az, dx, -1),
        _deriv(Ay, dx, -1) - _deriv(Ax, dy, -2),
    ])


def at_signs(face: int):
    """(s1, s2) with ``At1 = s1 dchi/dq2``, ``At2 = s2 dchi/dq1``: the
    projections of ``-grad(chi) x n`` on the two tangent vectors."""
    t1, t2, n = TVECS1[face], TVECS2[face], NVECS[face]
    return -float(np.dot(t1, np.cross(t2, n))), -float(np.dot(t2, np.cross(t1, n)))


def vector_potential(x, y, z, b, device="cuda"):
    """(A, B), float64 tensors of shape (3, nz, ny, nx) on ``device``, from
    the mesh vectors and the field ``b`` (numpy; only its normal
    components on the six faces are read)."""
    mesh = [np.asarray(v, dtype=np.float64) for v in (x, y, z)]
    shape = (mesh[2].size, mesh[1].size, mesh[0].size)
    dq = [float(m[1] - m[0]) for m in mesh]
    Lq = [float(m.max() - m.min()) for m in mesh]
    f64 = dict(dtype=torch.float64, device=device)

    chi_rhs, phi = [], []
    for f in range(6):
        d1, d2 = FACE_DIMS[f]
        bn = torch.as_tensor(np.ascontiguousarray(b[FACE_COMP[f]][face_index(f, shape)]), **f64)
        p = _trapz(bn, dq[d2], dq[d1])
        phi.append(p)
        chi_rhs.append(bn - p / (Lq[d1] * Lq[d2]))

    At1, At2 = [], []
    for f in range(6):
        d1, d2 = FACE_DIMS[f]
        h = [dq[d2], dq[d1]]  # the face array's axes are (d2, d1)
        chi = spectral.solve(chi_rhs[f], torch.zeros_like(chi_rhs[f]), h, (("N", "N"),) * 2)
        s1, s2 = at_signs(f)
        At1.append(s1 * _diff_zero_edges(chi, dq[d2], 0))
        At2.append(s2 * _diff_zero_edges(chi, dq[d1], 1))

    h3 = [dq[2], dq[1], dq[0]]  # (z, y, x)
    A = torch.zeros((3,) + shape, **f64)
    for comp in range(3):
        u0 = torch.zeros(shape, **f64)
        for f in range(6):
            if FACE_COMP[f] == comp:
                continue
            slot1 = TVECS1[f][comp] == 1.0
            u0[face_index(f, shape)] = At1[f] if slot1 else At2[f]
        bcs = tuple(("N", "N") if 2 - ax == comp else ("D", "D") for ax in range(3))
        A[comp] = spectral.solve(torch.zeros_like(u0), u0, h3, bcs)

    X = torch.as_tensor(mesh[0], **f64)[None, None, :]
    Y = torch.as_tensor(mesh[1], **f64)[None, :, None]
    Z = torch.as_tensor(mesh[2], **f64)[:, None, None]
    V = Lq[0] * Lq[1] * Lq[2]
    g = [(phi[1] - phi[0]) / V, (phi[3] - phi[2]) / V, (phi[5] - phi[4]) / V]
    A[0] += -phi[4] * Lq[2] * Y / V + (g[1] - g[2]) * Y * Z / 3.0
    A[1] += -phi[0] * Lq[0] * Z / V + (g[2] - g[0]) * X * Z / 3.0
    A[2] += -phi[2] * Lq[1] * X / V + (g[0] - g[1]) * X * Y / 3.0
    return A, curl(A, dq[0], dq[1], dq[2])
