"""Plain reference of ``solve_poisson_bvp`` on a uniform 3D node grid: the
exact discrete solution (``spectral.solve``) of the reference code's
problem (sag2021/ndsm ``fortran/ndsm_poisson.f90:63-155``: the 7-point
Laplacian, Neumann faces by reflection, Dirichlet faces held at ``u0``).

An all-Neumann solution is known up to a constant; the program pins it to
mean 0 (``subtract_mean``), so both sides are compared with the mean
taken out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spectral

def solve_poisson_bvp(u0, rhs, meshes, bcs, device="cuda") -> torch.Tensor:
    """u (float64, on ``device``) from numpy ``u0``, ``rhs`` and the per-axis
    mesh vectors."""
    h = [float(np.asarray(m)[1] - np.asarray(m)[0]) for m in meshes]
    f64 = dict(dtype=torch.float64, device=device)
    u = spectral.solve(torch.as_tensor(rhs, **f64), torch.as_tensor(u0, **f64), h, bcs)
    if all(tuple(b) == ("N", "N") for b in bcs):
        u = u - u.mean()
    return u
