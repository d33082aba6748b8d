"""Field kind ``poisson_modes``: u0 = 0 and rhs = laplace(u*), u* a sum of
products of sin(k pi q) on Dirichlet axes and cos(k pi q) on Neumann axes
(they fit the faces of the unit cube).

Parameters: ``bcs``, the faces ((z), (y), (x), each ``["D"|"N", "D"|"N"]``);
``modes_per_member``; ``k_catalog``, the wave numbers (kz, ky, kx) that are
dealt out to the pool's members (every seed the same catalogue).
"""

import math

import numpy as np


def make(n, mesh, rng, field, count):
    """``count`` inputs ``{"u0", "rhs", "meshes", "bcs"}`` of size ``n``."""
    x, y, z = mesh
    bcs = tuple(tuple(b) for b in field["bcs"])
    M = int(field["modes_per_member"])
    cat = [tuple(int(v) for v in k) for k in field["k_catalog"]]
    deal = rng.permutation(np.resize(np.arange(len(cat)), count * M))
    u0 = np.zeros((z.size, y.size, x.size))
    out = []
    for j in range(count):
        rhs = np.zeros_like(u0)
        for m in range(M):
            k = cat[deal[j * M + m]]
            a = rng.choice((-1.0, 1.0)) * rng.uniform(0.5, 1.0) / M
            f = [np.sin if bc[0] == "D" else np.cos for bc in bcs]
            fz, fy, fx = (f[ax](math.pi * k[ax] * q) for ax, q in enumerate((z, y, x)))
            lap = -(math.pi**2) * sum(v * v for v in k)
            rhs += (a * lap) * fz[:, None, None] * fy[None, :, None] * fx[None, None, :]
        out.append({"u0": u0, "rhs": rhs, "meshes": (z, y, x), "bcs": bcs})
    return out
