"""Field kind ``diffusion_modes``: manufactured solves of an injected
diffusion operator.  ``u_true`` is a sum of products of sin(k pi q) on
Dirichlet axes and cos(k pi q) on Neumann axes, and ``rhs = L_ref(u_true)``
in float64 (``reference/diffusion.py``, on the card where there is one), so
``u_true`` is the discrete solution; u0 = 0.

Parameters: ``bcs``, the faces ((z), (y), (x), each ``["D"|"N", "D"|"N"]``);
``operator``, the operator's spec (a configuration's ``operator``; the
entry refuses a call whose spec is not its configuration's);
``modes_per_member``; ``k_catalog``, the wave numbers (kz, ky, kx) that are
dealt out to the pool's members (every seed the same catalogue).  Each
input carries ``u_true`` for the check.
"""

import math

import numpy as np
import torch

from benchmark.reference import diffusion as ref


def make(n, mesh, rng, field, count):
    """``count`` inputs ``{"u0", "rhs", "meshes", "bcs", "operator",
    "u_true"}`` of size ``n``."""
    x, y, z = mesh
    bcs = tuple(tuple(b) for b in field["bcs"])
    spec = dict(field["operator"])
    M = int(field["modes_per_member"])
    cat = [tuple(int(v) for v in k) for k in field["k_catalog"]]
    deal = rng.permutation(np.resize(np.arange(len(cat)), count * M))
    shape = (z.size, y.size, x.size)
    # rhs is made on the card where there is one (the set-up's bulk of work)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    a = ref.coefficient(spec, shape, dev)
    h = [float(q[1] - q[0]) for q in (z, y, x)]
    u0 = np.zeros(shape)
    out = []
    for j in range(count):
        u_true = np.zeros(shape)
        for m in range(M):
            k = cat[deal[j * M + m]]
            amp = rng.choice((-1.0, 1.0)) * rng.uniform(0.5, 1.0) / M
            f = [np.sin if bc[0] == "D" else np.cos for bc in bcs]
            fz, fy, fx = (f[ax](math.pi * k[ax] * q) for ax, q in enumerate((z, y, x)))
            u_true += amp * fz[:, None, None] * fy[None, :, None] * fx[None, None, :]
        rhs = ref.apply(torch.from_numpy(u_true).to(dev), a, h, bcs).cpu().numpy()
        out.append({"u0": u0, "rhs": rhs, "meshes": (z, y, x), "bcs": bcs,
                    "operator": spec, "u_true": u_true})
    return out
