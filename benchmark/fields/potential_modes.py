"""Field kind ``potential_modes``: Bn on the six faces of a sum of
potential-field modes (the family of integration_test1.py:57-99).

Mode (kx, ky), with wave numbers in units of pi, phases px, py and
amplitude a gives B = a (kx' sin X cos Y, ky' cos X sin Y, l cos X cos Y)
exp(-l z), X = kx' x + px, Y = ky' y + py, kx' = pi kx, ky' = pi ky,
l = sqrt(kx'^2 + ky'^2).  Only the faces are filled (the program reads
nothing else).

Parameters: ``modes_per_member``, and ``k_catalog``, the wave numbers that
are dealt out to the pool's members (every seed the same catalogue).
"""

import math

import numpy as np


def make(n, mesh, rng, field, count):
    """``count`` inputs ``{"x", "y", "z", "b"}`` of size ``n`` on ``mesh``."""
    x, y, z = mesh
    M = int(field["modes_per_member"])
    cat = [tuple(float(v) for v in k) for k in field["k_catalog"]]
    deal = rng.permutation(np.resize(np.arange(len(cat)), count * M))
    faces = (  # (component, index into b[c], the face's coordinates)
        (0, np.s_[:, :, 0], (x[0], y[None, :], z[:, None])),
        (0, np.s_[:, :, -1], (x[-1], y[None, :], z[:, None])),
        (1, np.s_[:, 0, :], (x[None, :], y[0], z[:, None])),
        (1, np.s_[:, -1, :], (x[None, :], y[-1], z[:, None])),
        (2, np.s_[0, :, :], (x[None, :], y[:, None], z[0])),
        (2, np.s_[-1, :, :], (x[None, :], y[:, None], z[-1])),
    )
    out = []
    for j in range(count):
        modes = []
        for m in range(M):
            kx, ky = (math.pi * v for v in cat[deal[j * M + m]])
            px, py = rng.uniform(0.0, 2.0 * math.pi, 2)
            a = rng.choice((-1.0, 1.0)) * rng.uniform(0.5, 1.0) / M
            modes.append((kx, ky, math.hypot(kx, ky), px, py, a))
        b = np.zeros((3, z.size, y.size, x.size))
        for comp, idx, (X, Y, Z) in faces:
            acc = 0.0
            for kx, ky, l, px, py, a in modes:
                sx, cx = np.sin(kx * X + px), np.cos(kx * X + px)
                sy, cy = np.sin(ky * Y + py), np.cos(ky * Y + py)
                e = a * np.exp(-l * Z)
                acc = acc + (kx * sx * cy, ky * cx * sy, l * cx * cy)[comp] * e
            b[comp][idx] = acc
        out.append({"x": x, "y": y, "z": z, "b": b})
    return out
