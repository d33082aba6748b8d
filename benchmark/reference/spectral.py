"""Exact solves of the discrete Poisson problems NDSM iterates on.

The problem: the 5- or 7-point Laplacian ``sum_a (u[i-1] - 2 u[i] + u[i+1]) /
h_a^2 = rhs`` on a uniform node grid, each axis with a pair of equal faces:

  * ``("N", "N")``: the equation holds on the faces too, with the outside
    neighbour read by reflection (index -1 reads 1, index n reads n - 2);
  * ``("D", "D")``: the face planes hold fixed values, taken from ``u0``.

Each 1-D operator is diagonalised by a discrete trigonometric transform:
the reflected Neumann operator by the type-I cosine transform over all n
nodes (eigenvalues ``(2 cos(pi k / (n - 1)) - 2) / h^2``, k = 0..n-1), the
Dirichlet one by the type-I sine transform over the n - 2 inner nodes (the
same eigenvalues, k = 1..n-2).  So the discrete solution is three
transforms, a division and three transforms, in float64, with no
iteration.  The transforms are real FFTs of the even or odd extension.
The all-Neumann problem is singular: its constant mode is set to 0, which
gives the solution whose cosine coefficient 0 vanishes; callers that
compare it take out the mean.

Plain PyTorch; it imports nothing of the program it judges.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

BCS = Sequence[Tuple[str, str]]


def _dct1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``T(x)_k = x_0 + (-1)^k x_{n-1} + 2 sum_{0<j<n-1} x_j cos(pi j k / (n-1))``
    along ``axis``; ``T(T(x)) = 2 (n - 1) x``."""
    n = x.shape[axis]
    ext = torch.cat([x, x.flip(axis).narrow(axis, 1, n - 2)], dim=axis)
    return torch.fft.rfft(ext, dim=axis).real.narrow(axis, 0, n)


def _dst1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``S(x)_k = sum_{j=1..m} x_j sin(pi j k / (m + 1))`` along ``axis`` (x
    holds x_1..x_m); ``S(S(x)) = (m + 1) / 2 x``."""
    m = x.shape[axis]
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    ext = torch.cat([z, x, z, -x.flip(axis)], dim=axis)
    return -0.5 * torch.fft.rfft(ext, dim=axis).imag.narrow(axis, 1, m)


def _eigenvalues(n: int, h: float, bc: str, dtype, device) -> torch.Tensor:
    k = torch.arange(n, dtype=dtype, device=device) if bc == "N" else torch.arange(
        1, n - 1, dtype=dtype, device=device)
    return (2.0 * torch.cos(math.pi * k / (n - 1)) - 2.0) / (h * h)


def solve(rhs: torch.Tensor, u0: torch.Tensor, spacings: Sequence[float], bcs: BCS
          ) -> torch.Tensor:
    """The discrete solution of ``L u = rhs`` with the Dirichlet faces of
    ``u0`` (float64 tensors of one shape; ``spacings`` per axis, ``bcs`` a
    pair ``("N", "N")`` or ``("D", "D")`` per axis)."""
    if rhs.shape != u0.shape or len(bcs) != rhs.ndim or len(spacings) != rhs.ndim:
        raise ValueError(f"shapes {tuple(rhs.shape)}, {tuple(u0.shape)}, bcs {bcs}")
    if any(tuple(b) not in (("N", "N"), ("D", "D")) for b in bcs):
        raise ValueError(f"each axis takes ('N', 'N') or ('D', 'D'), got {bcs}")
    ndim = rhs.ndim
    dirichlet = [b[0] == "D" for b in bcs]
    inner = tuple(slice(1, -1) if d else slice(None) for d in dirichlet)
    f = rhs[inner].clone()
    # Known face values move to the right-hand side of the first inner planes.
    for a in range(ndim):
        if not dirichlet[a]:
            continue
        w = 1.0 / (spacings[a] * spacings[a])
        for src, dst in ((0, 0), (-1, -1)):
            sel = list(inner)
            sel[a] = src
            tgt = [slice(None)] * ndim
            tgt[a] = dst
            f[tuple(tgt)] -= w * u0[tuple(sel)]
    lam = None
    for a in range(ndim):
        ev = _eigenvalues(rhs.shape[a], spacings[a], bcs[a][0], f.dtype, f.device)
        shape = [1] * ndim
        shape[a] = ev.numel()
        ev = ev.view(shape)
        lam = ev if lam is None else lam + ev
    F = f
    for a in range(ndim):
        F = _dst1(F, a) if dirichlet[a] else _dct1(F, a)
    zero = lam == 0
    F = torch.where(zero, torch.zeros_like(F), F / torch.where(zero, torch.ones_like(lam), lam))
    scale = 1.0
    for a in range(ndim):
        F = _dst1(F, a) if dirichlet[a] else _dct1(F, a)
        n = rhs.shape[a]
        scale *= 2.0 / (n - 1) if dirichlet[a] else 1.0 / (2 * (n - 1))
    u = u0.clone()
    u[inner] = F * scale
    return u


def laplacian(u: torch.Tensor, spacings: Sequence[float]) -> torch.Tensor:
    """``L u`` with reflected neighbours on every face (the residual of a
    solve is ``rhs - laplacian(u)`` on the points that are not fixed)."""
    out = torch.zeros_like(u)
    for a in range(u.ndim):
        n = u.shape[a]
        lo = torch.cat([u.narrow(a, 1, 1), u.narrow(a, 0, n - 1)], dim=a)
        hi = torch.cat([u.narrow(a, 1, n - 1), u.narrow(a, n - 2, 1)], dim=a)
        out = out + (lo - 2.0 * u + hi) / (spacings[a] * spacings[a])
    return out
