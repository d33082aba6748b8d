"""Plain reference of an injected-operator solve: the discrete diffusion
operator ``L[u] = div(a grad u)`` that ``solve_poisson_bvp(...,
operator=DiffusionOperator(coef))`` solves, written from that operator's
documented discretisation (``ndsm_tpu_torch/mg/operator.py``), and the
numbers that judge a solve against a manufactured discrete solution.

The discretisation, on a uniform node grid with spacings ``h``:

  * flux form with arithmetic-mean face coefficients,
    ``L[u]_i = sum_ax (a_{i+1/2} (u_{i+1} - u_i) - a_{i-1/2} (u_i - u_{i-1})) / h_ax^2``,
    ``a_{i+-1/2} = (a_i + a_{i+-1}) / 2``;
  * the coefficient evaluated on the normalised nodes ``i / (n - 1)`` of
    each axis;
  * Neumann index reflection at every face, for ``u`` and for ``a`` alike
    (index -1 reads 1, index n reads n - 2);
  * Dirichlet points frozen: the solve holds them at ``u0``, so the
    operator has no equation there and ``apply`` gives 0 on them (the
    program's residual is zeroed on those faces).

Departures from the operator's docstring: this is the finest level's
operator alone, in float64 (the program re-discretises it on every
multigrid level and evaluates ``a`` in each level's dtype; those coarse
operators only steer the iteration, the finest one poses the problem);
and ``a`` is given by a configuration's ``operator`` spec rather than by
a callable.

The traffic manufactures each problem: a smooth ``u_true`` and ``rhs =
apply(u_true)`` in float64, so ``u_true`` is the exact discrete solution
up to rounding (about 1e-12 relative), known up to a constant where every
face is Neumann.  So no solve is needed here: ``u_gap`` compares the
program's u with ``u_true``, the means taken out where every face is
Neumann.

Plain PyTorch in float64; it imports nothing of the program it judges.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BCS = Sequence[Tuple[str, str]]


def unit_nodes(n: int, device="cpu") -> torch.Tensor:
    """The normalised nodes ``i / (n - 1)``, float64 (the last exactly 1)."""
    return torch.arange(n, dtype=torch.float64, device=device) / (n - 1)


def coefficient(spec: dict, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``a`` on the nodes of an array of ``shape`` (axes (z, y, x)), float64.

    ``spec`` is a configuration's ``operator``: ``{"kind": "diffusion",
    "coef": "stratified", "contrast": c}`` gives ``a(z) = exp(-ln(c) z)``
    on the normalised height z (axis 0), falling from 1 at the bottom to
    1 / c at the top."""
    if spec.get("kind") != "diffusion" or spec.get("coef") != "stratified":
        raise ValueError(f"no reference for the operator {spec}")
    z = unit_nodes(shape[0], device)
    a = torch.exp(-math.log(float(spec["contrast"])) * z)
    return a.reshape((-1,) + (1,) * (len(shape) - 1)).expand(tuple(shape))


def _neighbors(x: torch.Tensor, axis: int):
    """(lower, upper) neighbours along ``axis``, reflected at both faces."""
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 1, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 2, 1)], dim=axis)
    return lo, hi


def _frozen(shape: Sequence[int], bcs: BCS, device) -> torch.Tensor:
    """True on the points of Dirichlet faces."""
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for ax, (lo, hi) in enumerate(bcs):
        if lo == "D":
            mask.narrow(ax, 0, 1).fill_(True)
        if hi == "D":
            mask.narrow(ax, shape[ax] - 1, 1).fill_(True)
    return mask


def apply(u: torch.Tensor, a: torch.Tensor, spacings: Sequence[float], bcs: BCS
          ) -> torch.Tensor:
    """``L[u]`` (float64 tensors of one shape; ``spacings`` per axis; 0 on
    the points of Dirichlet faces)."""
    out = None
    for ax in range(u.ndim):
        ulo, uhi = _neighbors(u, ax)
        alo, ahi = _neighbors(a, ax)
        flux = (0.5 * (a + ahi) * (uhi - u) - 0.5 * (a + alo) * (u - ulo)) * (
            1.0 / (spacings[ax] * spacings[ax]))
        out = flux if out is None else out + flux
    return out.masked_fill(_frozen(u.shape, bcs, u.device), 0.0)


def u_gap(u: torch.Tensor, u_true: torch.Tensor, bcs: BCS) -> float:
    """``max|u - u_true| / max|u_true|``, each with its mean taken out
    where every face is Neumann (float64 tensors of one shape)."""
    u, u_true = u.to(torch.float64), u_true.to(torch.float64)
    if all(tuple(b) == ("N", "N") for b in bcs):
        u, u_true = u - u.mean(), u_true - u_true.mean()
    return float((u - u_true).abs().max() / u_true.abs().max())
