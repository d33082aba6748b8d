"""Second-order Poisson stencil: red-black Gauss-Seidel sweep and residual,
for any number of dimensions, in plain PyTorch (port of
``ndsm_tpu/ops/stencils.py``).

These functions are the oracles of the port: every CUDA kernel in ops/zc.py,
ops/v2d.py and ops/df.py has a plain version built from them, and the CPU
tests hold them against the JAX functions of the same name.

Semantics (see the JAX module for the derivation from the reference):

  * a sweep is two masked dense half-updates, red then black; the red
    color is ``first_color_parity(bcs)``;
  * Neumann faces use index reflection (neighbor -1 reads 1, n reads
    n-2); Dirichlet-face points are frozen and their residual is zero;
  * all-Neumann problems subtract the mean after every sweep.

Arithmetic order is the JAX module's: the weights are computed in float64
and cast to the working dtype, w0 is formed from the cast weights
(``stencil_weights``), and the half-sweep update is
``((z-pair*wz + y-pair*wy) + x-pair*wx - rhs) * w0`` (spatial axes in
array order).  PyTorch runs each elementwise op as its own kernel, so no
multiply-add is contracted: on the same inputs the CUDA kernels compiled
with ``-fmad=false`` reproduce these functions bit for bit.

Batching: ``bcs`` names the spatial axes, which are the LAST ``len(bcs)``
axes of ``u``; any leading axes are independent lanes (the chi faces'
``solve_batch``).  The all-Neumann mean is taken per lane.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.caching import BoundedCache

BCS = Tuple[Tuple[str, str], ...]  # per-axis (lower, upper), each "N" or "D"

__all__ = [
    "validate_bcs",
    "first_color_parity",
    "is_all_neumann",
    "stencil_weights",
    "interior_mask",
    "color_masks",
    "shard_masks",
    "red_black",
    "masked_red_black",
    "rb_sweep",
    "poisson_residual",
    "masked_residual",
    "subtract_mean",
]


def validate_bcs(bcs: Sequence[Sequence[str]], ndim: int) -> BCS:
    bcs = tuple(tuple(b) for b in bcs)
    if len(bcs) != ndim or any(
        len(b) != 2 or b[0] not in "ND" or b[1] not in "ND" for b in bcs
    ):
        raise ValueError(f"bcs must be {ndim} pairs drawn from 'N'/'D', got {bcs}")
    return bcs


def first_color_parity(bcs: BCS) -> int:
    """0-based sum-parity of the first-updated ("red") color: in 3D, 0 if
    the last axis' lower face is Neumann, else 1; 0 in any other ndim
    (reference ndsm_optimized.f90:106 and ndsm_poisson.f90:501)."""
    if len(bcs) == 3 and bcs[-1][0] == "D":
        return 1
    return 0


def is_all_neumann(bcs: BCS) -> bool:
    return all(tuple(b) == ("N", "N") for b in bcs)


def stencil_weights(dq, dtype: torch.dtype, shift: float = 0.0
                    ) -> Tuple[Tuple[float, ...], float]:
    """Per-axis weights ``w_i = 1/dq_i^2`` and inverse diagonal
    ``w0 = 1/(2 sum_i w_i + shift)``, rounded like the JAX module: w
    computed in float64 and cast to ``dtype``, w0 formed in ``dtype`` from
    the cast weights (reference ndsm_optimized.f90:87-94).  ``shift`` is
    the Helmholtz operator's c (mg/operator.py; 0 adds nothing, bit for
    bit).  Returned as Python floats, each exactly representable in
    ``dtype``."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    dq = np.asarray(dq, dtype=np.float64)
    w = (1.0 / (dq * dq)).astype(npdt)
    s = npdt(0.0)
    for v in w:  # sequential sum, the order XLA and numpy use for <= 3 terms
        s = npdt(s + v)
    w0 = npdt(npdt(1.0) / (npdt(2.0) * s + npdt(shift)))
    return tuple(float(v) for v in w), float(w0)


_MASKS: BoundedCache = BoundedCache(maxsize=64)


def _axis_index(shape, ax: int, device) -> torch.Tensor:
    view = [1] * len(shape)
    view[ax] = shape[ax]
    return torch.arange(shape[ax], device=device).view(view)


def interior_mask(shape: Tuple[int, ...], bcs: BCS, device) -> torch.Tensor:
    """Bool mask of the spatial ``shape``: True where the point is not on a
    Dirichlet face (reference at_dirichlet_boundary, ndsm_poisson.f90:361)."""
    key = ("interior", tuple(shape), bcs, str(device))
    m = _MASKS.get(key)
    if m is None:
        m = torch.ones(tuple(shape), dtype=torch.bool, device=device)
        for ax, (blo, bhi) in enumerate(bcs):
            idx = _axis_index(shape, ax, device)
            if blo == "D":
                m = m & (idx > 0)
            if bhi == "D":
                m = m & (idx < shape[ax] - 1)
        _MASKS.put(key, m)
    return m


def color_masks(shape: Tuple[int, ...], bcs: BCS, device):
    """(red, black) update masks: color parity AND not on a Dirichlet face."""
    key = ("colors", tuple(shape), bcs, str(device))
    m = _MASKS.get(key)
    if m is None:
        s = _axis_index(shape, 0, device)
        for ax in range(1, len(shape)):
            s = s + _axis_index(shape, ax, device)
        parity = s % 2
        interior = interior_mask(shape, bcs, device)
        red = first_color_parity(bcs)
        m = ((parity == red) & interior, (parity == 1 - red) & interior)
        _MASKS.put(key, m)
    return m


def shard_masks(shape: Tuple[int, ...], offsets, extents, bcs: BCS, device):
    """(red, black, interior) masks of a block of ``shape`` cut from a
    level along its leading axes: ``offsets`` and ``extents`` (an int each
    for axis 0 alone, or one entry per partitioned leading axis, e.g.
    ``(z0, y0)`` and ``(nz_global, ny_global)``) say that index k of
    partitioned axis a is index ``offsets[a] + k`` of a level of
    ``extents[a]`` points along it (a shard's block, halo included, which
    may lie outside the level).  Colour parity and Dirichlet faces are
    taken in global indices along those axes, in local ones along the
    rest."""
    offsets = (int(offsets),) if np.ndim(offsets) == 0 else tuple(int(o) for o in offsets)
    extents = (int(extents),) if np.ndim(extents) == 0 else tuple(int(e) for e in extents)
    key = ("shard", tuple(shape), offsets, extents, bcs, str(device))
    m = _MASKS.get(key)
    if m is None:
        idx = [_axis_index(shape, ax, device) for ax in range(len(shape))]
        for ax, o in enumerate(offsets):
            idx[ax] = idx[ax] + o
        extent = extents + tuple(shape[len(extents):])
        parity = sum(idx[1:], idx[0]) % 2
        interior = torch.ones(tuple(shape), dtype=torch.bool, device=device)
        for ax, (blo, bhi) in enumerate(bcs):
            if blo == "D":
                interior = interior & (idx[ax] != 0)
            if bhi == "D":
                interior = interior & (idx[ax] != extent[ax] - 1)
        red = first_color_parity(bcs)
        m = ((parity == red) & interior, (parity == 1 - red) & interior, interior)
        _MASKS.put(key, m)
    return m


def _neighbors(u: torch.Tensor, axis: int):
    """(lower, upper) neighbor arrays along ``axis`` with Neumann index
    reflection at both ends (index -1 reads 1, index n reads n-2).
    Dirichlet faces read them too, but their points are masked out."""
    n = u.shape[axis]
    lo = torch.cat([u.narrow(axis, 1, 1), u.narrow(axis, 0, n - 1)], dim=axis)
    hi = torch.cat([u.narrow(axis, 1, n - 1), u.narrow(axis, n - 2, 1)], dim=axis)
    return lo, hi


def subtract_mean(u: torch.Tensor, ndim: int | None = None) -> torch.Tensor:
    """Pin the additive null space of all-Neumann problems (per lane when
    ``u`` has leading lane axes before its ``ndim`` spatial axes)."""
    if ndim is None or ndim == u.ndim:
        return u - torch.mean(u)
    dims = tuple(range(u.ndim - ndim, u.ndim))
    return u - torch.mean(u, dim=dims, keepdim=True)


def _half_sweep(u, rhs, w, w0, mask, nb: int):
    total = None
    for ax in range(len(w)):
        lo, hi = _neighbors(u, nb + ax)
        term = (lo + hi) * w[ax]
        total = term if total is None else total + term
    unew = (total - rhs) * w0
    return torch.where(mask, unew, u)


def masked_red_black(u: torch.Tensor, rhs: torch.Tensor, dq, first: torch.Tensor,
                     second: torch.Tensor) -> torch.Tensor:
    """The two half-updates of a sweep with caller-given update masks
    (broadcastable to ``u``; per-lane masks carry per-lane BCs).  The
    spatial axes are the last ``len(dq)``."""
    nb = u.ndim - len(dq)
    w, w0 = stencil_weights(dq, u.dtype)
    u = _half_sweep(u, rhs, w, w0, first, nb)
    return _half_sweep(u, rhs, w, w0, second, nb)


def red_black(u: torch.Tensor, rhs: torch.Tensor, dq, bcs: BCS) -> torch.Tensor:
    """The two half-updates of a sweep, red then black (reading the updated
    red values), without the all-Neumann mean subtraction."""
    nb = u.ndim - len(bcs)
    red, black = color_masks(tuple(u.shape[nb:]), bcs, u.device)
    return masked_red_black(u, rhs, dq, red, black)


def rb_sweep(u: torch.Tensor, rhs: torch.Tensor, dq, bcs: BCS) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: ``red_black``, then the mean
    subtraction when all faces are Neumann (reference ndsm_optimized.f90:40;
    ndsm_poisson.f90:451)."""
    u = red_black(u, rhs, dq, bcs)
    if is_all_neumann(bcs):
        u = subtract_mean(u, len(bcs))
    return u


def masked_residual(u: torch.Tensor, rhs: torch.Tensor, dq, interior: torch.Tensor
                    ) -> torch.Tensor:
    """``rhs - L[u]``, zero where ``interior`` (broadcastable to ``u``) is
    False.  Per axis the term is ``(lo - 2u + hi) * w``, summed in axis
    order; the spatial axes are the last ``len(dq)``."""
    nb = u.ndim - len(dq)
    w, _ = stencil_weights(dq, u.dtype)
    lap = None
    for ax in range(len(w)):
        lo, hi = _neighbors(u, nb + ax)
        term = (lo - 2.0 * u + hi) * w[ax]
        lap = term if lap is None else lap + term
    r = rhs - lap
    return r.masked_fill(~interior, 0.0)


def poisson_residual(u: torch.Tensor, rhs: torch.Tensor, dq, bcs: BCS) -> torch.Tensor:
    """Residual ``r = rhs - L[u]`` with reflected-neighbor Neumann handling,
    zero on Dirichlet faces (reference ndsm_optimized.f90:346-447)."""
    nb = u.ndim - len(bcs)
    return masked_residual(u, rhs, dq, interior_mask(tuple(u.shape[nb:]), bcs, u.device))
