"""Colour-split red-black Gauss-Seidel sweep in plain PyTorch (port of
``ndsm_tpu/ops/stencils_compact.py``), for any number of dimensions,
float32 and float64.

The masked formulation (ops/stencils.py) updates half the points per pass
on the dense array.  Here the two colours are separate half-width arrays,
split along the last axis:

  R[..., k] = u[..., 2k + p]      p = (sum of the leading indices) % 2
  B[..., k] = u[..., 2k + 1 - p]

so R holds the points of 0-based total-index parity 0 and B the others,
and a half-update reads only the opposite colour and its own rhs half.
With this layout every neighbour read is a shift:

  * along a leading axis the neighbour of R[..., i, ..., k] is
    B[..., i +- 1, ..., k], the same k (the row parity flips, and B's
    x offset flips with it), with the index reflection of ops/stencils.py
    at the faces;
  * along the split axis the two neighbours are B[k-1], B[k] on rows whose
    own x is 2k and B[k], B[k+1] on rows whose own x is 2k+1, with edge
    clamp: the reflection -1 -> 1 / n -> n-2 lands on the clamped entry of
    the opposite colour.

An odd last extent gives both halves ``ceil(nx/2)`` entries; on the rows
where ``2k + parity >= nx`` the last entry is a ghost that mirrors the
row's previous entry (x = nx-2), which is what the top-edge clamp must
read.  Ghosts are masked out of the update and the all-Neumann mean.

The update order is ops/stencils.py's: ``(lo + hi) * w`` per leading axis
in array order, then the x pair ``* w``, then ``(total - rhs) * w0``.  So,
merged, a sweep equals ``stencils.rb_sweep`` bit for bit wherever the
problem is not all-Neumann (the mean's sum runs in another order there);
tests/test_torch_compact.py holds that.  These functions are the plain
versions of the kernels in ops/compact.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import stencils
from .stencils import BCS

__all__ = [
    "compact_supported",
    "row_parity",
    "split_colors",
    "split_colors_p",
    "merge_colors",
    "merge_colors_p",
    "rb_sweep_compact",
]


def compact_supported(shape, bcs: Optional[BCS] = None) -> bool:
    """Whether a level of ``shape`` can be colour-split (any ``bcs``)."""
    return len(shape) >= 2 and shape[-1] >= 4


def row_parity(shape_lead, device) -> torch.Tensor:
    """(*shape_lead, 1) tensor of (sum of the leading indices) % 2."""
    full = tuple(shape_lead) + (1,)
    s = torch.zeros(full, dtype=torch.int64, device=device)
    for ax, n in enumerate(shape_lead):
        view = [1] * len(full)
        view[ax] = n
        s = s + torch.arange(n, device=device).view(view)
    return s % 2


def _ghost_fix(v: torch.Tensor, own_par: torch.Tensor, nx: int) -> torch.Tensor:
    """For odd nx: an entry whose x = 2k + par >= nx is a ghost; set it to
    the row's last real value (x = nx-2), so the clamped neighbour reads
    realise the index reflection."""
    if nx % 2 == 0:
        return v
    gx_last = 2 * (v.shape[-1] - 1) + own_par
    fixed = torch.where(gx_last >= nx, v[..., -2:-1], v[..., -1:])
    return torch.cat([v[..., :-1], fixed], dim=-1)


def split_colors_p(u: torch.Tensor, rowpar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split with a given (*lead, 1) row-parity tensor: for a block of a
    larger array, whose parity comes from the global indices."""
    nx = u.shape[-1]
    even = u[..., 0::2]
    odd = u[..., 1::2]
    if nx % 2:
        odd = torch.nn.functional.pad(odd, (0, 1))
    R = torch.where(rowpar == 0, even, odd)
    B = torch.where(rowpar == 0, odd, even)
    return _ghost_fix(R, rowpar, nx), _ghost_fix(B, 1 - rowpar, nx)


def split_colors(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u -> (R, B), each (..., ceil(nx/2)); for odd nx each half's per-row
    ghost mirrors the row's last real value."""
    return split_colors_p(u, row_parity(u.shape[:-1], u.device))


def merge_colors_p(R: torch.Tensor, B: torch.Tensor, nx: int, rowpar: torch.Tensor
                   ) -> torch.Tensor:
    even = torch.where(rowpar == 0, R, B)
    odd = torch.where(rowpar == 0, B, R)
    u = torch.stack([even, odd], dim=-1).reshape(R.shape[:-1] + (2 * R.shape[-1],))
    return u[..., :nx].contiguous()


def merge_colors(R: torch.Tensor, B: torch.Tensor, nx: int) -> torch.Tensor:
    """(R, B) -> u with last extent nx."""
    return merge_colors_p(R, B, nx, row_parity(R.shape[:-1], R.device))


def _shift_clamp(v: torch.Tensor, delta: int) -> torch.Tensor:
    """Shift by +-1 along the last axis with edge clamp."""
    if delta == -1:  # v[k-1]; v[-1] -> v[0]
        return torch.cat([v[..., :1], v[..., :-1]], dim=-1)
    return torch.cat([v[..., 1:], v[..., -1:]], dim=-1)  # v[k+1]; v[n] -> v[n-1]


def _half_mask(shape_half, nx: int, bcs: BCS, own_par: torch.Tensor, device) -> torch.Tensor:
    """Update mask of a colour half whose x is 2k + own_par: off the
    Dirichlet faces and off the ghost column."""
    ndim = len(shape_half)
    view = [1] * ndim
    view[-1] = shape_half[-1]
    gx = 2 * torch.arange(shape_half[-1], device=device).view(view) + own_par
    mask = gx < nx
    for ax in range(ndim - 1):
        view = [1] * ndim
        view[ax] = shape_half[ax]
        idx = torch.arange(shape_half[ax], device=device).view(view)
        if bcs[ax][0] == "D":
            mask = mask & (idx > 0)
        if bcs[ax][1] == "D":
            mask = mask & (idx < shape_half[ax] - 1)
    if bcs[-1][0] == "D":
        mask = mask & (gx > 0)
    if bcs[-1][1] == "D":
        mask = mask & (gx < nx - 1)
    return mask


def _update_half(own, opp, rhs_own, w, w0, mask, own_par):
    """Gauss-Seidel update of one colour half, reading the other."""
    ndim = own.ndim
    total = None
    for ax in range(ndim - 1):
        lo, hi = stencils._neighbors(opp, ax)
        term = (lo + hi) * w[ax]
        total = term if total is None else total + term
    nbx = torch.where(own_par == 0, _shift_clamp(opp, -1) + opp, opp + _shift_clamp(opp, +1))
    total = total + nbx * w[ndim - 1]
    unew = (total - rhs_own) * w0
    return torch.where(mask, unew, own)


def rb_sweep_compact(R, B, rhs_R, rhs_B, dq, bcs: BCS, nx: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One red-black sweep on colour-split state; every axis is spatial.
    The first colour updated follows ``stencils.first_color_parity``."""
    w, w0 = stencils.stencil_weights(dq, R.dtype)
    rowpar = row_parity(R.shape[:-1], R.device)
    par = (rowpar, 1 - rowpar)  # own-x parity of R and of B
    halves, rhs = [R, B], (rhs_R, rhs_B)
    first = stencils.first_color_parity(bcs)
    for c in (first, 1 - first):
        mask = _half_mask(halves[c].shape, nx, bcs, par[c], R.device)
        v = _update_half(halves[c], halves[1 - c], rhs[c], w, w0, mask, par[c])
        halves[c] = _ghost_fix(v, par[c], nx)
    R, B = halves
    if stencils.is_all_neumann(bcs):
        n_total = float(np.prod(R.shape[:-1])) * nx

        def real_sum(v, p):
            if nx % 2 == 0:
                return torch.sum(v)
            kk = torch.arange(v.shape[-1], device=v.device)
            return torch.sum(torch.where(2 * kk + p < nx, v, torch.zeros_like(v)))

        mean = (real_sum(R, par[0]) + real_sum(B, par[1])) / torch.full(
            (), n_total, dtype=R.dtype, device=R.device)
        R = R - mean
        B = B - mean  # the ghosts shift too: they mirror shifted values
    return R, B
