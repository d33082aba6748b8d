"""Reductions: convergence metrics and boundary-flux quadrature (port of
``ndsm_tpu/ops/reduce.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["du_metrics", "trapz_2d", "trapz_weights_1d"]


def du_metrics(u_new: torch.Tensor, u_old: torch.Tensor, ndim: int | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, mean) absolute inter-iterate change (reference du_metrics,
    ndsm_multigrid_core.f90:808-853; quirk Q6).  With ``ndim`` smaller than
    ``u_new.ndim`` the leading axes are lanes and each metric has one
    entry per lane."""
    du = torch.abs(u_new - u_old)
    if ndim is None or ndim == du.ndim:
        return torch.max(du), torch.mean(du)
    flat = du.reshape(du.shape[: du.ndim - ndim] + (-1,))
    return torch.amax(flat, dim=-1), torch.mean(flat, dim=-1)


def trapz_weights_1d(n: int) -> np.ndarray:
    w = np.ones(n, dtype=np.float64)
    w[0] = 0.5
    w[-1] = 0.5
    return w


def trapz_2d(f: torch.Tensor, dq0: float, dq1: float) -> torch.Tensor:
    """2-D trapezoid-rule integral of ``f`` with spacings (dq0, dq1) along
    axes (0, 1) (reference trapz_2D, ndsm_vector_potential.f90:1070-1106)."""
    w0 = torch.as_tensor(trapz_weights_1d(f.shape[0]), dtype=f.dtype, device=f.device)
    w1 = torch.as_tensor(trapz_weights_1d(f.shape[1]), dtype=f.dtype, device=f.device)
    return torch.sum(f * (w0[:, None] * w1[None, :])) * (dq0 * dq1)
