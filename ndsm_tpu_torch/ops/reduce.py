"""Reductions: convergence metrics and boundary-flux quadrature (port of
``ndsm_tpu/ops/reduce.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["du_metrics", "trapz_2d", "trapz_weights_1d", "SUM_THREADS",
           "strided_block_sum"]

#: Slots of the CUDA sums' fixed order: the threads of a 1024-thread
#: block (csrc/zc_smooth.cu, the global route of csrc/v2d_smooth.cu), or
#: slots t and t + 512 of a 512-thread block, chained through the blocks
#: of a cluster in rank order (v2d_smooth.cu's lane kernel); the plain
#: version below follows that order.
SUM_THREADS = 1024


def strided_block_sum(x: torch.Tensor, nblocks: int = 1) -> torch.Tensor:
    """Sums over the last axis of ``x`` in the fixed order of the CUDA
    reductions, one per block: thread ``g`` of ``G = nblocks * SUM_THREADS``
    adds flat indices g, g+G, g+2G, ... in turn (starting from 0.0), then
    each block folds its threads' sums in a tree with strides 512, 256,
    ..., 1.  Returns ``(..., nblocks)`` partial sums; every add is one
    rounded operation, so the kernels match this bit for bit."""
    n = x.shape[-1]
    g = nblocks * SUM_THREADS
    k = -(-n // g)
    cols = torch.nn.functional.pad(x, (0, k * g - n)).reshape(x.shape[:-1] + (k, g))
    acc = torch.zeros(x.shape[:-1] + (g,), dtype=x.dtype, device=x.device)
    for i in range(k):
        acc = acc + cols[..., i, :]
    acc = acc.reshape(x.shape[:-1] + (nblocks, SUM_THREADS))
    width = SUM_THREADS
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc[..., 0]


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
