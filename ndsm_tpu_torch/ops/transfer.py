"""Coordinate-based grid-transfer operators: N-linear prolongation and its
full-weighting adjoint restriction (port of ``ndsm_tpu/ops/transfer.py``).

The per-axis matrix builders are the JAX module's numpy code, verbatim:
both packages build bitwise-equal matrices.  They are applied one axis at
a time as plain matrix products (``torch.matmul``).  Float32 products run
in full float32: TF32 is switched off before every application, matching
the JAX module's ``Precision.HIGHEST`` (a lower transfer precision changed
a 256^3 solve's cycle count; ROADMAP.md Queue C).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "bracket_uniform",
    "interp_matrix_1d",
    "restrict_matrix_1d",
    "full_f32_matmul",
    "apply_axis_matrices",
]


def bracket_uniform(qvec: np.ndarray, q0: float) -> Tuple[int, int, int]:
    """0-based port of ``find_bracket_points_uniform``
    (ndsm_interp.f90:373-435).  Returns (lo, hi, ierr) with ierr = -1/+1
    when q0 lies below/above the mesh (clamped bracket), else 0."""
    nq = len(qvec)
    if nq == 1:
        raise ValueError("mesh vector has length 1")
    if q0 <= qvec[0]:
        return 0, 1, -1
    if q0 >= qvec[nq - 1]:
        return nq - 2, nq - 1, +1
    dq = qvec[1] - qvec[0]
    lo = int(math.floor((q0 - qvec[0]) / dq))
    if lo >= nq - 1:
        lo, hi = nq - 2, nq - 1
    else:
        hi = lo + 1
    return lo, hi, 0


def interp_matrix_1d(qf: np.ndarray, qc: np.ndarray) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix taking coarse-mesh values to
    fine-mesh coordinates (per-axis factor of ninterp, ndsm_interp.f90:85)."""
    qf = np.asarray(qf, dtype=np.float64)
    qc = np.asarray(qc, dtype=np.float64)
    P = np.zeros((qf.size, qc.size), dtype=np.float64)
    for i, q0 in enumerate(qf):
        lo, hi, _ = bracket_uniform(qc, q0)
        ql, qh = qc[lo], qc[hi]
        dq = qh - ql
        wl = (q0 - ql) / dq  # weight of the HIGH bracket point
        wh = -(q0 - qh) / dq  # weight of the LOW bracket point
        P[i, lo] += wh
        P[i, hi] += wl
    return P


def restrict_matrix_1d(qc: np.ndarray, qf: np.ndarray) -> np.ndarray:
    """(nc, nf) full-weighting restriction matrix, the per-axis factor of
    ``nrestrict`` (ndsm_interp.f90:186-292) including its bracket-edge
    selection rules."""
    qc = np.asarray(qc, dtype=np.float64)
    qf = np.asarray(qf, dtype=np.float64)
    dq_c = qc[1] - qc[0]
    dq_f = qf[1] - qf[0]
    w2 = dq_f / dq_c**2
    R = np.zeros((qc.size, qf.size), dtype=np.float64)
    for c, q0 in enumerate(qc):
        il, ih, ierr = bracket_uniform(qf, q0 - dq_c)
        lo = il if ierr < 0 else ih
        il, ih, ierr = bracket_uniform(qf, q0 + dq_c)
        hi = ih if ierr > 0 else il
        for f in range(lo, hi + 1):
            c1 = abs(qf[f] - q0)
            c2 = abs(dq_c - c1)
            R[c, f] = c2 * w2
    return R


def full_f32_matmul() -> None:
    """Make float32 matrix products on the card full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def apply_axis_matrices(x: torch.Tensor, mats: Sequence[torch.Tensor],
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply one matrix per spatial axis: ``y = (M_0 ⊗ M_1 ⊗ ...) x``.
    The spatial axes are the last ``len(mats)`` axes of ``x``; leading
    axes are lanes.  ``mats`` are tensors of ``x``'s dtype and device.
    With ``out`` (e.g. one lane of a stack) the result is written there."""
    full_f32_matmul()
    nb = x.ndim - len(mats)
    for ax, m in enumerate(mats):
        a = nb + ax
        xt = x.movedim(a, 0)
        y = torch.matmul(m, xt.reshape(xt.shape[0], -1))
        x = y.reshape((m.shape[0],) + tuple(xt.shape[1:])).movedim(0, a)
    if out is None:
        return x.contiguous()
    return out.copy_(x)
