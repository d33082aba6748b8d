"""Direct coarse-grid solver (port of ``ndsm_tpu/mg/coarse.py``: the
numpy builder verbatim, and the generic assembly from an injected
operator's residual; the engine applies the result with ``torch.matmul``).

The reference's ``solve_exact`` relaxes the coarsest grid until the
inter-iterate change is <= ex_tol — potentially thousands of sweeps on a
tiny array (ndsm_multigrid_core.f90:728-800).  On TPU each tiny sweep
inside a ``lax.while_loop`` costs dispatch-bound microseconds, making the
coarse solve a latency wall (SURVEY.md "hard parts").

Because the coarsest operator is a fixed small matrix, we can instead
precompute (at trace time, in numpy float64) the exact solve:

  * interior/Neumann points assemble the reflected 7-point operator;
  * Dirichlet-face points are excluded (their correction is identically
    zero in the reference, since relaxation skips them);
  * for the all-Neumann (singular) case the Moore-Penrose pseudo-inverse
    yields the minimal-norm = zero-mean solution — exactly the limit the
    reference's mean-subtracted relaxation converges to.

The coarse solve then becomes ONE matvec.  The result agrees with the
relax-to-ex_tol limit to ex_tol (or to the float32 floor in mixed
precision), so converged solutions are unchanged; only the per-cycle cost
drops.  Enabled via ``Options.coarse_solver`` ("auto" -> direct for
mixed/fp32, relax for fp64 to stay step-for-step with the reference).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.stencils import BCS

__all__ = ["build_coarse_solver_matrix", "build_coarse_matrix_from_operator"]


def _interior(shape: Tuple[int, ...], bcs: BCS) -> np.ndarray:
    """Bool array of ``shape``: False on Dirichlet faces, the points the
    relax freezes (ops/stencils.interior_mask on the host)."""
    interior = np.ones(shape, dtype=bool)
    for ax, (lo, hi) in enumerate(bcs):
        if lo == "D":
            interior[(slice(None),) * ax + (0,)] = False
        if hi == "D":
            interior[(slice(None),) * ax + (shape[ax] - 1,)] = False
    return interior


def build_coarse_solver_matrix(
    shape: Tuple[int, ...],
    dq: Sequence[float],
    bcs: BCS,
    diag_shift: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (solve_matrix, interior_mask_flat).

    ``solve_matrix`` is (m, m) over the m non-Dirichlet points such that
    ``e_int = solve_matrix @ rhs_int`` solves the coarse problem
    ``L e = rhs`` (with e = 0 on Dirichlet faces); for an all-Neumann
    problem it is the pseudo-inverse restricted to zero-mean solutions.

    ``diag_shift`` adds a constant to every interior diagonal entry —
    the assembly hook for shifted operators (mg/operator.py's
    ``HelmholtzOperator`` passes ``-c`` for ``L - c``).  A nonzero
    shift removes the all-Neumann nullspace, so the true inverse is
    used there instead of the zero-mean pseudo-inverse.
    """
    ndim = len(shape)
    w = [1.0 / float(d) ** 2 for d in dq]
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)

    interior = _interior(shape, bcs)
    int_flat = interior.ravel()
    m = int(int_flat.sum())
    # map full linear index -> interior row
    row_of = -np.ones(n, dtype=np.int64)
    row_of[int_flat] = np.arange(m)

    A = np.zeros((m, m), dtype=np.float64)
    it = np.ndindex(*shape)
    for pt in it:
        if not interior[pt]:
            continue
        r = row_of[idx[pt]]
        diag = float(diag_shift)
        for ax in range(ndim):
            diag -= 2.0 * w[ax]
            for delta in (-1, +1):
                q = list(pt)
                q[ax] += delta
                # Neumann index reflection (-1 -> 1, n -> n-2)
                if q[ax] < 0:
                    q[ax] = 1
                elif q[ax] > shape[ax] - 1:
                    q[ax] = shape[ax] - 2
                qt = tuple(q)
                if interior[qt]:
                    A[r, row_of[idx[qt]]] += w[ax]
                # else: Dirichlet neighbor, e = 0 contributes nothing
        A[r, r] += diag

    all_n = all(tuple(b) == ("N", "N") for b in bcs) and diag_shift == 0.0
    if all_n:
        S = np.linalg.pinv(A, rcond=1e-12)
    else:
        S = np.linalg.inv(A)
    return S, int_flat


def build_coarse_matrix_from_operator(
    operator, shape: Tuple[int, ...], dq: Sequence[float], bcs: BCS
) -> Tuple[np.ndarray, np.ndarray]:
    """Generic (solve_matrix, interior_mask_flat) assembly for ANY
    injected :class:`~ndsm_tpu_torch.mg.operator.MGOperator` — probe the
    operator's own ``residual`` with basis vectors.

    ``residual(e_j, 0) = -L e_j`` (zeroed on Dirichlet faces), so the
    columns of L come straight from the operator's definition — no
    per-operator stencil re-derivation, and assembly/solve consistency is
    guaranteed by construction.  The reference has no counterpart (its
    only coarse solve is relax-to-ex_tol, ndsm_multigrid_core.f90:
    728-800); this makes the engine's one-matvec coarse solve available
    to every custom operator, not just the built-ins with hand-assembled
    matrices.

    Singular operators (``operator.is_singular(bcs)``) get the
    pseudo-inverse, matching the zero-mean relax limit as in
    :func:`build_coarse_solver_matrix`.

    The probe runs in float64 on the CPU, ``torch.func.vmap`` over at most
    512 basis vectors at a time, so the probe's working set is ~512 *
    prod(shape) doubles.  Host memory is not bounded by that: L itself is
    an (n, n) float64 array for an n-point grid, and its interior block
    and (pseudo-)inverse are as large again, so the peak is O(n^2) doubles
    (~0.4 GB for the engine's largest direct coarse grid, 4,096 points; a
    fine-grid oracle of 17^3 points takes ~0.6 GB).
    """
    n = int(np.prod(shape))
    int_flat = _interior(shape, bcs).ravel()

    dq64 = tuple(float(v) for v in np.asarray(dq, dtype=np.float64))
    zero = torch.zeros(tuple(shape), dtype=torch.float64)

    def _col(e_flat):
        return -operator.residual(e_flat.reshape(tuple(shape)), zero, dq64, bcs).reshape(-1)

    probe = torch.func.vmap(_col)
    chunk = min(n, 512)
    # LT[j] = L e_j: the rows of L^T, written chunk by chunk.
    LT = np.empty((n, n), dtype=np.float64)
    for j0 in range(0, n, chunk):
        m = min(chunk, n - j0)
        E = torch.zeros((m, n), dtype=torch.float64)
        E[torch.arange(m), j0 + torch.arange(m)] = 1.0
        LT[j0:j0 + m] = probe(E).numpy()
    A = LT.T[int_flat][:, int_flat]
    del LT
    if operator.is_singular(bcs):
        S = np.linalg.pinv(A, rcond=1e-12)
    else:
        S = np.linalg.inv(A)
    return S, int_flat
