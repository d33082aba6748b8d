"""The multigrid engine: V-cycle, coarse solves and metrics on torch
tensors (port of ``ndsm_tpu/mg/engine.py``).

Cycle structure and smoothing order are the reference's, as in the JAX
engine: ms pre-smooth sweeps plus the residual on each level going down,
the coarse solve, then on each level going up ms sweeps on the coarse
level, prolongation, and ms sweeps on (u + correction).

What the port changes:

  * the loops are driven from the host (PyTorch runs eagerly); the coarse
    relaxation checks its stopping metric after every sweep, as the
    reference does;
  * on every float32 level, every smoothing call goes through a kernel
    wrapper: on a CUDA tensor that is the hand-written kernel, on a CPU
    tensor its plain version.
      - 3D, not all-Neumann: ops/zc.py's zc_smooth_3d/_residual/_cor (the
        dense kernels); with ``smoother="compact"``, on every such level
        whose last extent is >= 4 (``stencils_compact.compact_supported``),
        ops/compact.py instead: split into colour halves once, the sweeps
        on the halves, merge once, then (residual form) the dense residual
        launch on the merged state; the correction is added by the split.
        A level the compact route does not take (nx < 4) goes to the dense
        kernels by that rule, never by a handler.  Merged, the compact
        sweeps equal the dense ones bit for bit, so the two routes give
        the same iterates;
      - 3D all-Neumann: ops/zc.py's zc_smooth_mean_3d, whatever
        ``smoother`` says (sweep, then subtract the global mean, as the
        JAX engine composes it from zc_smooth_mean_3d passes); its
        residual is the plain one, and the correction is added before it,
        as in JAX, whose residual and correction kernels exclude
        all-Neumann;
      - 2D, with or without a lane axis (the chi faces): ops/v2d.py.
    The JAX engine's TPU-calibrated size gates, pass widths and padded
    work storage (128-lane alignment) have no counterpart: the CUDA
    kernels take any shape.  One JAX gate stays: a 2D level with an
    extent < 3 smooths in plain torch, as JAX's runs on XLA there
    (ndsm_tpu/ops/pallas_v2d.py:v2d_kernel_supported);
  * a leading lane axis is allowed on 2D levels (the chi faces in
    ``solve_batch``): every op acts per lane;
  * with an injected operator (mg/operator.py, the reference's
    MG_RELAX/MG_RESIDUAL extension point, ndsm_multigrid_core.f90:
    106-136) no level has a kernel route: every sweep and residual is the
    operator's ``relax`` / ``residual``, plain tensor code, as the JAX
    engine runs an operator on its masked-XLA path (the kernels encode
    the Poisson stencil).  Its direct coarse solve uses
    ``operator.coarse_matrix``, or relaxes to ``ex_tol`` when that is
    None.

Besides the V-cycle, the reference's reduced drivers ``two_grid`` and
``one_grid`` (ndsm_multigrid_core.f90:385-441).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..grids import GridHierarchy
from ..ops import compact, stencils, stencils_compact, v2d, zc
from ..ops.reduce import du_metrics
from ..ops.transfer import (
    apply_axis_matrices,
    full_f32_matmul,
    interp_matrix_1d,
    restrict_matrix_1d,
)
from .coarse import build_coarse_solver_matrix

# Direct coarse solves are precomputed dense (pseudo)inverses; cap the
# coarsest-level size for which that is sensible.
_COARSE_DIRECT_MAX = 4096

__all__ = ["MGEngine"]


class MGEngine:
    """Cycle functions of one problem configuration (hierarchy, boundary
    conditions, metric, dtype, device, and ``smoother``: ``"compact"`` or
    anything else for the dense kernels; ``Options`` validates the names;
    ``operator``: an injected ``MGOperator``, or None for the Poisson
    stencil and its kernels).  ``t_*`` methods take and return tensors of
    the engine's dtype on its device."""

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs: Sequence[Sequence[str]],
        *,
        ms: int,
        du_max: bool,
        dtype: torch.dtype,
        device,
        coarse_direct: bool = False,
        smoother: str = "auto",
        operator=None,
    ):
        self.h = hierarchy
        self.bcs = stencils.validate_bcs(bcs, hierarchy.ndim)
        self.ms = int(ms)
        self.du_max = bool(du_max)
        self.dtype = dtype
        self.device = torch.device(device)
        self.ndim = hierarchy.ndim
        self.operator = operator
        # The kernel route of float32 levels (module docstring); none under
        # an operator, whose stencil the kernels do not compute.
        self.kernel_route = None
        if operator is None and dtype == torch.float32 and hierarchy.ndim == 3:
            self.kernel_route = "zc_mean" if stencils.is_all_neumann(self.bcs) else (
                "compact" if smoother == "compact" else "zc")
        elif operator is None and dtype == torch.float32 and hierarchy.ndim == 2:
            self.kernel_route = "v2d"
        self._relax = stencils.rb_sweep if operator is None else operator.relax
        self._residual = (stencils.poisson_residual if operator is None
                          else operator.residual)
        coarse_shape = hierarchy.shapes[-1]
        self.coarse_direct = bool(coarse_direct) and int(
            np.prod(coarse_shape)
        ) <= _COARSE_DIRECT_MAX
        if self.coarse_direct:
            # The operator's dense coarse assembly, or None: relax to ex_tol.
            cm = (build_coarse_solver_matrix(coarse_shape, hierarchy.dq[-1], self.bcs)
                  if operator is None
                  else operator.coarse_matrix(coarse_shape, hierarchy.dq[-1], self.bcs))
            self.coarse_direct = cm is not None
        if self.coarse_direct:
            S, int_mask = cm
            self._coarse_S = torch.as_tensor(S, dtype=dtype, device=self.device)
            self._coarse_rows = torch.as_tensor(
                np.flatnonzero(int_mask), dtype=torch.long, device=self.device
            )

        self._dq = [tuple(float(v) for v in d) for d in hierarchy.dq]

        # Per-level-pair separable transfer matrices (numpy float64 built
        # exactly as in the JAX engine, then cast to the engine dtype).
        self._interp_mats: List[List[torch.Tensor]] = []
        self._restrict_mats: List[List[torch.Tensor]] = []
        for l in range(hierarchy.ngrids - 1):
            fine = hierarchy.meshes[l]
            coarse = hierarchy.meshes[l + 1]
            self._interp_mats.append(
                [self._mat(interp_matrix_1d(f, c)) for f, c in zip(fine, coarse)]
            )
            self._restrict_mats.append(
                [self._mat(restrict_matrix_1d(c, f)) for f, c in zip(fine, coarse)]
            )

    def _mat(self, m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(m, dtype=self.dtype, device=self.device)

    def _lanes(self, x: torch.Tensor):
        return tuple(x.shape[: x.ndim - self.ndim])

    # ------------------------------------------------------------------
    # Level primitives
    # ------------------------------------------------------------------

    def _route(self, x, level: int):
        """The kernel route for ``x`` on ``level``, or None (plain torch)."""
        if self.kernel_route == "v2d":
            # JAX smooths a 2D level with an extent < 3 on XLA; so does the port.
            return "v2d" if min(self.h.shapes[level]) >= 3 else None
        if self.kernel_route is not None and x.ndim == 3:
            if self.kernel_route == "compact" and not stencils_compact.compact_supported(
                    self.h.shapes[level], self.bcs):
                return "zc"
            return self.kernel_route
        return None

    def t_sweep(self, u, rhs, level: int):
        return self.t_smooth(u, rhs, level, nsweeps=1)

    def t_smooth(self, u, rhs, level: int, nsweeps: int | None = None):
        n = self.ms if nsweeps is None else nsweeps
        if n == 0:
            return u
        dq, route = self._dq[level], self._route(u, level)
        if route == "zc":
            return zc.zc_smooth_3d(u, rhs, dq, self.bcs, n)
        if route == "compact":
            return compact.smooth_dense(u, rhs, dq, self.bcs, n)
        if route == "zc_mean":
            return zc.zc_smooth_mean_3d(u, rhs, dq, self.bcs, n)
        if route == "v2d":
            return v2d.v2d_smooth(u, rhs, dq, self.bcs, n)
        for _ in range(n):
            u = self._relax(u, rhs, dq, self.bcs)
        return u

    def t_smooth_residual(self, u, rhs, level: int):
        """ms pre-smooth sweeps + residual; returns (u_smoothed, residual)."""
        if self.ms >= 1:
            dq, route = self._dq[level], self._route(u, level)
            if route == "zc":
                return zc.zc_smooth_residual_3d(u, rhs, dq, self.bcs, self.ms)
            if route == "compact":
                return compact.smooth_residual_dense(u, rhs, dq, self.bcs, self.ms)
            if route == "v2d":
                return v2d.v2d_smooth_residual(u, rhs, dq, self.bcs, self.ms)
        u = self.t_smooth(u, rhs, level)
        return u, self.t_residual(u, rhs, level)

    def t_smooth_cor(self, u, cor, rhs, level: int):
        """ms post-smooth sweeps on (u + cor) — the ascent's
        correct-then-relax (reference ndsm_multigrid_core.f90:659-682)."""
        if self.ms >= 1:
            dq, route = self._dq[level], self._route(u, level)
            if route == "zc":
                return zc.zc_smooth_cor_3d(u, cor, rhs, dq, self.bcs, self.ms)
            if route == "compact":
                return compact.smooth_dense(u, rhs, dq, self.bcs, self.ms, cor)
            if route == "v2d":
                return v2d.v2d_smooth_cor(u, cor, rhs, dq, self.bcs, self.ms)
        return self.t_smooth(u + cor, rhs, level)

    def t_residual(self, u, rhs, level: int):
        return self._residual(u, rhs, self._dq[level], self.bcs)

    def t_restrict(self, r, level: int):
        """Restrict fine-level ``r`` at ``level`` to level+1."""
        return apply_axis_matrices(r, self._restrict_mats[level])

    def t_prolong(self, u_c, level: int):
        """Prolong coarse ``u_c`` at ``level+1`` to ``level``."""
        return apply_axis_matrices(u_c, self._interp_mats[level])

    def t_metric(self, u_new, u_old):
        """max or mean |u_new - u_old| (one value per lane)."""
        dmax, dmean = du_metrics(u_new, u_old, self.ndim)
        return dmax if self.du_max else dmean

    # ------------------------------------------------------------------
    # Coarse solves
    # ------------------------------------------------------------------

    def t_solve_exact(self, u, rhs, level: int, ex_tol, nmax_exact):
        """Relax until the inter-iterate change is <= ex_tol or nmax_exact
        sweeps (reference solve_exact, ndsm_multigrid_core.f90:728-800);
        the saved state starts zeroed (:757).  The metric is read on the
        host after every sweep.  Returns ``(u, noconv)``."""
        if self._lanes(u):
            raise ValueError("t_solve_exact takes one lane (solve_batch runs "
                             "relax-coarse configurations lane by lane)")
        npdt = np.float32 if self.dtype == torch.float32 else np.float64
        tol = float(npdt(ex_tol))
        du = float(np.finfo(npdt).max)
        u_sav = torch.zeros_like(u)
        it = 0
        while du > tol and it < int(nmax_exact):
            u = self.t_sweep(u, rhs, level)
            du = float(self.t_metric(u, u_sav))
            u_sav = u
            it += 1
        return u, du > tol

    def t_coarse_solve_direct(self, rhs):
        """One-matvec coarse solve via the precomputed (pseudo)inverse."""
        full_f32_matmul()
        lanes = self._lanes(rhs)
        flat = rhs.reshape(lanes + (-1,))
        rhs_int = flat.index_select(-1, self._coarse_rows)
        e_int = torch.matmul(rhs_int, self._coarse_S.T) if lanes else torch.mv(
            self._coarse_S, rhs_int
        )
        e = torch.zeros_like(flat)
        e.index_copy_(e.ndim - 1, self._coarse_rows, e_int)
        return e.reshape(rhs.shape)

    # ------------------------------------------------------------------
    # Cycles
    # ------------------------------------------------------------------

    def t_vcycle(self, u, rhs, ex_tol, nmax_exact):
        """One V-cycle on the finest level (reference v_cycle,
        ndsm_multigrid_core.f90:341-377).  Returns ``(u, coarse_noconv)``."""
        L = self.h.ngrids
        lanes = self._lanes(u)
        us = [None] * L
        rhss = [None] * L
        us[0], rhss[0] = u, rhs
        for l in range(L - 1):
            ul, r = self.t_smooth_residual(us[l], rhss[l], l)
            rhss[l + 1] = self.t_restrict(r, l)
            us[l] = ul
            us[l + 1] = torch.zeros(
                lanes + tuple(self.h.shapes[l + 1]), dtype=self.dtype, device=u.device
            )
        if self.coarse_direct and L > 1:
            us[L - 1] = self.t_coarse_solve_direct(rhss[L - 1])
            noconv = False
        else:
            us[L - 1], noconv = self.t_solve_exact(
                us[L - 1], rhss[L - 1], L - 1, ex_tol, nmax_exact
            )
        for l in range(L - 2, -1, -1):
            uc = self.t_smooth(us[l + 1], rhss[l + 1], l + 1)
            cor = self.t_prolong(uc, l)
            us[l] = self.t_smooth_cor(us[l], cor, rhss[l], l)
        return us[0], noconv

    def t_vcycle_du(self, u, rhs, ex_tol, nmax_exact, u_ref):
        """t_vcycle plus the inter-iterate metric against ``u_ref``.
        Returns ``(u_new, coarse_noconv, du)`` with du a tensor (one entry
        per lane)."""
        u_new, noconv = self.t_vcycle(u, rhs, ex_tol, nmax_exact)
        return u_new, noconv, self.t_metric(u_new, u_ref)

    def t_two_grid(self, u, rhs, ex_tol, nmax_exact):
        """Two-grid correction scheme for testing (reference two_grid,
        ndsm_multigrid_core.f90:385-410): ms pre-smooth and residual,
        restrict, relax level 1 to ex_tol from zero, ms coarse sweeps,
        prolong and add, ms post-smooth.  Returns ``(u, coarse_noconv)``."""
        ul, r = self.t_smooth_residual(u, rhs, 0)
        rhs_c = self.t_restrict(r, 0)
        u_c = torch.zeros(tuple(self.h.shapes[1]), dtype=self.dtype, device=u.device)
        u_c, noconv = self.t_solve_exact(u_c, rhs_c, 1, ex_tol, nmax_exact)
        u_c = self.t_smooth(u_c, rhs_c, 1)
        cor = self.t_prolong(u_c, 0)
        return self.t_smooth_cor(ul, cor, rhs, 0), noconv

    def t_one_grid(self, u, rhs, ex_tol, nmax_exact):
        """Single-grid relax-to-convergence (reference one_grid,
        ndsm_multigrid_core.f90:424-441).  Returns ``(u, noconv)``."""
        return self.t_solve_exact(u, rhs, 0, ex_tol, nmax_exact)
