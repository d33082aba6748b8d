"""Lane-masked multigrid solves over problems with different boundary
conditions (port of ``ndsm_tpu/mg/batched.py``): the three 3D component
solves of the vector-potential pipeline as one lane-batched solve
(reference solve(), ndsm_vector_potential.f90:598-691, runs Ax/Ay/Az one
after the other).

The BCs differ per lane (Neumann on the faces normal to the component,
Dirichlet elsewhere), so the state is a stack ``(B, *grid)`` and every
mask (checkerboard parity with the lane's first colour, Dirichlet
freezing, residual zeroing) is per lane:

  * float32 3D levels smooth through ops/fused.py's lane kernels (one
    launch per half-sweep for all lanes; on the CPU their plain versions),
    or, with ``Options(smoother="compact")`` on every such level whose last
    extent is >= 4, through the colour-split lane kernels of ops/compact.py
    (split once, the sweeps on the halves, merge once; the residual is the
    dense lane residual launch on the merged state), lane freezing as for
    the dense lane kernels.  Merged, the compact sweeps equal the dense
    ones bit for bit.  Other levels (float64) smooth through the same
    masked sweeps in plain torch, with the per-level lane masks ``_masks``;
  * the grid transfers are BC-independent: each active lane's slice goes
    through ``apply_axis_matrices`` alone, the product the sequential
    route runs, written into its lane of the level's stack;
  * the coarse direct solve applies per-lane full-size (pseudo)inverse
    embeddings ``_coarse_S`` (rows outside a lane's interior give e = 0),
    one matrix-vector product per active lane.

The loops run on the host, as in ``PoissonBVP``: one device sync per
V-cycle reads every active lane's du.  A lane whose iteration has stopped
is frozen: the kernels skip it (it costs no sweep work), the transfers
skip it, and its iterate is never touched again.  So a lane's result does
not depend on the other lanes (a one-lane solve equals its lane of a
three-lane one).  Against the sequential route it is bitwise equal in
fp64; in mixed precision it agrees to within 5e-9 and one cycle, since
the full-size coarse embedding sums in another order than the sequential
coarse solve.  In mixed 3D mode (``mixed_defect`` "auto" or
"df32") the outer defect runs per lane in ops/df.py's float64 kernel with
the pending correction applied in its update form; the iterate is one
float64 tensor per lane (JAX carried an f32 pair).  ``ex_tol_eff`` uses
the largest max|r| over all lanes, as in JAX: a lane that froze keeps the
max|r| of its last defect, taken once with its final correction applied.

Not ported, because it exists only for the TPU (ROADMAP.md "Not ported"):
the padded work storage (``_plan_padding``, ``_pad0/_unpad0``,
``_work_shapes``, ``_interp_w/_restrict_w``; the port's kernels take every
shape), the pass-width composition ``_pallas_nsweeps``, which is a TPU
calibration (the port splits a smoothing call into passes inside the
kernel wrapper, by ``ops/zc.pass_plan``, a rule set for the H100; and the
per-lane serial calls of ``_compact_fns``: the port's compact kernel takes
the lanes in one launch), and the retry that
rebuilt the solver with ``use_pallas="off"`` after a kernel-compile
failure (a failed build or launch raises).  One addition: as in the
sequential engine, the direct coarse solve is used only up to
``engine._COARSE_DIRECT_MAX`` coarse points (relaxation above).
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..grids import GridHierarchy
from ..ops import compact, df, fused, stencils, stencils_compact
from ..ops.reduce import du_metrics
from ..ops.transfer import (
    apply_axis_matrices,
    full_f32_matmul,
    interp_matrix_1d,
    restrict_matrix_1d,
)
from ..options import IERR_COVFAIL, IERR_SUCCESS, Options, SolveInfo
from ..utils.device import resolve_device
from ..utils.msgs import debug_msg
from .coarse import build_coarse_solver_matrix
from .engine import _COARSE_DIRECT_MAX
from .poisson import _EPS32, PoissonBVP, _np_dtype

__all__ = ["MultiBCSolver"]


class MultiBCSolver:
    """Mixed/fp32/fp64 multigrid solver for B <= 8 same-shape problems with
    per-lane BCs and zero right-hand sides (the component solves).

    Parameters:
      hierarchy: level metadata shared by the lanes.
      bcs_list: one BC set per lane; no lane may be all-Neumann (its
        per-sweep global mean would interleave with lane freezing).
      options: solver options (precision, tolerances, ms, coarse solver).
      device: "cuda" (the default; raises without a CUDA device) or "cpu"
        (the kernels' plain PyTorch versions).
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs_list: Sequence[Sequence[Sequence[str]]],
        options: Options = Options(),
        device="cuda",
    ):
        self.h = hierarchy
        self.bcs_list = tuple(stencils.validate_bcs(b, hierarchy.ndim) for b in bcs_list)
        if any(stencils.is_all_neumann(b) for b in self.bcs_list):
            raise ValueError("all-Neumann lanes are not batchable")
        self.B = len(self.bcs_list)
        if not 1 <= self.B <= fused.MAX_LANES:
            raise ValueError(f"MultiBCSolver takes 1 to {fused.MAX_LANES} lanes, got {self.B}")
        self.options = options
        self.device = resolve_device(device)
        self.mode = options.resolve_precision(self.device)
        if self.mode not in ("fp64", "mixed", "fp32"):
            raise ValueError(f"unknown precision mode {self.mode!r}")
        self.outer_dtype = torch.float32 if self.mode == "fp32" else torch.float64
        self.inner_dtype = torch.float64 if self.mode == "fp64" else torch.float32
        cs = options.coarse_solver
        cshape = hierarchy.shapes[-1]
        self.coarse_direct = (
            cs == "direct" or (cs == "auto" and self.mode != "fp64")
        ) and int(np.prod(cshape)) <= _COARSE_DIRECT_MAX
        self._inner_max = max(1, int(options.mixed_inner_max)) if self.mode != "fp64" else 1
        #: True when the outer defect runs per lane in ops/df.py.
        self.df_defect = (
            self.mode == "mixed" and hierarchy.ndim == 3 and options.mixed_defect != "f64"
        )

        dev, dt = self.device, self.inner_dtype
        self._dq = [tuple(float(v) for v in d) for d in hierarchy.dq]
        # Per-level-pair transfer matrices (shared across lanes).
        self._interp: List[List[torch.Tensor]] = []
        self._restrict: List[List[torch.Tensor]] = []
        for l in range(hierarchy.ngrids - 1):
            fine, coarse = hierarchy.meshes[l], hierarchy.meshes[l + 1]
            self._interp.append([torch.as_tensor(interp_matrix_1d(f, c), dtype=dt, device=dev)
                                 for f, c in zip(fine, coarse)])
            self._restrict.append([torch.as_tensor(restrict_matrix_1d(c, f), dtype=dt, device=dev)
                                   for f, c in zip(fine, coarse)])
        # Levels that smooth on colour-split state (module docstring).
        self._compact = [
            options.smoother == "compact" and hierarchy.ndim == 3
            and stencils_compact.compact_supported(s) for s in hierarchy.shapes
        ]
        # Per-level per-lane (first colour, second colour, interior) masks.
        self._masks = [fused.lane_masks(s, self.bcs_list, dev) for s in hierarchy.shapes]
        # Per-lane full-size coarse solvers (identity-free embedding: rows
        # outside the lane's interior produce e = 0).
        if self.coarse_direct:
            N = int(np.prod(cshape))
            S_stack = np.zeros((self.B, N, N))
            for b, bcs in enumerate(self.bcs_list):
                S, int_mask = build_coarse_solver_matrix(cshape, hierarchy.dq[-1], bcs)
                rows = np.flatnonzero(int_mask)
                S_stack[b][np.ix_(rows, rows)] = S
            self._coarse_S = torch.as_tensor(S_stack, dtype=dt, device=dev)

    # -- level ops (``act``: per-lane active flags) -------------------------

    def _kernels(self, u) -> bool:
        return u.dtype == torch.float32 and self.h.ndim == 3

    def _sel(self, act) -> torch.Tensor:
        return torch.tensor(act, device=self.device).view((self.B,) + (1,) * self.h.ndim)

    def _smooth(self, u, rhs, level, n, act):
        if n == 0:
            return u
        dq = self._dq[level]
        if self._kernels(u):
            if self._compact[level]:
                return compact.smooth_dense(u, rhs, dq, self.bcs_list, n, None, act)
            return fused.fused_smooth_3d_batched(u, rhs, dq, self.bcs_list, n, act)
        return fused.lane_sweeps(u, rhs, dq, self._masks[level], n, act)

    def _smooth_residual(self, u, rhs, level, act):
        """ms pre-smooth sweeps + residual per lane: (u, r)."""
        ms, dq = self.options.ms, self._dq[level]
        if ms >= 1 and self._kernels(u):
            if self._compact[level]:
                return compact.smooth_residual_dense(u, rhs, dq, self.bcs_list, ms, act)
            return fused.fused_smooth_residual_3d_batched(u, rhs, dq, self.bcs_list, ms, act)
        u = self._smooth(u, rhs, level, ms, act)
        return u, fused.lane_residual(u, rhs, dq, self._masks[level], act)

    def _smooth_cor(self, u, cor, rhs, level, act):
        """ms post-smooth sweeps per lane on (u + cor)."""
        ms, dq = self.options.ms, self._dq[level]
        if ms >= 1 and self._kernels(u):
            if self._compact[level]:
                return compact.smooth_dense(u, rhs, dq, self.bcs_list, ms, cor, act)
            return fused.fused_smooth_cor_3d_batched(u, cor, rhs, dq, self.bcs_list, ms, act)
        v = u + cor if all(act) else torch.where(self._sel(act), u + cor, u)
        return self._smooth(v, rhs, level, ms, act)

    def _transfer(self, x, mats, shape, act):
        """``apply_axis_matrices`` on each active lane alone; frozen lanes 0."""
        out = torch.zeros((self.B,) + tuple(shape), dtype=x.dtype, device=x.device)
        for b in range(self.B):
            if act[b]:
                apply_axis_matrices(x[b], mats, out=out[b])
        return out

    def _coarse_solve(self, rhs, act):
        """e = S_b r_b on each active lane (one full-precision matrix-vector
        product per lane, so a lane's result never depends on the others);
        frozen lanes 0."""
        full_f32_matmul()
        e = torch.zeros_like(rhs)
        for b in range(self.B):
            if act[b]:
                torch.mv(self._coarse_S[b], rhs[b].reshape(-1), out=e[b].view(-1))
        return e

    def _metric(self, a, b, act) -> List[float]:
        """Per-lane du (the engine's ``t_metric`` on each active lane), read
        on the host in one sync; 0.0 for frozen lanes."""
        vals = [du_metrics(a[k], b[k])[0 if self.options.du_max else 1]
                for k in range(self.B) if act[k]]
        got = iter(torch.stack(vals).tolist())
        return [next(got) if act[k] else 0.0 for k in range(self.B)]

    def _coarse_relax(self, u, rhs, level, ex_tol, nmax_exact, act):
        """Per-lane relax-to-ex_tol with lane freezing (the engine's
        ``t_solve_exact`` per lane; the saved state starts zeroed)."""
        tol = float(_np_dtype(u.dtype)(ex_tol))
        du = [float(np.finfo(_np_dtype(u.dtype)).max)] * self.B
        it = [0] * self.B
        u_sav = torch.zeros_like(u)
        while True:
            a = [act[b] and du[b] > tol and it[b] < int(nmax_exact) for b in range(self.B)]
            if not any(a):
                break
            u = self._smooth(u, rhs, level, 1, a)
            d = self._metric(u, u_sav, a)
            for b in range(self.B):
                if a[b]:
                    du[b], it[b] = d[b], it[b] + 1
            u_sav = u
        return u, [act[b] and du[b] > tol for b in range(self.B)]

    def _vcycle(self, u, rhs, ex_tol, nmax_exact, act):
        """One V-cycle of the active lanes (frozen lanes come back
        unchanged).  Returns (u, per-lane coarse noconv)."""
        L, shapes = self.h.ngrids, self.h.shapes
        us = [None] * L
        rhss = [None] * L
        us[0], rhss[0] = u, rhs
        for l in range(L - 1):
            ul, r = self._smooth_residual(us[l], rhss[l], l, act)
            rhss[l + 1] = self._transfer(r, self._restrict[l], shapes[l + 1], act)
            us[l] = ul
            us[l + 1] = torch.zeros((self.B,) + tuple(shapes[l + 1]), dtype=u.dtype,
                                    device=u.device)
        if self.coarse_direct and L > 1:
            us[L - 1] = self._coarse_solve(rhss[L - 1], act)
            noconv = [False] * self.B
        else:
            us[L - 1], noconv = self._coarse_relax(us[L - 1], rhss[L - 1], L - 1, ex_tol,
                                                   nmax_exact, act)
        for l in range(L - 2, -1, -1):
            uc = self._smooth(us[l + 1], rhss[l + 1], l + 1, self.options.ms, act)
            cor = self._transfer(uc, self._interp[l], shapes[l], act)
            us[l] = self._smooth_cor(us[l], cor, rhss[l], l, act)
        return us[0], noconv

    def _vcycle_du(self, u, rhs, ex_tol, nmax_exact, act):
        """_vcycle plus the per-lane metric against the pre-cycle iterate."""
        u_new, noconv = self._vcycle(u, rhs, ex_tol, nmax_exact, act)
        return u_new, noconv, self._metric(u_new, u, act)

    # -- defect groups and solve loops ---------------------------------

    def _debug(self, du, active) -> None:
        if self.options.debug:
            for b in range(self.B):
                if active[b]:
                    debug_msg("solve_poisson_bvp", f" Solution delta: {du[b]}")

    def _inner_cycles(self, e, r32, ex_tol_eff, nmax_exact, vc_tol, it, nmax, active,
                      du_of):
        """Up to ``inner_max`` float32 V-cycles per active lane on the
        defect ``r32`` (JAX ``_mixed_group``'s inner loop with explicit lane
        masks: a lane stops once its group's first cycle is done and
        ``du_of(lane, du_e) < vc_tol``, or at nmax / inner_max).  Returns
        (e, du_e, k, noconv) per lane."""
        big32 = float(np.finfo(np.float32).max)
        du_e, k, nc = [big32] * self.B, [0] * self.B, [False] * self.B
        while True:
            a = [active[b] and (k[b] == 0 or (du_of(b, du_e[b]) >= vc_tol
                                              and it[b] + k[b] < nmax
                                              and k[b] < self._inner_max))
                 for b in range(self.B)]
            if not any(a):
                return e, du_e, k, nc
            e, noconv, d = self._vcycle_du(e, r32, ex_tol_eff, nmax_exact, a)
            for b in range(self.B):
                if a[b]:
                    du_e[b], k[b], nc[b] = d[b], k[b] + 1, nc[b] or noconv[b]

    def _mixed_group(self, u, ex_tol, nmax_exact, vc_tol, it, nmax, active):
        """One outer-dtype defect per lane, scaled to unit max, supporting
        up to ``inner_max`` float32 V-cycles (JAX ``_mixed_group``).  Frozen
        lanes are returned unchanged.  Returns (u, noconv, du, ncycles)."""
        B, npdt = self.B, _np_dtype(self.outer_dtype)
        r0 = fused.lane_residual(u, torch.zeros_like(u), self._dq[0], self._masks[0])
        s = torch.amax(torch.abs(r0).reshape(B, -1), dim=1)
        pos = s > 0
        s_safe = torch.where(pos, s, torch.ones_like(s))
        shape1 = (B,) + (1,) * self.h.ndim
        r32 = (r0 / s_safe.view(shape1)).to(self.inner_dtype)
        s_host = s_safe.tolist()
        pos_host = pos.tolist()

        def du_of(b, du_e):
            return float(npdt(s_host[b]) * npdt(du_e)) if pos_host[b] else 0.0

        e, du_e, k, nc = self._inner_cycles(
            torch.zeros_like(r32), r32, max(float(ex_tol), _EPS32), nmax_exact, vc_tol,
            it, nmax, active, du_of)
        e64 = e.to(self.outer_dtype) * s_safe.view(shape1)
        e64 = torch.where(pos.view(shape1), e64, torch.zeros_like(e64))
        u_new = torch.where(self._sel(active), u + e64, u)
        return u_new, nc, [du_of(b, du_e[b]) for b in range(B)], k

    def _solve_loop(self, u, vc_tol, ex_tol, nmax, nmax_exact):
        """Lane-masked outer loop (JAX ``_solve_impl``): mixed/fp32 V-cycles
        in defect groups, fp64 plain V-cycles; a lane stops once its du <
        vc_tol or its cycle count reaches nmax."""
        B = self.B
        du = [float(np.finfo(_np_dtype(self.outer_dtype)).max)] * B
        it, flag = [0] * B, [False] * B
        rhs = torch.zeros_like(u)
        while True:
            active = [it[b] < nmax and du[b] >= vc_tol for b in range(B)]
            if not any(active):
                break
            if self.mode != "fp64":
                u, nc, du_new, ncyc = self._mixed_group(u, ex_tol, nmax_exact, vc_tol, it,
                                                        nmax, active)
            else:
                u, nc, du_new = self._vcycle_du(u, rhs, ex_tol, nmax_exact, active)
                ncyc = [1] * B
            for b in range(B):
                if active[b]:
                    du[b], it[b], flag[b] = du_new[b], it[b] + ncyc[b], flag[b] or nc[b]
            self._debug(du, active)
        return u, du, it, flag

    def _solve_df(self, u0, vc_tol, ex_tol, nmax, nmax_exact):
        """Mixed 3D solve with the df semantics (JAX ``_solve_impl_df`` /
        ``_mixed_group_df``): the first group runs on every lane; each later
        group's defect pass applies the lane's pending correction; a lane's
        final correction is applied once, by the defect pass of the group
        after it froze (whose max|r| it keeps for ``s``) or after the loop."""
        B = self.B
        big = float(np.finfo(np.float64).max)
        if nmax < 1:  # reference DO-loop contract: no cycles, u0 back
            return u0, [big] * B, [0] * B, [False] * B
        us = list(u0.unbind(0))
        pend: List = [None] * B
        mx: List = [None] * B
        it, du, flag = [0] * B, [big] * B, [False] * B
        active = [True] * B
        r32 = torch.empty(u0.shape, dtype=torch.float32, device=u0.device)
        while True:
            for b in range(B):
                if active[b] or pend[b] is not None:
                    _, mx[b], us[b] = df.df_residual_3d(
                        us[b], None, pend[b], self._dq[0], self.bcs_list[b], r32_out=r32[b])
                    if not active[b]:
                        pend[b] = None
            s = float(torch.stack(mx).max())
            e, du_e, k, nc = self._inner_cycles(
                torch.zeros_like(r32), r32, max(float(ex_tol), _EPS32 * s), nmax_exact,
                vc_tol, it, nmax, active, lambda b, d: d)
            for b in range(B):
                if active[b]:
                    it[b], du[b], flag[b] = it[b] + k[b], du_e[b], flag[b] or nc[b]
                    pend[b] = e[b]
            self._debug(du, active)
            active = [it[b] < nmax and du[b] >= vc_tol for b in range(B)]
            if not any(active):
                break
        us = [u if p is None else u + p.to(torch.float64) for u, p in zip(us, pend)]
        return torch.stack(us), du, it, flag

    def solve(self, u0_stack, *, names=None) -> Tuple[torch.Tensor, List[SolveInfo]]:
        """Solve the B problems from stacked initial data ``(B, *grid)``,
        whose Dirichlet values are held fixed, with zero right-hand sides
        (the component-solve configuration).  ``u0_stack`` is never
        modified.  Returns (u_stack on the device, [SolveInfo] * B)."""
        o = self.options
        names = list(names or [""] * self.B)
        u0 = torch.as_tensor(u0_stack, dtype=self.outer_dtype, device=self.device).contiguous()
        if tuple(u0.shape) != (self.B,) + tuple(self.h.fine_shape):
            raise ValueError(f"u0 stack shape {tuple(u0.shape)} != "
                             f"{(self.B,) + tuple(self.h.fine_shape)}")
        vc_tol = float(_np_dtype(self.outer_dtype)(o.vc_tol))
        nmax, nmax_exact = int(o.ncycles_max), int(o.niterex_max)
        t0 = time.perf_counter()
        solve = self._solve_df if self.df_defect else self._solve_loop
        u, du, it, flag = solve(u0, vc_tol, float(o.ex_tol), nmax, nmax_exact)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        infos = [
            SolveInfo(
                ierr=IERR_SUCCESS if du[b] < vc_tol else IERR_COVFAIL,
                du_last=float(du[b]), cycles=int(it[b]), name=names[b], wall_time=wall,
                coarse_noconv=bool(flag[b]), batch_size=self.B,
            )
            for b in range(self.B)
        ]
        PoissonBVP._post_warnings(infos)
        return u, infos
