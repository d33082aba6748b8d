"""Poisson boundary-value-problem driver (port of ``ndsm_tpu/mg/poisson.py``):
the V-cycle iteration with the reference's inter-cycle metric, tolerances
and error flags (``solve_poisson_bvp``, fortran/ndsm_poisson.f90:63-155).

Precision modes, as in the JAX package:

  * ``fp64``: everything in float64, step for step the reference.
  * ``mixed`` (the default on a CUDA device): float32 V-cycles inside a
    float64 defect-correction loop, in groups of up to
    ``Options.mixed_inner_max`` V-cycles per defect.
      - 3D, not all-Neumann: the semantics of the JAX ``_mixed_group_df``
        / ``_solve_df_core`` (poisson.py:330-474).  The defect is
        unscaled, ``ex_tol_eff = max(ex_tol, 32 eps32 max|r|)``, and each
        group's correction is applied inside the next group's defect pass
        (ops/df.py, a CUDA kernel on the card).  The iterate is ONE
        float64 tensor: the JAX package carried an f32 pair because f64
        was emulated on its TPU.
      - otherwise (the 2D chi faces, a 3D all-Neumann box): ``_mixed_group``
        — float64 defect, scaled to unit max, float64 update; all-Neumann
        problems re-center the mean (poisson.py:250-328).
  * ``fp32``: everything in float32.

The loops run on the host: every V-cycle reads its du (one device sync).
``solve_batch`` lane-masks same-configuration problems: a lane whose
iteration has stopped is frozen, so each lane follows its standalone
iterate sequence.

An injected operator (mg/operator.py; ``operator=`` of ``PoissonBVP``,
``get_poisson_bvp`` and ``solve_poisson_bvp``) solves ``operator[u] =
rhs`` with the same loops, stopping rules and error contract: the engines
route every sweep and residual through it, the 3D defect kernel (which
computes the Poisson residual) is off, a singular operator pins the mean
as all-Neumann Poisson does, and ``solve_batch`` runs lane by lane, so
the operator never sees a lane axis (each lane follows its standalone
iterate sequence, the JAX lane-masked semantics).

``solve(history=True)`` records du per V-cycle; ``solve_checkpointed``
runs strict one-V-cycle defect groups in chunks, writing the iterate to
an ``.npz`` between them; ``vcycle``/``two_grid``/``one_grid`` are the
reference's reduced drivers.  There is no kernel-failure retry: a kernel
that fails to build or launch raises.

``shard_spec`` (a ``parallel.shard.ShardSpec``; JAX's GSPMD route, which
torch has no partitioner for) sends ``solve`` (``history`` included),
``solve_batch``, ``solve_checkpointed`` and the reduced drivers to the
sharded engine (``parallel/sm_engine.py``) on ``spec.mesh``: array axis 0
over ``spec.axis_name``, and axis 1 over the mesh axis of
``extra_axes=((1, name),)``, with ``spec.min_rows_per_shard``; the result
is gathered on every process.  With an ``operator`` the engine runs it on
each block in the block's window (mg/operator.py, "Windows"; an operator
without ``supports_window`` raises NotImplementedError) and no kernel,
where JAX's partitioner splits the injected functions.  A finest level
that cannot be partitioned runs on this process's first device of the
mesh (the root device in one process), as a ``DistConfig`` sub-problem
does.  Any other axis raises ValueError.  Nothing turns a spec into an
unsharded solve.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..grids import GridHierarchy
from ..ops import df, stencils
from ..options import IERR_COVFAIL, IERR_SUCCESS, Options, SolveInfo
from ..utils import profiling
from ..utils.caching import BoundedCache
from ..utils.device import resolve_device
from ..utils.msgs import debug_msg, warn
from ..utils.profiling import host_read
from .engine import MGEngine

__all__ = ["PoissonBVP", "get_poisson_bvp", "solve_poisson_bvp"]

_ENGINE_CACHE: BoundedCache = BoundedCache(maxsize=64)

_COARSE_NOCONV_WARNING = (
    "Warning: IOPT_NMAXEX exceeded. Coarse-mesh solution may not have converged"
)
_COVFAIL_WARNING = (
    "Warning: IOPT_NCYCLES exceeded. V-cycle iteration may not have converged"
)

_EPS32 = 32.0 * float(np.finfo(np.float32).eps)


def _cached_engine(hierarchy, bcs, ms, du_max, dtype, device, coarse_direct=False,
                   smoother="auto", operator=None):
    key = (hierarchy, bcs, ms, du_max, dtype, str(device), coarse_direct, smoother,
           operator)
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        with profiling.span(profiling.BUILD):
            eng = MGEngine(
                hierarchy, bcs, ms=ms, du_max=du_max, dtype=dtype, device=device,
                coarse_direct=coarse_direct, smoother=smoother, operator=operator,
            )
        _ENGINE_CACHE.put(key, eng)
    return eng


def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        host_read(torch.cuda.synchronize, device)


def write_checkpoint(path: str, u: np.ndarray, cycles: int, du: float, shape) -> None:
    """Write a solve's state atomically: an ``.npz`` holding ``u``,
    ``cycles``, ``du`` and ``shape``, written as ``<path>.tmp.npz`` and
    then renamed over ``path`` (``np.savez`` appends ".npz" to a name
    without it; the temporary name has the suffix, so the rename is
    exact)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, u=u, cycles=cycles, du=du, shape=np.asarray(shape))
    os.replace(tmp, path)


def read_checkpoint(path: str, shape) -> Optional[Tuple[np.ndarray, int, float]]:
    """(u, cycles, du) from a file of ``write_checkpoint`` whose shape is
    ``shape``, or None when there is no file or it holds another shape."""
    if not os.path.exists(path):
        return None
    with np.load(path) as ck:
        if tuple(ck["shape"]) != tuple(shape):
            return None
        return ck["u"], int(ck["cycles"]), float(ck["du"])

class PoissonBVP:
    """A reusable handle for one Poisson BVP configuration on one device.

    Parameters:
      hierarchy: level metadata (shapes, meshes, spacings).
      bcs: per-axis ("N"/"D", "N"/"D") homogeneous boundary conditions.
      options: solver options; ``options.precision`` picks the mode
        ("auto" resolves by ``device``).
      device: where the solve runs: "cuda" (the default) raises without a
        CUDA device; "cpu" runs the kernels' plain PyTorch versions.
      operator: an injected ``MGOperator`` (mg/operator.py), or None for
        the Poisson stencil with its kernels.
      shard_spec: a ``parallel.shard.ShardSpec`` routing the solves to the
        sharded engine on its mesh (module docstring), whose devices must
        be of ``device``'s type; None: one device.
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs: Sequence[Sequence[str]],
        options: Options = Options(),
        device="cuda",
        operator=None,
        *,
        shard_spec=None,
    ):
        self.h = hierarchy
        self.bcs = stencils.validate_bcs(bcs, hierarchy.ndim)
        self.options = options
        self.operator = operator
        self.shard_spec = shard_spec
        self.device = resolve_device(device)
        #: the sharded engine of a spec whose finest level partitions
        self._sharded = None
        if shard_spec is not None:
            self.device = self._route(shard_spec)
            if self._sharded is not None:
                sb = self._sharded
                self.mode, self.outer_dtype, self.inner_dtype = (sb.mode, sb.outer_dtype,
                                                                 sb.inner_dtype)
                self.df_defect = sb.df_defect
                return
        self.mode = options.resolve_precision(self.device)
        if self.mode not in ("fp64", "mixed", "fp32"):
            raise ValueError(f"unknown precision mode {self.mode!r}")
        self.outer_dtype = torch.float32 if self.mode == "fp32" else torch.float64
        self.inner_dtype = torch.float64 if self.mode == "fp64" else torch.float32
        cs = options.coarse_solver
        coarse_direct = cs == "direct" or (cs == "auto" and self.mode != "fp64")
        self._inner = _cached_engine(
            hierarchy, self.bcs, options.ms, options.du_max, self.inner_dtype,
            self.device, coarse_direct, options.smoother, operator,
        )
        self._outer = (
            self._inner
            if self.inner_dtype == self.outer_dtype
            else _cached_engine(
                hierarchy, self.bcs, options.ms, options.du_max, self.outer_dtype,
                self.device, smoother=options.smoother, operator=operator,
            )
        )
        self._all_neumann = (stencils.is_all_neumann(self.bcs) if operator is None
                             else operator.is_singular(self.bcs))
        self._inner_max = (
            max(1, int(options.mixed_inner_max)) if self.mode == "mixed" else 1
        )
        #: True when the 3D defect runs in ops/df.py (the df semantics); never
        #: under an operator, whose residual that kernel does not compute.
        self.df_defect = (
            self.mode == "mixed"
            and operator is None
            and hierarchy.ndim == 3
            and not self._all_neumann
            and options.mixed_defect != "f64"
        )

    def _route(self, spec) -> torch.device:
        """Build the sharded engine of ``spec`` (``self._sharded``) when
        the finest level partitions; returns this process's first device of
        the engine's mesh."""
        from ..parallel.sm_engine import ShardedPoissonBVP, _OperatorBVP, seam_of

        names = (spec.axis_name,) + tuple(nm for _, nm in spec.extra_axes)
        if spec.axis != 0 or [ax for ax, _ in spec.extra_axes] not in ([], [1]):
            raise ValueError(
                f"ShardSpec partitions array axes {[a for a, _ in spec.partitioned_axes()]}: "
                "the sharded engine cuts axis 0, or axes 0 and 1 (axis=0, extra_axes=((1, "
                "name),))")
        sub = spec.mesh.submesh(names)
        home = sub.devices[sub.local_positions()[0]]
        if torch.device(home).type != self.device.type:
            raise ValueError(f"shard_spec.mesh devices {sub.devices} do not match "
                             f"device={str(self.device)!r}")
        if seam_of(self.h, sub.shape, spec.min_rows_per_shard):
            kw = dict(mesh=spec.mesh, axis_names=names, min_rows_per_shard=spec.min_rows_per_shard)
            self._sharded = (ShardedPoissonBVP(self.h, self.bcs, self.options, **kw)
                             if self.operator is None else
                             _OperatorBVP(self.h, self.bcs, self.options, operator=self.operator,
                                          **kw))
            return self._sharded.device
        return resolve_device(home)

    # ------------------------------------------------------------------
    # Defect groups
    # ------------------------------------------------------------------

    def _mixed_group(self, u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max,
                     hist=None):
        """One float64 defect, scaled to unit max, supporting up to
        ``inner_max`` float32 V-cycles (JAX ``_mixed_group``).  Works per
        lane when ``u`` has a leading lane axis: ``it`` is then a tensor
        of per-lane cycle counts and a lane whose inner condition fails
        is frozen.  ``hist`` (one lane only) gets each inner V-cycle's du.
        Returns (u_new, noconv, du, ncycles), the last three per lane."""
        eng64, eng32 = self._outer, self._inner
        ndim = self.h.ndim
        sdims = tuple(range(u.ndim - ndim, u.ndim))

        def bc(x):  # per-lane value -> broadcastable over the level
            return x.reshape(tuple(x.shape) + (1,) * ndim)

        r0 = eng64.t_residual(u, rhs, 0)
        s = torch.amax(torch.abs(r0), dim=sdims)
        pos = s > 0
        s_safe = torch.where(pos, s, torch.ones_like(s))
        r32 = (r0 / bc(s_safe)).to(self.inner_dtype)
        ex_tol_eff = max(float(ex_tol), _EPS32)
        e = torch.zeros_like(r32)
        big32 = float(np.finfo(np.float32).max)
        du_e = torch.full(s.shape, big32, dtype=torch.float32, device=u.device)
        k = torch.zeros(s.shape, dtype=torch.long, device=u.device)
        nc = torch.zeros(s.shape, dtype=torch.bool, device=u.device)

        def du_of(du_e):
            d = s_safe * du_e.to(self.outer_dtype)
            return torch.where(pos, d, torch.zeros_like(d))

        while True:
            cond = (k == 0) | (
                (du_of(du_e) >= vc_tol) & (it + k < nmax) & (k < inner_max)
            )
            if not host_read(bool, cond.any()):
                break
            e_new, noconv, du_new = eng32.t_vcycle_du(e, r32, ex_tol_eff, nmax_exact, e)
            if hist is not None:
                hist.append(du_of(du_new))
            e = torch.where(bc(cond), e_new, e)
            du_e = torch.where(cond, du_new.to(torch.float32), du_e)
            k = k + cond.to(torch.long)
            nc = nc | (cond & noconv)
        e64 = e.to(self.outer_dtype) * bc(s_safe)
        e64 = torch.where(bc(pos), e64, torch.zeros_like(e64))
        u_new = u + e64
        if self._all_neumann:
            u_new = stencils.subtract_mean(u_new, ndim)
        return u_new, nc, du_of(du_e), k

    # ------------------------------------------------------------------
    # Solve loops
    # ------------------------------------------------------------------

    def _debug(self, du) -> None:
        if self.options.debug:
            debug_msg("solve_poisson_bvp", f" Solution delta: {du}")

    def _solve_df(self, u, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max, hist=None):
        """3D mixed solve with the df semantics (JAX ``_solve_df_core``):
        the first group runs unconditionally, each later group's defect
        pass applies the previous group's correction, the final correction
        is applied after the loop.  ``rhs=None`` is the zero-rhs form;
        ``hist`` gets each V-cycle's du."""
        big = float(np.finfo(np.float64).max)
        if nmax < 1:  # reference DO-loop contract: no cycles, u0 back
            return u, big, 0, IERR_COVFAIL, False
        dq0, eng32 = self._inner._dq[0], self._inner
        e = None
        it, flag = 0, False
        while True:
            r32, mx, u = df.df_residual_3d(u, rhs, e, dq0, self.bcs)
            ex_tol_eff = max(float(ex_tol), _EPS32 * host_read(float, mx))
            e = torch.zeros_like(r32)
            du_e, k = big, 0
            while k == 0 or (du_e >= vc_tol and it + k < nmax and k < inner_max):
                e, noconv, du_t = eng32.t_vcycle_du(e, r32, ex_tol_eff, nmax_exact, e)
                du_e = host_read(float, du_t)
                if hist is not None:
                    hist.append(du_e)
                flag = flag or noconv
                k += 1
            it += k
            self._debug(du_e)
            if not (it < nmax and du_e >= vc_tol):
                break
        u = u + e.to(torch.float64)
        ierr = IERR_SUCCESS if du_e < vc_tol else IERR_COVFAIL
        return u, du_e, it, ierr, flag

    def _solve_loop(self, u, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max, hist=None):
        """Outer V-cycle loop (reference VCYCLE_LOOP, ndsm_poisson.f90:
        116-141): cycle until du < vc_tol or nmax cycles (IERR_COVFAIL).
        ``hist`` gets each V-cycle's du."""
        mixed = self.mode == "mixed"
        du = float(np.finfo(_np_dtype(self.outer_dtype)).max)
        it, flag = 0, False
        while it < nmax and du >= vc_tol:
            if mixed:
                u, nc, du_t, k = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max, hist
                )
                ncyc, noconv = host_read(int, k), host_read(bool, nc)
            else:
                u, noconv, du_t = self._inner.t_vcycle_du(u, rhs, ex_tol, nmax_exact, u)
                ncyc = 1
                if hist is not None:
                    hist.append(du_t)
            du = host_read(float, du_t)
            it += ncyc
            flag = flag or noconv
            self._debug(du)
        ierr = IERR_SUCCESS if du < vc_tol else IERR_COVFAIL
        return u, du, it, ierr, flag

    def _batch_loop(self, u, rhs, vc_tol, ex_tol, nmax, nmax_exact):
        """Lane-masked form of ``_solve_loop`` (JAX ``_solve_batch_impl``):
        u and rhs carry a leading lane axis; a lane stops (is frozen) once
        its own du < vc_tol or its cycle count reaches nmax."""
        B = u.shape[0]
        ndim = self.h.ndim
        big = float(np.finfo(_np_dtype(self.outer_dtype)).max)
        du = torch.full((B,), big, dtype=self.outer_dtype, device=u.device)
        it = torch.zeros((B,), dtype=torch.long, device=u.device)
        flag = torch.zeros((B,), dtype=torch.bool, device=u.device)
        while True:
            active = (it < nmax) & (du >= vc_tol)
            if not host_read(bool, active.any()):
                break
            if self.mode == "mixed":
                u_new, noconv, du_new, ncyc = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, self._inner_max
                )
            else:
                u_new, nc, du_new = self._inner.t_vcycle_du(u, rhs, ex_tol, nmax_exact, u)
                noconv = torch.full((B,), bool(nc), device=u.device)
                ncyc = torch.ones((B,), dtype=torch.long, device=u.device)
            sel = active.reshape((B,) + (1,) * ndim)
            u = torch.where(sel, u_new, u)
            du = torch.where(active, du_new.to(self.outer_dtype), du)
            it = it + torch.where(active, ncyc, torch.zeros_like(ncyc))
            flag = flag | (noconv & active)
        ierr = torch.where(du < vc_tol, IERR_SUCCESS, IERR_COVFAIL)
        return u, *(host_read(x.tolist) for x in (du, it, ierr, flag))

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------

    def _uploading(self, *xs):
        """The ``ndsm.upload`` span where an input is not a tensor on the
        device (it is copied there), else nothing."""
        if all(isinstance(x, torch.Tensor) and x.device.type == self.device.type for x in xs):
            return contextlib.nullcontext()
        return profiling.span(profiling.UPLOAD)

    def _as_field(self, x, what: str) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=self.outer_dtype, device=self.device)
        if tuple(t.shape) != tuple(self.h.fine_shape):
            raise ValueError(f"{what} shape {tuple(t.shape)} != fine grid {self.h.fine_shape}")
        return t.contiguous()

    def _limits(self, vc_tol, ex_tol, ncycles_max, niterex_max):
        o = self.options
        vc_tol = o.vc_tol if vc_tol is None else vc_tol
        ex_tol = o.ex_tol if ex_tol is None else ex_tol
        nmax = int(o.ncycles_max if ncycles_max is None else ncycles_max)
        nmax_exact = int(o.niterex_max if niterex_max is None else niterex_max)
        # vc_tol is compared in the outer dtype, as in the JAX loop.
        vc_tol = float(_np_dtype(self.outer_dtype)(vc_tol))
        return vc_tol, float(ex_tol), nmax, nmax_exact

    def solve(
        self,
        u0,
        rhs,
        *,
        vc_tol: Optional[float] = None,
        ex_tol: Optional[float] = None,
        ncycles_max: Optional[int] = None,
        niterex_max: Optional[int] = None,
        name: str = "",
        zero_rhs: bool = False,
        history: bool = False,
    ) -> Tuple[torch.Tensor, SolveInfo]:
        """Solve ``laplace(u) = rhs`` (``operator[u] = rhs`` under an
        operator) from ``u0``, whose values on Dirichlet faces are held
        fixed.  ``zero_rhs=True`` ignores ``rhs``.  ``history=True`` also
        records du of every V-cycle in ``SolveInfo.du_history`` (the
        reference's debug-mode "Solution delta" lines, ndsm_poisson.f90:
        129-135; mixed defect groups give one entry per inner V-cycle)
        without changing the iterates.  ``u0`` is never modified.  Returns
        (u, SolveInfo) with u on the device (under a spec, gathered on
        every process)."""
        if self._sharded is not None:
            return self._sharded.solve(
                u0, rhs, name=name, zero_rhs=zero_rhs, history=history, vc_tol=vc_tol,
                ex_tol=ex_tol, ncycles_max=ncycles_max, niterex_max=niterex_max)
        vc_tol, ex_tol, nmax, nmax_exact = self._limits(
            vc_tol, ex_tol, ncycles_max, niterex_max
        )
        with self._uploading(u0, *(() if zero_rhs else (rhs,))):
            u = self._as_field(u0, "u0")
            r = None if zero_rhs else self._as_field(rhs, "rhs")
        hist = [] if history else None
        t0 = time.perf_counter()
        u, du, it, ierr, flag = self._run(
            u, r, vc_tol, ex_tol, nmax, nmax_exact, self._inner_max, hist
        )
        _sync(self.device)
        info = SolveInfo(
            ierr=int(ierr), du_last=float(du), cycles=int(it), name=name,
            wall_time=time.perf_counter() - t0, coarse_noconv=bool(flag),
            du_history=None if hist is None else tuple(
                v if isinstance(v, float) else host_read(float, v) for v in hist),
        )
        self._post_warnings([info])
        return u, info

    def _run(self, u, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max, hist):
        """The solve loop of this configuration (``rhs=None``: zero rhs).
        Returns (u, du, cycles, ierr, coarse_noconv)."""
        if self.df_defect:
            return self._solve_df(u, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max, hist)
        rhs = torch.zeros_like(u) if rhs is None else rhs
        with self._held():
            return self._solve_loop(u, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max, hist)

    def _held(self):
        """The operator's context for one solve (``MGOperator.held``)."""
        return contextlib.nullcontext() if self.operator is None else self.operator.held()

    def solve_batch(
        self,
        u0s,
        rhss,
        *,
        vc_tol: Optional[float] = None,
        ex_tol: Optional[float] = None,
        ncycles_max: Optional[int] = None,
        niterex_max: Optional[int] = None,
        names: Optional[Sequence[str]] = None,
    ):
        """Solve B same-configuration problems.  With a direct coarse
        solver on a 1D/2D problem the lanes run together, lane-masked;
        otherwise (relax coarse solver, as in the JAX package, a 3D
        problem, whose kernels take one lane, or an injected operator,
        whose functions take none) one ``solve`` per lane.  Returns (list
        of u, list of SolveInfo)."""
        if self._sharded is not None:
            return self._sharded.solve_batch(
                u0s, rhss, names=names, vc_tol=vc_tol, ex_tol=ex_tol,
                ncycles_max=ncycles_max, niterex_max=niterex_max)
        names = list(names or [""] * len(u0s))
        if not self._inner.coarse_direct or self.h.ndim == 3 or self.operator is not None:
            out = [
                self.solve(
                    u0, rhs, vc_tol=vc_tol, ex_tol=ex_tol, ncycles_max=ncycles_max,
                    niterex_max=niterex_max, name=nm,
                )
                for u0, rhs, nm in zip(u0s, rhss, names)
            ]
            return [u for u, _ in out], [i for _, i in out]
        vc_tol, ex_tol, nmax, nmax_exact = self._limits(
            vc_tol, ex_tol, ncycles_max, niterex_max
        )
        with self._uploading(*u0s, *rhss):
            u0 = torch.stack([self._as_field(u, "u0") for u in u0s])
            rhs = torch.stack([self._as_field(r, "rhs") for r in rhss])
        t0 = time.perf_counter()
        u, du, it, ierr, flag = self._batch_loop(u0, rhs, vc_tol, ex_tol, nmax, nmax_exact)
        _sync(self.device)
        wall = time.perf_counter() - t0
        infos = [
            SolveInfo(
                ierr=int(ierr[k]), du_last=float(du[k]), cycles=int(it[k]),
                name=names[k], wall_time=wall, coarse_noconv=bool(flag[k]),
                batch_size=len(u0s),
            )
            for k in range(len(u0s))
        ]
        self._post_warnings(infos)
        return list(u.unbind(0)), infos

    @staticmethod
    def _post_warnings(infos) -> None:
        """The reference's convergence warnings, printed from the host once
        per solve (ndsm_multigrid_core.f90:796-798; ndsm_poisson.f90:147-150)."""
        if any(i.coarse_noconv for i in infos):
            warn(_COARSE_NOCONV_WARNING)
        if any(i.ierr != IERR_SUCCESS for i in infos):
            warn(_COVFAIL_WARNING)

    def solve_checkpointed(
        self,
        u0,
        rhs,
        *,
        checkpoint_path: str,
        checkpoint_every: int = 32,
        vc_tol: Optional[float] = None,
        ex_tol: Optional[float] = None,
        ncycles_max: Optional[int] = None,
        niterex_max: Optional[int] = None,
        name: str = "",
    ) -> Tuple[torch.Tensor, SolveInfo]:
        """Resumable solve: V-cycles run in chunks of ``checkpoint_every``
        with the current iterate written atomically to ``checkpoint_path``
        (an ``.npz`` holding ``u``, ``cycles``, ``du`` and ``shape``,
        written as ``<path>.tmp.npz`` and then renamed over it) between
        chunks; a solve that finds a file of its fine shape there resumes
        from it.  The iterate sequence is independent of
        ``checkpoint_every``: mixed mode runs the strict
        one-V-cycle-per-defect iteration (``inner_max=1``) here, so a chunk
        boundary can never split a defect group; fp64/fp32 run ``solve``'s
        sequence (JAX ``solve_checkpointed``, ndsm_tpu/mg/poisson.py:907).
        Under a spec: ``ShardedPoissonBVP.solve_checkpointed`` (the root's
        process writes)."""
        if self._sharded is not None:
            return self._sharded.solve_checkpointed(
                u0, rhs, checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                name=name, vc_tol=vc_tol, ex_tol=ex_tol, ncycles_max=ncycles_max,
                niterex_max=niterex_max)
        if int(checkpoint_every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        vc_tol, ex_tol, nmax, nmax_exact = self._limits(
            vc_tol, ex_tol, ncycles_max, niterex_max
        )
        u = self._as_field(u0, "u0")
        r = self._as_field(rhs, "rhs")
        cycles, du = 0, float("inf")
        ck = read_checkpoint(checkpoint_path, self.h.fine_shape)
        if ck is not None:
            u = self._as_field(ck[0], "checkpoint u")
            cycles, du = ck[1], ck[2]
        t0 = time.perf_counter()
        flag = False
        with self._held():
            while cycles < nmax and not du < vc_tol:
                chunk = min(int(checkpoint_every), nmax - cycles)
                u, du, it, _, noconv = self._run(u, r, vc_tol, ex_tol, chunk, nmax_exact, 1,
                                                 None)
                du, cycles, flag = float(du), cycles + int(it), flag or bool(noconv)
                write_checkpoint(checkpoint_path, host_read(u.cpu).numpy(), cycles, du,
                                 self.h.fine_shape)
        info = SolveInfo(
            ierr=IERR_SUCCESS if du < vc_tol else IERR_COVFAIL, du_last=du, cycles=cycles,
            name=name, wall_time=time.perf_counter() - t0, coarse_noconv=flag,
        )
        self._post_warnings([info])
        return u, info

    # Reduced-cycle drivers, for operator-isolation tests (reference
    # one_grid/two_grid, ndsm_multigrid_core.f90:385-441).  Each takes and
    # returns tensors of the inner dtype on the BVP's device (under a spec,
    # on the sharded engine, gathered on every process).

    def _reduced(self, cycle, u, rhs, ex_tol, niterex_max):
        o = self.options
        ex_tol = float(o.ex_tol if ex_tol is None else ex_tol)
        niterex_max = int(o.niterex_max if niterex_max is None else niterex_max)
        if self._sharded is not None:
            return self._sharded._reduced(cycle, u, rhs, ex_tol, niterex_max)
        u, rhs = (torch.as_tensor(x, dtype=self.inner_dtype, device=self.device).contiguous()
                  for x in (u, rhs))
        with self._held():
            out, _ = getattr(self._inner, f"t_{cycle}")(u, rhs, ex_tol, niterex_max)
        return out

    def vcycle(self, u, rhs, *, ex_tol=None, niterex_max=None) -> torch.Tensor:
        """One V-cycle on ``u`` (reference v_cycle)."""
        return self._reduced("vcycle", u, rhs, ex_tol, niterex_max)

    def two_grid(self, u, rhs, *, ex_tol=None, niterex_max=None) -> torch.Tensor:
        """One two-grid cycle on levels 0 and 1 (reference two_grid)."""
        return self._reduced("two_grid", u, rhs, ex_tol, niterex_max)

    def one_grid(self, u, rhs, *, ex_tol=None, niterex_max=None) -> torch.Tensor:
        """Relax the fine grid to ``ex_tol`` (reference one_grid)."""
        return self._reduced("one_grid", u, rhs, ex_tol, niterex_max)


_BVP_CACHE: BoundedCache = BoundedCache(maxsize=32)


def get_poisson_bvp(
    hierarchy: GridHierarchy,
    bcs: Sequence[Sequence[str]],
    options: Options = Options(),
    device="cuda",
    operator=None,
    *,
    shard_spec=None,
) -> PoissonBVP:
    """Memoized PoissonBVP construction (tolerances and limits are passed
    per call, so they are not part of the key; the spec is)."""
    bcs_t = tuple(tuple(b) for b in bcs)
    opt_key = dataclasses.astuple(
        dataclasses.replace(options, vc_tol=0.0, ex_tol=0.0, ncycles_max=0, niterex_max=0)
    )
    key = (hierarchy, bcs_t, opt_key, str(torch.device(device)), operator, shard_spec)
    bvp = _BVP_CACHE.get(key)
    if bvp is None:
        with profiling.span(profiling.BUILD):
            bvp = PoissonBVP(hierarchy, bcs_t, options, device=device, operator=operator,
                             shard_spec=shard_spec)
        _BVP_CACHE.put(key, bvp)
    return bvp


def solve_poisson_bvp(
    u0,
    rhs,
    meshes: Sequence[np.ndarray],
    bcs: Sequence[Sequence[str]],
    *,
    ngrids: Optional[int] = None,
    options: Options = Options(),
    operator=None,
    device="cuda",
    shard_spec=None,
) -> Tuple[torch.Tensor, SolveInfo]:
    """Functional one-shot Poisson solve (the reference's entry of the same
    name, fortran/ndsm_poisson.f90:63-155).

    Solves ``laplace(u) = rhs`` on the uniform per-axis mesh given by
    ``meshes`` (one coordinate vector per array axis) with homogeneous
    "N"/"D" conditions per face; Dirichlet faces take their (possibly
    nonzero) values from ``u0``.  The multigrid hierarchy depth defaults to
    the reference rule ``floor(log2(min(shape)/2))``.

    ``operator`` injects a non-Poisson operator (an
    :class:`~ndsm_tpu_torch.mg.operator.MGOperator`): the same V-cycle
    machinery, stopping rules, precision modes, and error contract then
    solve ``operator[u] = rhs`` — the reference's MG_RELAX/MG_RESIDUAL
    extension point (ndsm_multigrid_core.f90:106-136).

    Runs on ``device``: "cuda" (the default) raises without a CUDA device;
    "cpu" runs the kernels' plain versions.  ``shard_spec`` (a
    ``parallel.shard.ShardSpec``) runs it on the sharded engine, as
    ``PoissonBVP(shard_spec=...)``.  Returns (u, SolveInfo) with u on the
    device (under a spec, gathered on every process).  One call of the
    registry (``utils.profiling.call``).
    """
    with profiling.call("solve_poisson_bvp"):
        hierarchy = GridHierarchy.from_mesh(meshes, ngrids=ngrids)
        bvp = get_poisson_bvp(hierarchy, bcs, options, device=device, operator=operator,
                              shard_spec=shard_spec)
        return bvp.solve(
            u0,
            rhs,
            vc_tol=options.vc_tol,
            ex_tol=options.ex_tol,
            ncycles_max=options.ncycles_max,
            niterex_max=options.niterex_max,
        )
