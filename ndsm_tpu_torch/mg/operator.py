"""Injectable multigrid operators — the engine's extension point (port of
``ndsm_tpu/mg/operator.py``).

The reference multigrid core is operator-agnostic: callers inject
problem-specific relaxation/residual procedures through the abstract
interfaces ``MG_RELAX``/``MG_RESIDUAL``
(fortran/ndsm_multigrid_core.f90:106-136), and the Poisson layer plugs
in via dispatch wrappers (fortran/ndsm_poisson.f90:163-276).  An
:class:`MGOperator` bundles the per-level relax/residual functions (plus
two optional hooks the reference expresses differently — a dense
coarse-operator assembly for the direct coarse solve, and a nullspace
declaration), and ``MGEngine``/``PoissonBVP``/``solve_poisson_bvp``
accept one via their ``operator=`` argument.  Every driver capability
(V-cycle/two-grid/one-grid, relax or direct coarse solves, fp64/fp32 and
mixed defect-correction precision, history, checkpointing, lane-by-lane
``solve_batch``) then runs the injected operator: the mixed outer defect
routes through ``MGEngine.t_residual`` and therefore through the operator
as well.

Design notes for PyTorch:

  * The reference passes bare subroutines that mutate ``this%u(g_id)``
    in place; here an operator is a *hashable value object* whose
    methods are functions ``(u, rhs, dq, bcs) -> tensor`` that return a
    new tensor and leave their inputs alone.  Hashability matters: it
    keys the engine/BVP caches, so two operators that compare equal
    share engines (transfer matrices, coarse inverses).
  * Level geometry is passed explicitly (``dq`` — the level's per-axis
    spacings as float64 values) rather than through a mutable handle:
    each level re-discretizes the operator exactly like the reference's
    wrappers re-read ``this%meshes(:,g_id)``.
  * PyTorch runs eagerly, so there is no trace and no ``jit``: each
    method runs its tensor ops on the device of ``u`` as they are
    called.  The engine's CUDA kernels encode the Poisson stencil and
    stay reserved for the default (``operator=None``) engine; an injected
    operator runs as plain tensor code, one kernel per elementwise op.
    An operator whose ``relax`` launches a kernel of its own gets kernel
    performance with no engine changes.

Contract for implementers:

  * ``relax(u, rhs, dq, bcs)`` — ONE full relaxation sweep of
    ``L u = rhs`` (the engine composes ``ms``-sweep smoothing and the
    coarse relax-to-tolerance loop from it).  It must keep Dirichlet
    points frozen (the engine carries inhomogeneous Dirichlet data in
    the iterate, reference ndsm_poisson.f90:591-594) and must handle
    any nullspace pinning itself (the reference's relax subtracts the
    mean for all-Neumann Poisson, ndsm_optimized.f90:173-189).
  * ``residual(u, rhs, dq, bcs)`` — ``rhs - L[u]``, zeroed on
    Dirichlet faces (reference ndsm_poisson.f90:325-328).
  * ``coarse_matrix(shape, dq, bcs)`` — optional: return
    ``(S, int_mask_flat)`` (numpy float64) such that
    ``e_int = S @ rhs_int`` solves the coarse problem (see mg/coarse.py),
    or None to use the reference's relax-to-``ex_tol`` coarse solve
    (which only needs ``relax``).
  * ``is_singular(bcs)`` — True when L has the constant nullspace for
    these BCs; the outer defect-correction loop then pins the mean of
    the corrected iterate exactly as for all-Neumann Poisson.
  * ``held()`` — optional: a context in which the operator may keep
    data of its levels between calls; ``PoissonBVP`` enters it once a
    solve and the operator drops that data on leaving it.  The default
    keeps nothing.
  * Both methods must be dtype-polymorphic (float32/float64): mixed
    precision calls ``residual`` in float64 and ``relax`` in float32.
    They see no lane axis: ``solve_batch`` runs an operator's problems
    one by one.

Instances must be hashable and comparable by value — use frozen
dataclasses (the built-ins here are).

Distribution: the JAX package composes injected operators with its
GSPMD path (``PoissonBVP(shard_spec=...)``); the port has no GSPMD
partitioner and no ``shard_spec`` yet, and its sharded engine
(parallel/sm_engine.py) is Poisson-specialized, as the JAX one is.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..ops import stencils
from ..ops.stencils import BCS
from ..utils.caching import BoundedCache

__all__ = [
    "MGOperator",
    "PoissonOperator",
    "HelmholtzOperator",
    "DiffusionOperator",
]


class MGOperator:
    """Abstract injectable operator (see module docstring for the
    contract; reference analogue: the MG_RELAX/MG_RESIDUAL abstract
    interfaces, fortran/ndsm_multigrid_core.f90:106-136)."""

    def relax(self, u: torch.Tensor, rhs: torch.Tensor, dq, bcs: BCS) -> torch.Tensor:
        raise NotImplementedError

    def residual(self, u: torch.Tensor, rhs: torch.Tensor, dq, bcs: BCS) -> torch.Tensor:
        raise NotImplementedError

    def coarse_matrix(self, shape, dq, bcs: BCS):
        """(S, int_mask_flat) for a one-matvec direct coarse solve, or
        None to relax the coarsest grid to ``ex_tol`` instead."""
        return None

    def is_singular(self, bcs: BCS) -> bool:
        """True when the operator has the additive-constant nullspace
        under these BCs (all-Neumann Poisson semantics: per-sweep mean
        pinning in ``relax``, outer-iterate mean pinning in the
        drivers)."""
        return False

    def held(self):
        """Context in which the operator may keep data of its levels
        between calls; the solve drivers enter it once a solve."""
        return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class PoissonOperator(MGOperator):
    """The default operator, as an explicit value: second-order
    red-black Gauss-Seidel Poisson (ops/stencils.py; reference
    ndsm_optimized.f90:40,346).  ``MGEngine(operator=None)`` encodes
    exactly this with its CUDA kernels on float32 levels; injecting
    ``PoissonOperator()`` runs the same math as plain tensor code — in
    float64 bitwise the default engine's iterates."""

    def relax(self, u, rhs, dq, bcs):
        return stencils.rb_sweep(u, rhs, dq, stencils.validate_bcs(bcs, u.ndim))

    def residual(self, u, rhs, dq, bcs):
        return stencils.poisson_residual(u, rhs, dq, stencils.validate_bcs(bcs, u.ndim))

    def coarse_matrix(self, shape, dq, bcs):
        from .coarse import build_coarse_solver_matrix

        return build_coarse_solver_matrix(shape, dq, bcs)

    def is_singular(self, bcs):
        return stencils.is_all_neumann(bcs)


@dataclasses.dataclass(frozen=True)
class HelmholtzOperator(MGOperator):
    """Shifted operator ``L[u] = laplace(u) - c*u`` (modified Helmholtz
    for ``c > 0``) — the non-Poisson client of the injection point.

    Same second-order discretization, Neumann index reflection, frozen
    Dirichlet faces, and red-black ordering as the Poisson stencil;
    only the diagonal changes: ``u_new = (sum_ax (lo+hi)*w_ax - rhs) /
    (2*sum_ax w_ax + c)``.  For ``c > 0`` the operator is nonsingular
    even with all-Neumann faces (no mean pinning; the direct coarse
    solve uses a true inverse); ``c == 0`` degrades to Poisson, bit for
    bit (``stencils.rb_sweep`` / ``poisson_residual``).
    """

    c: float = 0.0

    def __post_init__(self):
        if not (self.c >= 0.0):
            raise ValueError(f"HelmholtzOperator needs c >= 0, got {self.c}")

    def relax(self, u, rhs, dq, bcs):
        bcs = stencils.validate_bcs(bcs, u.ndim)
        w, w0 = stencils.stencil_weights(dq, u.dtype, self.c)
        red, black = stencils.color_masks(tuple(u.shape), bcs, u.device)
        u = stencils._half_sweep(u, rhs, w, w0, red, 0)
        u = stencils._half_sweep(u, rhs, w, w0, black, 0)
        if self.is_singular(bcs):
            u = stencils.subtract_mean(u)
        return u

    def residual(self, u, rhs, dq, bcs):
        bcs = stencils.validate_bcs(bcs, u.ndim)
        w, _ = stencils.stencil_weights(dq, u.dtype)
        c = float(_np_dtype(u.dtype)(self.c))
        lap = None
        for ax in range(u.ndim):
            lo, hi = stencils._neighbors(u, ax)
            term = (lo - 2.0 * u + hi) * w[ax]
            lap = term if lap is None else lap + term
        r = rhs - (lap - c * u)
        return r.masked_fill(~stencils.interior_mask(tuple(u.shape), bcs, u.device), 0.0)

    def coarse_matrix(self, shape, dq, bcs):
        from .coarse import build_coarse_solver_matrix

        return build_coarse_solver_matrix(shape, dq, bcs, diag_shift=-float(self.c))

    def is_singular(self, bcs):
        return self.c == 0.0 and stencils.is_all_neumann(bcs)


@dataclasses.dataclass(frozen=True)
class DiffusionOperator(MGOperator):
    """Variable-coefficient diffusion ``L[u] = div(a(q) grad u)`` —
    the second non-Poisson client of the injection point, exercising
    what :class:`HelmholtzOperator` cannot: per-level operator
    *re-discretization* from spatially varying data (the reference's
    wrappers re-read ``this%meshes(:,g_id)`` per level for exactly this
    reason, ndsm_poisson.f90:163-276).

    ``coef`` maps NORMALIZED per-axis coordinates (each in [0, 1] over
    the domain, ``ndim`` tensors of the level's shape in ``indexing='ij'``
    order, in the level's dtype and on its device) to a strictly positive
    coefficient (a tensor, or anything ``torch.as_tensor`` takes, that
    broadcasts to the level).  Normalized coordinates make the definition
    level-independent, and that is what makes every level right: each
    multigrid level re-evaluates ``coef`` on its own nodes, which are
    exactly the nodes of its regenerated uniform mesh.  The coarse nodes
    are NOT a subset of the fine ones (the hierarchy coarsens n to
    floor(n/2) points, 17 -> 8, and regenerates a uniform mesh, SURVEY.md
    quirk Q10), so the coarse coefficient is not an injection of the
    fine one, and need not be.  The nodes are ``i / (n - 1)``, correctly
    rounded in the level's dtype, as ``jnp.linspace(0, 1, n)`` makes them.

    Discretization: standard second-order flux form with
    arithmetic-mean face coefficients,

      ``L[u]_i = sum_ax (a_{i+1/2}(u_{i+1}-u_i)
                         - a_{i-1/2}(u_i-u_{i-1})) / dq_ax^2``,

    red-black Gauss-Seidel relaxation solving pointwise
    ``u_i = (sum_ax (a_lo u_lo + a_hi u_hi) w_ax - rhs_i) / den_i``
    with ``den_i = sum_ax (a_lo + a_hi) w_ax``.  Boundary faces reuse
    the engine's Neumann index reflection (ops/stencils._neighbors) for
    both ``u`` and ``a`` — the mirrored half-coefficient at index 0 is
    ``a_{1/2}``, exactly the image flux of the zero-normal-derivative
    condition.  ``a == const`` reduces to ``const *`` the Poisson
    stencil (and to the Poisson iterates, since the relax fixed-point
    equation is scale-invariant).

    Like all-Neumann Poisson, the operator has the additive-constant
    nullspace under all-Neumann BCs for ANY positive ``a``; the direct
    coarse solve is assembled generically from the operator's own
    residual (mg/coarse.build_coarse_matrix_from_operator).

    ``coef`` is compared and hashed by identity (it keys the engine and
    BVP caches): reuse one function object per operator.

    Within ``held()`` (each solve of ``PoissonBVP``) the face
    coefficients and ``den`` of a level are computed once per (shape,
    dtype, device, weights) and kept until the solve returns: the port
    runs eagerly, so without them every relax and residual call would
    evaluate ``coef`` again.  Outside it each call computes them afresh,
    so an operator held by the engine and BVP caches keeps nothing on
    the device between solves.  The numbers are the same either way.
    """

    coef: object = None  # Callable[*norm_coords] -> positive tensor
    _terms: BoundedCache = dataclasses.field(
        default_factory=lambda: BoundedCache(maxsize=16),
        init=False, repr=False, compare=False, hash=False,
    )
    _depth: list = dataclasses.field(
        default_factory=list, init=False, repr=False, compare=False, hash=False,
    )

    def __post_init__(self):
        if not callable(self.coef):
            raise ValueError("DiffusionOperator needs coef=<callable>")

    @contextlib.contextmanager
    def held(self):
        self._depth.append(None)
        try:
            yield
        finally:
            self._depth.pop()
            if not self._depth:
                self._terms.clear()

    def _level_terms(self, u: torch.Tensor, w):
        """(halves, den) of ``u``'s level: ``halves[ax] = (a_lo, a_hi)``."""
        key = (tuple(u.shape), u.dtype, str(u.device), w)
        terms = self._terms.get(key)
        if terms is None:
            halves = _diffusion_halves(tuple(u.shape), self.coef, u.dtype, u.device)
            den = None
            for ax, (alo, ahi) in enumerate(halves):
                t = (alo + ahi) * w[ax]
                den = t if den is None else den + t
            terms = (halves, den)
            if self._depth:
                self._terms.put(key, terms)
        return terms

    def relax(self, u, rhs, dq, bcs):
        bcs = stencils.validate_bcs(bcs, u.ndim)
        w, _ = stencils.stencil_weights(dq, u.dtype)
        halves, den = self._level_terms(u, w)
        for mask in stencils.color_masks(tuple(u.shape), bcs, u.device):
            num = None
            for ax in range(u.ndim):
                lo, hi = stencils._neighbors(u, ax)
                alo, ahi = halves[ax]
                t = (alo * lo + ahi * hi) * w[ax]
                num = t if num is None else num + t
            u = torch.where(mask, (num - rhs) / den, u)
        if self.is_singular(bcs):
            u = stencils.subtract_mean(u)
        return u

    def residual(self, u, rhs, dq, bcs):
        bcs = stencils.validate_bcs(bcs, u.ndim)
        w, _ = stencils.stencil_weights(dq, u.dtype)
        halves, _ = self._level_terms(u, w)
        out = None
        for ax in range(u.ndim):
            lo, hi = stencils._neighbors(u, ax)
            alo, ahi = halves[ax]
            term = (ahi * (hi - u) - alo * (u - lo)) * w[ax]
            out = term if out is None else out + term
        r = rhs - out
        return r.masked_fill(~stencils.interior_mask(tuple(u.shape), bcs, u.device), 0.0)

    def coarse_matrix(self, shape, dq, bcs):
        from .coarse import build_coarse_matrix_from_operator

        return build_coarse_matrix_from_operator(self, shape, dq, bcs)

    def is_singular(self, bcs):
        return stencils.is_all_neumann(bcs)


def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _unit_nodes(n: int, dtype: torch.dtype) -> np.ndarray:
    """``linspace(0, 1, n)`` as ``jnp.linspace`` rounds it: ``i / (n - 1)``
    correctly rounded in ``dtype``, the last node exactly 1."""
    npdt = _np_dtype(dtype)
    return np.append(np.arange(n - 1, dtype=npdt) / npdt(n - 1), npdt(1.0))


def _diffusion_halves(shape, coef, dtype: torch.dtype, device):
    """Face coefficients ``(a_lo, a_hi)`` per axis: evaluate ``coef`` on
    the level's normalized node grid, then arithmetic-mean to the
    half-points with the same index reflection as the stencil reads
    (so the mirrored boundary half-coefficient matches the mirrored
    neighbor)."""
    coords = torch.meshgrid(
        *[torch.as_tensor(_unit_nodes(n, dtype), device=device) for n in shape],
        indexing="ij",
    )
    a = torch.as_tensor(coef(*coords), dtype=dtype, device=device).broadcast_to(shape)
    halves = []
    for ax in range(len(shape)):
        lo, hi = stencils._neighbors(a, ax)
        halves.append((0.5 * (a + lo), 0.5 * (a + hi)))
    return halves
