"""Static multigrid hierarchy metadata.

Replaces the reference's ``MG_HANDLE`` (reference:
fortran/ndsm_multigrid_core.f90:86-101) with an immutable, trace-time
structure. Level shapes follow the reference rule
``nshape_{l+1} = max(floor(nshape_l / 2), 1)``
(ndsm_multigrid_core.f90:215-217) and every coarse mesh is regenerated as a
fresh uniform linspace over the [min, max] extent of the finest mesh
(ndsm_multigrid_core.f90:243-263; quirk Q10 in SURVEY.md: coarse points do
*not* coincide with fine points, which is why the transfer operators are
coordinate-based).

Unlike the reference — which allocates and frees coarse-level ``u``/``rhs``
on every V-cycle descent/ascent (quirk Q9) — all per-level buffers live in a
preallocated pytree owned by the jitted solver; this module holds only
static metadata (shapes, meshes, spacings) used at trace time.

Axis convention: dimension ``i`` of the solver is axis ``i`` of the array
(C order).  The reference is Fortran (column-major), so its dimension 1
(fastest-varying, "x") corresponds to the *last* axis here; this matters
only for the red-black sweep's first-color parity (see ops/stencils.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "GridHierarchy",
    "coarsen_shape",
    "num_grids",
    "mesh_uniformity_error",
]

# Relative tolerance (vs the mean spacing) for declaring a mesh vector
# uniform.  Meshes built by linspace/arange carry only ulp-level jitter
# (~1e-16 relative); a genuinely graded mesh deviates at O(1).
_UNIFORM_RTOL = 1e-8


def mesh_uniformity_error(m: np.ndarray) -> float | None:
    """None if ``m`` is uniformly spaced (within tolerance); else the
    max absolute spacing deviation.

    The whole solver stack assumes per-axis uniform spacing — the
    transfer matrices (ops/transfer.py), the stencil weights, and the
    reference itself (ndsm_interp.f90:373 ``find_bracket_points_uniform``,
    ndsm_vector_potential.f90:201-221 ``dq = q(2)-q(1)``).  A non-uniform
    mesh is the one input error that corrupts results instead of
    crashing, so it is validated at every construction boundary.

    The tolerance has two terms: ``_UNIFORM_RTOL`` of the mean spacing,
    plus the rounding jitter a uniform mesh *represented in the input's
    own dtype* necessarily carries — ``8*eps(dtype)*max|m|`` (a float32
    linspace on [0,1] deviates by ~eps32*|m| ≈ 4e-8, far above any
    dq-relative tolerance; similarly f64 meshes whose offset dwarfs
    their span).  Grading below that floor is sub-representable in the
    input precision and cannot be meant."""
    m = np.asarray(m)
    eps = (
        float(np.finfo(m.dtype).eps)
        if np.issubdtype(m.dtype, np.floating)
        else float(np.finfo(np.float64).eps)
    )
    scale = float(np.abs(np.asarray(m, dtype=np.float64)).max())
    d = np.diff(np.asarray(m, dtype=np.float64))
    dq = (float(m[-1]) - float(m[0])) / (m.size - 1)
    tol = max(_UNIFORM_RTOL * abs(dq), 8.0 * eps * scale)
    if dq == 0.0:
        # zero-extent mesh: uniform only if every spacing is ~0
        err = float(np.abs(d).max())
        return err if err > tol else None
    err = float(np.abs(d - dq).max())
    if err <= tol:
        return None
    return err


def coarsen_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """One level of coarsening: ``max(floor(n/2), 1)`` per dimension
    (reference: ndsm_multigrid_core.f90:216)."""
    return tuple(max(n // 2, 1) for n in shape)


def num_grids(shape: Sequence[int]) -> int:
    """Default number of levels: ``floor(log2(min(shape)/2))``
    (reference: ndsm_vector_potential.f90:341-342 with BASE_GRID=2)."""
    nmin = min(shape)
    if nmin < 4:
        raise ValueError(
            f"smallest dimension {nmin} < 4: cannot build a multigrid "
            "hierarchy (need at least one coarsening level)"
        )
    return int(math.floor(math.log(nmin / 2.0) / math.log(2.0)))


def _uniform_mesh(lo: float, hi: float, n: int) -> np.ndarray:
    """Coarse-mesh regeneration rule (ndsm_multigrid_core.f90:253-259):
    ``q_j = (j-1) * L / (n-1) + q_min``."""
    j = np.arange(n, dtype=np.float64)
    # Evaluation order matches the reference ((j-1)*Lq/(nq-1) + qil) so the
    # regenerated coordinates agree bitwise.
    return (j * (hi - lo)) / float(n - 1) + lo


@dataclasses.dataclass(frozen=True)
class GridHierarchy:
    """Immutable level metadata for one multigrid solve.

    Attributes:
      ndim: number of dimensions.
      ngrids: number of levels; level 0 is finest.
      shapes: per-level array shapes (C-order tuples).
      meshes: per-level, per-axis 1-D coordinate vectors (numpy float64).
      dq: per-level, per-axis uniform spacings.
    """

    ndim: int
    ngrids: int
    shapes: Tuple[Tuple[int, ...], ...]
    meshes: Tuple[Tuple[np.ndarray, ...], ...]
    dq: Tuple[Tuple[float, ...], ...]

    @staticmethod
    def from_mesh(meshes: Sequence[np.ndarray], ngrids: int | None = None) -> "GridHierarchy":
        """Build the hierarchy from the finest-level per-axis mesh vectors.

        Mirrors ``new_mg_handle`` (ndsm_multigrid_core.f90:165-270): the
        finest mesh is taken verbatim; each coarser mesh is a uniform
        linspace over the finest extent with ``max(floor(n/2),1)`` points.
        """
        meshes_in = [np.asarray(m) for m in meshes]  # original dtype
        meshes = [np.asarray(m, dtype=np.float64) for m in meshes]
        ndim = len(meshes)
        for i, m in enumerate(meshes):
            if m.ndim != 1 or m.size < 2:
                raise ValueError(f"mesh vector {i} must be 1-D with >= 2 points")
            # validate on the ORIGINAL input: its dtype sets the
            # representable-jitter floor (see mesh_uniformity_error)
            err = mesh_uniformity_error(meshes_in[i])
            if err is None and meshes_in[i].dtype != np.float64:
                # narrow-dtype input (e.g. float32): its f64 copy still
                # carries ~eps(dtype)*|m| spacing jitter, which the
                # stencil/transfer math would faithfully amplify —
                # regenerate the exactly-uniform f64 mesh over the same
                # extent (within the input's own precision this is the
                # same mesh).  float64 inputs pass through untouched
                # (golden-digit paths see bit-identical meshes).
                meshes[i] = _uniform_mesh(
                    float(meshes[i][0]), float(meshes[i][-1]), m.size
                )
            if err is not None:
                raise ValueError(
                    f"mesh vector {i} is not uniformly spaced "
                    f"(max |spacing - mean spacing| = {err:.3e}); the "
                    "transfer operators and stencils assume uniform "
                    "per-axis spacing (as does the reference, "
                    "ndsm_interp.f90:373) — a non-uniform mesh would "
                    "silently produce wrong answers"
                )
        fine_shape = tuple(int(m.size) for m in meshes)
        if ngrids is None:
            ngrids = num_grids(fine_shape)
        if ngrids < 1:
            raise ValueError(f"ngrids must be >= 1, got {ngrids}")

        shapes = [fine_shape]
        for _ in range(ngrids - 1):
            shapes.append(coarsen_shape(shapes[-1]))
        if min(shapes[-1]) < 2:
            raise ValueError(
                f"ngrids={ngrids} coarsens below 2 points per axis "
                f"(coarsest shape {shapes[-1]}); reduce ngrids"
            )

        level_meshes = [tuple(meshes)]
        extents = [(float(m.min()), float(m.max())) for m in meshes]
        for lvl in range(1, ngrids):
            level_meshes.append(
                tuple(
                    _uniform_mesh(lo, hi, n)
                    for (lo, hi), n in zip(extents, shapes[lvl])
                )
            )

        dq = tuple(
            tuple(float(m[1] - m[0]) for m in lvl_meshes)
            for lvl_meshes in level_meshes
        )
        return GridHierarchy(
            ndim=ndim,
            ngrids=ngrids,
            shapes=tuple(shapes),
            meshes=tuple(level_meshes),
            dq=dq,
        )

    @property
    def fine_shape(self) -> Tuple[int, ...]:
        return self.shapes[0]

    def __hash__(self):  # hashable for jit static args / caches
        return hash((self.ndim, self.ngrids, self.shapes))

    def __eq__(self, other):
        if not isinstance(other, GridHierarchy):
            return NotImplemented
        return (
            self.ndim == other.ndim
            and self.ngrids == other.ngrids
            and self.shapes == other.shapes
            and all(
                np.array_equal(a, b)
                for la, lb in zip(self.meshes, other.meshes)
                for a, b in zip(la, lb)
            )
        )
