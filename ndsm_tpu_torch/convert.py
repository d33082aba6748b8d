"""State carried across from the JAX package.

The system has no learned weights: what crosses from ``ndsm_tpu`` to the
port is configuration (``Options``) and the precomputed operators that
follow from a grid hierarchy (meshes, spacings, transfer and coarse-solve
matrices).  These helpers build the port's objects from plain Python and
numpy data, so both packages can be fed identical configurations without
the port importing JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .grids import GridHierarchy
from .options import Options

__all__ = ["options_from_reference", "hierarchy_from_reference"]


def options_from_reference(d: Mapping) -> Options:
    """The port's ``Options`` from ``dataclasses.asdict`` of an
    ``ndsm_tpu.Options``.  Unknown keys raise ``TypeError``; a value the
    port has no switch for (``use_pallas="off"``) raises ``ValueError``."""
    names = {f.name for f in dataclasses.fields(Options)}
    extra = set(d) - names
    if extra:
        raise TypeError(f"unknown option(s) {sorted(extra)}")
    return Options(**dict(d))


def hierarchy_from_reference(
    shapes: Sequence[Sequence[int]],
    meshes: Sequence[Sequence[np.ndarray]],
    dq: Sequence[Sequence[float]],
) -> GridHierarchy:
    """A ``GridHierarchy`` from per-level shapes, per-level per-axis mesh
    vectors and spacings (e.g. the fields of an ``ndsm_tpu``
    ``GridHierarchy``, as numpy arrays).  Checks that the three agree."""
    shapes = tuple(tuple(int(n) for n in s) for s in shapes)
    meshes = tuple(tuple(np.asarray(m, dtype=np.float64) for m in lvl) for lvl in meshes)
    dq = tuple(tuple(float(v) for v in lvl) for lvl in dq)
    if not (len(shapes) == len(meshes) == len(dq)) or not shapes:
        raise ValueError("shapes, meshes and dq need one entry per level")
    ndim = len(shapes[0])
    for s, m, d in zip(shapes, meshes, dq):
        if len(s) != ndim or len(m) != ndim or len(d) != ndim:
            raise ValueError("every level needs one entry per axis")
        if tuple(v.size for v in m) != s:
            raise ValueError(f"mesh lengths {[v.size for v in m]} != shape {s}")
        if tuple(float(v[1] - v[0]) for v in m) != d:
            raise ValueError(f"dq {d} disagrees with the meshes")
    return GridHierarchy(ndim=ndim, ngrids=len(shapes), shapes=shapes, meshes=meshes, dq=dq)
