"""NDSM on PyTorch and CUDA: the port of ``ndsm_tpu`` to an NVIDIA H100.

The same geometric-multigrid Poisson solver and 3D Coulomb-gauge
vector-potential pipeline as ``ndsm_tpu``, with plain tensor code in
PyTorch and the TPU's Pallas kernels replaced by hand-written CUDA
kernels for Hopper (``csrc/``, built at first use with ``nvcc``).

This package imports neither JAX nor ``ndsm_tpu``; the JAX package stays
the reference that the port's tests hold it against.  It runs where the
caller puts it: ``device="cuda"`` raises when there is no CUDA device.
"""

from .options import (
    IERR_BADMESH,
    IERR_COVFAIL,
    IERR_SUCCESS,
    Options,
    SolveInfo,
    VectorPotentialInfo,
)
from .grids import GridHierarchy, coarsen_shape, num_grids
from .mg.batched import MultiBCSolver
from .mg.operator import DiffusionOperator, HelmholtzOperator, MGOperator, PoissonOperator
from .mg.poisson import PoissonBVP, solve_poisson_bvp
from .ops.fused import fused_smooth_3d
from .potential.vector_potential import compute_vector_potential
from .api import vector_potential

__all__ = [
    "vector_potential",
    "compute_vector_potential",
    "solve_poisson_bvp",
    "PoissonBVP",
    "MGOperator",
    "PoissonOperator",
    "HelmholtzOperator",
    "DiffusionOperator",
    "MultiBCSolver",
    "fused_smooth_3d",
    "GridHierarchy",
    "Options",
    "SolveInfo",
    "VectorPotentialInfo",
    "num_grids",
    "coarsen_shape",
    "IERR_SUCCESS",
    "IERR_COVFAIL",
    "IERR_BADMESH",
]

__version__ = "0.5.1"
