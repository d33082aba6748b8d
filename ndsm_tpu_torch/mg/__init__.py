from .batched import MultiBCSolver
from .operator import DiffusionOperator, HelmholtzOperator, MGOperator, PoissonOperator
from .poisson import PoissonBVP, get_poisson_bvp, solve_poisson_bvp

__all__ = [
    "PoissonBVP",
    "get_poisson_bvp",
    "solve_poisson_bvp",
    "MultiBCSolver",
    "MGOperator",
    "PoissonOperator",
    "HelmholtzOperator",
    "DiffusionOperator",
]
