from .batched import MultiBCSolver
from .poisson import PoissonBVP, get_poisson_bvp

__all__ = ["PoissonBVP", "get_poisson_bvp", "MultiBCSolver"]
