from .vector_potential import compute_vector_potential

__all__ = ["compute_vector_potential"]
