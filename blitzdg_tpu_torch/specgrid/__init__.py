from . import jacobi, vandermonde
from .nodes1d import build_nodes1d

__all__ = ["jacobi", "vandermonde", "build_nodes1d"]
