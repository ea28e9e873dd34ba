from . import jacobi, vandermonde

__all__ = ["jacobi", "vandermonde"]
