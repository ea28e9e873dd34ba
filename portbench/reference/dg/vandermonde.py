"""Frozen copy of ``blitzdg_tpu_torch/specgrid/vandermonde.py`` at commit
dfe7828, trimmed to vandermonde_1d.

1D generalized Vandermonde matrices and nodal differentiation operators.

Setup-time host code (numpy, float64). Counterpart of the JAX package's
``blitzdg_tpu/specgrid/vandermonde.py`` (own copy).
"""
from __future__ import annotations

import numpy as np

from .jacobi import jacobi_p


def vandermonde_1d(n_order: int, r: np.ndarray) -> np.ndarray:
    """V[i, j] = P_j(r_i) with orthonormal Legendre (Jacobi(0,0)) basis."""
    r = np.asarray(r, dtype=np.float64)
    V = np.empty((r.size, n_order + 1), dtype=np.float64)
    for j in range(n_order + 1):
        V[:, j] = jacobi_p(r, 0.0, 0.0, j)
    return V
