"""1D generalized Vandermonde matrices and nodal differentiation operators.

Setup-time host code (numpy, float64). Counterpart of the JAX package's
``blitzdg_tpu/specgrid/vandermonde.py`` (own copy).
"""
from __future__ import annotations

import numpy as np

from .jacobi import jacobi_p, grad_jacobi_p


def vandermonde_1d(n_order: int, r: np.ndarray) -> np.ndarray:
    """V[i, j] = P_j(r_i) with orthonormal Legendre (Jacobi(0,0)) basis."""
    r = np.asarray(r, dtype=np.float64)
    V = np.empty((r.size, n_order + 1), dtype=np.float64)
    for j in range(n_order + 1):
        V[:, j] = jacobi_p(r, 0.0, 0.0, j)
    return V


def grad_vandermonde_1d(n_order: int, r: np.ndarray) -> np.ndarray:
    """Vr[i, j] = dP_j/dr (r_i)."""
    r = np.asarray(r, dtype=np.float64)
    Vr = np.empty((r.size, n_order + 1), dtype=np.float64)
    for j in range(n_order + 1):
        Vr[:, j] = grad_jacobi_p(r, 0.0, 0.0, j)
    return Vr


def dmatrix_1d(n_order: int, r: np.ndarray, V: np.ndarray | None = None) -> np.ndarray:
    """Nodal differentiation matrix Dr = Vr V^{-1} on the nodes r."""
    if V is None:
        V = vandermonde_1d(n_order, r)
    Vr = grad_vandermonde_1d(n_order, r)
    # Solve Dr V = Vr, i.e. V^T Dr^T = Vr^T.
    return np.linalg.solve(V.T, Vr.T).T
