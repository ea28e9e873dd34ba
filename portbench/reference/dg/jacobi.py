"""Frozen copy of ``blitzdg_tpu_torch/specgrid/jacobi.py`` at commit dfe7828,
unchanged.

Orthonormal Jacobi polynomials, Gauss and Gauss-Lobatto quadrature.

Setup-time host code (pure numpy, float64). These are the spectral building
blocks for nodal DG operators; everything here runs once per discretization
and is frozen into device-resident contexts afterwards.

Counterpart of the JAX package's ``blitzdg_tpu/specgrid/jacobi.py`` (own
copy: the port imports nothing of that package). Orthonormal Jacobi via
three-term recurrence, Golub-Welsch quadrature, Gauss-Lobatto points, from
the standard formulas (Hesthaven & Warburton, "Nodal Discontinuous Galerkin
Methods", Appendix A).
"""
from __future__ import annotations

import numpy as np
from scipy.special import gamma


def jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Evaluate the orthonormal Jacobi polynomial P_n^(alpha,beta) at x.

    Normalized so that int_{-1}^{1} P_m P_n (1-x)^a (1+x)^b dx = delta_mn.
    """
    x = np.asarray(x, dtype=np.float64)
    # gamma0 = 2^(a+b+1)/(a+b+1) * G(a+1)G(b+1)/G(a+b+1)
    gamma0 = (
        2.0 ** (alpha + beta + 1.0)
        / (alpha + beta + 1.0)
        * gamma(alpha + 1.0)
        * gamma(beta + 1.0)
        / gamma(alpha + beta + 1.0)
    )
    p0 = np.full_like(x, 1.0 / np.sqrt(gamma0))
    if n == 0:
        return p0
    gamma1 = (alpha + 1.0) * (beta + 1.0) / (alpha + beta + 3.0) * gamma0
    p1 = ((alpha + beta + 2.0) * x / 2.0 + (alpha - beta) / 2.0) / np.sqrt(gamma1)
    if n == 1:
        return p1

    aold = (
        2.0
        / (2.0 + alpha + beta)
        * np.sqrt((alpha + 1.0) * (beta + 1.0) / (alpha + beta + 3.0))
    )
    pm2, pm1 = p0, p1
    for i in range(1, n):
        h1 = 2.0 * i + alpha + beta
        anew = (
            2.0
            / (h1 + 2.0)
            * np.sqrt(
                (i + 1.0)
                * (i + 1.0 + alpha + beta)
                * (i + 1.0 + alpha)
                * (i + 1.0 + beta)
                / (h1 + 1.0)
                / (h1 + 3.0)
            )
        )
        bnew = -(alpha * alpha - beta * beta) / h1 / (h1 + 2.0)
        pnew = (1.0 / anew) * (-aold * pm2 + (x - bnew) * pm1)
        pm2, pm1 = pm1, pnew
        aold = anew
    return pm1


def grad_jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Derivative of the orthonormal Jacobi polynomial.

    d/dx P_n^(a,b) = sqrt(n(n+a+b+1)) * P_{n-1}^(a+1,b+1).
    """
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    return np.sqrt(n * (n + alpha + beta + 1.0)) * jacobi_p(x, alpha + 1.0, beta + 1.0, n - 1)


def gauss_quadrature(alpha: float, beta: float, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes and weights of the (n+1)-point Gauss-Jacobi rule (Golub-Welsch).

    Builds the symmetric tridiagonal Jacobi matrix from the recurrence
    coefficients and takes its eigendecomposition; weights come from the
    squared first components of the eigenvectors.
    """
    if n == 0:
        x = np.array([(alpha - beta) / (alpha + beta + 2.0)])
        w = np.array([2.0])
        return x, w

    h1 = 2.0 * np.arange(n + 1) + alpha + beta
    # diagonal: b_n = -(a^2-b^2)/((2n+a+b)(2n+a+b+2))
    with np.errstate(invalid="ignore", divide="ignore"):
        diag = -(alpha * alpha - beta * beta) / (h1 + 2.0) / h1
    if alpha + beta < 10.0 * np.finfo(float).eps:
        diag[0] = 0.0
    # off-diagonal
    i = np.arange(1, n + 1)
    off = (
        2.0
        / (h1[:-1] + 2.0)
        * np.sqrt(
            i
            * (i + alpha + beta)
            * (i + alpha)
            * (i + beta)
            / (h1[:-1] + 1.0)
            / (h1[:-1] + 3.0)
        )
    )
    from scipy.linalg import eigh_tridiagonal

    x, vecs = eigh_tridiagonal(diag, off)
    mu0 = (
        2.0 ** (alpha + beta + 1.0)
        / (alpha + beta + 1.0)
        * gamma(alpha + 1.0)
        * gamma(beta + 1.0)
        / gamma(alpha + beta + 1.0)
    )
    w = (vecs[0, :] ** 2) * mu0
    return x, w


def gauss_lobatto_points(alpha: float, beta: float, n: int) -> np.ndarray:
    """(n+1) Gauss-Lobatto-Jacobi points on [-1, 1] (endpoints included)."""
    if n == 1:
        return np.array([-1.0, 1.0])
    xint, _ = gauss_quadrature(alpha + 1.0, beta + 1.0, n - 2)
    return np.concatenate(([-1.0], xint, [1.0]))
