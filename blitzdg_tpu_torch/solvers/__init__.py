"""Elliptic solvers of the port: Krylov methods and preconditioners.

Counterpart of the JAX package's ``blitzdg_tpu/solvers`` (same export
list).
"""
from .precon import (
    block_diagonal_blocks,
    block_jacobi_apply,
    block_jacobi_from_assembled,
    block_jacobi_from_matvec,
    block_jacobi_precon,
    coarse_prolongation,
    invert_blocks,
    probe_diagonal_blocks,
    two_level_from_assembled,
)
from .krylov import (
    CONV_BREAKDOWN,
    CONV_DIVERGED,
    CONV_INF_OR_NAN,
    CONV_MAXITS,
    CONV_STAGNATION,
    CONV_SUCCESS,
    SolveResult,
    cg,
    gmres,
)

__all__ = [
    "cg",
    "gmres",
    "SolveResult",
    "CONV_SUCCESS",
    "CONV_MAXITS",
    "CONV_BREAKDOWN",
    "CONV_INF_OR_NAN",
    "CONV_DIVERGED",
    "CONV_STAGNATION",
    "block_diagonal_blocks",
    "block_jacobi_apply",
    "block_jacobi_from_assembled",
    "block_jacobi_from_matvec",
    "block_jacobi_precon",
    "coarse_prolongation",
    "invert_blocks",
    "probe_diagonal_blocks",
    "two_level_from_assembled",
]
