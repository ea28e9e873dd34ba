"""Continuous-Galerkin (SEM) Poisson path through gather/scatter assembly.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sem.py`` (the whole
file, same names): the SEM stiffness action applied matrix-free (scatter
the unique-node vector to the DG nodes, apply the per-element stiffness,
gather-add back), Dirichlet nodes by masking, and a host scipy assembly as
the direct-solve oracle.

The gather-add is ``index_add_`` over the unique-node ids, where the JAX
package uses ``segment_sum``. On the card ``index_add_`` adds with atomics,
so the order of the additions, and with it the last bits of a sum over
coincident nodes, may change from run to run: results are not bit-stable
between runs there (they are on the CPU). Vectors may carry leading batch
axes: ``(..., n_unique)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import check_matmul_precision
from ..context import DGContext2D


def sem_num_nodes(ctx: DGContext2D) -> int:
    return int(ctx.gather_ids.shape[0])


def sem_boundary_nodes(ctx: DGContext2D) -> np.ndarray:
    """Unique-node ids lying on the physical boundary."""
    scatter = ctx.scatter_ids.cpu().numpy()
    vb = ctx.vmapB.cpu().numpy()[ctx.maskB.cpu().numpy()]
    return np.unique(scatter[vb])


def sem_scatter(ctx: DGContext2D, u_sem: torch.Tensor) -> torch.Tensor:
    """(..., n_unique) -> (..., K, Np) continuous nodal field."""
    return u_sem[..., ctx.scatter_ids].reshape(*u_sem.shape[:-1], ctx.k_elem,
                                               ctx.n_p)


def sem_gather_add(ctx: DGContext2D, f_dg: torch.Tensor) -> torch.Tensor:
    """(..., K, Np) -> (..., n_unique) by summing coincident-node
    contributions."""
    lead = f_dg.shape[:-2]
    out = torch.zeros(*lead, sem_num_nodes(ctx), dtype=f_dg.dtype,
                      device=f_dg.device)
    return out.index_add_(-1, ctx.scatter_ids, f_dg.reshape(*lead, -1))


def sem_poisson_op(ctx: DGContext2D, u_sem: torch.Tensor,
                   dirichlet_mask: torch.Tensor) -> torch.Tensor:
    """Matrix-free SEM stiffness action A u (SPD on the free nodes).

    ``dirichlet_mask`` (n_unique,) bool marks constrained nodes; the
    operator acts as the identity there (CG then solves with the boundary
    values folded into the right-hand side)."""
    check_matmul_precision(u_sem)
    u_sem = torch.where(dirichlet_mask, torch.zeros_like(u_sem), u_sem)
    u = sem_scatter(ctx, u_sem)
    ux, uy = ctx.grad(u)
    M = ctx.Vinv.T @ ctx.Vinv
    # weak local stiffness Dx^T (J M) Dx u, weighted in gradient space
    wx = ctx.J * (ux @ M.T)
    wy = ctx.J * (uy @ M.T)
    out = ((ctx.rx * wx + ctx.ry * wy) @ ctx.Dr
           + (ctx.sx * wx + ctx.sy * wy) @ ctx.Ds)
    return torch.where(dirichlet_mask, u_sem, sem_gather_add(ctx, out))


def sem_load_vector(ctx: DGContext2D, f: torch.Tensor,
                    dirichlet_mask: torch.Tensor) -> torch.Tensor:
    """The SEM load vector of a nodal forcing f: gather of J M f, zero on
    the Dirichlet nodes."""
    check_matmul_precision(f)
    M = ctx.Vinv.T @ ctx.Vinv
    b = sem_gather_add(ctx, ctx.J * (f @ M.T))
    return torch.where(dirichlet_mask, torch.zeros_like(b), b)


def assemble_sem_poisson(ctx: DGContext2D):
    """Host scipy assembly of the SEM stiffness and mass over the unique
    nodes (direct-solve oracle); Dirichlet handling is left to the
    caller."""
    import scipy.sparse as sp

    host = lambda a: a.detach().to("cpu", torch.float64).numpy()
    K, n_p = ctx.k_elem, ctx.n_p
    Dr, Ds, V = host(ctx.Dr), host(ctx.Ds), host(ctx.V)
    M = np.linalg.inv(V @ V.T)
    rx, ry, sx, sy = host(ctx.rx), host(ctx.ry), host(ctx.sx), host(ctx.sy)
    J = host(ctx.J)
    scatter = ctx.scatter_ids.cpu().numpy().reshape(K, n_p)
    n = sem_num_nodes(ctx)

    rows, cols, avals, mvals = [], [], [], []
    for k in range(K):
        Dx = rx[k, 0] * Dr + sx[k, 0] * Ds
        Dy = ry[k, 0] * Dr + sy[k, 0] * Ds
        Ak = J[k, 0] * (Dx.T @ M @ Dx + Dy.T @ M @ Dy)
        gid = scatter[k]
        rows.append(np.repeat(gid, n_p))
        cols.append(np.tile(gid, n_p))
        avals.append(Ak.reshape(-1))
        mvals.append((J[k, 0] * M).reshape(-1))

    rc = (np.concatenate(rows), np.concatenate(cols))
    A = sp.csr_matrix((np.concatenate(avals), rc), shape=(n, n))
    Msem = sp.csr_matrix((np.concatenate(mvals), rc), shape=(n, n))
    return A, Msem
