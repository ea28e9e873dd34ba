"""Block-Jacobi and two-level preconditioning for element-blocked DG
operators.

Counterpart of the JAX package's ``blitzdg_tpu/solvers/precon.py`` (the
whole file, same names). The per-element (Np, Np) diagonal blocks of an
operator are extracted and inverted once on the host in float64 (numpy,
scipy); the application is one batched product on the device,
``einsum('kij,...kj->...ki')``. Vectors are flat and element-major,
``(..., K*Np)``, with any leading batch axes.

``probe_diagonal_blocks`` reads the blocks of a matrix-free operator by
colored probing: the JAX package maps the operator over the probes with
``vmap``; here the probes go through the operator as one batch, so the
operator must take leading batch axes (the ``ops.poisson`` operators do).

The two-level preconditioner adds the Galerkin coarse correction on the
per-element P1 subspace, with a dense (nc K, nc K) coarse inverse formed on
the host, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch


def block_diagonal_blocks(op, k_elem: int, n_p: int) -> np.ndarray:
    """The (K, Np, Np) element-diagonal blocks of an assembled operator (a
    scipy.sparse matrix or a dense array over flat (K*Np,) dofs in
    element-major order, e.g. ``assemble_poisson2d``'s OP)."""
    A = sp.csr_matrix(op) if not isinstance(op, np.ndarray) else None
    blocks = np.zeros((k_elem, n_p, n_p))
    for k in range(k_elem):
        sl = slice(k * n_p, (k + 1) * n_p)
        blocks[k] = (A[sl, sl].toarray() if A is not None else op[sl, sl])
    return blocks


def invert_blocks(blocks: np.ndarray, dtype: torch.dtype = torch.float32,
                  device="cuda") -> torch.Tensor:
    """Host batched inverse (float64) of (K, Np, Np) blocks, placed on
    ``device`` in ``dtype``."""
    inv = np.linalg.inv(np.asarray(blocks, dtype=np.float64))
    return torch.as_tensor(inv, dtype=dtype, device=device)


def block_jacobi_apply(inv_blocks: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """inv_blocks (K, Np, Np) applied to v (..., K*Np), element-major: one
    batched product. K is whatever the caller owns (the whole mesh, or a
    shard's rows)."""
    K, n_p = inv_blocks.shape[0], inv_blocks.shape[-1]
    kv = v.reshape(*v.shape[:-1], K, n_p)
    return torch.einsum("kij,...kj->...ki", inv_blocks, kv).reshape(v.shape)


def block_jacobi_precon(blocks: np.ndarray,
                        dtype: torch.dtype = torch.float32,
                        device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """Host-invert the (K, Np, Np) diagonal blocks; return the preconditioner
    v -> blocks^{-1} v on ``device``."""
    inv = invert_blocks(blocks, dtype, device)
    return lambda v: block_jacobi_apply(inv, v)


def block_jacobi_from_assembled(op, k_elem: int, n_p: int,
                                dtype: torch.dtype = torch.float32,
                                device="cuda"
                                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Assembled operator -> block-Jacobi preconditioner."""
    return block_jacobi_precon(block_diagonal_blocks(op, k_elem, n_p), dtype,
                               device)


def greedy_color(adjacency: np.ndarray) -> np.ndarray:
    """Greedy graph coloring of elements given (K, Nfaces) neighbor ids
    (self-ids on boundary faces)."""
    K = adjacency.shape[0]
    colors = np.full(K, -1, dtype=np.int64)
    for k in range(K):
        used = {colors[n] for n in adjacency[k] if n != k and colors[n] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[k] = c
    return colors


def element_adjacency(ctx) -> np.ndarray:
    """(K, Nfaces) neighbor element ids from the context's face-granular
    '+'-trace structure (self on boundary faces)."""
    face_nbr = ctx.face_nbr.cpu().numpy().reshape(ctx.k_elem, ctx.n_faces)
    return face_nbr // ctx.n_faces


def probe_diagonal_blocks(matvec2d: Callable, ctx) -> np.ndarray:
    """The exact (K, Np, Np) element-diagonal blocks of a matrix-free DG
    operator (..., K, Np) -> (..., K, Np) that couples only face-adjacent
    elements, by colored probing: no two neighbors share a color, so Np
    unit-nodal probes per color read off uncontaminated block columns
    (ncolors * Np probes, one batched operator application). The probes
    take the dtype and device of ``ctx.J``."""
    K, n_p = ctx.k_elem, ctx.n_p
    colors = greedy_color(element_adjacency(ctx))
    ncolors = int(colors.max()) + 1

    probes = np.zeros((ncolors * n_p, K, n_p))
    for c in range(ncolors):
        sel = colors == c
        for i in range(n_p):
            probes[c * n_p + i, sel, i] = 1.0

    pt = torch.as_tensor(probes, dtype=ctx.J.dtype, device=ctx.J.device)
    outs = matvec2d(pt).detach().to("cpu", torch.float64).numpy()
    blocks = np.zeros((K, n_p, n_p))
    for c in range(ncolors):
        sel = colors == c
        for i in range(n_p):
            blocks[sel, :, i] = outs[c * n_p + i, sel, :]
    return blocks


def block_jacobi_from_matvec(matvec2d: Callable, ctx,
                             dtype: torch.dtype = torch.float32,
                             device="cuda"
                             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Matrix-free operator -> block-Jacobi preconditioner (no assembly)."""
    return block_jacobi_precon(probe_diagonal_blocks(matvec2d, ctx), dtype,
                               device)


def coarse_prolongation(ctx, n_coarse_modes: int = 3) -> np.ndarray:
    """(Np, n_c) per-element prolongation columns: the first
    ``n_coarse_modes`` orthonormal basis functions at the nodes (the P1
    subspace of a triangle for 3)."""
    return ctx.V.detach().to("cpu", torch.float64).numpy()[:, :n_coarse_modes]


def two_level_from_assembled(
    ctx,
    op,
    *,
    n_coarse_modes: int = 3,
    dtype: torch.dtype = torch.float32,
    sign: float = 1.0,
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Additive two-level preconditioner from an assembled operator:

        M^{-1} = BJ^{-1} + P A_c^{-1} P^T,   A_c = P^T A P

    with P the per-element P1 prolongation (blockdiag of V's first
    ``n_coarse_modes`` columns). Both terms are SPD when ``sign * op`` is
    SPD (pass sign=-1.0 for an operator assembled negative definite), so CG
    stays valid. The coarse operator is inverted densely on the host in
    float64. Apply: one batched (K, Np, Np) product, two modal products and
    one dense (nc K, nc K) product on ``device``."""
    K, n_p = ctx.k_elem, ctx.n_p
    A = sp.csr_matrix(op)
    Pcols = coarse_prolongation(ctx, n_coarse_modes)  # (Np, nc)
    Ps = sp.kron(sp.eye(K), sp.csr_matrix(Pcols), format="csr")
    Ac = (Ps.T @ (sign * A) @ Ps).toarray()
    Ac_inv = np.linalg.inv(Ac)

    blocks = block_diagonal_blocks(sign * A, K, n_p)
    bj_inv = invert_blocks(blocks, dtype, device)
    P_dev = torch.as_tensor(Pcols, dtype=dtype, device=device)
    Ac_inv_t = torch.as_tensor(Ac_inv.T.copy(), dtype=dtype, device=device)
    nc = n_coarse_modes

    def precon(v: torch.Tensor) -> torch.Tensor:
        lead = v.shape[:-1]
        kv = v.reshape(*lead, K, n_p)
        fine = torch.einsum("kij,...kj->...ki", bj_inv, kv)
        rc = (kv @ P_dev).reshape(*lead, K * nc)  # P^T r
        yc = (rc @ Ac_inv_t).reshape(*lead, K, nc)
        coarse = yc @ P_dev.T
        return (fine + coarse).reshape(v.shape)

    return precon
