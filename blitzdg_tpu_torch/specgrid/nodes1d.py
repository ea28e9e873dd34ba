"""1D nodal DG discretization on a uniform line-segment grid.

Counterpart of the JAX package's ``blitzdg_tpu/specgrid/nodes1d.py``
(``build_nodes1d``): LGL nodes, V / Vinv, Dr = Vr V^{-1}, Lift = V V^T E,
affine x-grid, J = Dr x, rx = 1/J, Fscale = 1/J at the face nodes,
endpoint normals -1/+1 and the vmapM/vmapP interface maps, built
element-major (K, Np) on the host in float64 and placed on ``device`` in
``dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import DGContext1D
from .jacobi import gauss_lobatto_points
from .vandermonde import dmatrix_1d, vandermonde_1d


def build_nodes1d(
    n_order: int,
    k_elem: int,
    xmin: float,
    xmax: float,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> DGContext1D:
    n_p = n_order + 1
    n_faces, n_fp = 2, 1

    # reference element: LGL nodes, Vandermonde, differentiation
    r = gauss_lobatto_points(0.0, 0.0, n_order)
    V = vandermonde_1d(n_order, r)
    Vinv = np.linalg.inv(V)
    Dr = dmatrix_1d(n_order, r, V)

    # Lift = V V^T E, E picks the endpoint nodes (faces are points in 1D)
    E = np.zeros((n_p, n_faces * n_fp))
    E[0, 0] = 1.0
    E[n_p - 1, 1] = 1.0
    lift = V @ (V.T @ E)

    # physical grid: uniform elements, affine map, element-major (K, Np)
    width = (xmax - xmin) / k_elem
    k_idx = np.arange(k_elem)
    x = xmin + width * (k_idx[:, None] + 0.5 * (r[None, :] + 1.0))

    # metric, computed nodally as Dr @ x
    J = x @ Dr.T
    rx = 1.0 / J
    fmask = np.array([0, n_p - 1])
    fscale = rx[:, fmask]
    nx = np.tile(np.array([-1.0, 1.0]), (k_elem, 1))

    # face f of element k touches element k-1 (f=0) / k+1 (f=1); at the
    # domain ends the map refers to itself (boundary)
    vmapM = k_idx[:, None] * n_p + fmask[None, :]
    vmapP = vmapM.copy()
    mapP = k_idx[:, None] * 2 + np.arange(2)[None, :]
    vmapP[1:, 0] = (k_idx[:-1]) * n_p + (n_p - 1)
    mapP[1:, 0] = k_idx[:-1] * 2 + 1
    vmapP[:-1, 1] = (k_idx[1:]) * n_p
    mapP[:-1, 1] = k_idx[1:] * 2

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               dtype=dtype, device=device)

    def to_idx(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=device)

    return DGContext1D(
        n_order=n_order, n_p=n_p, k_elem=k_elem, n_faces=n_faces, n_fp=n_fp,
        r=to_dev(r), V=to_dev(V), Vinv=to_dev(Vinv), Dr=to_dev(Dr),
        lift=to_dev(lift), x=to_dev(x), J=to_dev(J), rx=to_dev(rx),
        nx=to_dev(nx), fscale=to_dev(fscale), vmapM=to_idx(vmapM),
        vmapP=to_idx(vmapP), mapP=to_idx(mapP), fmask=to_idx(fmask),
        mapI=0, mapO=2 * k_elem - 1, vmapI=0, vmapO=n_p * k_elem - 1,
    )
