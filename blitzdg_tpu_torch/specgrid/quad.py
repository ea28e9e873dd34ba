"""Quadrilateral nodal DG discretization (tensor-product LGL elements).

Host-side setup (numpy, float64) producing a frozen element-major
:class:`~blitzdg_tpu_torch.context.DGContext2D` with ``n_faces=4``.
Counterpart of the JAX package's ``blitzdg_tpu/specgrid/quad.py``:
tensor-product LGL nodes Np=(N+1)^2, tensor-product Legendre Vandermonde,
Dr/Ds/Drw/Dsw, exponential modal filter, four face masks, the bilinear
vertex-blend physical map (the metric varies per node even for straight
sides), the four-edge lift, node-matching interface maps (the native helper
where it builds, else the numpy ``_build_maps`` of the triangle module).
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import BCMaps, DGContext2D, face_trace_structure
from ..mesh.gmsh import Mesh2D
from .jacobi import gauss_lobatto_points
from .triangle import _build_maps
from .vandermonde import grad_vandermonde_1d, vandermonde_1d

NODE_TOL = 1e-5


def quad_nodes(n_order: int) -> tuple[np.ndarray, np.ndarray]:
    """Tensor-product LGL nodes on [-1,1]^2, ordered s-major then r (row
    i varies r fastest)."""
    r1 = gauss_lobatto_points(0.0, 0.0, n_order)
    R, S = np.meshgrid(r1, r1, indexing="xy")  # S rows, R cols
    return R.reshape(-1), S.reshape(-1)


def vandermonde_quad(n_order: int, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """V[n, (i,j)] = P_i(r_n) P_j(s_n), orthonormal tensor Legendre basis."""
    Vr = vandermonde_1d(n_order, r)  # (n, N+1)
    Vs = vandermonde_1d(n_order, s)
    # column order: i varies fastest within j (the filter's modal degrees)
    return np.einsum("ni,nj->nji", Vr, Vs).reshape(r.size, -1)


def grad_vandermonde_quad(n_order, r, s):
    Vr = vandermonde_1d(n_order, r)
    Vs = vandermonde_1d(n_order, s)
    dVr = grad_vandermonde_1d(n_order, r)
    dVs = grad_vandermonde_1d(n_order, s)
    Vr2 = np.einsum("ni,nj->nji", dVr, Vs).reshape(r.size, -1)
    Vs2 = np.einsum("ni,nj->nji", Vr, dVs).reshape(r.size, -1)
    return Vr2, Vs2


def dmatrices_quad(n_order, r, s, V):
    Vr, Vs = grad_vandermonde_quad(n_order, r, s)
    Dr = np.linalg.solve(V.T, Vr.T).T
    Ds = np.linalg.solve(V.T, Vs.T).T
    VVt = V @ V.T
    Drw = np.linalg.solve(VVt.T, (V @ Vr.T).T).T
    Dsw = np.linalg.solve(VVt.T, (V @ Vs.T).T).T
    return Dr, Ds, Drw, Dsw


def build_fmask_quad(r: np.ndarray, s: np.ndarray, n_fp: int) -> np.ndarray:
    """(4, Nfp) nodes on faces: 1: s=-1, 2: r=+1, 3: s=+1, 4: r=-1
    (edges in CCW vertex order v0->v1->v2->v3)."""
    f1 = np.flatnonzero(np.abs(s + 1.0) < NODE_TOL)
    f2 = np.flatnonzero(np.abs(r - 1.0) < NODE_TOL)
    f3 = np.flatnonzero(np.abs(s - 1.0) < NODE_TOL)
    f4 = np.flatnonzero(np.abs(r + 1.0) < NODE_TOL)
    fmask = np.stack([f1, f2, f3, f4]).astype(np.int32)
    assert fmask.shape == (4, n_fp)
    return fmask


def lift_quad(n_order, r, s, fmask, V) -> np.ndarray:
    n_p = r.size
    n_fp = fmask.shape[1]
    E = np.zeros((n_p, 4 * n_fp))
    face_coord = (r, s, r, s)  # the coordinate that varies along each face
    for f in range(4):
        fr = face_coord[f][fmask[f]]
        v1d = vandermonde_1d(n_order, fr)
        mass_edge = np.linalg.inv(v1d @ v1d.T)
        E[fmask[f], f * n_fp : (f + 1) * n_fp] = mass_edge
    return (V @ V.T) @ E


def filter_quad(n_order: int, V: np.ndarray, Nc: float, s_order: int) -> np.ndarray:
    """Exponential modal filter on the tensor degrees i + j >= Nc."""
    alpha = -np.log(np.finfo(np.float64).eps)
    n_p = V.shape[0]
    diag = np.ones(n_p)
    idx = 0
    for j in range(n_order + 1):  # column order (i fastest within j)
        for i in range(n_order + 1):
            deg = i + j
            if deg >= Nc:
                k = (deg - Nc) / (2 * n_order - Nc) if 2 * n_order > Nc else 1.0
                diag[idx] = np.exp(-alpha * k**s_order)
            idx += 1
    return (V * diag[None, :]) @ np.linalg.inv(V)


def _build_maps_quad(x, y, fmask, mesh, n_p):
    """vmapM/vmapP/mapP: the native helper where it builds, else the same
    node-matching construction as the triangle case in numpy."""
    from .. import native

    nat = native.build_maps(x, y, fmask, mesh.etoe, mesh.etof, mesh.verts,
                            mesh.etov, NODE_TOL)
    if nat is not None:
        return nat
    return _build_maps(x, y, fmask, mesh, n_p)


def build_quad_context(
    n_order: int,
    mesh: Mesh2D,
    dtype: torch.dtype = torch.float64,
    filter_cutoff: float | None = None,
    filter_order: int = 4,
    coords: tuple[np.ndarray, np.ndarray] | None = None,
    device="cuda",
) -> DGContext2D:
    """Assemble the full frozen quad context from a 4-face mesh, on the
    host in float64, then placed on ``device`` in ``dtype``."""
    if mesh.num_faces != 4:
        raise ValueError("the quad context needs a quadrilateral mesh")
    n_p = (n_order + 1) ** 2
    n_fp = n_order + 1
    n_faces = 4
    K = mesh.num_elements

    r, s = quad_nodes(n_order)
    V = vandermonde_quad(n_order, r, s)
    Vinv = np.linalg.inv(V)
    Dr, Ds, Drw, Dsw = dmatrices_quad(n_order, r, s, V)
    fmask = build_fmask_quad(r, s, n_fp)
    lift = lift_quad(n_order, r, s, fmask, V)

    # bilinear vertex-blend map x = 1/4 sum (1 +- r)(1 +- s) V_i
    VX, VY = mesh.verts[:, 0], mesh.verts[:, 1]
    blend = np.stack(
        [
            0.25 * (1 - r) * (1 - s),
            0.25 * (1 + r) * (1 - s),
            0.25 * (1 + r) * (1 + s),
            0.25 * (1 - r) * (1 + s),
        ],
        axis=0,
    )  # (4, Np)
    if coords is not None:
        x, y = np.asarray(coords[0]), np.asarray(coords[1])
    else:
        corners = [mesh.etov[:, i] for i in range(4)]
        x = sum(blend[i][None, :] * VX[v][:, None] for i, v in enumerate(corners))
        y = sum(blend[i][None, :] * VY[v][:, None] for i, v in enumerate(corners))

    xr, yr = x @ Dr.T, y @ Dr.T
    xs, ys = x @ Ds.T, y @ Ds.T
    J = xr * ys - xs * yr
    if np.any(J <= 0):
        raise ValueError("non-positive Jacobian (inverted quads?)")
    rx, ry = ys / J, -xs / J
    sx, sy = -yr / J, xr / J

    fm_flat = fmask.reshape(-1)
    fxr, fxs = xr[:, fm_flat], xs[:, fm_flat]
    fyr, fys = yr[:, fm_flat], ys[:, fm_flat]
    nx = np.empty((K, n_faces * n_fp))
    ny = np.empty((K, n_faces * n_fp))
    sl = [slice(f * n_fp, (f + 1) * n_fp) for f in range(4)]
    # outward normals per face of the reference square:
    # f1 (s=-1): (yr, -xr); f2 (r=+1): (ys, -xs);
    # f3 (s=+1): (-yr, xr); f4 (r=-1): (-ys, xs)
    nx[:, sl[0]], ny[:, sl[0]] = fyr[:, sl[0]], -fxr[:, sl[0]]
    nx[:, sl[1]], ny[:, sl[1]] = fys[:, sl[1]], -fxs[:, sl[1]]
    nx[:, sl[2]], ny[:, sl[2]] = -fyr[:, sl[2]], fxr[:, sl[2]]
    nx[:, sl[3]], ny[:, sl[3]] = -fys[:, sl[3]], fxs[:, sl[3]]
    sJ = np.hypot(nx, ny)
    nx /= sJ
    ny /= sJ
    fscale = sJ / J[:, fm_flat]

    vmapM, vmapP, mapP = _build_maps_quad(x, y, fmask, mesh, n_p)

    trace_flat = vmapP.reshape(-1) == vmapM.reshape(-1)
    mapB_list = np.flatnonzero(trace_flat)
    nB = max(1, mapB_list.size)
    mapB = np.zeros(nB, dtype=np.int32)
    maskB = np.zeros(nB, dtype=bool)
    mapB[: mapB_list.size] = mapB_list
    maskB[: mapB_list.size] = True
    vmapB = vmapM.reshape(-1)[mapB]

    bc_maps = BCMaps.from_bc_table(mesh.bc_type, n_fp, device=device)

    coords_all = np.stack([x.reshape(-1), y.reshape(-1)], axis=1)
    rounded = np.round(coords_all / 1e-9) * 1e-9
    _, gather_ids, scatter_ids = np.unique(
        rounded, axis=0, return_index=True, return_inverse=True
    )

    filt = (
        filter_quad(n_order, V, filter_cutoff, filter_order)
        if filter_cutoff is not None
        else np.eye(n_p)
    )

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               dtype=dtype, device=device)

    def to_idx(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=device)

    _fts = face_trace_structure(mapP, n_fp)
    return DGContext2D(
        n_order=n_order,
        n_p=n_p,
        k_elem=K,
        n_faces=n_faces,
        n_fp=n_fp,
        r=to_dev(r),
        s=to_dev(s),
        V=to_dev(V),
        Vinv=to_dev(Vinv),
        Dr=to_dev(Dr),
        Ds=to_dev(Ds),
        Drw=to_dev(Drw),
        Dsw=to_dev(Dsw),
        lift=to_dev(lift),
        filter=to_dev(filt),
        fmask=to_idx(fmask),
        x=to_dev(x),
        y=to_dev(y),
        J=to_dev(J),
        rx=to_dev(rx),
        ry=to_dev(ry),
        sx=to_dev(sx),
        sy=to_dev(sy),
        nx=to_dev(nx),
        ny=to_dev(ny),
        fscale=to_dev(fscale),
        sJ=to_dev(sJ),
        vmapM=to_idx(vmapM),
        vmapP=to_idx(vmapP),
        mapP=to_idx(mapP),
        mapB=to_idx(mapB),
        maskB=torch.as_tensor(maskB, device=device),
        vmapB=to_idx(vmapB),
        bc_maps=bc_maps,
        bc_table=to_idx(mesh.bc_type),
        gather_ids=to_idx(gather_ids),
        scatter_ids=to_idx(scatter_ids),
        face_nbr=None if _fts is None else to_idx(_fts[0]),
        face_flip=None if _fts is None else torch.as_tensor(_fts[1], device=device),
    )
