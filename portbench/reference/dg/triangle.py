"""Frozen copy of ``blitzdg_tpu_torch/specgrid/triangle.py`` at commit dfe7828,
trimmed to what the reference uses.

Triangle nodal DG discretization: warp-and-blend nodes, Koornwinder
basis, operators, geometry, and interface maps.

Host-side setup (numpy, float64) producing a frozen element-major
:class:`~blitzdg_tpu_torch.context.DGContext2D` of tensors. Counterpart of
the JAX package's ``blitzdg_tpu/specgrid/triangle.py``: alpha-optimized
warp-and-blend nodes, orthonormal simplex basis, 2D
Vandermonde/differentiation, Lift via edge mass matrices, vertex-blend
physical grid + metric + normals, node-matching interface maps (the numpy
``_build_maps`` path), BC sets, exponential modal filter, SEM
gather/scatter. The standard Hesthaven-Warburton construction, vectorized
in numpy and laid out element-major.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import BCMaps, DGContext2D, face_trace_structure
from .gmsh import Mesh2D
from .jacobi import gauss_lobatto_points, jacobi_p, grad_jacobi_p
from .vandermonde import vandermonde_1d

NODE_TOL = 1e-5

# Warp-and-blend alpha-optimal parameters for N=1..15 (published table,
# Hesthaven & Warburton).
ALPHA_OPT = (
    0.0, 0.0, 1.4152, 0.1001, 0.2751, 0.98, 1.0999, 1.2832,
    1.3648, 1.4773, 1.4959, 1.5743, 1.577, 1.6223, 1.6258,
)


# ---------------------------------------------------------------------------
# Coordinate maps on the reference simplex
# ---------------------------------------------------------------------------

def rs_to_ab(r: np.ndarray, s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Collapsed coordinates: a = 2(1+r)/(1-s) - 1 (a=-1 at the s=1 tip)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(np.abs(s - 1.0) > 1e-14, 2.0 * (1.0 + r) / (1.0 - s) - 1.0, -1.0)
    return a, s.copy()


def xy_to_rs(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Equilateral-triangle (x,y) to reference (r,s) via barycentric blend."""
    L1 = (np.sqrt(3.0) * y + 1.0) / 3.0
    L2 = (-3.0 * x - np.sqrt(3.0) * y + 2.0) / 6.0
    L3 = (3.0 * x - np.sqrt(3.0) * y + 2.0) / 6.0
    return -L2 + L3 - L1, -L2 - L3 + L1


def simplex_2d_p(a: np.ndarray, b: np.ndarray, i: int, j: int) -> np.ndarray:
    """Orthonormal Koornwinder-Dubiner basis on the simplex:
    psi_ij = sqrt(2) P_i^(0,0)(a) P_j^(2i+1,0)(b) (1-b)^i."""
    h1 = jacobi_p(a, 0.0, 0.0, i)
    h2 = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    return np.sqrt(2.0) * h1 * h2 * (1.0 - b) ** i


def grad_simplex_2d_p(
    a: np.ndarray, b: np.ndarray, i: int, j: int
) -> tuple[np.ndarray, np.ndarray]:
    """(d/dr, d/ds) of the orthonormal simplex basis at collapsed (a,b)."""
    fa = jacobi_p(a, 0.0, 0.0, i)
    gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
    dfa = grad_jacobi_p(a, 0.0, 0.0, i)
    dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)

    # d/dr = (2/(1-b)) d/da
    dpdr = dfa * gb
    if i > 0:
        dpdr = dpdr * (0.5 * (1.0 - b)) ** (i - 1)
    # d/ds = ((1+a)/2)(2/(1-b)) d/da + d/db
    dpds = dfa * gb * 0.5 * (1.0 + a)
    if i > 0:
        dpds = dpds * (0.5 * (1.0 - b)) ** (i - 1)
    tmp = dgb * (0.5 * (1.0 - b)) ** i
    if i > 0:
        tmp = tmp - 0.5 * i * gb * (0.5 * (1.0 - b)) ** (i - 1)
    dpds = dpds + fa * tmp

    norm = 2.0 ** (i + 0.5)
    return norm * dpdr, norm * dpds


# ---------------------------------------------------------------------------
# Node construction
# ---------------------------------------------------------------------------

def warp_factor(n_order: int, rout: np.ndarray) -> np.ndarray:
    """1D warp from equidistant to LGL node distribution, evaluated at rout."""
    n_p = n_order + 1
    req = np.linspace(-1.0, 1.0, n_p)
    rlgl = gauss_lobatto_points(0.0, 0.0, n_order)
    veq = vandermonde_1d(n_order, req)

    # Lagrange basis (on req) evaluated at rout: L = Veq^{-T} P
    pmat = np.stack([jacobi_p(rout, 0.0, 0.0, i) for i in range(n_p)], axis=0)
    lmat = np.linalg.solve(veq.T, pmat)
    warp = lmat.T @ (rlgl - req)

    zerof = (np.abs(rout) < 1.0 - 1e-10).astype(np.float64)
    sf = 1.0 - (zerof * rout) ** 2
    return warp / sf + warp * (zerof - 1.0)


def equilateral_nodes(n_order: int) -> tuple[np.ndarray, np.ndarray]:
    """Alpha-optimized warp-and-blend interpolation nodes on the
    equilateral triangle."""
    alpha = ALPHA_OPT[n_order - 1] if n_order < 16 else 5.0 / 3.0
    n_p = (n_order + 1) * (n_order + 2) // 2

    L1 = np.empty(n_p)
    L3 = np.empty(n_p)
    idx = 0
    for n in range(n_order + 1):
        for m in range(n_order + 1 - n):
            L1[idx] = n / n_order if n_order > 0 else 0.0
            L3[idx] = m / n_order if n_order > 0 else 0.0
            idx += 1
    L2 = 1.0 - L1 - L3

    x = -L2 + L3
    y = (-L2 - L3 + 2.0 * L1) / np.sqrt(3.0)

    blend1 = 4.0 * L2 * L3
    blend2 = 4.0 * L1 * L3
    blend3 = 4.0 * L1 * L2

    wf1 = warp_factor(n_order, L3 - L2)
    wf2 = warp_factor(n_order, L1 - L3)
    wf3 = warp_factor(n_order, L2 - L1)

    a2 = alpha * alpha
    w1 = blend1 * wf1 * (1.0 + a2 * L1 * L1)
    w2 = blend2 * wf2 * (1.0 + a2 * L2 * L2)
    w3 = blend3 * wf3 * (1.0 + a2 * L3 * L3)

    x = x + 1.0 * w1 + np.cos(2.0 * np.pi / 3.0) * w2 + np.cos(4.0 * np.pi / 3.0) * w3
    y = y + 0.0 * w1 + np.sin(2.0 * np.pi / 3.0) * w2 + np.sin(4.0 * np.pi / 3.0) * w3
    return x, y


def triangle_nodes(n_order: int) -> tuple[np.ndarray, np.ndarray]:
    """Reference-simplex (r,s) warp-and-blend nodes."""
    x, y = equilateral_nodes(n_order)
    return xy_to_rs(x, y)


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

def vandermonde_2d(n_order: int, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    a, b = rs_to_ab(r, s)
    n_p = (n_order + 1) * (n_order + 2) // 2
    V = np.empty((r.size, n_p))
    col = 0
    for i in range(n_order + 1):
        for j in range(n_order - i + 1):
            V[:, col] = simplex_2d_p(a, b, i, j)
            col += 1
    return V


def grad_vandermonde_2d(
    n_order: int, r: np.ndarray, s: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    a, b = rs_to_ab(r, s)
    n_p = (n_order + 1) * (n_order + 2) // 2
    Vr = np.empty((r.size, n_p))
    Vs = np.empty((r.size, n_p))
    col = 0
    for i in range(n_order + 1):
        for j in range(n_order - i + 1):
            Vr[:, col], Vs[:, col] = grad_simplex_2d_p(a, b, i, j)
            col += 1
    return Vr, Vs


def dmatrices_2d(
    n_order: int, r: np.ndarray, s: np.ndarray, V: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Strong (Dr, Ds) and weak (Drw, Dsw) differentiation matrices."""
    Vr, Vs = grad_vandermonde_2d(n_order, r, s)
    Dr = np.linalg.solve(V.T, Vr.T).T
    Ds = np.linalg.solve(V.T, Vs.T).T
    # weak operators: Drw = (V Vr^T)(V V^T)^{-1}
    VVt = V @ V.T
    Drw = np.linalg.solve(VVt.T, (V @ Vr.T).T).T
    Dsw = np.linalg.solve(VVt.T, (V @ Vs.T).T).T
    return Dr, Ds, Drw, Dsw


def build_fmask(r: np.ndarray, s: np.ndarray, n_fp: int) -> np.ndarray:
    """(3, Nfp) node ids on faces s=-1, r+s=0, r=-1 (reference face order)."""
    f1 = np.flatnonzero(np.abs(s + 1.0) < NODE_TOL)
    f2 = np.flatnonzero(np.abs(r + s) < NODE_TOL)
    f3 = np.flatnonzero(np.abs(r + 1.0) < NODE_TOL)
    fmask = np.stack([f1, f2, f3]).astype(np.int32)
    assert fmask.shape == (3, n_fp)
    return fmask


def lift_2d(
    n_order: int, r: np.ndarray, s: np.ndarray, fmask: np.ndarray, V: np.ndarray
) -> np.ndarray:
    """Lift = M^{-1} E with per-edge mass matrices placed by fmask;
    M^{-1} = V V^T for the orthonormal basis."""
    n_p = r.size
    n_fp = fmask.shape[1]
    E = np.zeros((n_p, 3 * n_fp))
    face_coord = (r, r, s)  # the coordinate that varies along each face
    for f in range(3):
        fr = face_coord[f][fmask[f]]
        v1d = vandermonde_1d(n_order, fr)
        mass_edge = np.linalg.inv(v1d @ v1d.T)
        E[fmask[f], f * n_fp : (f + 1) * n_fp] = mass_edge
    return (V @ V.T) @ E


def filter_2d(n_order: int, V: np.ndarray, Nc: float, s_order: int) -> np.ndarray:
    """Exponential modal filter F = V diag(sigma) V^{-1} with
    sigma = exp(-alpha ((deg-Nc)/(N-Nc))^s) for modal degree >= Nc."""
    alpha = -np.log(np.finfo(np.float64).eps)
    n_p = V.shape[0]
    diag = np.ones(n_p)
    idx = 0
    for i in range(n_order + 1):
        for j in range(n_order - i + 1):
            deg = i + j
            if deg >= Nc:
                k = (deg - Nc) / (n_order - Nc)
                diag[idx] = np.exp(-alpha * k**s_order)
            idx += 1
    return (V * diag[None, :]) @ np.linalg.inv(V)


# ---------------------------------------------------------------------------
# Full discretization
# ---------------------------------------------------------------------------

def _build_maps(
    x: np.ndarray,
    y: np.ndarray,
    fmask: np.ndarray,
    mesh: Mesh2D,
    n_p: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """vmapM/vmapP/mapP by physical node matching across faces.

    For each face pair ((k,f) -> (k2,f2)) the Nfp '-' nodes are matched to
    the Nfp '+' nodes by distance (tolerance scaled by edge length).
    Vectorized over all faces at once: distances are an (K*Nf, Nfp, Nfp)
    batch, argmin along the last axis gives the permutation.
    """
    K, Nf = mesh.etoe.shape
    n_fp = fmask.shape[1]

    # vmapM: (K, Nf, Nfp) flat volume indices of face nodes
    vmapM = (np.arange(K, dtype=np.int64)[:, None, None] * n_p + fmask[None, :, :]).astype(
        np.int64
    )

    xf = x.reshape(-1)[vmapM]  # (K, Nf, Nfp)
    yf = y.reshape(-1)[vmapM]

    k2 = mesh.etoe  # (K, Nf)
    f2 = mesh.etof
    # '+' side candidate nodes for every face: (K, Nf, Nfp)
    xP = xf[k2, f2]
    yP = yf[k2, f2]

    # reference edge lengths from the vertices of face f of element k
    fv1 = mesh.etov  # (K, Nf): first vertex of face f is local vertex f
    fv2 = mesh.etov[:, (np.arange(Nf) + 1) % Nf]
    p1, p2 = mesh.verts[fv1], mesh.verts[fv2]
    refd = np.hypot(p1[:, :, 0] - p2[:, :, 0], p1[:, :, 1] - p2[:, :, 1])  # (K, Nf)

    # distance of every '-' node to every '+' node on the matched face
    d = np.hypot(
        xf[:, :, :, None] - xP[:, :, None, :], yf[:, :, :, None] - yP[:, :, None, :]
    )  # (K, Nf, Nfp-, Nfp+)
    jbest = np.argmin(d, axis=3)
    dbest = np.take_along_axis(d, jbest[..., None], axis=3)[..., 0]
    matched = dbest < refd[:, :, None] * NODE_TOL

    vmapP_cand = vmapM[k2[:, :, None], f2[:, :, None], jbest]
    vmapP = np.where(matched, vmapP_cand, vmapM)

    trace_ids = (
        np.arange(K)[:, None, None] * (Nf * n_fp)
        + np.arange(Nf)[None, :, None] * n_fp
        + np.arange(n_fp)[None, None, :]
    )
    mapP_cand = k2[:, :, None] * (Nf * n_fp) + f2[:, :, None] * n_fp + jbest
    mapP = np.where(matched, mapP_cand, trace_ids)

    return (
        vmapM.reshape(K, Nf * n_fp).astype(np.int32),
        vmapP.reshape(K, Nf * n_fp).astype(np.int32),
        mapP.reshape(K, Nf * n_fp).astype(np.int32),
    )


def build_triangle_context(
    n_order: int,
    mesh: Mesh2D,
    dtype: torch.dtype = torch.float64,
    filter_cutoff: float | None = None,
    filter_order: int = 4,
    coords: tuple[np.ndarray, np.ndarray] | None = None,
    device="cuda",
) -> DGContext2D:
    """Assemble the full frozen 2D triangle context from a mesh.

    ``coords`` optionally overrides the straight-sided physical nodes
    (curved-geometry push-back). Everything is computed on the host in
    float64 and then placed on ``device`` in ``dtype``.
    """
    n_p = (n_order + 1) * (n_order + 2) // 2
    n_fp = n_order + 1
    n_faces = 3
    K = mesh.num_elements

    r, s = triangle_nodes(n_order)
    V = vandermonde_2d(n_order, r, s)
    Vinv = np.linalg.inv(V)
    Dr, Ds, Drw, Dsw = dmatrices_2d(n_order, r, s, V)
    fmask = build_fmask(r, s, n_fp)
    lift = lift_2d(n_order, r, s, fmask, V)

    # physical nodes: barycentric blend of the element vertices
    va, vb, vc = mesh.etov[:, 0], mesh.etov[:, 1], mesh.etov[:, 2]
    VX, VY = mesh.verts[:, 0], mesh.verts[:, 1]
    lam = np.stack([-(r + s), 1.0 + r, 1.0 + s], axis=0) * 0.5  # (3, Np)
    if coords is not None:
        x, y = np.asarray(coords[0]), np.asarray(coords[1])
        assert x.shape == (K, n_p)
    else:
        x = lam[0][None, :] * VX[va][:, None] + lam[1][None, :] * VX[vb][:, None] + lam[2][None, :] * VX[vc][:, None]
        y = lam[0][None, :] * VY[va][:, None] + lam[1][None, :] * VY[vb][:, None] + lam[2][None, :] * VY[vc][:, None]

    # metric terms (element-major: x @ Dr.T differentiates each row)
    xr, yr = x @ Dr.T, y @ Dr.T
    xs, ys = x @ Ds.T, y @ Ds.T
    J = xr * ys - xs * yr
    if np.any(J <= 0):
        bad = int(np.sum(J <= 0))
        raise ValueError(f"non-positive Jacobian at {bad} nodes (inverted elements?)")
    rx, ry = ys / J, -xs / J
    sx, sy = -yr / J, xr / J

    # face normals from the metric at face nodes (outward by construction)
    fm_flat = fmask.reshape(-1)
    fxr, fxs = xr[:, fm_flat], xs[:, fm_flat]
    fyr, fys = yr[:, fm_flat], ys[:, fm_flat]
    nx = np.empty((K, n_faces * n_fp))
    ny = np.empty((K, n_faces * n_fp))
    sl = [slice(f * n_fp, (f + 1) * n_fp) for f in range(3)]
    # face 1: s=-1;  face 2: r+s=0;  face 3: r=-1
    nx[:, sl[0]], ny[:, sl[0]] = fyr[:, sl[0]], -fxr[:, sl[0]]
    nx[:, sl[1]], ny[:, sl[1]] = fys[:, sl[1]] - fyr[:, sl[1]], -fxs[:, sl[1]] + fxr[:, sl[1]]
    nx[:, sl[2]], ny[:, sl[2]] = -fys[:, sl[2]], fxs[:, sl[2]]
    sJ = np.hypot(nx, ny)
    nx /= sJ
    ny /= sJ
    fscale = sJ / J[:, fm_flat]

    vmapM, vmapP, mapP = _build_maps(x, y, fmask, mesh, n_p)

    # boundary maps: where vmapP == vmapM
    trace_flat = vmapP.reshape(-1) == vmapM.reshape(-1)
    mapB_list = np.flatnonzero(trace_flat)
    nB = max(1, mapB_list.size)
    mapB = np.zeros(nB, dtype=np.int32)
    maskB = np.zeros(nB, dtype=bool)
    mapB[: mapB_list.size] = mapB_list
    maskB[: mapB_list.size] = True
    vmapB = vmapM.reshape(-1)[mapB]

    bc_maps = BCMaps.from_bc_table(mesh.bc_type, n_fp, device=device)

    # SEM gather/scatter: first-occurrence unique of physical node coords
    coords_all = np.stack([x.reshape(-1), y.reshape(-1)], axis=1)
    rounded = np.round(coords_all / 1e-9) * 1e-9
    _, gather_ids, scatter_ids = np.unique(
        rounded, axis=0, return_index=True, return_inverse=True
    )

    filt = (
        filter_2d(n_order, V, filter_cutoff, filter_order)
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
