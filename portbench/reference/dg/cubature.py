"""Frozen copy of ``blitzdg_tpu_torch/specgrid/cubature.py (and its
_cubature_tables.npz)`` at commit dfe7828, unchanged but for import paths.

Cubature volume and Gauss face contexts for curved/over-integrated DG.

Counterpart of the JAX package's ``blitzdg_tpu/specgrid/cubature.py``
(``duffy_cubature``, ``triangle_cubature``, ``CubatureContext2D``,
``GaussFaceContext2D``, ``build_cubature_context``,
``build_gauss_face_context``). Host-side numpy in float64; the contexts are
frozen dataclasses of tensors placed on ``device`` in ``dtype``:

 - ``CubatureContext2D``: cubature nodes/weights, interpolation V, Dr/Ds at
   the cubature nodes, geometric factors, W = w*J, per-element mass MM, its
   Cholesky factor and its inverse (K, Np, Np), inverted in float64;
 - ``GaussFaceContext2D``: per-face Gauss nodes, interpolation, face
   geometry and normals, W = w*sJ, the trace maps mapM/mapP (built by
   matching physical coordinates) and per-tag boundary node lists.

Cubature rules come from ``_cubature_tables.npz`` beside this module (this
package's own copy of the node-eliminated compact rules) when the order is
tabulated, else from the collapsed Gauss (Duffy) construction.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .context import BC_TAGS, _tree_to
from .jacobi import gauss_quadrature
from .triangle import grad_vandermonde_2d, vandermonde_2d


def duffy_cubature(order: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Positive-weight cubature on the reference triangle exact to the given
    polynomial order, via the collapsed (Duffy) construction: the generator
    that is always available (n^2 points for order 2n-1)."""
    n = max(1, (order + 2) // 2)  # 1D points: order 2n-1 >= order
    ga, wa = gauss_quadrature(0.0, 0.0, n - 1)  # Legendre in 'a'
    gb, wb = gauss_quadrature(1.0, 0.0, n - 1)  # Jacobi(1,0) in 'b': (1-b) weight
    A, B = np.meshgrid(ga, gb, indexing="ij")
    r = (0.5 * (1.0 + A) * (1.0 - B) - 1.0).reshape(-1)
    s = B.reshape(-1)
    w = (np.outer(wa, wb) * 0.5).reshape(-1)
    # total weight = triangle area = 2
    return r, s, w


_COMPACT_TABLES = None


def _load_compact_tables():
    global _COMPACT_TABLES
    if _COMPACT_TABLES is None:
        path = os.path.join(os.path.dirname(__file__), "_cubature_tables.npz")
        _COMPACT_TABLES = np.load(path) if os.path.exists(path) else {}
    return _COMPACT_TABLES


def triangle_cubature(order: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Positive-weight cubature exact to ``order``: the node-eliminated
    compact rule (about a quarter fewer points than the tensor rule at the
    curved pipeline's orders) when tabulated, else the collapsed Duffy rule.
    Every curved volume term pays the point count in the hot loop."""
    t = _load_compact_tables()
    if f"r{order}" in getattr(t, "files", t):
        return (np.asarray(t[f"r{order}"]), np.asarray(t[f"s{order}"]),
                np.asarray(t[f"w{order}"]))
    return duffy_cubature(order)


@dataclass(frozen=True)
class CubatureContext2D:
    """Frozen cubature volume context (element-major)."""

    n_cub: int
    r: torch.Tensor  # (Ncub,)
    s: torch.Tensor
    w: torch.Tensor
    V: torch.Tensor  # (Ncub, Np) interpolation
    Dr: torch.Tensor  # (Ncub, Np) derivative interpolation
    Ds: torch.Tensor
    # per-element at cubature nodes, (K, Ncub)
    x: torch.Tensor
    y: torch.Tensor
    J: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    W: torch.Tensor  # w * J
    # per-element custom mass matrices, (K, Np, Np)
    MM: torch.Tensor
    MMchol: torch.Tensor
    MMinv: torch.Tensor

    def to(self, device) -> "CubatureContext2D":
        return _tree_to(self, device)


@dataclass(frozen=True)
class GaussFaceContext2D:
    """Frozen Gauss face context (element-major)."""

    n_gauss: int  # points per face
    interp: torch.Tensor  # (Nfaces*NG, Np) volume->face-gauss interpolation
    # per-face-gauss-node, (K, Nfaces*NG)
    x: torch.Tensor
    y: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    sJ: torch.Tensor
    W: torch.Tensor  # w1d * sJ
    mapM: torch.Tensor  # (K, Nfaces*NG) int64, flat into (K*Nfaces*NG,)
    mapP: torch.Tensor
    bc_idx: dict[int, torch.Tensor]  # per tag: padded flat node list
    bc_mask: dict[int, torch.Tensor]  # per tag: valid entries of the list
    # derivative interpolation and per-element geometric factors at the
    # face Gauss nodes (a curved interior-penalty operator needs the basis'
    # normal derivatives at the faces)
    Dr: torch.Tensor  # (Nfaces*NG, Np)
    Ds: torch.Tensor
    rx: torch.Tensor  # (K, Nfaces*NG)
    ry: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    J: torch.Tensor

    def to(self, device) -> "GaussFaceContext2D":
        return _tree_to(self, device)


def _placer(dtype: torch.dtype, device):
    def to(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                               dtype=dtype, device=device)
    return to


def build_cubature_context(n_order, mesh, x, y, V_nodal, order=None,
                           dtype: torch.dtype = torch.float64,
                           device="cuda") -> CubatureContext2D:
    """Cubature context from nodal geometry (x, y are (K, Np) numpy)."""
    if order is None:
        order = 3 * (n_order + 1)
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    V_nodal = np.asarray(V_nodal, np.float64)
    rc, sc, wc = triangle_cubature(order)

    Vc = np.linalg.solve(V_nodal.T, vandermonde_2d(n_order, rc, sc).T).T
    Vrc, Vsc = grad_vandermonde_2d(n_order, rc, sc)
    Drc = np.linalg.solve(V_nodal.T, Vrc.T).T
    Dsc = np.linalg.solve(V_nodal.T, Vsc.T).T

    xr, yr = x @ Drc.T, y @ Drc.T
    xs, ys = x @ Dsc.T, y @ Dsc.T
    J = xr * ys - xs * yr
    rx, ry = ys / J, -xs / J
    sx, sy = -yr / J, xr / J
    W = wc[None, :] * J

    # per-element mass MM_k = Vc^T diag(W_k) Vc, batched
    MM = np.einsum("ci,kc,cj->kij", Vc, W, Vc)
    MMchol = np.linalg.cholesky(MM)
    MMinv = np.linalg.inv(MM)

    to = _placer(dtype, device)
    return CubatureContext2D(
        n_cub=rc.size,
        r=to(rc), s=to(sc), w=to(wc),
        V=to(Vc), Dr=to(Drc), Ds=to(Dsc),
        x=to(x @ Vc.T), y=to(y @ Vc.T),
        J=to(J), rx=to(rx), ry=to(ry), sx=to(sx), sy=to(sy), W=to(W),
        MM=to(MM), MMchol=to(MMchol), MMinv=to(MMinv),
    )


def build_gauss_face_context(n_order, mesh, x, y, V_nodal, n_gauss=None,
                             dtype: torch.dtype = torch.float64,
                             device="cuda") -> GaussFaceContext2D:
    """Gauss face context from nodal geometry; maps by coordinate matching."""
    if n_gauss is None:
        n_gauss = 2 * (n_order + 1)
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    V_nodal = np.asarray(V_nodal, np.float64)
    K = x.shape[0]
    NG = n_gauss
    g1, w1 = gauss_quadrature(0.0, 0.0, NG - 1)

    # (r,s) of Gauss points on each reference face (v0->v1, v1->v2, v2->v0)
    face_ends = [((-1.0, -1.0), (1.0, -1.0)), ((1.0, -1.0), (-1.0, 1.0)),
                 ((-1.0, 1.0), (-1.0, -1.0))]
    interp_rows, dr_rows, ds_rows = [], [], []
    for (r0, s0), (r1, s1) in face_ends:
        rf = 0.5 * (1 - g1) * r0 + 0.5 * (1 + g1) * r1
        sf = 0.5 * (1 - g1) * s0 + 0.5 * (1 + g1) * s1
        interp_rows.append(
            np.linalg.solve(V_nodal.T, vandermonde_2d(n_order, rf, sf).T).T)
        Vr, Vs = grad_vandermonde_2d(n_order, rf, sf)
        dr_rows.append(np.linalg.solve(V_nodal.T, Vr.T).T)
        ds_rows.append(np.linalg.solve(V_nodal.T, Vs.T).T)
    interp = np.concatenate(interp_rows, axis=0)  # (3NG, Np)
    Drg = np.concatenate(dr_rows, axis=0)
    Dsg = np.concatenate(ds_rows, axis=0)

    xg = x @ interp.T  # (K, 3NG)
    yg = y @ interp.T
    xr, yr = x @ Drg.T, y @ Drg.T
    xs, ys = x @ Dsg.T, y @ Dsg.T
    Jg = xr * ys - xs * yr

    nx = np.empty((K, 3 * NG))
    ny = np.empty((K, 3 * NG))
    sl = [slice(f * NG, (f + 1) * NG) for f in range(3)]
    nx[:, sl[0]], ny[:, sl[0]] = yr[:, sl[0]], -xr[:, sl[0]]
    nx[:, sl[1]], ny[:, sl[1]] = (ys[:, sl[1]] - yr[:, sl[1]],
                                  -xs[:, sl[1]] + xr[:, sl[1]])
    nx[:, sl[2]], ny[:, sl[2]] = -ys[:, sl[2]], xs[:, sl[2]]
    sJ = np.hypot(nx, ny)
    nx /= sJ
    ny /= sJ
    W = np.tile(w1, 3)[None, :] * sJ

    # trace maps by coordinate matching (as for the nodal context)
    k2 = mesh.etoe
    f2 = mesh.etof
    xg3 = xg.reshape(K, 3, NG)
    yg3 = yg.reshape(K, 3, NG)
    xP = xg3[k2, f2]  # (K, 3, NG) neighbor's face points
    yP = yg3[k2, f2]
    d = np.hypot(xg3[:, :, :, None] - xP[:, :, None, :],
                 yg3[:, :, :, None] - yP[:, :, None, :])
    jbest = np.argmin(d, axis=3)
    dbest = np.take_along_axis(d, jbest[..., None], axis=3)[..., 0]
    # tolerance scaled by the face diameter (independent of the mesh's unit)
    face_diam = np.hypot(xg3[:, :, 0] - xg3[:, :, -1],
                         yg3[:, :, 0] - yg3[:, :, -1])
    matched = dbest < 1e-6 * face_diam[:, :, None] + 1e-13

    trace_ids = (np.arange(K)[:, None, None] * (3 * NG)
                 + np.arange(3)[None, :, None] * NG
                 + np.arange(NG)[None, None, :])
    mapP_cand = k2[:, :, None] * (3 * NG) + f2[:, :, None] * NG + jbest
    mapP = np.where(matched, mapP_cand, trace_ids).reshape(K, 3 * NG)
    mapM = trace_ids.reshape(K, 3 * NG)

    # per-tag boundary Gauss-node lists from the face tag table
    bc_idx, bc_mask = {}, {}
    for tag in BC_TAGS:
        faces = np.argwhere(mesh.bc_type == tag)
        flat = ((faces[:, 0] * 3 + faces[:, 1])[:, None] * NG
                + np.arange(NG)[None, :]).ravel()
        n = flat.size
        size = max(1, n)
        pidx = np.zeros(size, dtype=np.int64)
        pidx[:n] = flat
        pm = np.zeros(size, dtype=bool)
        pm[:n] = True
        bc_idx[tag] = torch.as_tensor(pidx, device=device)
        bc_mask[tag] = torch.as_tensor(pm, device=device)

    to = _placer(dtype, device)
    to_idx = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
    return GaussFaceContext2D(
        n_gauss=NG,
        interp=to(interp),
        x=to(xg), y=to(yg), nx=to(nx), ny=to(ny), sJ=to(sJ), W=to(W),
        mapM=to_idx(mapM), mapP=to_idx(mapP),
        bc_idx=bc_idx, bc_mask=bc_mask,
        Dr=to(Drg), Ds=to(Dsg),
        rx=to(ys / Jg), ry=to(-xs / Jg),
        sx=to(-yr / Jg), sy=to(xr / Jg),
        J=to(Jg),
    )
