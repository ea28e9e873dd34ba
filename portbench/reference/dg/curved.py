"""Frozen copy of ``blitzdg_tpu_torch/mesh/curved.py`` at commit dfe7828,
trimmed to the circle.

Curved-boundary element deformation via Gordon-Hall blending.

Host-side numpy. Counterpart of the JAX package's
``blitzdg_tpu/mesh/curved.py`` (own copy: the port imports nothing of that
package): snap boundary vertices onto a parametric curve, move boundary-face
nodes onto the curve, and blend the face deformation into the element
interior with the standard Gordon-Hall blending functions (Hesthaven &
Warburton, MakeCylinder2D).

The curve is given as a projection function ``project(x, y) -> (xc, yc)``
mapping near-boundary points onto the curve (for a circle: radial
projection), or fitted through ordered boundary points by
``spline_boundary_projection``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .triangle import triangle_nodes
from .vandermonde import vandermonde_1d
from .gmsh import Mesh2D


def snap_boundary_vertices(
    mesh: Mesh2D, project: Callable, tol: float
) -> list[tuple[int, int]]:
    """Snap boundary-face vertices within ``tol`` of the curve onto it.
    Returns the list of (element, face) curved faces. Mutates mesh.verts."""
    K, Nf = mesh.etov.shape
    curved_faces = []
    for k in range(K):
        for f in range(Nf):
            if mesh.etoe[k, f] == k and mesh.etof[k, f] == f:  # boundary face
                v1 = mesh.etov[k, f]
                v2 = mesh.etov[k, (f + 1) % Nf]
                p1, p2 = mesh.verts[v1], mesh.verts[v2]
                c1 = np.asarray(project(p1[0], p1[1]))
                c2 = np.asarray(project(p2[0], p2[1]))
                if np.hypot(*(p1 - c1)) <= tol and np.hypot(*(p2 - c2)) <= tol:
                    mesh.verts[v1] = c1
                    mesh.verts[v2] = c2
                    curved_faces.append((k, f))
    return curved_faces


def gordon_hall_deform(
    n_order: int,
    mesh: Mesh2D,
    x: np.ndarray,
    y: np.ndarray,
    curved_faces: list[tuple[int, int]],
    project: Callable,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deform (x, y) nodal coordinates of curved elements.

    For each curved face: project its face nodes onto the curve, extend the
    1D face deformation to the volume via the 1D Vandermonde in the face
    coordinate, and blend with the Gordon-Hall functions
    (1 + r)/(1 - s)-type functions. Returns (x, y, curved element ids).
    """
    from .triangle import build_fmask

    r, s = triangle_nodes(n_order)
    n_fp = n_order + 1
    fmask = build_fmask(r, s, n_fp)
    x = x.copy()
    y = y.copy()

    # face coordinate (the one that varies along the face) per face id
    face_coord = (r, s, s)
    curved_els = []
    for (k, f) in curved_faces:
        curved_els.append(k)
        vr = face_coord[f]
        fm = fmask[f]
        fr = vr[fm]

        # project face nodes onto the curve
        fx, fy = x[k, fm], y[k, fm]
        px, py = np.empty_like(fx), np.empty_like(fy)
        for i in range(n_fp):
            px[i], py[i] = project(fx[i], fy[i])
        fdx = px - fx
        fdy = py - fy

        # extend 1D face deformation to all volume nodes via modal interp
        vface = vandermonde_1d(n_order, fr)
        vvol = vandermonde_1d(n_order, vr)
        vdx = vvol @ np.linalg.solve(vface, fdx)
        vdy = vvol @ np.linalg.solve(vface, fdy)

        # Gordon-Hall blending
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = 1.0 - vr
            ids = np.abs(denom) > 1e-7
            blend = np.zeros_like(vr)
            if f == 0:
                blend[ids] = -(r[ids] + s[ids]) / denom[ids]
            elif f == 1:
                blend[ids] = (r[ids] + 1.0) / denom[ids]
            else:
                blend[ids] = -(r[ids] + s[ids]) / denom[ids]

        x[k, ids] += blend[ids] * vdx[ids]
        y[k, ids] += blend[ids] * vdy[ids]

    return x, y, np.unique(np.asarray(curved_els, dtype=np.int32))


def circle_projection(cx: float, cy: float, radius: float) -> Callable:
    """Radial projection onto a circle of given center/radius."""

    def project(x, y):
        dx, dy = x - cx, y - cy
        d = np.hypot(dx, dy)
        if d < 1e-14:
            return cx + radius, cy
        return cx + radius * dx / d, cy + radius * dy / d

    return project
