"""Curved-boundary element deformation via Gordon-Hall blending.

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

from ..specgrid.triangle import triangle_nodes
from ..specgrid.vandermonde import vandermonde_1d
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
    from ..specgrid.triangle import build_fmask

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


def boundary_loops(mesh: Mesh2D, bc_tag: int | None = None) -> list[np.ndarray]:
    """Ordered boundary vertex loops (host-side). Walks the boundary edges
    (optionally only those with the given BC tag) and chains them into
    closed/open loops of vertex indices: the "boundary point cloud ->
    ordered curve" step."""
    K, Nf = mesh.etov.shape
    bc = np.asarray(mesh.bc_type)
    edges = []
    for k in range(K):
        for f in range(Nf):
            if bc[k, f] > 0 and (bc_tag is None or bc[k, f] == bc_tag):
                edges.append((int(mesh.etov[k, f]),
                              int(mesh.etov[k, (f + 1) % Nf])))
    nxt = {a: b for a, b in edges}
    loops = []
    seen = set()
    for a, _ in edges:
        if a in seen:
            continue
        loop = [a]
        seen.add(a)
        cur = a
        while cur in nxt and nxt[cur] not in seen:
            cur = nxt[cur]
            loop.append(cur)
            seen.add(cur)
        closed = cur in nxt and nxt[cur] == loop[0]
        loops.append(np.asarray(loop, dtype=np.int64) if not closed
                     else np.asarray(loop + [loop[0]], dtype=np.int64))
    return loops


def spline_boundary_projection(
    points: np.ndarray,  # (n, 2) ordered boundary points
    periodic: bool = True,
    smoothing: float = 0.0,
    n_samples: int = 4096,
) -> Callable:
    """Spline-fit boundary adapter: fit a parametric spline through an
    ORDERED boundary point list and return a ``project(x, y) -> (xc, yc)``
    closest-point projection onto the fitted curve, so that the Gordon-Hall
    deformation (``gordon_hall_deform``) can consume real coastline point
    data directly.

    Projection = dense arc-length sampling + one Newton refinement of the
    squared-distance minimization (host-side, setup only).
    """
    from scipy.interpolate import splev, splprep

    pts = np.asarray(points, dtype=float)
    if periodic and np.hypot(*(pts[0] - pts[-1])) > 1e-12:
        pts = np.vstack([pts, pts[0]])
    (tck, _) = splprep([pts[:, 0], pts[:, 1]], s=smoothing, per=periodic,
                       k=3)
    uu = np.linspace(0.0, 1.0, n_samples, endpoint=not periodic)
    cx, cy = splev(uu, tck)
    cx, cy = np.asarray(cx), np.asarray(cy)

    def project(x, y):
        d2 = (cx - x) ** 2 + (cy - y) ** 2
        i = int(np.argmin(d2))
        u = uu[i]
        # one Newton step on g(u) = d/du |c(u) - p|^2
        for _ in range(3):
            px, py = splev(u, tck)
            dx, dy = splev(u, tck, der=1)
            ddx, ddy = splev(u, tck, der=2)
            ex, ey = px - x, py - y
            g = ex * dx + ey * dy
            gp = dx * dx + dy * dy + ex * ddx + ey * ddy
            if abs(gp) < 1e-30:
                break
            u_new = u - g / gp
            if periodic:
                u_new = u_new % 1.0
            else:
                u_new = min(max(u_new, 0.0), 1.0)
            if abs(u_new - u) < 1e-14:
                u = u_new
                break
            u = u_new
        px, py = splev(u, tck)
        return float(px), float(py)

    return project
