"""Structured mesh generators (standalone test/benchmark fixtures).

Host-side numpy. Counterpart of the JAX package's
``blitzdg_tpu/mesh/generators.py``; only ``box_triangles`` is ported so far.
"""
from __future__ import annotations

import numpy as np

from ..context import BC_WALL
from .gmsh import Mesh2D, build_mesh


def box_triangles(nx: int, ny: int, xlim=(-1.0, 1.0), ylim=(-1.0, 1.0),
                  default_bc: int = BC_WALL) -> Mesh2D:
    """Uniform triangulated rectangle: nx*ny cells, 2 triangles each
    (K = 2*nx*ny)."""
    xs = np.linspace(*xlim, nx + 1)
    ys = np.linspace(*ylim, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            # split along the cell diagonal, alternating for isotropy
            if (i + j) % 2 == 0:
                tris.append([v00, v10, v11])
                tris.append([v00, v11, v01])
            else:
                tris.append([v00, v10, v01])
                tris.append([v10, v11, v01])
    return build_mesh(verts, np.asarray(tris, dtype=np.int32), default_bc)
