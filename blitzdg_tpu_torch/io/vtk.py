"""VTK unstructured-grid (.vtu XML) writer with high-order subdivision.

Counterpart of the JAX package's ``blitzdg_tpu/io/vtk.py``: high-order
elements are subdivided into linear sub-cells before writing; a
dict-of-fields batch writer emits one file per time index. Written against
the VTK XML format spec, no VTK library dependency. Contexts and fields may
hold tensors on either device (or numpy arrays); the file is the JAX
writer's, byte for byte, for the same values.
"""
from __future__ import annotations

import numpy as np

from .csv import _host

VTK_TRIANGLE = 5
VTK_QUAD = 9


def split_triangle_indices(n_order: int) -> np.ndarray:
    """Subdivide the (i,j) node lattice of a degree-N triangle into linear
    sub-triangles; returns (n_sub, 3) local node indices matching the
    equilateral_nodes ordering (n outer, m inner)."""
    def idx(n, m):
        # row n holds N+1-n nodes; rows 0..n-1 precede it
        return n * (n_order + 1) - (n * (n - 1)) // 2 + m

    tris = []
    for n in range(n_order):
        for m in range(n_order - n):
            tris.append([idx(n, m), idx(n, m + 1), idx(n + 1, m)])
            if m < n_order - n - 1:
                tris.append([idx(n, m + 1), idx(n + 1, m + 1), idx(n + 1, m)])
    return np.asarray(tris, dtype=np.int64)


def split_quad_indices(n_order: int) -> np.ndarray:
    """Subdivide the (N+1)^2 lattice into linear quads (VTK node order)."""
    npts = n_order + 1

    def idx(i, j):  # j rows (s), i cols (r): r varies fastest
        return j * npts + i

    quads = []
    for j in range(n_order):
        for i in range(n_order):
            quads.append([idx(i, j), idx(i + 1, j), idx(i + 1, j + 1), idx(i, j + 1)])
    return np.asarray(quads, dtype=np.int64)


def write_vtu(path: str, ctx, fields: dict) -> None:
    """Write nodal fields on a 2D DG context to a .vtu file.

    Every element contributes its Np nodes as distinct points (DG fields are
    discontinuous); high-order elements are subdivided into linear cells.
    """
    x = _host(ctx.x)
    y = _host(ctx.y)
    K, n_p = x.shape
    if ctx.n_faces == 3:
        sub = split_triangle_indices(ctx.n_order)
        cell_type = VTK_TRIANGLE
        nodes_per_cell = 3
    else:
        sub = split_quad_indices(ctx.n_order)
        cell_type = VTK_QUAD
        nodes_per_cell = 4

    n_points = K * n_p
    n_cells = K * len(sub)
    conn = (np.arange(K)[:, None, None] * n_p + sub[None, :, :]).reshape(-1, nodes_per_cell)

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        f.write("<UnstructuredGrid>\n")
        f.write(f'<Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">\n')

        f.write('<Points>\n<DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        pts = np.stack([x.reshape(-1), y.reshape(-1), np.zeros(n_points)], axis=1)
        np.savetxt(f, pts, fmt="%.12g")
        f.write("</DataArray>\n</Points>\n")

        f.write("<Cells>\n")
        f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
        np.savetxt(f, conn, fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="Int64" Name="offsets" format="ascii">\n')
        np.savetxt(f, np.arange(1, n_cells + 1) * nodes_per_cell, fmt="%d")
        f.write("</DataArray>\n")
        f.write('<DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(f, np.full(n_cells, cell_type), fmt="%d")
        f.write("</DataArray>\n</Cells>\n")

        f.write("<PointData>\n")
        for name, data in fields.items():
            arr = _host(data).reshape(-1)
            assert arr.size == n_points, f"field {name}: {arr.size} != {n_points}"
            f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
            np.savetxt(f, arr, fmt="%.12g")
            f.write("</DataArray>\n")
        f.write("</PointData>\n")

        f.write("</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


def generate_file_name(base: str, index: int, ext: str = "vtu") -> str:
    """field%07d naming, as the CSV writer's."""
    return f"{base}{index:07d}.{ext}"


def write_fields_to_files(ctx, fields: dict, index: int, out_dir: str = ".") -> str:
    """Dict-of-fields batch writer: one file named after the first field."""
    import os

    name = list(fields.keys())[0] if fields else "field"
    path = os.path.join(out_dir, generate_file_name(name, index))
    write_vtu(path, ctx, {k: _host(v) for k, v in fields.items()})
    return path
