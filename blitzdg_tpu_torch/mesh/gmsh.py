"""Gmsh 2.x ASCII mesh reader and in-memory mesh construction.

Host-side setup (numpy only). Counterpart of the JAX package's
``blitzdg_tpu/mesh/gmsh.py`` (``Mesh2D``, ``build_mesh``, ``set_bc_type``,
``read_gmsh``, ``write_gmsh``, ``read_csv_mesh``): $MeshFormat validation (2.x ASCII, 8-byte reals), $Nodes /
$Elements parsing with element-type dispatch (15=point, 1=line, 2=triangle,
3=quadrangle), CCW re-orientation via the signed determinant, then face
connectivity and a default-Wall boundary table. Boundary *line* elements
carrying Gmsh physical tags are matched to element faces by vertex pair so
physical-group BCs survive. Connectivity takes the numpy path here; the
native helper (``blitzdg_tpu_torch.native.build_connectivity``) gives the
same tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..context import BC_WALL
from .connectivity import build_connectivity, match_line_tags


@dataclass
class Mesh2D:
    """Host-side unstructured 2D mesh (triangles or quads)."""

    verts: np.ndarray  # (Nv, 2) float64
    etov: np.ndarray  # (K, Nfaces) int32, CCW
    etoe: np.ndarray = field(default=None)  # (K, Nfaces) int32
    etof: np.ndarray = field(default=None)  # (K, Nfaces) int32
    bc_type: np.ndarray = field(default=None)  # (K, Nfaces) int32 tags
    # boundary line elements from the file: (n_lines, 2) vertex ids + tags
    boundary_lines: np.ndarray | None = None
    boundary_tags: np.ndarray | None = None

    @property
    def num_elements(self) -> int:
        return self.etov.shape[0]

    @property
    def num_faces(self) -> int:
        return self.etov.shape[1]

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]

    def set_bc_type(self, bc: np.ndarray) -> None:
        bc = np.asarray(bc, dtype=np.int32)
        assert bc.shape == self.etov.shape
        self.bc_type = bc


def _orient_ccw(verts: np.ndarray, etov: np.ndarray) -> np.ndarray:
    """Flip vertex order (swap 2nd/3rd) where the signed area is negative."""
    a = verts[etov[:, 0]]
    b = verts[etov[:, 1]]
    c = verts[etov[:, 2]]
    det = (a[:, 0] - c[:, 0]) * (b[:, 1] - c[:, 1]) - (b[:, 0] - c[:, 0]) * (
        a[:, 1] - c[:, 1]
    )
    flip = det < 0
    out = etov.copy()
    out[flip, 1], out[flip, 2] = etov[flip, 2], etov[flip, 1]
    return out


def build_mesh(verts: np.ndarray, etov: np.ndarray, default_bc: int = BC_WALL) -> Mesh2D:
    """Construct a mesh from raw vertex/element arrays."""
    verts = np.asarray(verts, dtype=np.float64)[:, :2]
    etov = np.asarray(etov, dtype=np.int32)
    etov = _orient_ccw(verts, etov)
    mesh = Mesh2D(verts=verts, etov=etov)
    mesh.etoe, mesh.etof = build_connectivity(etov)
    mesh.bc_type = default_boundary_table(mesh, default_bc)
    return mesh


def default_boundary_table(mesh: Mesh2D, tag: int = BC_WALL) -> np.ndarray:
    """Tag every self-referential (boundary) face; interior faces get 0."""
    K, Nf = mesh.etov.shape
    bc = np.zeros((K, Nf), dtype=np.int32)
    boundary = mesh.etoe == np.arange(K, dtype=np.int32)[:, None]
    boundary &= mesh.etof == np.arange(Nf, dtype=np.int32)[None, :]
    bc[boundary] = tag
    return bc


def read_gmsh(path: str, default_bc: int = BC_WALL, apply_line_tags: bool = True) -> Mesh2D:
    """Parse a Gmsh 2.x ASCII .msh file into a :class:`Mesh2D`."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0

    def expect(marker: str):
        nonlocal i
        if lines[i] != marker:
            raise ValueError(f"expected {marker!r} at line {i + 1}, got {lines[i]!r}")
        i += 1

    expect("$MeshFormat")
    vers_str, file_type, float_size = lines[i].split()[:3]
    i += 1
    vers = float(vers_str)
    if not (2.0 <= vers < 3.0):
        raise ValueError("only Gmsh 2.x ASCII meshes are supported")
    if int(file_type) != 0:
        raise ValueError("only ASCII Gmsh files are supported")
    if int(float_size) != 8:
        raise ValueError("only 8-byte reals are supported")
    expect("$EndMeshFormat")

    expect("$Nodes")
    n_verts = int(lines[i])
    i += 1
    verts = np.zeros((n_verts, 2), dtype=np.float64)
    for _ in range(n_verts):
        parts = lines[i].split()
        i += 1
        verts[int(parts[0]) - 1] = (float(parts[1]), float(parts[2]))
    expect("$EndNodes")

    expect("$Elements")
    n_rows = int(lines[i])
    i += 1
    tris, quads, blines, btags = [], [], [], []
    for _ in range(n_rows):
        parts = lines[i].split()
        i += 1
        etype = int(parts[1])
        ntags = int(parts[2])
        tags = [int(t) for t in parts[3 : 3 + ntags]]
        vids = [int(v) - 1 for v in parts[3 + ntags :]]
        if etype == 2:
            tris.append(vids)
        elif etype == 3:
            quads.append(vids)
        elif etype == 1:
            blines.append(vids)
            btags.append(tags[0] if tags else 0)
        # type 15 (points) ignored
    expect("$EndElements")

    if quads and not tris:
        etov = np.asarray(quads, dtype=np.int32)
    elif tris:
        etov = np.asarray(tris, dtype=np.int32)
    else:
        raise ValueError("mesh contains no triangles or quadrangles")

    etov = _orient_ccw(verts, etov)
    mesh = Mesh2D(verts=verts, etov=etov)
    mesh.etoe, mesh.etof = build_connectivity(etov)
    mesh.bc_type = default_boundary_table(mesh, default_bc)
    if blines:
        mesh.boundary_lines = np.asarray(blines, dtype=np.int32)
        mesh.boundary_tags = np.asarray(btags, dtype=np.int32)
        if apply_line_tags:
            match_line_tags(mesh)
    return mesh


def write_gmsh(path: str, mesh: Mesh2D) -> None:
    """Write a Gmsh 2.2 ASCII file (round-trip support for fixtures)."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.num_verts}\n")
        for n, (x, y) in enumerate(mesh.verts, start=1):
            f.write(f"{n} {float(x):.17g} {float(y):.17g} 0\n")
        f.write("$EndNodes\n$Elements\n")
        n_lines = 0 if mesh.boundary_lines is None else len(mesh.boundary_lines)
        f.write(f"{mesh.num_elements + n_lines}\n")
        row = 1
        etype = 2 if mesh.num_faces == 3 else 3
        if mesh.boundary_lines is not None:
            for (v0, v1), tag in zip(mesh.boundary_lines, mesh.boundary_tags):
                f.write(f"{row} 1 2 {tag} {tag} {v0 + 1} {v1 + 1}\n")
                row += 1
        for k in range(mesh.num_elements):
            vs = " ".join(str(v + 1) for v in mesh.etov[k])
            f.write(f"{row} {etype} 2 0 0 {vs}\n")
            row += 1
        f.write("$EndElements\n")


def read_csv_mesh(vertices_path: str, elements_path: str,
                  default_bc: int = BC_WALL) -> Mesh2D:
    """Build a mesh from whitespace-delimited vertex/element files. Vertex
    rows are x y [z]; element rows are 0-based vertex ids (triangles or
    quads by column count)."""
    from ..io.csv import csvread

    verts = csvread(vertices_path, float)[:, :2]
    etov = csvread(elements_path, float).astype(np.int64)
    return build_mesh(verts, etov, default_bc=default_bc)
