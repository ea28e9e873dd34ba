"""Frozen copy of ``blitzdg_tpu_torch/mesh/gmsh.py`` at commit dfe7828, trimmed
to the in-memory mesh: no file reader or writer.

Gmsh 2.x ASCII mesh reader and in-memory mesh construction.

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

from .context import BC_WALL
from .connectivity import build_connectivity


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
