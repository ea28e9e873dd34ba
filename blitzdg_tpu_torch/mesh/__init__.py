from .connectivity import build_connectivity
from .generators import box_quads, box_triangles, disk_triangles
from .gmsh import (Mesh2D, build_mesh, read_csv_mesh, read_gmsh,
                   write_gmsh)

__all__ = [
    "Mesh2D",
    "build_mesh",
    "read_gmsh",
    "write_gmsh",
    "read_csv_mesh",
    "build_connectivity",
    "box_triangles",
    "box_quads",
    "disk_triangles",
]
