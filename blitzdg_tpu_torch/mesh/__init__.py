from .connectivity import build_connectivity
from .generators import box_triangles, disk_triangles
from .gmsh import Mesh2D, build_mesh, read_gmsh

__all__ = [
    "Mesh2D",
    "build_mesh",
    "read_gmsh",
    "build_connectivity",
    "box_triangles",
    "disk_triangles",
]
