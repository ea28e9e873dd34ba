"""Element orderings.

Counterpart of the JAX package's ``blitzdg_tpu/parallel/partition.py``; only
``rcm_order`` is ported so far (the partitioners come with the sharded
path). On a GPU the '+' traces are index gathers through ``vmapP`` for any
element numbering, so the ordering is a locality tool here (neighbouring
elements land in the same or a nearby thread block), not a precondition of
the blocked kernels as it is for the TPU's roll-based trace exchange.
"""
from __future__ import annotations

import numpy as np

from ..mesh.gmsh import Mesh2D, build_mesh


def rcm_order(mesh: Mesh2D) -> tuple[Mesh2D, np.ndarray]:
    """Reorder elements by reverse Cuthill-McKee over the face-adjacency
    graph, which bounds the index distance between neighbouring elements to
    about sqrt(K). Returns (reordered mesh, permutation old-index-of-new)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    K, nf = mesh.etoe.shape
    rows = np.repeat(np.arange(K), nf)
    cols = mesh.etoe.reshape(-1)
    A = sp.coo_matrix((np.ones(K * nf), (rows, cols)), shape=(K, K)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    new_mesh = build_mesh(mesh.verts, mesh.etov[perm])
    if mesh.bc_type is not None:
        new_mesh.bc_type = mesh.bc_type[perm]
    new_mesh.boundary_lines = mesh.boundary_lines
    new_mesh.boundary_tags = mesh.boundary_tags
    return new_mesh, perm
