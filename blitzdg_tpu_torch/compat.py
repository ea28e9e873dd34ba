"""pyblitzdg-compatible API surface.

Counterpart of the JAX package's ``blitzdg_tpu/compat.py``: class wrappers
over the port's core that cover the public API of the reference's Python
bindings (src/pyblitzdg/pyblitzdg.cpp:52-199): ``Nodes1DProvisioner``,
``MeshManager``, ``TriangleNodesProvisioner``, ``QuadNodesProvisioner``,
``VandermondeBuilder``, ``LSERK4``, the ``DGContext2D`` property accessors,
``Poisson2DSparseMatrix``, ``VtkOutputter`` and the ``BCType`` constants.

Array conventions: the reference hands out numpy arrays, (Np, K)
column-major fields and flat F-ordered index maps; these wrappers do the
same (transposing the port's element-major (K, Np) tensors and copying them
to the host), so scripts written against pyblitzdg keep working. The
provisioners build their contexts in float64 on ``device`` (the card unless
``device="cpu"`` is given). New code should use the element-major core API
directly.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class BCType:
    """Reference include/BCtypes.hpp:9-18."""

    In = 1
    Out = 2
    Wall = 3
    Far = 4
    Cyl = 5
    Dirichlet = 6
    Neuman = 7
    Slip = 8


class LSERK4:
    """Reference include/LSERK4.hpp:16-27."""

    from .timestepping import LSERK4_A as _a, LSERK4_B as _b

    numStages = 5
    rk4a = np.asarray(_a)
    rk4b = np.asarray(_b)


class VandermondeBuilder:
    """Reference pyblitzdg.cpp:92-94."""

    def buildVandermondeMatrix(self, r, includeInverse: bool, order: int):
        from .specgrid.vandermonde import vandermonde_1d

        V = vandermonde_1d(order, np.asarray(r, dtype=np.float64))
        if includeInverse:
            return V, np.linalg.inv(V)
        return (V,)


class MeshManager:
    """Reference pyblitzdg.cpp:101-111."""

    def __init__(self):
        self._mesh = None
        self._element_partition = None
        self._vertex_partition = None
        self._csv_verts = self._csv_elems = None

    def readMesh(self, path: str):
        from .mesh import read_gmsh

        self._mesh = read_gmsh(path)

    def buildMesh(self, EToV, Vertices):
        from .mesh import build_mesh

        self._mesh = build_mesh(np.asarray(Vertices), np.asarray(EToV))

    def readVertices(self, path: str):
        """CSV vertex reader (reference MeshManager.cpp:546-552)."""
        from .io.csv import csvread

        self._csv_verts = csvread(path, float)[:, :2]
        self._maybe_build_csv()

    def readElements(self, path: str):
        """CSV element reader (reference MeshManager.cpp:554-562)."""
        from .io.csv import csvread

        self._csv_elems = csvread(path, float).astype(np.int64)
        self._maybe_build_csv()

    def _maybe_build_csv(self):
        if self._csv_verts is not None and self._csv_elems is not None:
            from .mesh import build_mesh

            self._mesh = build_mesh(self._csv_verts, self._csv_elems)

    def partitionMesh(self, numPartitions: int):
        from .parallel.partition import rcb_partition

        cent = self._mesh.verts[self._mesh.etov].mean(axis=1)
        self._element_partition = rcb_partition(cent, numPartitions)
        # vertex partition: the owner of the first element that touches it
        vp = np.zeros(self._mesh.num_verts, dtype=np.int32)
        for k in range(self._mesh.num_elements - 1, -1, -1):
            vp[self._mesh.etov[k]] = self._element_partition[k]
        self._vertex_partition = vp

    def setBCType(self, bcType):
        self._mesh.set_bc_type(np.asarray(bcType))

    @property
    def numElements(self):
        return self._mesh.num_elements

    @property
    def elements(self):
        return self._mesh.etov

    @property
    def vertices(self):
        v = self._mesh.verts
        return np.concatenate([v, np.zeros((v.shape[0], 1))], axis=1)

    @property
    def bcType(self):
        return self._mesh.bc_type

    @property
    def elementPartitionMap(self):
        return self._element_partition

    @property
    def vertexPartitionMap(self):
        return self._vertex_partition


class _ContextView:
    """Reference DGContext2D property surface (pyblitzdg.cpp:160-187), as
    numpy arrays in the reference's shapes: fields (Np, K), face data
    (Nfp*Nfaces, K)."""

    def __init__(self, ctx):
        self._ctx = ctx

    def computeDifferentiationMatrices(self, x, y):
        """Physical differentiation matrices (Dx, Dy), each (Np, Np), at the
        given single-element nodal coordinates x, y (Np,): reference
        DGContext2D::computeDifferentiationMatrices
        (include/DGContext2D.hpp:222-257), the metric from Dr/Ds applied to
        the coordinates, then Dx = rx Dr + sx Ds scaled by rows."""
        Dr, Ds = _np(self._ctx.Dr), _np(self._ctx.Ds)
        x, y = np.asarray(x).reshape(-1), np.asarray(y).reshape(-1)
        xr, xs = Dr @ x, Ds @ x
        yr, ys = Dr @ y, Ds @ y
        J = -xs * yr + xr * ys
        rx, sx = ys / J, -yr / J
        ry, sy = -xs / J, xr / J
        Dx = rx[:, None] * Dr + sx[:, None] * Ds
        Dy = ry[:, None] * Dr + sy[:, None] * Ds
        return Dx, Dy

    # static
    numLocalPoints = property(lambda self: self._ctx.n_p)
    numElements = property(lambda self: self._ctx.k_elem)
    numFaces = property(lambda self: self._ctx.n_faces)
    numFacePoints = property(lambda self: self._ctx.n_fp)
    order = property(lambda self: self._ctx.n_order)

    # reference-element operators (already in the reference's shapes)
    r = property(lambda self: _np(self._ctx.r))
    s = property(lambda self: _np(self._ctx.s))
    V = property(lambda self: _np(self._ctx.V))
    Vinv = property(lambda self: _np(self._ctx.Vinv))
    Dr = property(lambda self: _np(self._ctx.Dr))
    Ds = property(lambda self: _np(self._ctx.Ds))
    Drw = property(lambda self: _np(self._ctx.Drw))
    Dsw = property(lambda self: _np(self._ctx.Dsw))
    Lift = property(lambda self: _np(self._ctx.lift))
    Filter = property(lambda self: _np(self._ctx.filter))
    # reference: (Nfp, Nfaces)
    Fmask = property(lambda self: _np(self._ctx.fmask).T)

    # per-element fields -> the reference's (Np, K)
    x = property(lambda self: _np(self._ctx.x).T)
    y = property(lambda self: _np(self._ctx.y).T)
    jacobian = property(lambda self: _np(self._ctx.J).T)
    rx = property(lambda self: _np(self._ctx.rx).T)
    ry = property(lambda self: _np(self._ctx.ry).T)
    sx = property(lambda self: _np(self._ctx.sx).T)
    sy = property(lambda self: _np(self._ctx.sy).T)
    nx = property(lambda self: _np(self._ctx.nx).T)
    ny = property(lambda self: _np(self._ctx.ny).T)
    Fscale = property(lambda self: _np(self._ctx.fscale).T)

    @property
    def vmapM(self):
        """Flat F-ordered (column-major (Nfp*Nfaces, K)) volume indices into
        F-ordered (Np, K) fields: the reference's layout."""
        return self._to_ref_map(self._ctx.vmapM)

    @property
    def vmapP(self):
        return self._to_ref_map(self._ctx.vmapP)

    def _to_ref_map(self, m):
        # the port's (K, Nfaces*Nfp) table indexes the flat (K*Np,) field;
        # the reference's volume id is node + Np*k (F-order of (Np, K)),
        # and its trace sequence runs over (n, f) within each element k:
        # the row-major flattening of the (K, ntr) table
        n_p = self._ctx.n_p
        m = _np(m)
        return (m % n_p + n_p * (m // n_p)).reshape(-1)

    @property
    def BCmap(self):
        """tag -> array of flat F-ordered trace indices: row f*Nfp + node
        and column k of the (Nfp*Nfaces, K) trace array."""
        bc = _np(self._ctx.bc_table)
        _, Nf = bc.shape
        nfp = self._ctx.n_fp
        out = {}
        for tag in np.unique(bc):
            if tag == 0:
                continue
            faces = np.argwhere(bc == tag)
            rows = (faces[:, 1][:, None] * nfp
                    + np.arange(nfp)[None, :]).ravel()
            cols = np.repeat(faces[:, 0], nfp)
            out[int(tag)] = rows + cols * (Nf * nfp)
        return out


class TriangleNodesProvisioner:
    """Reference pyblitzdg.cpp:113-118. The context is built in float64 on
    ``device``."""

    def __init__(self, NOrder: int, meshManager: MeshManager, *,
                 device="cuda"):
        self._order = NOrder
        self._mesh = meshManager._mesh
        self._device = device
        self._filter = (None, 4)
        self._coords = None
        self._build()

    def _build(self):
        from .specgrid.triangle import build_triangle_context

        cutoff, forder = self._filter
        self._ctx = build_triangle_context(
            self._order, self._mesh, dtype=torch.float64,
            filter_cutoff=cutoff, filter_order=forder, coords=self._coords,
            device=self._device)

    def buildFilter(self, Nc: float, s: int):
        self._filter = (Nc, s)
        self._build()

    def setCoordinates(self, x, y):
        # the reference's (Np, K) -> element-major
        self._coords = (np.asarray(x).T, np.asarray(y).T)
        self._build()

    def buildCubatureVolumeMesh(self, NCubature: int):
        from .specgrid.cubature import build_cubature_context

        c = self._ctx
        self._cub = build_cubature_context(
            self._order, self._mesh, _np(c.x), _np(c.y), _np(c.V),
            order=NCubature, dtype=torch.float64, device=self._device)
        return self._cub

    def buildGaussFaceNodes(self, NGauss: int):
        from .specgrid.cubature import build_gauss_face_context

        c = self._ctx
        self._gauss = build_gauss_face_context(
            self._order, self._mesh, _np(c.x), _np(c.y), _np(c.V),
            n_gauss=NGauss, dtype=torch.float64, device=self._device)
        return self._gauss

    def dgContext(self):
        return _ContextView(self._ctx)


class QuadNodesProvisioner:
    """Reference pyblitzdg.cpp:120-122. The context is built in float64 on
    ``device``."""

    def __init__(self, NOrder: int, meshManager: MeshManager, *,
                 device="cuda"):
        self._order = NOrder
        self._mesh = meshManager._mesh
        self._device = device
        self.buildFilter(None, 4)

    def buildFilter(self, Nc: float | None, s: int):
        from .specgrid.quad import build_quad_context

        self._ctx = build_quad_context(
            self._order, self._mesh, dtype=torch.float64, filter_cutoff=Nc,
            filter_order=s, device=self._device)

    def dgContext(self):
        return _ContextView(self._ctx)


class Nodes1DProvisioner:
    """Reference pyblitzdg.cpp:66-81. The context is built in float64 on
    ``device``."""

    def __init__(self, NOrder: int, K: int, xLeft: float, xRight: float, *,
                 device="cuda"):
        self._args = (NOrder, K, xLeft, xRight)
        self._device = device
        self._ctx = None

    def buildNodes(self):
        from .specgrid.nodes1d import build_nodes1d

        self._ctx = build_nodes1d(*self._args, dtype=torch.float64,
                                  device=self._device)

    def computeJacobian(self):
        if self._ctx is None:
            self.buildNodes()

    numLocalPoints = property(lambda self: self._ctx.n_p)
    xGrid = property(lambda self: _np(self._ctx.x).T)
    Dr = property(lambda self: _np(self._ctx.Dr))
    rx = property(lambda self: _np(self._ctx.rx).T)
    Fscale = property(lambda self: _np(self._ctx.fscale).T)
    Lift = property(lambda self: _np(self._ctx.lift))
    nx = property(lambda self: _np(self._ctx.nx).T)

    def _ref_map(self, m):
        n_p = self._ctx.n_p
        m = _np(m)
        return (m % n_p + n_p * (m // n_p)).reshape(-1)

    vmapM = property(lambda self: self._ref_map(self._ctx.vmapM))
    vmapP = property(lambda self: self._ref_map(self._ctx.vmapP))
    mapI = property(lambda self: self._ctx.mapI)
    # the reference's F-order trace numbering: f + k*Nfaces
    mapO = property(lambda self: 2 * self._ctx.k_elem - 1)
    vmapI = property(lambda self: 0)
    vmapO = property(lambda self: self._ctx.n_p * self._ctx.k_elem - 1)


class Poisson2DSparseMatrix:
    """Reference pyblitzdg.cpp:194-199: the assembled SIP operator as
    (nnz, 3) triplets (row, column, value)."""

    def __init__(self, dgContext: _ContextView, meshManager: MeshManager,
                 bordered: bool = False, skipDG: bool = False,
                 gaussFaceContext=None, cubatureContext=None):
        """The nodal assembly by default; the Gauss-face and cubature
        contexts together select the CURVED cubature/Gauss SIP assembly: the
        reference's curved constructor overload (pyblitzdg.cpp:194-199 ->
        Poisson2DSparseMatrix.cpp:37-317)."""
        from .ops.poisson import assemble_poisson2d, assemble_poisson2d_curved
        from .ops.sem import assemble_sem_poisson

        ctx = dgContext._ctx
        if gaussFaceContext is not None or cubatureContext is not None:
            if gaussFaceContext is None or cubatureContext is None:
                raise ValueError("the curved assembly needs both the Gauss-"
                                 "face and the cubature context")
            gauss = getattr(gaussFaceContext, "_gauss", gaussFaceContext)
            cub = getattr(cubatureContext, "_cub", cubatureContext)
            self._OP, self._MM = assemble_poisson2d_curved(
                ctx, cub, gauss, bordered=bordered)
        elif skipDG:
            self._OP, self._MM = assemble_sem_poisson(ctx)
        else:
            self._OP, self._MM = assemble_poisson2d(ctx, bordered=bordered)
        self._ctx = ctx

    def buildBcRhs(self, dgContext, meshManager, ubc, qbc):
        from .ops.poisson import assemble_bc_rhs

        # the reference's (Nfp*Nfaces, K) -> (K, ntr); the result (Np, K)
        b = assemble_bc_rhs(self._ctx, np.asarray(ubc).T, np.asarray(qbc).T)
        return _np(b).T

    @staticmethod
    def _triplets(A):
        coo = A.tocoo()
        return np.stack([coo.row, coo.col, coo.data], axis=1)

    def getOP(self):
        return self._triplets(self._OP)

    def getMM(self):
        return self._triplets(self._MM)


class VtkOutputter:
    """Reference pyblitzdg.cpp:189-192."""

    def __init__(self, provisioner):
        self._ctx = provisioner._ctx

    def generateFileName(self, base: str, index: int) -> str:
        from .io.vtk import generate_file_name

        return generate_file_name(base, index)

    def writeFieldToFile(self, fileName: str, field, fieldName: str = "field"):
        from .io.vtk import write_vtu

        write_vtu(fileName, self._ctx, {fieldName: np.asarray(field).T})

    def writeFieldsToFiles(self, fields: dict, index: int):
        from .io.vtk import write_fields_to_files

        write_fields_to_files(
            self._ctx, {k: np.asarray(v).T for k, v in fields.items()}, index)
