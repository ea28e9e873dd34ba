"""The port's pyblitzdg-compatible API (``blitzdg_tpu_torch/compat.py``)
against the JAX package's (``blitzdg_tpu/compat.py``) on the same inputs,
CPU, float64: every case of ``tests/test_compat.py`` (the 1D provisioner's
shapes and arrays, the reference's advec1d numpy script, the mesh manager
and the triangle provisioner, the Poisson triplets, the VTK outputter, the
physical differentiation matrices), with the arrays held to the JAX
package's; the mesh-manager case reads a Gmsh file that the test writes
from ``mesh/generators``, since the reference's mesh files are absent
(ROADMAP C1). Besides: the CSV readers on small ``.V``/``.E2V`` files that
the test writes (``tests/test_io.py::test_compat_csv_readers`` skips
without the reference's files), the curved constructor overload of
``Poisson2DSparseMatrix`` (``tests/test_poisson.py``'s
``test_compat_curved_ctor_overload``), the quad provisioner, the BC right
side and the small classes. Contexts are built with ``device="cpu"``."""
import os

import numpy as np
import pytest
import scipy.sparse as sp

from blitzdg_tpu import compat as jdg
from blitzdg_tpu.mesh import box_triangles as j_box

from blitzdg_tpu_torch import compat as dg
from blitzdg_tpu_torch.mesh import box_quads, box_triangles, write_gmsh

CPU = dict(device="cpu")


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0,
                                                            np.abs(b).max()))


def _managers(mesh):
    """A port and a JAX mesh manager built from one mesh's arrays."""
    v = np.concatenate([mesh.verts, 0 * mesh.verts[:, :1]], 1)
    m, jm = dg.MeshManager(), jdg.MeshManager()
    m.buildMesh(mesh.etov, v)
    jm.buildMesh(mesh.etov, v)
    return m, jm


def test_nodes1d_api_shapes():
    p = dg.Nodes1DProvisioner(4, 30, -1.0, 4.0, **CPU)
    p.buildNodes()
    p.computeJacobian()
    jp = jdg.Nodes1DProvisioner(4, 30, -1.0, 4.0)
    jp.buildNodes()
    assert p.numLocalPoints == 5
    assert p.xGrid.shape == (5, 30)  # the reference's (Np, K)
    assert p.Dr.shape == (5, 5) and p.Lift.shape == (5, 2)
    assert p.vmapM.shape == (60,)
    for name in ("xGrid", "Dr", "rx", "Fscale", "Lift", "nx"):
        _close(getattr(p, name), getattr(jp, name))
    for name in ("vmapM", "vmapP", "mapI", "mapO", "vmapI", "vmapO"):
        np.testing.assert_array_equal(getattr(p, name), getattr(jp, name))


def _advec1d(dgm, **kw):
    """The reference's pure-numpy advec1d.py script (advec1d.py:12-39) on a
    compat module, with F-ordered maps."""
    p = dgm.Nodes1DProvisioner(4, 30, -1.0, 4.0, **kw)
    p.buildNodes()
    p.computeJacobian()
    x = p.xGrid
    Dr, rx, Lift, Fscale, nx = p.Dr, p.rx, p.Lift, p.Fscale, p.nx
    vmapM, vmapP = p.vmapM, p.vmapP
    mapI, mapO = p.mapI, p.mapO
    c = 0.1

    def computeRHS(u):
        uVec = u.flatten("F")
        nxVec = nx.flatten("F")
        uM = uVec[vmapM]
        uP = uVec[vmapP].copy()
        uP[mapO] = uM[mapO]
        uP[mapI] = 0.0
        du = (uM - uP) * 0.5 * (c * nxVec - np.abs(c * nxVec))
        duMat = np.reshape(du, (2, 30), order="F")
        return -c * rx * (Dr @ u) + Lift @ (Fscale * duMat)

    u = np.exp(-10.0 * x ** 2)
    dt = 0.8 * (x[1, 0] - x[0, 0]) / c
    a, b = dgm.LSERK4.rk4a, dgm.LSERK4.rk4b
    res = np.zeros_like(u)
    steps = int(np.ceil(20.0 / dt))
    for _ in range(steps):
        for i in range(5):
            res = a[i] * res + dt * computeRHS(u)
            u = u + b[i] * res
    return x, u, steps * dt, c


def test_reference_advec1d_numpy_script():
    x, u, t, c = _advec1d(dg, **CPU)
    assert np.max(np.abs(u - np.exp(-10.0 * (x - c * t) ** 2))) < 5e-4
    _, ju, jt, _ = _advec1d(jdg)
    assert t == jt
    _close(u, ju)


def test_mesh_manager_and_triangle_provisioner(tmp_path):
    """Both managers read one Gmsh file (``box_triangles(4, 5)``, K=40, the
    coarse box's count), partition it and build the filtered N=2 context:
    every accessor of the context view equals the JAX one."""
    path = str(tmp_path / "box.msh")
    write_gmsh(path, box_triangles(4, 5))
    m, jm = dg.MeshManager(), jdg.MeshManager()
    m.readMesh(path)
    jm.readMesh(path)
    assert m.numElements == 40 and m.vertices.shape[1] == 3
    np.testing.assert_array_equal(m.elements, jm.elements)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.bcType, jm.bcType)
    m.partitionMesh(4)
    jm.partitionMesh(4)
    assert m.elementPartitionMap.shape == (40,)
    assert set(np.unique(m.elementPartitionMap)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(m.elementPartitionMap,
                                  jm.elementPartitionMap)
    np.testing.assert_array_equal(m.vertexPartitionMap,
                                  jm.vertexPartitionMap)

    tri = dg.TriangleNodesProvisioner(2, m, **CPU)
    tri.buildFilter(1.8, 2)
    jtri = jdg.TriangleNodesProvisioner(2, jm)
    jtri.buildFilter(1.8, 2)
    ctx, jctx = tri.dgContext(), jtri.dgContext()
    assert ctx.x.shape == (6, 40) and ctx.Fscale.shape == (9, 40)
    assert ctx.vmapM.shape == (9 * 40,)
    xF, yF = ctx.x.flatten("F"), ctx.y.flatten("F")
    np.testing.assert_allclose(xF[ctx.vmapM], xF[ctx.vmapP], atol=1e-9)
    np.testing.assert_allclose(yF[ctx.vmapM], yF[ctx.vmapP], atol=1e-9)
    for name in ("numLocalPoints", "numElements", "numFaces",
                 "numFacePoints", "order"):
        assert getattr(ctx, name) == getattr(jctx, name)
    for name in ("r", "s", "V", "Vinv", "Dr", "Ds", "Drw", "Dsw", "Lift",
                 "Filter", "x", "y", "jacobian", "rx", "ry", "sx", "sy",
                 "nx", "ny", "Fscale"):
        _close(getattr(ctx, name), getattr(jctx, name), 1e-11)
    for name in ("Fmask", "vmapM", "vmapP"):
        np.testing.assert_array_equal(getattr(ctx, name),
                                      getattr(jctx, name))
    bcmap, jbcmap = ctx.BCmap, jctx.BCmap
    assert dg.BCType.Wall in bcmap and bcmap.keys() == jbcmap.keys()
    for tag in bcmap:
        np.testing.assert_array_equal(bcmap[tag], jbcmap[tag])


def test_poisson_sparse_matrix_triplets():
    m, jm = _managers(box_triangles(4, 4))
    view = dg.TriangleNodesProvisioner(2, m, **CPU).dgContext()
    poisson = dg.Poisson2DSparseMatrix(view, m)
    jpoisson = jdg.Poisson2DSparseMatrix(
        jdg.TriangleNodesProvisioner(2, jm).dgContext(), jm)
    n = 6 * 32
    for got, want in ((poisson.getOP(), jpoisson.getOP()),
                      (poisson.getMM(), jpoisson.getMM())):
        assert got.shape[1] == 3
        A = sp.csr_matrix((got[:, 2], (got[:, 0].astype(int),
                                       got[:, 1].astype(int))), shape=(n, n))
        B = sp.csr_matrix((want[:, 2], (want[:, 0].astype(int),
                                        want[:, 1].astype(int))),
                          shape=(n, n))
        assert abs(A - A.T).max() < 1e-8 * abs(A).max()
        assert abs(A - B).max() <= 1e-10 * abs(B).max()


def test_vtk_outputter(tmp_path):
    """The port's VTU file equals the JAX package's byte for byte."""
    m, jm = _managers(box_triangles(2, 2))
    tri = dg.TriangleNodesProvisioner(2, m, **CPU)
    jtri = jdg.TriangleNodesProvisioner(2, jm)
    x = tri.dgContext().x
    cwd = os.getcwd()
    try:
        for d, prov, mod in (("port", tri, dg), ("jax", jtri, jdg)):
            (tmp_path / d).mkdir()
            os.chdir(tmp_path / d)
            out = mod.VtkOutputter(prov)
            out.writeFieldsToFiles({"eta": x}, 0)
            out.writeFieldToFile(out.generateFileName("u", 3), 2.0 * x, "u")
    finally:
        os.chdir(cwd)
    for name in ("eta0000000.vtu", "u0000003.vtu"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()


def test_compute_differentiation_matrices():
    m, jm = dg.MeshManager(), jdg.MeshManager()
    for mm in (m, jm):
        mm.buildMesh(np.array([[0, 1, 2]]),
                     np.array([[0.0, 0.0], [2.0, 0.5], [0.5, 1.5]]))
    ctx = dg.TriangleNodesProvisioner(3, m, **CPU).dgContext()
    jctx = jdg.TriangleNodesProvisioner(3, jm).dgContext()
    x, y = ctx.x[:, 0], ctx.y[:, 0]
    Dx, Dy = ctx.computeDifferentiationMatrices(x, y)
    f = 2.0 + 3.0 * x - 1.5 * y + 0.25 * x * y
    np.testing.assert_allclose(Dx @ f, 3.0 + 0.25 * y, atol=1e-10)
    np.testing.assert_allclose(Dy @ f, -1.5 + 0.25 * x, atol=1e-10)
    jDx, jDy = jctx.computeDifferentiationMatrices(x, y)
    _close(Dx, jDx)
    _close(Dy, jDy)


def test_compat_csv_readers(tmp_path):
    """``readVertices``/``readElements`` on two quads sharing one face (the
    shape of the reference's ``2box`` fixture), written here."""
    (tmp_path / "2box.V").write_text(
        "0 0 0\n1 0 0\n2 0 0\n0 1 0\n1 1 0\n2 1 0\n")
    (tmp_path / "2box.E2V").write_text("0 1 4 3\n1 2 5 4\n")
    m, jm = dg.MeshManager(), jdg.MeshManager()
    for mm in (m, jm):
        mm.readVertices(str(tmp_path / "2box.V"))
        mm.readElements(str(tmp_path / "2box.E2V"))
    assert m.numElements == 2
    np.testing.assert_array_equal(m.elements, jm.elements)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    etoe = m._mesh.etoe
    assert (etoe[0] == 1).sum() + (etoe[1] == 0).sum() == 2
    q = dg.QuadNodesProvisioner(2, m, **CPU).dgContext()
    jq = jdg.QuadNodesProvisioner(2, jm).dgContext()
    assert q.numFaces == 4 and q.x.shape == (9, 2)
    _close(q.x, jq.x)
    np.testing.assert_array_equal(q.vmapP, jq.vmapP)


def test_quad_provisioner_with_filter():
    m, jm = _managers(box_quads(3, 2))
    q = dg.QuadNodesProvisioner(3, m, **CPU)
    jq = jdg.QuadNodesProvisioner(3, jm)
    q.buildFilter(2.7, 4)
    jq.buildFilter(2.7, 4)
    for name in ("Filter", "x", "y", "rx", "Fscale", "Lift"):
        _close(getattr(q.dgContext(), name), getattr(jq.dgContext(), name))
    np.testing.assert_array_equal(q.dgContext().vmapM, jq.dgContext().vmapM)


def test_compat_curved_ctor_overload():
    """The curved constructor overload (pyblitzdg.cpp:194-199): the
    provisioner's cubature and Gauss-face contexts select the curved
    assembly, whose (nnz, 3) triplets equal the JAX package's; a context
    given without its partner raises."""
    from blitzdg_tpu_torch.ops.poisson import assemble_poisson2d_curved

    m, jm = _managers(box_triangles(2, 3))
    tri = dg.TriangleNodesProvisioner(2, m, **CPU)
    jtri = jdg.TriangleNodesProvisioner(2, jm)
    for p in (tri, jtri):
        p.buildCubatureVolumeMesh(6)
        p.buildGaussFaceNodes(4)
    for name in ("W", "MMinv"):
        _close(getattr(tri._cub, name), getattr(jtri._cub, name))
    _close(tri._gauss.interp, jtri._gauss.interp)
    mat = dg.Poisson2DSparseMatrix(tri.dgContext(), m, gaussFaceContext=tri,
                                   cubatureContext=tri)
    jmat = jdg.Poisson2DSparseMatrix(jtri.dgContext(), jm,
                                     gaussFaceContext=jtri,
                                     cubatureContext=jtri)
    trip, jtrip = mat.getOP(), jmat.getOP()
    assert trip.shape[1] == 3
    OP, _ = assemble_poisson2d_curved(tri._ctx, tri._cub, tri._gauss)
    assert trip.shape[0] == OP.nnz
    n = tri._ctx.k_elem * tri._ctx.n_p
    A = sp.csr_matrix((trip[:, 2], (trip[:, 0].astype(int),
                                    trip[:, 1].astype(int))), shape=(n, n))
    B = sp.csr_matrix((jtrip[:, 2], (jtrip[:, 0].astype(int),
                                     jtrip[:, 1].astype(int))), shape=(n, n))
    assert abs(A - B).max() <= 1e-10 * abs(B).max()
    with pytest.raises(ValueError):
        dg.Poisson2DSparseMatrix(tri.dgContext(), m, gaussFaceContext=tri)


def test_bc_rhs_and_small_classes():
    """``buildBcRhs`` in the reference's shapes, the SEM assembly
    (``skipDG``), ``VandermondeBuilder``, ``LSERK4`` and ``BCType`` equal
    the JAX package's."""
    m, jm = _managers(box_triangles(2, 2))
    view = dg.TriangleNodesProvisioner(2, m, **CPU).dgContext()
    jview = jdg.TriangleNodesProvisioner(2, jm).dgContext()
    ntr, K = view.Fscale.shape
    rng = np.random.default_rng(2)
    ubc, qbc = rng.standard_normal((ntr, K)), rng.standard_normal((ntr, K))
    b = dg.Poisson2DSparseMatrix(view, m).buildBcRhs(view, m, ubc, qbc)
    jb = jdg.Poisson2DSparseMatrix(jview, jm).buildBcRhs(jview, jm, ubc, qbc)
    assert b.shape == (view.numLocalPoints, K)
    _close(b, jb)
    sem = dg.Poisson2DSparseMatrix(view, m, skipDG=True).getOP()
    jsem = jdg.Poisson2DSparseMatrix(jview, jm, skipDG=True).getOP()
    _close(sem, jsem)
    r = np.linspace(-1.0, 1.0, 5)
    V, Vi = dg.VandermondeBuilder().buildVandermondeMatrix(r, True, 4)
    jV, jVi = jdg.VandermondeBuilder().buildVandermondeMatrix(r, True, 4)
    _close(V, jV)
    _close(Vi, jVi)
    assert len(dg.VandermondeBuilder().buildVandermondeMatrix(r, False,
                                                              4)) == 1
    np.testing.assert_array_equal(dg.LSERK4.rk4a, jdg.LSERK4.rk4a)
    np.testing.assert_array_equal(dg.LSERK4.rk4b, jdg.LSERK4.rk4b)
    assert dg.LSERK4.numStages == 5
    for tag in ("In", "Out", "Wall", "Far", "Cyl", "Dirichlet", "Neuman",
                "Slip"):
        assert getattr(dg.BCType, tag) == getattr(jdg.BCType, tag)
