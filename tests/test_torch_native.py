"""The port's native mesh helpers (``native/``: its own copy of
``dgmesh.cpp``, built with g++ into ``blitzdg_tpu_torch/_build/``) against
the numpy implementations.

Mirrors ``tests/test_native.py``: connectivity of triangle and quad
meshes, the interface maps of a triangle mesh (and here also of a quad
mesh), and the Gmsh element scan against the Python reader (on a file
written here: the reference library's fixtures are not in the
repository). These tests need g++ and assert that it is there and that the
build succeeds, so that none of them passes through a numpy fallback
unnoticed. The copy's code is the JAX package's, line for line (only its
header comment differs).
"""
import shutil

import numpy as np

from blitzdg_tpu_torch import native
from blitzdg_tpu_torch.mesh import box_quads, box_triangles, read_gmsh, write_gmsh
from blitzdg_tpu_torch.mesh.connectivity import build_connectivity as np_connectivity
from blitzdg_tpu_torch.specgrid import quad as TQ
from blitzdg_tpu_torch.specgrid.triangle import (_build_maps, build_fmask,
                                                 triangle_nodes)


def test_native_library_builds_into_the_ports_build_dir():
    assert shutil.which("g++") is not None, "g++ is needed for the native build"
    assert native.available(), native.last_build_log
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "blitzdg_tpu_torch"
    # the port's own source, the JAX package's code line for line
    own = native.SOURCE.read_text()
    jax_src = (native.SOURCE.parents[2] / "blitzdg_tpu" / "native"
               / "dgmesh.cpp").read_text()
    code = lambda s: s[s.index("#include"):]
    assert native.SOURCE.parent.name == "native"
    assert code(own) == code(jax_src)
    assert "blitzdg_tpu/" not in own


def test_connectivity_matches_numpy():
    assert native.available(), native.last_build_log
    for mesh in [box_triangles(5, 7), box_quads(4, 6)]:
        etoe_np, etof_np = np_connectivity(mesh.etov)
        etoe_c, etof_c = native.build_connectivity(mesh.etov)
        np.testing.assert_array_equal(etoe_c, etoe_np)
        np.testing.assert_array_equal(etof_c, etof_np)


def test_maps_match_numpy():
    assert native.available(), native.last_build_log
    mesh = box_triangles(4, 5)
    N = 3
    r, s = triangle_nodes(N)
    fmask = build_fmask(r, s, N + 1)
    va, vb, vc = mesh.etov[:, 0], mesh.etov[:, 1], mesh.etov[:, 2]
    VX, VY = mesh.verts[:, 0], mesh.verts[:, 1]
    lam = np.stack([-(r + s), 1.0 + r, 1.0 + s], axis=0) * 0.5
    x = lam[0][None, :] * VX[va][:, None] + lam[1][None, :] * VX[vb][:, None] + lam[2][None, :] * VX[vc][:, None]
    y = lam[0][None, :] * VY[va][:, None] + lam[1][None, :] * VY[vb][:, None] + lam[2][None, :] * VY[vc][:, None]
    want = _build_maps(x, y, fmask, mesh, x.shape[1])
    got = native.build_maps(x, y, fmask, mesh.etoe, mesh.etof, mesh.verts,
                            mesh.etov)
    assert got is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the quad context's maps (native) against the numpy construction
    qm = box_quads(3, 4)
    ctx = TQ.build_quad_context(2, qm, device="cpu")
    want = _build_maps(ctx.x.numpy(), ctx.y.numpy(), ctx.fmask.numpy(), qm,
                       ctx.n_p)
    for name, w in zip(("vmapM", "vmapP", "mapP"), want):
        np.testing.assert_array_equal(getattr(ctx, name).numpy(), w)


def test_gmsh_parse_matches_python(tmp_path):
    assert native.available(), native.last_build_log
    mesh = box_triangles(4, 5)
    mesh.boundary_lines = np.array([[0, 1], [1, 2]], dtype=np.int32)
    mesh.boundary_tags = np.array([7, 8], dtype=np.int32)
    p = tmp_path / "box.msh"
    write_gmsh(str(p), mesh)
    out = native.parse_gmsh_elements(p.read_text())
    assert out is not None
    tris, quads, lines, tags = out
    assert tris.shape == (40, 3) and quads.shape[0] == 0
    np.testing.assert_array_equal(lines, mesh.boundary_lines)
    np.testing.assert_array_equal(tags, mesh.boundary_tags)
    back = read_gmsh(str(p), apply_line_tags=False)
    a = {tuple(sorted(r)) for r in tris.tolist()}
    b = {tuple(sorted(r)) for r in back.etov.tolist()}
    assert a == b
    qp = tmp_path / "quads.msh"
    write_gmsh(str(qp), box_quads(3, 2))
    tris, quads, _, _ = native.parse_gmsh_elements(qp.read_text())
    assert tris.shape[0] == 0
    np.testing.assert_array_equal(quads, box_quads(3, 2).etov)
