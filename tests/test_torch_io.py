"""Host IO of the port (``io/vtk.py``, ``io/csv.py``, ``io/checkpoint.py``,
``mesh.write_gmsh`` / ``read_csv_mesh``) against the JAX package.

Mirrors ``tests/test_io.py`` (the compat CSV readers, ``compat.py``, are
not ported yet). The VTU and CSV files that both packages write from the
same context and fields are equal as text, byte for byte; the sub-cell
splits are equal arrays; a Gmsh file written by the port is the JAX
writer's, byte for byte, and reads back to the same mesh. Checkpoints: a
round trip of a state, every validation error (shape, dtype, treedef, leaf
count), ``strict_dtype=False``, restored tensors on the template's device
and dtype, and an MPC solve resumed mid-way (controls and Adam state)
equal to the uninterrupted solve. The CSV readers on fixtures written here
(blank lines, ragged rows, a two-quad mesh) and the depth-file loader.
"""
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.io import csv as jcsv
from blitzdg_tpu.io import vtk as jvtk
from blitzdg_tpu.mesh import box_quads as j_box_quads
from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.mesh import write_gmsh as j_write_gmsh
from blitzdg_tpu.specgrid.quad import build_quad_context as j_quad
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_tri

from blitzdg_tpu_torch.io.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from blitzdg_tpu_torch.io.csv import (csvread, read_depth_data, read_field,
                                      write_field)
from blitzdg_tpu_torch.io import csv as tcsv
from blitzdg_tpu_torch.io.vtk import (split_quad_indices,
                                      split_triangle_indices,
                                      write_fields_to_files, write_vtu)
from blitzdg_tpu_torch.mesh import (box_quads, box_triangles, read_csv_mesh,
                                    read_gmsh, write_gmsh)
from blitzdg_tpu_torch.ops.sw2d import SWState
from blitzdg_tpu_torch.specgrid.quad import build_quad_context
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

F32, F64 = torch.float32, torch.float64


def test_split_triangle_counts():
    for N in [1, 2, 4]:
        sub = split_triangle_indices(N)
        assert len(sub) == N * N  # degree-N triangle -> N^2 linear tris
        n_p = (N + 1) * (N + 2) // 2
        assert sub.max() == n_p - 1 and sub.min() == 0
        np.testing.assert_array_equal(sub, jvtk.split_triangle_indices(N))


def test_split_quad_counts():
    for N in [1, 3]:
        sub = split_quad_indices(N)
        assert len(sub) == N * N
        assert sub.max() == (N + 1) ** 2 - 1
        np.testing.assert_array_equal(sub, jvtk.split_quad_indices(N))


@pytest.mark.parametrize("dtype", [F64, F32])
def test_write_vtu_triangles(tmp_path, dtype):
    """The port's file from its own context (float64, or float32 tensors)
    is the JAX writer's file from the JAX context, byte for byte."""
    ctx = build_triangle_context(3, box_triangles(2, 2), dtype=dtype,
                                 device="cpu")
    x, y = ctx.x.double().numpy(), ctx.y.double().numpy()
    un = (np.sin(x) * np.cos(y)).astype(ctx.x.numpy().dtype)
    u = torch.as_tensor(un)  # the same values for both writers
    path = tmp_path / "u.vtu"
    write_vtu(str(path), ctx, {"u": u, "x": ctx.x})
    piece = ET.parse(path).getroot().find(".//Piece")
    assert int(piece.get("NumberOfPoints")) == ctx.k_elem * ctx.n_p
    assert int(piece.get("NumberOfCells")) == ctx.k_elem * 9
    assert {d.get("Name") for d in piece.find("PointData")} == {"u", "x"}
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    jc = j_tri(3, j_box_triangles(2, 2), dtype=jdt)
    jpath = tmp_path / "ju.vtu"
    jvtk.write_vtu(str(jpath), jc, {"u": un, "x": np.asarray(jc.x)})
    assert path.read_bytes() == jpath.read_bytes()


def test_write_vtu_quads(tmp_path):
    ctx = build_quad_context(2, box_quads(2, 2), device="cpu")
    path = tmp_path / "q.vtu"
    write_vtu(str(path), ctx, {"u": ctx.x})
    piece = ET.parse(path).getroot().find(".//Piece")
    assert int(piece.get("NumberOfCells")) == 4 * 4
    jc = j_quad(2, j_box_quads(2, 2))
    jpath = tmp_path / "jq.vtu"
    jvtk.write_vtu(str(jpath), jc, {"u": np.asarray(jc.x)})
    assert path.read_bytes() == jpath.read_bytes()
    # the batch writer: one file named after the first field
    out = write_fields_to_files(ctx, {"eta": ctx.y, "u": ctx.x}, 12,
                                str(tmp_path))
    jout = jvtk.write_fields_to_files(jc, {"eta": jc.y, "u": jc.x}, 13,
                                      str(tmp_path))
    assert out.endswith("eta0000012.vtu") and jout.endswith("eta0000013.vtu")
    assert open(out, "rb").read() == open(jout, "rb").read()


def test_csv_roundtrip(tmp_path):
    a = np.random.default_rng(0).normal(size=(5, 7))
    p = tmp_path / "f.dat"
    write_field(str(p), torch.as_tensor(a))
    np.testing.assert_allclose(read_field(str(p)), a, atol=0)
    jp = tmp_path / "j.dat"
    jcsv.write_field(str(jp), a)
    assert p.read_bytes() == jp.read_bytes()
    paths = tcsv.write_fields_to_files({"h": a, "u": 2 * a}, 3, str(tmp_path))
    assert [q.rsplit("/", 1)[1] for q in paths] == ["h0000003.dat",
                                                    "u0000003.dat"]
    np.testing.assert_allclose(read_field(paths[1]), 2 * a, atol=0)


def _state(dtype=F64):
    return SWState(h=torch.ones((4, 3), dtype=dtype) * 10,
                   hu=torch.arange(12.0, dtype=dtype).reshape(4, 3),
                   hv=torch.zeros((4, 3), dtype=dtype))


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, state, step=42, t=1.5, meta={"note": "x"})
    out, step, t, extra = restore_checkpoint(p, state)
    assert step == 42 and t == 1.5 and extra["note"] == "x"
    assert isinstance(out, SWState)
    for a, b in zip(out, state):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # the JAX package's file layout: leaf_<i> arrays and the meta record
    data = np.load(p)
    assert sorted(data.files) == ["__meta__", "leaf_0", "leaf_1", "leaf_2"]


def test_checkpoint_restore_validates_structure(tmp_path):
    """A mismatched template raises, not silently mis-assigns leaves."""
    state = SWState(h=torch.ones((4, 3), dtype=F64),
                    hu=torch.zeros((4, 3), dtype=F64),
                    hv=torch.zeros((4, 3), dtype=F64))
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, state)

    bad_shape = state._replace(h=torch.ones((5, 3), dtype=F64))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(p, bad_shape)

    bad_dtype = state._replace(h=torch.ones((4, 3), dtype=F32))
    with pytest.raises(ValueError, match="dtype"):
        restore_checkpoint(p, bad_dtype)
    out, *_ = restore_checkpoint(p, bad_dtype, strict_dtype=False)
    assert out.h.dtype == F32 and float(out.h.min()) == 1.0

    bad_tree = {"a": torch.ones((4, 3)), "b": torch.zeros((4, 3)),
                "c": torch.zeros((4, 3))}
    with pytest.raises(ValueError, match="treedef"):
        restore_checkpoint(p, bad_tree)

    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(p, (torch.ones((4, 3)), torch.zeros((4, 3))))


def test_checkpoint_mpc_resume(tmp_path):
    """Mid-solve MPC resume: checkpoint (controls, Adam state) after 5
    iterations, restore, run 5 more: identical to an uninterrupted
    10-iteration solve (the optimizer state's integer count included)."""
    from blitzdg_tpu_torch.mpc import MPCProblem, mpc_cost
    from blitzdg_tpu_torch.mpc.solver import adam_init, adam_update
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics

    ctx = build_triangle_context(1, box_triangles(2, 2), device="cpu")
    prob = MPCProblem(ctx=ctx, phys=SWPhysics(g=9.81), dt=1e-3, horizon=2,
                      steps_per_control=2, q_eta=0.0, q_terminal=1.0,
                      r_control=1e-8)
    h0 = torch.full((ctx.k_elem, ctx.n_p), 10.0, dtype=F64)
    state0 = SWState(h=h0, hu=torch.zeros_like(h0), hv=torch.zeros_like(h0))
    target = 1e-3 * torch.exp(-5.0 * (ctx.x**2 + ctx.y**2))
    bump = torch.exp(-8.0 * (ctx.x**2 + ctx.y**2))

    def forcing(c, control, state, t):
        return (torch.zeros_like(state.h), control[0] * bump,
                control[1] * bump)

    def run(carry, n):
        c, s = carry
        for _ in range(n):
            cc = c.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                mpc_cost(prob, state0, cc, target, forcing), cc)
            c, s = adam_update(g, s, c.detach(), 0.05)
        return c, s

    c0 = torch.zeros((prob.horizon, 2), dtype=F64)
    carry = run((c0, adam_init(c0)), 5)
    p = str(tmp_path / "mpc.npz")
    save_checkpoint(p, carry, step=5)
    restored, step, _, _ = restore_checkpoint(p, carry)
    assert step == 5 and restored[1].count == 5
    assert isinstance(restored[1].count, int)
    c_resumed, _ = run(restored, 5)
    c_straight, _ = run((c0, adam_init(c0)), 10)
    assert torch.equal(c_resumed, c_straight)


def test_gmsh_roundtrip(tmp_path):
    for mesh, jmesh in ((box_triangles(3, 2), j_box_triangles(3, 2)),
                        (box_quads(2, 3), j_box_quads(2, 3))):
        p = tmp_path / "m.msh"
        write_gmsh(str(p), mesh)
        mesh2 = read_gmsh(str(p))
        np.testing.assert_allclose(mesh2.verts, mesh.verts)
        np.testing.assert_array_equal(mesh2.etov, mesh.etov)
        np.testing.assert_array_equal(mesh2.etoe, mesh.etoe)
        np.testing.assert_array_equal(mesh2.bc_type, mesh.bc_type)
        jp = tmp_path / "j.msh"
        j_write_gmsh(str(jp), jmesh)
        assert p.read_bytes() == jp.read_bytes()


def test_csvread_fixtures(tmp_path):
    """Blank lines are skipped, commas or blanks separate values, a ragged
    row raises (the reference library's CSV reader's cases)."""
    ok = tmp_path / "csvtest1.csv"
    ok.write_text("1.0, 2.0\n\n3.5 4.5\n  \n-1e3,7\n")
    m = csvread(str(ok))
    np.testing.assert_array_equal(m, [[1.0, 2.0], [3.5, 4.5], [-1e3, 7.0]])
    np.testing.assert_array_equal(m, jcsv.csvread(str(ok)))
    ragged = tmp_path / "csvtest3.csv"
    ragged.write_text("1 2 3\n4 5\n")
    with pytest.raises(ValueError, match="columns"):
        csvread(str(ragged))
    empty = tmp_path / "empty.csv"
    empty.write_text("\n\n")
    assert csvread(str(empty)).shape == (0, 0)


def test_read_csv_mesh_2box(tmp_path):
    """A two-quad mesh from vertex and element files: the two quads share
    exactly one face."""
    v = tmp_path / "2box.V"
    v.write_text("0 0 0\n1 0 0\n2 0 0\n0 1 0\n1 1 0\n2 1 0\n")
    e = tmp_path / "2box.E2V"
    e.write_text("0 1 4 3\n1 2 5 4\n")
    mesh = read_csv_mesh(str(v), str(e))
    assert mesh.num_elements == 2 and mesh.num_faces == 4
    assert mesh.verts.shape == (6, 2)
    etoe = mesh.etoe
    assert (etoe[0] == 1).sum() + (etoe[1] == 0).sum() == 2


def test_read_depth_data(tmp_path):
    """One value per row, element-major fill (node fastest), clip-up at
    150 m applied to every entry, missing trailing values included."""
    vals = [200.0, 100.0, 175.5, 149.9, 300.0]
    p = tmp_path / "depth.oct"
    p.write_text("\n".join(str(v) for v in vals) + "\n")
    H = read_depth_data(str(p), k_elem=2, n_p=3)
    assert H.shape == (2, 3)
    np.testing.assert_allclose(H[0], [200.0, 150.0, 175.5])
    np.testing.assert_allclose(H[1], [150.0, 300.0, 150.0])
    np.testing.assert_array_equal(H, jcsv.read_depth_data(str(p), 2, 3))
