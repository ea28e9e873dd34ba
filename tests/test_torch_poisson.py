"""The port's elliptic operators, assemblies and preconditioners against the
JAX package's on the same inputs (CPU, float64; each package builds its own
context from the same mesh).

 - ``poisson2d_op`` (with and without ``symmetrize``, with Neumann faces)
   and ``apply_mass`` on ``box_triangles(4, 4)`` at N=2 and N=3,
   ``poisson1d_op`` on ``build_nodes1d``, and on the curved N=3 disk of
   ``tests/test_poisson.py::TestCurvedSIP`` ``apply_mass_curved``,
   ``poisson2d_curved_op`` and ``poisson2d_curved_sip_op``: to 1e-12 of
   the largest entry, on a batch of random fields (the JAX operator under
   vmap);
 - ``assemble_poisson2d``, ``assemble_poisson2d_curved`` and
   ``assemble_bc_rhs``: the same sparse pattern and values;
 - block-Jacobi (assembled and probed) and two-level applications equal;
 - the manufactured solves of ``TestPoisson1D``/``TestPoisson2D`` equal to
   the JAX solve (flag, iterations, solution);
 - ``convert.context1d_from_numpy``: a JAX 1D context carried across gives
   the port's ``poisson1d_op`` result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.ops import poisson as JP
from blitzdg_tpu.solvers import krylov as jk
from blitzdg_tpu.solvers import precon as jpre
from blitzdg_tpu.specgrid.nodes1d import build_nodes1d as j_nodes1d
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.context import BC_DIRICHLET, BC_NEUMAN
from blitzdg_tpu_torch.mesh import box_triangles as t_box
from blitzdg_tpu_torch.ops import poisson as TP
from blitzdg_tpu_torch.solvers import krylov as tk
from blitzdg_tpu_torch.solvers import precon as tpre
from blitzdg_tpu_torch.specgrid import build_nodes1d as t_nodes1d
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context as t_build

F64 = torch.float64


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


def with_neumann_east(mesh):
    """Boundary faces on x = +1 become Neumann, the rest Dirichlet."""
    mids = 0.5 * (mesh.verts[mesh.etov] + mesh.verts[mesh.etov[:, [1, 2, 0]]])
    bc = mesh.bc_type.copy()
    on = bc > 0
    east = np.abs(mids[:, :, 0] - 1.0) < 1e-12
    bc[on & east] = BC_NEUMAN
    bc[on & ~east] = BC_DIRICHLET
    mesh.set_bc_type(bc)
    return mesh


def box_pair(n_order, cells=4, neumann=False):
    jm, tm = j_box(cells, cells), t_box(cells, cells)
    if neumann:
        jm, tm = with_neumann_east(jm), with_neumann_east(tm)
    return j_build(n_order, jm), t_build(n_order, tm, dtype=F64, device="cpu")


def fields(ctx, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, ctx.k_elem, ctx.n_p))


@pytest.mark.parametrize("n_order", [2, 3])
@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_poisson2d_op_matches_jax(n_order, neumann, symmetrize):
    jc, tc = box_pair(n_order, neumann=neumann)
    u = fields(jc, seed=n_order)
    want = jax.vmap(lambda v: JP.poisson2d_op(jc, v, symmetrize=symmetrize))(
        jnp.asarray(u))
    got = TP.poisson2d_op(tc, torch.as_tensor(u), symmetrize=symmetrize)
    close(got.numpy(), want)
    # unbatched too
    close(TP.poisson2d_op(tc, torch.as_tensor(u[0]),
                          symmetrize=symmetrize).numpy(), want[0])


@pytest.mark.parametrize("n_order", [2, 3])
def test_apply_mass_matches_jax(n_order):
    jc, tc = box_pair(n_order)
    u = fields(jc)
    close(TP.apply_mass(tc, torch.as_tensor(u)).numpy(),
          jax.vmap(lambda v: JP.apply_mass(jc, v))(jnp.asarray(u)))


@pytest.mark.parametrize("n_order,k_elem", [(4, 15), (3, 8)])
def test_poisson1d_op_and_nodes1d_match_jax(n_order, k_elem):
    jc = j_nodes1d(n_order, k_elem, -1.0, 1.0)
    tc = t_nodes1d(n_order, k_elem, -1.0, 1.0, device="cpu")
    for name in ("r", "V", "Vinv", "Dr", "lift", "x", "J", "rx", "nx",
                 "fscale", "vmapM", "vmapP", "mapP", "fmask"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for name in ("mapI", "mapO", "vmapI", "vmapO"):
        assert getattr(tc, name) == getattr(jc, name)
    u = fields(jc)
    for sym in (True, False):
        want = jax.vmap(lambda v: JP.poisson1d_op(jc, v, symmetrize=sym))(
            jnp.asarray(u))
        close(TP.poisson1d_op(tc, torch.as_tensor(u), symmetrize=sym).numpy(),
              want)


def test_context1d_from_numpy_gives_the_same_operator():
    jc = j_nodes1d(4, 15, -1.0, 1.0)
    arrays = {f: (getattr(jc, f) if isinstance(getattr(jc, f), int)
                  else np.asarray(getattr(jc, f)))
              for f in jc.__dataclass_fields__}
    tc = convert.context1d_from_numpy(arrays, device="cpu", dtype=F64)
    u = fields(jc, n=1)[0]
    close(TP.poisson1d_op(tc, torch.as_tensor(u)).numpy(),
          JP.poisson1d_op(jc, jnp.asarray(u)))
    assert tc.mapO == jc.mapO and tc.vmapO == jc.vmapO


@pytest.fixture(scope="module")
def disk():
    """The curved N=3 disk of TestCurvedSIP, built by each package."""
    from blitzdg_tpu.mesh.curved import circle_projection as jproj
    from blitzdg_tpu.mesh.curved import gordon_hall_deform as jgh
    from blitzdg_tpu.mesh.curved import snap_boundary_vertices as jsnap
    from blitzdg_tpu.mesh.generators import disk_triangles as jdisk
    from blitzdg_tpu.specgrid.cubature import build_cubature_context as jcub
    from blitzdg_tpu.specgrid.cubature import build_gauss_face_context as jgf
    from blitzdg_tpu_torch.mesh import disk_triangles as tdisk
    from blitzdg_tpu_torch.mesh.curved import (circle_projection,
                                               gordon_hall_deform,
                                               snap_boundary_vertices)
    from blitzdg_tpu_torch.specgrid.cubature import (build_cubature_context,
                                                     build_gauss_face_context)

    N = 3
    mesh = jdisk(3, radius=1.0)
    proj = jproj(0.0, 0.0, 1.0)
    faces = jsnap(mesh, proj, tol=0.3)
    host = j_build(N, mesh, dtype=None)
    x2, y2, _ = jgh(N, mesh, host.x, host.y, faces, proj)
    jside = (j_build(N, mesh, coords=(x2, y2)),
             jcub(N, mesh, x2, y2, host.V), jgf(N, mesh, x2, y2, host.V))

    tmesh = tdisk(3, radius=1.0)
    tproj = circle_projection(0.0, 0.0, 1.0)
    tfaces = snap_boundary_vertices(tmesh, tproj, tol=0.3)
    thost = t_build(N, tmesh, dtype=F64, device="cpu")
    tx, ty, _ = gordon_hall_deform(N, tmesh, thost.x.numpy(), thost.y.numpy(),
                                   tfaces, tproj)
    V = thost.V.numpy()
    tside = (t_build(N, tmesh, coords=(tx, ty), dtype=F64, device="cpu"),
             build_cubature_context(N, tmesh, tx, ty, V, device="cpu"),
             build_gauss_face_context(N, tmesh, tx, ty, V, device="cpu"))
    return jside, tside


@pytest.mark.parametrize("name", ["poisson2d_curved_op",
                                  "poisson2d_curved_sip_op"])
def test_curved_operators_match_jax(disk, name):
    (jc, jcb, jg), (tc, tcb, tg) = disk
    u = fields(jc, seed=4)
    want = jax.vmap(lambda v: getattr(JP, name)(jc, jcb, jg, v))(
        jnp.asarray(u))
    close(getattr(TP, name)(tc, tcb, tg, torch.as_tensor(u)).numpy(), want)


def test_apply_mass_curved_matches_jax(disk):
    (jc, jcb, _), (tc, tcb, _) = disk
    u = fields(jc, seed=5)
    close(TP.apply_mass_curved(tcb, torch.as_tensor(u)).numpy(),
          jax.vmap(lambda v: JP.apply_mass_curved(jcb, v))(jnp.asarray(u)))


def same_sparse(got, want, tol=1e-12):
    got, want = got.tocsr(), want.tocsr()
    got.sort_indices()
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    close(got.data, want.data, tol)


@pytest.mark.parametrize("n_order,neumann,bordered",
                         [(2, False, False), (3, True, False),
                          (2, False, True)])
def test_assemble_poisson2d_matches_jax(n_order, neumann, bordered):
    jc, tc = box_pair(n_order, neumann=neumann)
    jop, jmm = JP.assemble_poisson2d(jc, bordered=bordered)
    top, tmm = TP.assemble_poisson2d(tc, bordered=bordered)
    same_sparse(top, jop)
    same_sparse(tmm, jmm)


def test_assemble_poisson2d_curved_matches_jax(disk):
    (jc, jcb, jg), (tc, tcb, tg) = disk
    jop, jmm = JP.assemble_poisson2d_curved(jc, jcb, jg)
    top, tmm = TP.assemble_poisson2d_curved(tc, tcb, tg)
    same_sparse(top, jop)
    same_sparse(tmm, jmm)
    # and the assembled operator is the matrix-free SIP operator
    u = fields(jc, n=1, seed=6)[0]
    close((top @ u.reshape(-1)).reshape(u.shape),
          TP.poisson2d_curved_sip_op(tc, tcb, tg, torch.as_tensor(u)).numpy())


def test_assemble_bc_rhs_matches_jax():
    """Mixed Dirichlet (y = +-1) / Neumann (x = +-1) data of
    tests/test_bc_rhs.py on box_triangles(5, 5) at N=3."""
    def mixed(mesh):
        mids = 0.5 * (mesh.verts[mesh.etov]
                      + mesh.verts[mesh.etov[:, [1, 2, 0]]])
        bc = mesh.bc_type.copy()
        on = bc > 0
        on_x = np.abs(np.abs(mids[:, :, 0]) - 1.0) < 1e-12
        bc[on & on_x] = BC_NEUMAN
        bc[on & ~on_x] = BC_DIRICHLET
        mesh.set_bc_type(bc)
        return mesh

    jc = j_build(3, mixed(j_box(5, 5)), dtype=None)
    tc = t_build(3, mixed(t_box(5, 5)), dtype=F64, device="cpu")
    x = np.asarray(jc.x)
    K, n_tr = jc.k_elem, jc.n_faces * jc.n_fp
    vm = np.asarray(jc.vmapM)
    ubc = (x ** 2).reshape(-1)[vm].reshape(K, n_tr)
    qbc = 2.0 * x.reshape(-1)[vm].reshape(K, n_tr) * np.asarray(jc.nx)
    want = JP.assemble_bc_rhs(jc, ubc, qbc)
    got = TP.assemble_bc_rhs(tc, ubc, qbc)
    close(got, want)
    # the manufactured solve of tests/test_bc_rhs.py: u = x^2
    OP, MM = TP.assemble_poisson2d(tc)
    f = np.full(K * jc.n_p, -2.0)
    u = spla.spsolve(OP.tocsc(), MM @ f + got.reshape(-1))
    assert np.max(np.abs(u - (x ** 2).reshape(-1))) < 1e-7


def test_block_jacobi_and_two_level_match_jax():
    jc, tc = box_pair(2, cells=3)
    OP, _ = JP.assemble_poisson2d(jc)
    top, _ = TP.assemble_poisson2d(tc)
    K, n_p = jc.k_elem, jc.n_p
    np.testing.assert_array_equal(
        tpre.block_diagonal_blocks(top, K, n_p),
        jpre.block_diagonal_blocks(OP, K, n_p))

    # probed blocks of the assembled operator applied matrix-free
    Aj, At = jnp.asarray(OP.toarray()), torch.as_tensor(top.toarray())
    probed_j = jpre.probe_diagonal_blocks(
        lambda u: (Aj @ u.reshape(-1)).reshape(u.shape), jc)
    probed_t = tpre.probe_diagonal_blocks(
        lambda u: (u.reshape(*u.shape[:-2], -1) @ At.T).reshape(u.shape), tc)
    close(probed_t, probed_j)
    close(probed_t, tpre.block_diagonal_blocks(top, K, n_p))

    v = np.random.default_rng(3).standard_normal((2, K * n_p))
    vj, vt = jnp.asarray(v), torch.as_tensor(v)
    kw = dict(dtype=F64, device="cpu")
    pairs = [
        (jpre.block_jacobi_from_assembled(OP, K, n_p),
         tpre.block_jacobi_from_assembled(top, K, n_p, **kw)),
        (jpre.block_jacobi_precon(probed_j),
         tpre.block_jacobi_precon(probed_t, **kw)),
        (jpre.two_level_from_assembled(jc, OP),
         tpre.two_level_from_assembled(tc, top, **kw)),
        (jpre.two_level_from_assembled(jc, -OP, sign=-1.0),
         tpre.two_level_from_assembled(tc, -top, sign=-1.0, **kw)),
    ]
    for pj, pt in pairs:
        close(pt(vt).numpy(), jax.vmap(pj)(vj))
        close(pt(vt[0]).numpy(), pj(vj[0]))
    # the matrix-free probe of the symmetrized operator
    mv_j = lambda u: -JP.poisson2d_op(jc, u, symmetrize=True)
    mv_t = lambda u: -TP.poisson2d_op(tc, u, symmetrize=True)
    close(tpre.probe_diagonal_blocks(mv_t, tc),
          jpre.probe_diagonal_blocks(mv_j, jc))
    np.testing.assert_array_equal(
        tpre.greedy_color(tpre.element_adjacency(tc)),
        jpre.greedy_color(jpre.element_adjacency(jc)))


def same_solve(rj, rt, x_rtol=1e-10):
    assert int(rt.flag) == int(rj.flag) == tk.CONV_SUCCESS
    assert int(rt.iters) == int(rj.iters)
    close(rt.x.numpy(), rj.x, x_rtol)


def test_poisson1d_manufactured_solve_matches_jax():
    """-u'' = pi^2 sin(pi x), u(+-1) = 0, N=4, K=15, by CG on the
    symmetrized SIP operator."""
    jc = j_nodes1d(4, 15, -1.0, 1.0)
    tc = t_nodes1d(4, 15, -1.0, 1.0, device="cpu")
    fj = np.pi ** 2 * jnp.sin(np.pi * jc.x)
    ft = np.pi ** 2 * torch.sin(np.pi * tc.x)
    shape = (jc.k_elem, jc.n_p)
    rj = jk.cg(lambda v: -JP.poisson1d_op(jc, v.reshape(shape)).reshape(-1),
               JP.apply_mass(jc, fj).reshape(-1), tol=1e-10, maxiter=2000)
    rt = tk.cg(lambda v: -TP.poisson1d_op(tc, v.reshape(shape)).reshape(-1),
               TP.apply_mass(tc, ft).reshape(-1), tol=1e-10, maxiter=2000)
    same_solve(rj, rt)
    np.testing.assert_allclose(rt.x.numpy().reshape(shape),
                               np.sin(np.pi * tc.x.numpy()), atol=2e-5)


@pytest.fixture(scope="module")
def box63():
    jc, tc = box_pair(3, cells=6)
    uj = jnp.sin(np.pi * jc.x) * jnp.sin(np.pi * jc.y)
    ut = torch.sin(np.pi * tc.x) * torch.sin(np.pi * tc.y)
    return jc, tc, uj, ut


def test_poisson2d_gmres_manufactured_solve_matches_jax(box63):
    """Lap u = -2 pi^2 sin(pi x) sin(pi y), u = 0 on the walls, by GMRES on
    the strong-form operator (box_triangles(6, 6), N=3)."""
    jc, tc, uj, ut = box63
    shape = (jc.k_elem, jc.n_p)
    kw = dict(tol=1e-8, restart=200, maxiter=20)
    rj = jk.gmres(lambda v: JP.poisson2d_op(jc, v.reshape(shape)).reshape(-1),
                  (-2.0 * np.pi ** 2 * uj).reshape(-1), **kw)
    rt = tk.gmres(lambda v: TP.poisson2d_op(tc, v.reshape(shape)).reshape(-1),
                  (-2.0 * np.pi ** 2 * ut).reshape(-1), **kw)
    same_solve(rj, rt)
    assert np.max(np.abs(rt.x.numpy().reshape(shape) - ut.numpy())) < 5e-3


def test_poisson2d_cg_symmetrized_and_preconditioned_match_jax(box63):
    """CG on -J M L (box_triangles(6, 6), N=3), plain and with block-Jacobi
    from the assembled operator, against the same JAX solves; and the
    assembled operator's direct solve."""
    jc, tc, uj, ut = box63
    shape = (jc.k_elem, jc.n_p)
    bj = -JP.apply_mass(jc, -2.0 * np.pi ** 2 * uj).reshape(-1)
    bt = -TP.apply_mass(tc, -2.0 * np.pi ** 2 * ut).reshape(-1)
    mv_j = lambda v: -JP.poisson2d_op(jc, v.reshape(shape),
                                      symmetrize=True).reshape(-1)
    mv_t = lambda v: -TP.poisson2d_op(tc, v.reshape(*v.shape[:-1], *shape),
                                      symmetrize=True).reshape(v.shape)
    rj = jk.cg(mv_j, bj, tol=1e-9, maxiter=4000)
    rt = tk.cg(mv_t, bt, tol=1e-9, maxiter=4000)
    same_solve(rj, rt, x_rtol=1e-9)
    assert np.max(np.abs(rt.x.numpy().reshape(shape) - ut.numpy())) < 5e-3

    OP, MM = JP.assemble_poisson2d(jc)
    top, tmm = TP.assemble_poisson2d(tc)
    pj = jpre.block_jacobi_from_assembled(OP, jc.k_elem, jc.n_p)
    pt = tpre.block_jacobi_from_assembled(top, tc.k_elem, tc.n_p, dtype=F64,
                                          device="cpu")
    rj = jk.cg(mv_j, bj, tol=1e-9, maxiter=4000, precon=pj)
    rt = tk.cg(mv_t, bt, tol=1e-9, maxiter=4000, precon=pt)
    same_solve(rj, rt, x_rtol=1e-9)

    u = spla.spsolve(top.tocsc(), tmm @ (2.0 * np.pi ** 2 * ut.numpy()
                                         ).reshape(-1))
    assert np.max(np.abs(u - ut.numpy().reshape(-1))) < 5e-3
