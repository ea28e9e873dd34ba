"""The element-sharded plain-tensor path of ``parallel/halo.py`` on the CPU,
in float64: the port's stacked transport (every shard on one device, a
leading shard axis) against the JAX function under ``shard_map`` over the
virtual devices, and against the port's unsharded function, to 1e-11.

Mirrors ``tests/test_parallel.py`` (the halo RHS on ``box_triangles(4, 8)``
partitioned into 8, plain and coastal with tidal forcing, drag and
Coriolis; the 10-step coastal rollout with ``halo_sw2d_timestep``; the case
where a boundary list has K entries; ghost padding, here on a mesh from
``mesh/generators`` since the reference's mesh files are absent (ROADMAP
C1); the curved RHS on the Gordon-Hall disk) and
``tests/test_poisson.py::TestShardedElliptic`` (``halo_poisson2d_op`` in CG
and GMRES). Besides: ``halo_comm_model``'s byte counts, bfloat16 halos
(both packages cast the shipped buffer alone, to the same bits), gradients
of the stacked RHS against ``jax.grad``, and two gloo processes running the
RHS and the halo CG over a process group, equal to the stacked transport.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from blitzdg_tpu import parallel as JP
from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops.poisson import apply_mass as j_apply_mass
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays, jax_fields

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch import parallel as TP
from blitzdg_tpu_torch.ops.poisson import poisson2d_op
from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState, sw2d_rhs, sw2d_timestep
from blitzdg_tpu_torch.solvers import cg, gmres
from blitzdg_tpu_torch.solvers.krylov import CONV_SUCCESS
from blitzdg_tpu_torch.timestepping import ssprk2_step

S = 8
F64 = torch.float64
ATOL = 1e-11


def _el_mesh(n=S):
    return Mesh(np.array(jax.devices()[:n]), ("element",))


def _row_specs(tables):
    return tuple(P("element", *([None] * (a.ndim - 1))) for a in tables)


def _split(a, n=S):
    """(K, ...) numpy -> (S, K/S, ...) tensor: the stacked shards."""
    a = torch.as_tensor(np.asarray(a))
    return a.reshape(n, a.shape[0] // n, *a.shape[1:])


def _join(a):
    return a.reshape(-1, *a.shape[2:]).numpy()


class Pair:
    """One partitioned JAX context, the port's from its arrays, and their
    halo plans, tables and stacked shard context."""

    def __init__(self, jc, n=S):
        self.jc, self.n = jc, n
        arrays, static = jax_arrays(jc)
        self.tc = convert.context_from_numpy(arrays, static, device="cpu",
                                             dtype=F64)
        self.jplan = JP.build_halo_plan(jc, n)
        self.jtables = JP.halo_tables(self.jplan)
        self.plan = TP.build_halo_plan(self.tc, n)
        self.tables = TP.halo_tables(self.plan, device="cpu")
        self.sc = TP.shard_context(self.tc, n)


def _partitioned(mesh0, n_order=2, n=S):
    mesh, _, _ = JP.partition_mesh(mesh0, n)
    return Pair(j_build(n_order, mesh), n)


@pytest.fixture(scope="module")
def box():
    return _partitioned(j_box(4, 8))


def _j_halo_rhs(p, state, phys, forcing=None, halo_dtype=None):
    el = P("element", None)
    st = jax.tree.map(lambda a: el, state)
    ph = jax.tree.map(lambda a: el, phys)
    fn = jax.shard_map(
        lambda c, s, ph_, tb: JP.halo_sw2d_rhs(
            c, s, 0.3, ph_, tb, p.jplan, tidal_forcing=forcing,
            halo_dtype=halo_dtype),
        mesh=_el_mesh(p.n),
        in_specs=(JP.context_shard_specs(p.jc), st, ph,
                  _row_specs(p.jtables)),
        out_specs=st)
    return jax.jit(fn)(p.jc, state, phys, p.jtables)


def _coastal(p, rng):
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    H = 10.0 + 2.0 * x + rng.uniform(0.0, 1.0, size=(x.shape[0], 1))
    Hx, Hy = (np.asarray(a) for a in p.jc.grad(jnp.asarray(H)))
    return dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy)


def _physics(phys_np, n=S):
    """The JAX physics, the port's unsharded one and the port's stacked
    one (its fields split into the shards)."""
    j = jsw.SWPhysics(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in phys_np.items()})
    t = SWPhysics(**{k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                     else v for k, v in phys_np.items()})
    s = SWPhysics(**{k: _split(v, n) if isinstance(v, np.ndarray) else v
                     for k, v in phys_np.items()})
    return j, t, s


@pytest.mark.parametrize("kind", ["flat", "coastal", "coastal_bf16"])
def test_halo_sw2d_rhs_matches_jax_and_unsharded(box, kind):
    """Flat (mirrors ``test_ppermute_halo_exchange_matches_single``) and
    coastal: well-balanced bathymetry, tidal forcing on an open east side,
    drag, Coriolis, nonzero momentum at the walls. With a bfloat16 halo the
    port equals the JAX function (both cast the shipped buffer alone), and
    the RHS differs from the full-precision one on the elements with a cut
    face alone."""
    p = box
    rng = np.random.default_rng(0)
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    phys_np = dict(g=9.81) if kind == "flat" else _coastal(p, rng)
    H = phys_np.get("H", 10.0)
    eta = 0.1 * np.exp(-5.0 * (x ** 2 + y ** 2))
    s_np = (H + eta, 0.3 * (H + eta), -0.2 * (H + eta))
    jphys, tphys, sphys = _physics(phys_np)
    forcing = None
    pc = p
    if kind != "flat":
        # the open east side (a new context: the tags live in bc_maps)
        m0 = j_box(4, 8)
        mids = 0.5 * (m0.verts[m0.etov][:, :, 0]
                      + m0.verts[m0.etov[:, [1, 2, 0]]][:, :, 0])
        bc = m0.bc_type.copy()
        bc[(bc > 0) & (np.abs(mids - 1.0) < 1e-6)] = BC_OUT
        m0.set_bc_type(bc)
        pc = _partitioned(m0)
        forcing = lambda t: 12.0 + 0.5 * np.cos(0.3 * t)
    halo_dtype = kind.endswith("bf16")
    want = _j_halo_rhs(pc, jsw.SWState(*map(jnp.asarray, s_np)), jphys,
                       forcing and (lambda t: 12.0 + 0.5 * jnp.cos(0.3 * t)),
                       jnp.bfloat16 if halo_dtype else None)
    got = TP.halo_sw2d_rhs(pc.sc, SWState(*map(_split, s_np)), 0.3, sphys,
                           pc.tables, pc.plan, tidal_forcing=forcing,
                           halo_dtype=torch.bfloat16 if halo_dtype else None)
    ref = sw2d_rhs(pc.tc, SWState(*map(torch.as_tensor, s_np)), 0.3, tphys,
                   tidal_forcing=forcing)
    # with a bfloat16 halo, only the elements with a face on the cut see it
    f_loc = pc.plan.psrc.shape[1]
    cut = (pc.plan.psrc >= f_loc).reshape(S, -1, pc.tc.n_faces).any(-1)
    cut = cut.reshape(-1)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(_join(g), np.asarray(w), rtol=0, atol=ATOL)
        keep = ~cut if halo_dtype else slice(None)
        np.testing.assert_allclose(_join(g)[keep], r.numpy()[keep], rtol=0,
                                   atol=ATOL)
        if halo_dtype:
            assert np.abs(_join(g)[cut] - r.numpy()[cut]).max() > ATOL


def test_halo_coastal_rollout_with_adaptive_dt(box):
    """Mirrors ``test_halo_coastal_rollout_matches_single``: 10 SSP-RK2
    steps with the halo RHS (coastal physics, tidal forcing) and the
    sharded adaptive dt, against the port's unsharded rollout and the JAX
    sharded rollout under ``shard_map``."""
    m0 = j_box(4, 8)
    mids = 0.5 * (m0.verts[m0.etov][:, :, 0]
                  + m0.verts[m0.etov[:, [1, 2, 0]]][:, :, 0])
    bc = m0.bc_type.copy()
    bc[(bc > 0) & (np.abs(mids - 1.0) < 1e-6)] = BC_OUT
    m0.set_bc_type(bc)
    p = _partitioned(m0)
    phys_np = _coastal(p, np.random.default_rng(3))
    jphys, tphys, sphys = _physics(phys_np)
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    eta = 0.1 * np.exp(-5.0 * (x ** 2 + y ** 2))
    s_np = (phys_np["H"] + eta, 0.05 * eta, 0.0 * eta)
    cfl = 0.3

    def j_body(c, s, t, ph, tb):
        dt = JP.halo_sw2d_timestep(c, s, ph.g, cfl)
        rhs = lambda ss, tt: JP.halo_sw2d_rhs(
            c, ss, tt, ph, tb, p.jplan,
            tidal_forcing=lambda t_: 12.0 + 0.5 * jnp.cos(0.3 * t_))
        from blitzdg_tpu.timestepping import ssprk2_step as j_step
        return j_step(rhs, s, t, dt), t + dt

    el = P("element", None)
    st = jax.tree.map(lambda a: el, jsw.SWState(*map(jnp.asarray, s_np)))
    fn = jax.shard_map(j_body, mesh=_el_mesh(),
                       in_specs=(JP.context_shard_specs(p.jc), st, P(),
                                 jax.tree.map(lambda a: el, jphys),
                                 _row_specs(p.jtables)),
                       out_specs=(st, P()))

    @jax.jit
    def j_run(s):
        def body(carry, _):
            return fn(p.jc, carry[0], carry[1], jphys, p.jtables), None
        return jax.lax.scan(body, (s, 0.0), None, length=10)[0]

    want, t_want = j_run(jsw.SWState(*map(jnp.asarray, s_np)))

    forcing = lambda t: 12.0 + 0.5 * torch.cos(torch.as_tensor(0.3 * t))
    st_s, t_s = SWState(*map(_split, s_np)), torch.zeros((), dtype=F64)
    st_u, t_u = SWState(*map(torch.as_tensor, s_np)), torch.zeros((), dtype=F64)
    for _ in range(10):
        dt = TP.halo_sw2d_timestep(p.sc, st_s, 9.81, cfl)
        st_s = ssprk2_step(lambda ss, tt: TP.halo_sw2d_rhs(
            p.sc, ss, tt, sphys, p.tables, p.plan, tidal_forcing=forcing),
            st_s, t_s, dt)
        t_s = t_s + dt
        dtu = sw2d_timestep(p.tc, st_u, 9.81, cfl)
        st_u = ssprk2_step(lambda ss, tt: sw2d_rhs(
            p.tc, ss, tt, tphys, tidal_forcing=forcing), st_u, t_u, dtu)
        t_u = t_u + dtu
    np.testing.assert_allclose(float(t_s), float(t_want), rtol=1e-14)
    np.testing.assert_allclose(float(t_s), float(t_u), rtol=1e-14)
    for g, w, r in zip(st_s, want, st_u):
        np.testing.assert_allclose(_join(g), np.asarray(w), rtol=0, atol=ATOL)
        np.testing.assert_allclose(_join(g), r.numpy(), rtol=0, atol=ATOL)


def test_bc_maps_replicated_when_count_equals_k():
    """Mirrors the JAX test: on ``box_triangles(4, 4)`` at N=1 the wall list
    has K = 32 entries; it stays global, and the symmetrized halo Laplacian
    and the halo RHS with nonzero wall momentum are exact."""
    p = Pair(j_build(1, j_box(4, 4)))
    assert int(p.tc.bc_maps.mask[3].sum()) == p.tc.k_elem
    specs = TP.context_shard_specs(p.tc)
    assert specs["bc_maps"] is None and specs["x"] == "element"
    assert torch.equal(p.sc.bc_maps.idx[3], p.tc.bc_maps.idx[3])
    u = np.random.default_rng(0).normal(size=(p.tc.k_elem, p.tc.n_p))
    tau = float((p.tc.n_order + 1) ** 2 * p.tc.fscale.max())
    ref = poisson2d_op(p.tc, torch.as_tensor(u), tau=tau, symmetrize=True)
    got = TP.halo_poisson2d_op(p.sc, _split(u), tau, p.tables, p.plan,
                               symmetrize=True)
    np.testing.assert_allclose(_join(got), ref.numpy(), rtol=0, atol=ATOL)
    fn = jax.shard_map(
        lambda c, uu, tb: JP.halo_poisson2d_op(c, uu, tau, tb, p.jplan,
                                               symmetrize=True),
        mesh=_el_mesh(), in_specs=(JP.context_shard_specs(p.jc),
                                   P("element", None), _row_specs(p.jtables)),
        out_specs=P("element", None))
    want = jax.jit(fn)(p.jc, jnp.asarray(u), p.jtables)
    np.testing.assert_allclose(_join(got), np.asarray(want), rtol=0,
                               atol=ATOL)
    h = 10.0 + np.exp(-10.0 * (np.asarray(p.jc.x) ** 2
                               + np.asarray(p.jc.y) ** 2))
    s_np = (h, 0.3 * h, -0.2 * h)
    got = TP.halo_sw2d_rhs(p.sc, SWState(*map(_split, s_np)), 0.0,
                           SWPhysics(g=9.81), p.tables, p.plan)
    ref = sw2d_rhs(p.tc, SWState(*map(torch.as_tensor, s_np)), 0.0,
                   SWPhysics(g=9.81))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_join(g), r.numpy(), rtol=0, atol=ATOL)


class TestGhostPadding:
    """Ghost-element padding of a context whose K does not divide into the
    shards (``pad_context``), on ``box_triangles(3, 5)`` (K = 30) over 8
    shards: the halo RHS and dt, and the halo CG, equal the unsharded,
    unpadded results on the real elements."""

    @pytest.fixture(scope="class")
    def padded(self):
        from blitzdg_tpu_torch.mesh import box_triangles
        from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

        mesh0 = box_triangles(3, 5)
        assert mesh0.num_elements % S != 0
        sizes = TP.partition_block_sizes(mesh0, S)
        mesh, _, kp = TP.partition_mesh(mesh0, S)
        ctx = build_triangle_context(1, mesh, dtype=F64, device="cpu")
        ctx_p, real = TP.pad_context(ctx, sizes)
        assert ctx_p.k_elem == S * kp and int(real.sum()) == ctx.k_elem
        plan = TP.build_halo_plan(ctx_p, S)
        return (ctx, ctx_p, np.asarray(real), TP.shard_context(ctx_p, S),
                plan, TP.halo_tables(plan, device="cpu"))

    def _pad(self, ctx_p, real, f, fill):
        out = torch.full((ctx_p.k_elem, f.shape[-1]), fill, dtype=f.dtype)
        out[torch.as_tensor(np.flatnonzero(real))] = f
        return out

    def test_padded_rhs_and_dt_match_unpadded(self, padded):
        ctx, ctx_p, real, sc, plan, tables = padded
        phys = SWPhysics(g=9.81)
        h = 10.0 + torch.exp(-3.0 * (ctx.x ** 2 + ctx.y ** 2))
        state = SWState(h, 0.3 * h, -0.2 * h)
        ref = sw2d_rhs(ctx, state, 0.0, phys)
        dt_ref = sw2d_timestep(ctx, state, 9.81, 0.4)
        sp = SWState(*(_split(self._pad(ctx_p, real, f, fill)) for f, fill
                       in zip(state, (1.0, 0.0, 0.0))))
        out = TP.halo_sw2d_rhs(sc, sp, 0.0, phys, tables, plan)
        dt = TP.halo_sw2d_timestep(sc, sp, 9.81, 0.4)
        for g, w in zip(out, ref):
            np.testing.assert_allclose(_join(g)[real], w.numpy(), rtol=0,
                                       atol=0)
        assert float(dt) == float(dt_ref)

    def test_padded_sharded_cg_matches_unpadded(self, padded):
        from blitzdg_tpu_torch.ops.poisson import apply_mass

        ctx, ctx_p, real, sc, plan, tables = padded
        tau = float((ctx.n_order + 1) ** 2 * ctx.fscale.max())
        uex = torch.sin(np.pi * ctx.x) * torch.sin(np.pi * ctx.y)
        b = -apply_mass(ctx, -2.0 * np.pi ** 2 * uex)
        ref = cg(lambda v: -poisson2d_op(ctx, v.reshape(ctx.k_elem, -1),
                                         tau=tau, symmetrize=True).reshape(-1),
                 b.reshape(-1), tol=1e-10, maxiter=4000)
        assert int(ref.flag) == CONV_SUCCESS
        bp = _split(self._pad(ctx_p, real, b, 0.0))
        res = cg(lambda v: -TP.halo_poisson2d_op(
            sc, v.reshape(bp.shape), tau, tables, plan,
            symmetrize=True).reshape(-1), bp.reshape(-1), tol=1e-10,
            maxiter=4000)
        assert int(res.flag) == CONV_SUCCESS
        assert int(res.iters) == int(ref.iters)
        x = res.x.reshape(-1, ctx.n_p).numpy()[real]
        np.testing.assert_allclose(x.reshape(-1), ref.x.numpy(), rtol=0,
                                   atol=1e-9)


def test_halo_curved_rhs_matches_jax_and_unsharded():
    """Mirrors ``test_halo_curved_rhs_matches_single``: the Gordon-Hall
    disk (``disk_triangles(4)``, N=3) partitioned into 8 with an open
    eastern arc, wall and tidal boundaries, drag and Coriolis, the Gauss
    traces through the halo of the Gauss plan."""
    from blitzdg_tpu.mesh import disk_triangles
    from blitzdg_tpu.mesh.curved import (circle_projection,
                                         gordon_hall_deform,
                                         snap_boundary_vertices)
    from blitzdg_tpu.ops.sw2d_curved import SWStateTracer as JTracer
    from blitzdg_tpu.specgrid.cubature import (build_cubature_context,
                                               build_gauss_face_context)
    from blitzdg_tpu_torch.ops.sw2d_curved import (SWStateTracer,
                                                   sw2d_curved_rhs)

    N = 3
    mesh0 = disk_triangles(4, radius=1.0)
    bc = np.asarray(mesh0.bc_type).copy()
    mids = 0.5 * (mesh0.verts[mesh0.etov]
                  + mesh0.verts[np.roll(mesh0.etov, -1, axis=1)])
    bc[(bc > 0) & (mids[:, :, 0] > 0.7)] = BC_OUT
    mesh0.set_bc_type(bc)
    mesh, _, _ = JP.partition_mesh(mesh0, S)
    proj = circle_projection(0.0, 0.0, 1.0)
    faces = snap_boundary_vertices(mesh, proj, tol=0.3)
    ctx0 = j_build(N, mesh, dtype=None)
    x2, y2, _ = gordon_hall_deform(N, mesh, ctx0.x, ctx0.y, faces, proj)
    jc = j_build(N, mesh, coords=(x2, y2))
    jcub = build_cubature_context(N, mesh, x2, y2, ctx0.V)
    jg = build_gauss_face_context(N, mesh, x2, y2, ctx0.V)
    arrays, static = jax_arrays(jc)
    tc = convert.context_from_numpy(arrays, static, device="cpu", dtype=F64)
    tcub = convert.cubature_from_numpy(jax_fields(jcub), device="cpu",
                                       dtype=F64)
    tg = convert.gauss_from_numpy(jax_fields(jg), device="cpu", dtype=F64)
    phys_np = dict(g=9.81, cd=2.5e-3, f_cor=1e-4)
    jphys, tphys, _ = _physics(phys_np)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    eta = 0.05 * np.exp(-5.0 * ((x - 0.2) ** 2 + y ** 2))
    s_np = (1.0 + eta, 0.02 * eta, -0.01 * eta, eta)
    t0 = 0.37

    jplan = JP.build_gauss_halo_plan(jg, S)
    jtables = JP.halo_tables(jplan)
    el = P("element", None)
    jst = JTracer(*map(jnp.asarray, s_np))
    fn = jax.shard_map(
        lambda c, cb, gs, s, tb: JP.halo_sw2d_curved_rhs(
            c, cb, gs, s, t0, jphys, tb, jplan,
            tidal_forcing=lambda t: 1.0 + 0.05 * jnp.cos(0.3 * t)),
        mesh=_el_mesh(),
        in_specs=(JP.context_shard_specs(jc), JP.cubature_shard_specs(jcub),
                  JP.gauss_shard_specs(jg), jax.tree.map(lambda a: el, jst),
                  _row_specs(jtables)),
        out_specs=jax.tree.map(lambda a: el, jst))
    want = fn(jc, jcub, jg, jst, jtables)

    plan = TP.build_gauss_halo_plan(tg, S)
    assert plan.offs == jplan.offs and plan.max_send == jplan.max_send
    np.testing.assert_array_equal(plan.psrc, jplan.psrc)
    forcing = lambda t: 1.0 + 0.05 * np.cos(0.3 * t)
    got = TP.halo_sw2d_curved_rhs(
        TP.shard_context(tc, S), TP.shard_context(tcub, S),
        TP.shard_context(tg, S), SWStateTracer(*map(_split, s_np)), t0,
        tphys, TP.halo_tables(plan, device="cpu"), plan,
        tidal_forcing=forcing)
    ref = sw2d_curved_rhs(tc, tcub, tg,
                          SWStateTracer(*map(torch.as_tensor, s_np)), t0,
                          tphys, tidal_forcing=forcing)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(_join(g), np.asarray(w), rtol=0, atol=ATOL)
        np.testing.assert_allclose(_join(g), r.numpy(), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def elliptic(box):
    p = box
    tau = float((p.tc.n_order + 1) ** 2 * p.tc.fscale.max())
    uex = np.sin(np.pi * np.asarray(p.jc.x)) * np.sin(np.pi * np.asarray(p.jc.y))
    return p, tau, uex, -2.0 * np.pi ** 2 * uex


def test_sharded_cg_matches_jax_and_single(elliptic):
    """``TestShardedElliptic.test_sharded_cg_matches_single``: unpreconditioned
    CG on the symmetrized halo Laplacian, the flattened stacked vector to
    ``cg`` with ``group=None``: the iterations and the solution of the
    unsharded solve and of the JAX solve inside ``shard_map``."""
    from blitzdg_tpu.solvers import cg as j_cg

    p, tau, uex, f = elliptic
    b = -j_apply_mass(p.jc, jnp.asarray(f))

    def j_solve(c, bb, tb):
        mv = lambda v: -JP.halo_poisson2d_op(
            c, v.reshape(-1, c.n_p), tau, tb, p.jplan,
            symmetrize=True).reshape(-1)
        res = j_cg(mv, bb.reshape(-1), tol=1e-10, maxiter=4000,
                   axis_name="element")
        return res.x.reshape(-1, c.n_p), res.iters

    jx, jit_ = jax.jit(jax.shard_map(
        j_solve, mesh=_el_mesh(),
        in_specs=(JP.context_shard_specs(p.jc), P("element", None),
                  _row_specs(p.jtables)),
        out_specs=(P("element", None), P())))(p.jc, b, p.jtables)
    bt = torch.as_tensor(np.asarray(b))
    ref = cg(lambda v: -poisson2d_op(p.tc, v.reshape(bt.shape), tau=tau,
                                     symmetrize=True).reshape(-1),
             bt.reshape(-1), tol=1e-10, maxiter=4000)
    bs = _split(np.asarray(b))
    res = cg(lambda v: -TP.halo_poisson2d_op(
        p.sc, v.reshape(bs.shape), tau, p.tables, p.plan,
        symmetrize=True).reshape(-1), bs.reshape(-1), tol=1e-10,
        maxiter=4000)
    assert int(res.flag) == CONV_SUCCESS
    assert int(res.iters) == int(ref.iters) == int(jit_)
    x = res.x.reshape(-1, p.tc.n_p).numpy()
    np.testing.assert_allclose(x.reshape(-1), ref.x.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0, atol=1e-9)
    assert np.abs(x - uex).max() < 5e-2


def test_sharded_gmres_matches_jax_and_single(elliptic):
    """``TestShardedElliptic.test_sharded_gmres_matches_single``: GMRES
    (restart 60) on the halo Laplacian."""
    from blitzdg_tpu.solvers import gmres as j_gmres

    p, tau, uex, f = elliptic

    def j_solve(c, bb, tb):
        mv = lambda v: JP.halo_poisson2d_op(c, v.reshape(-1, c.n_p), tau, tb,
                                            p.jplan).reshape(-1)
        res = j_gmres(mv, bb.reshape(-1), tol=1e-8, restart=60, maxiter=40,
                      axis_name="element")
        return res.x.reshape(-1, c.n_p), res.iters

    jx, jit_ = jax.jit(jax.shard_map(
        j_solve, mesh=_el_mesh(),
        in_specs=(JP.context_shard_specs(p.jc), P("element", None),
                  _row_specs(p.jtables)),
        out_specs=(P("element", None), P())))(p.jc, jnp.asarray(f),
                                              p.jtables)
    ft = torch.as_tensor(f)
    ref = gmres(lambda v: poisson2d_op(p.tc, v.reshape(ft.shape),
                                       tau=tau).reshape(-1),
                ft.reshape(-1), tol=1e-8, restart=60, maxiter=40)
    fs = _split(f)
    res = gmres(lambda v: TP.halo_poisson2d_op(
        p.sc, v.reshape(fs.shape), tau, p.tables, p.plan).reshape(-1),
        fs.reshape(-1), tol=1e-8, restart=60, maxiter=40)
    assert int(res.flag) == CONV_SUCCESS
    assert int(res.iters) == int(ref.iters) == int(jit_)
    x = res.x.numpy()
    np.testing.assert_allclose(x, ref.x.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(x, np.asarray(jx).reshape(-1), rtol=0,
                               atol=1e-7)


def test_halo_comm_model_counts_the_jax_bytes(box):
    """The same bytes, key for key, as the JAX function; the link's
    bandwidth and latency are the caller's (no default)."""
    from blitzdg_tpu.parallel.halo import halo_comm_model as j_comm_model

    p = box
    for width, n_fields, itemsize in ((p.tc.n_fp, 3, 4), (7, 4, 2)):
        got = TP.halo_comm_model(p.plan, width, n_fields, link_gbps=450.0,
                                 latency_us=5.0, itemsize=itemsize)
        want = j_comm_model(p.jplan, width, n_fields,
                                  itemsize=itemsize, ici_gbps=450.0,
                                  latency_us=5.0)
        assert got.pop("link_gbps_assumed") == want.pop("ici_gbps_assumed")
        assert got == want
        assert got["bytes_per_shard_per_exchange"] == (
            n_fields * width * itemsize * p.plan.max_send * len(p.plan.offs))
    with pytest.raises(TypeError):
        TP.halo_comm_model(p.plan, 3, 3)


def test_halo_rhs_gradient_matches_jax_grad(box):
    """The gradient of a random linear functional of the stacked halo RHS
    (coastal physics) with respect to the state, by ``torch.autograd``
    through the exchange, against ``jax.grad`` through ``shard_map``."""
    p = box
    rng = np.random.default_rng(5)
    phys_np = _coastal(p, rng)
    jphys, _, sphys = _physics(phys_np)
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    eta = 0.1 * np.exp(-5.0 * (x ** 2 + y ** 2))
    H = phys_np["H"]
    s_np = (H + eta, 0.3 * H + eta, -0.2 * H + eta)
    w = [rng.standard_normal(x.shape) for _ in range(3)]

    def jloss(s):
        out = _j_halo_rhs(p, jsw.SWState(*s), jphys)
        return sum(jnp.sum(o * wi) for o, wi in zip(out, w))

    want = jax.grad(jloss)(tuple(map(jnp.asarray, s_np)))
    st = [_split(f).requires_grad_() for f in s_np]
    out = TP.halo_sw2d_rhs(p.sc, SWState(*st), 0.3, sphys, p.tables, p.plan)
    loss = sum((o * _split(wi)).sum() for o, wi in zip(out, w))
    loss.backward()
    for a, b in zip(st, want):
        b = np.asarray(b)
        np.testing.assert_allclose(_join(a.grad), b, rtol=0,
                                   atol=1e-11 * np.abs(b).max())


_WORKER = r'''
import os, sys
port, rank, repo, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch
from blitzdg_tpu_torch import parallel as TP
from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState
from blitzdg_tpu_torch.solvers import cg
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

S = 2
mesh = TP.partition_mesh(box_triangles(4, 4), S)[0]
ctx = build_triangle_context(2, mesh, dtype=torch.float64, device="cpu")
plan = TP.build_halo_plan(ctx, S)
h = 10.0 + torch.exp(-5.0 * (ctx.x ** 2 + ctx.y ** 2))
state = (h, 0.3 * h, -0.2 * h)
tau = float((ctx.n_order + 1) ** 2 * ctx.fscale.max())
b = torch.sin(np.pi * ctx.x) * torch.sin(np.pi * ctx.y)


def run(group, rank=None):
    sc = TP.shard_context(ctx, S, rank)
    tables = TP.halo_tables(plan, device="cpu", rank=rank)
    keep = slice(None) if rank is None else slice(rank, rank + 1)
    split = lambda f: f.reshape(S, -1, ctx.n_p)[keep]
    rhs = TP.halo_sw2d_rhs(sc, SWState(*map(split, state)), 0.0,
                           SWPhysics(g=9.81), tables, plan, group=group)
    dt = TP.halo_sw2d_timestep(sc, SWState(*map(split, state)), 9.81, 0.4,
                               group=group)
    bs = split(b)
    res = cg(lambda v: -TP.halo_poisson2d_op(
        sc, v.reshape(bs.shape), tau, tables, plan, group=group,
        symmetrize=True).reshape(-1), bs.reshape(-1), tol=1e-10,
        maxiter=2000, group=group)
    return {"h": rhs.h, "hu": rhs.hu, "hv": rhs.hv, "dt": dt,
            "x": res.x.reshape(bs.shape), "iters": res.iters}


if rank >= 0:
    info = TP.distributed_init(f"tcp://localhost:{port}", S, rank,
                               backend="gloo")
    assert info["n_processes"] == S and info["process_id"] == rank, info
    mesh_ = TP.make_global_mesh(1, S)
    res = run(mesh_.get_group("element"), rank)
    import torch.distributed as dist
    dist.destroy_process_group()
else:
    res = run(None)
np.savez(out, **{k: torch.as_tensor(v).numpy() for k, v in res.items()})
print(f"HALO_OK rank={rank}")
'''


def test_two_gloo_processes_match_the_stacked_transport(tmp_path):
    """Two gloo processes hold one shard each of ``box_triangles(4, 4)`` at
    N=2: the halo RHS, the sharded dt and the halo CG (its dots summed over
    the ranks of ``make_global_mesh``'s element group) equal the stacked
    transport's results in a third process, to 1e-12, the CG's iteration
    count exactly. Started as ``tests/test_distributed_multiproc.py``
    starts its workers, with a timeout, and always ended."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    ranks = (0, 1, -1)  # -1: the stacked transport
    outs = {r: tmp_path / f"rank{r}.npz" for r in ranks}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(r), repo, str(outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in ranks]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=180)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, pr, log in zip(ranks, procs, logs):
        assert pr.returncode == 0, f"rank {r} failed:\n{log}"
        assert f"HALO_OK rank={r}" in log, log
    ref = np.load(outs[-1])
    for r in (0, 1):
        got = np.load(outs[r])
        for k in ("h", "hu", "hv", "x"):
            np.testing.assert_allclose(got[k], ref[k][r:r + 1], rtol=0,
                                       atol=1e-12, err_msg=f"rank {r} {k}")
        assert float(got["dt"]) == float(ref["dt"])
        assert int(got["iters"]) == int(ref["iters"])
