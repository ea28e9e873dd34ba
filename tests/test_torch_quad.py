"""Quadrilateral elements in the port against the JAX package (CPU, float64).

Mirrors ``tests/test_quad.py`` (operators, context geometry, maps, normals,
gradient, shallow water on quads conserving mass) on the port's
``specgrid/quad.py`` and ``mesh.box_quads``, each also held to the JAX
function on the same inputs: reference operators and every context array
at 1e-13, every index map exactly; ``sw2d_rhs`` + SSP-RK2 with and without
the filter and the adaptive time step (the path of ``examples/sw2dquads.py``)
at 1e-12. Then the blocked kernels' plain versions on a quad set (the
counterpart of ``tests/test_blocked.py::test_blocked_step_quads``): the
step ``sw2d_step_blocked`` on ``build_quad_context(2, box_quads(4, 3))``
against the JAX kernel in interpret mode and against the plain SSP-RK2 step
at 1e-12, and the rollout over 3 steps with controls, on coastal physics and
on a wet/dry beach, against the JAX kernel at 1e-12. The forward takes a
face's maximum, which has no tie rule, so nothing there depends on how a
tie splits. The adjoint (B6's plain version) against ``jax.grad`` through
the JAX kernels, and the fused sharded step (B7's plain version, twice a
step) on a partitioned quad mesh at N=2 against the JAX step under
``shard_map``, 1e-12; at N=4 the differentiable sharded step (B7's and
B8's plain versions) and its gradients against the JAX diff step and
``jax.grad`` through it, 1e-12 and 1e-9. Also the repair of ``retag_east_open`` (it walked three faces)
and the assembled SIP operator on quads (the counterpart of
``tests/test_poisson.py::TestAssembledQuads``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blitzdg_tpu.context as jctx_mod
from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mesh import box_quads as j_box_quads
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_blocked as JB
from blitzdg_tpu.specgrid import quad as JQ
from blitzdg_tpu.timestepping import ssprk2_step as j_ssprk2

from torch_parity import STATIC, jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mesh import box_quads
from blitzdg_tpu_torch.mesh.gmsh import build_mesh
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.ops.sw2d import (SWPhysics, SWState, apply_filter,
                                        sw2d_rhs, sw2d_timestep)
from blitzdg_tpu_torch.specgrid import quad as TQ
from blitzdg_tpu_torch.timestepping import ssprk2_step

F64 = torch.float64
INDEX = ("fmask", "vmapM", "vmapP", "mapP", "mapB", "maskB", "vmapB",
         "bc_table", "gather_ids", "scatter_ids", "face_nbr", "face_flip")


def t_quad(n_order, cells, **kw):
    return TQ.build_quad_context(n_order, box_quads(*cells), dtype=F64,
                                 device="cpu", **kw)


def j_quad(n_order, cells, **kw):
    return JQ.build_quad_context(n_order, j_box_quads(*cells), **kw)


class TestQuadOperators:
    def test_nodes_count(self):
        r, s = TQ.quad_nodes(3)
        assert r.size == 16
        assert np.isclose(r.min(), -1) and np.isclose(s.max(), 1)
        jr, js = JQ.quad_nodes(3)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(s, js)

    def test_vandermonde_orthonormal_mass(self):
        r, s = TQ.quad_nodes(4)
        V = TQ.vandermonde_quad(4, r, s)
        M = np.linalg.inv(V @ V.T)
        # total mass = area of [-1,1]^2 = 4
        np.testing.assert_allclose(M.sum(), 4.0, rtol=1e-12)
        np.testing.assert_allclose(V, JQ.vandermonde_quad(4, r, s), rtol=0,
                                   atol=1e-13)

    def test_dmatrices_exact_on_polynomials(self):
        for N in [1, 3]:
            r, s = TQ.quad_nodes(N)
            V = TQ.vandermonde_quad(N, r, s)
            D = TQ.dmatrices_quad(N, r, s, V)
            Dr, Ds = D[:2]
            for p in range(N + 1):
                for q in range(N + 1):
                    u = r**p * s**q
                    dudr = p * r ** max(p - 1, 0) * s**q if p else 0 * r
                    duds = q * r**p * s ** max(q - 1, 0) if q else 0 * r
                    np.testing.assert_allclose(Dr @ u, dudr, atol=1e-10)
                    np.testing.assert_allclose(Ds @ u, duds, atol=1e-10)
            for a, b in zip(D, JQ.dmatrices_quad(N, r, s, V)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


class TestQuadContext:
    def test_geometry_and_area(self):
        ctx = t_quad(2, (4, 4))
        J = ctx.J.numpy()
        assert np.all(J > 0)
        V = ctx.V.numpy()
        M = np.linalg.inv(V @ V.T)
        area = float(np.sum(M.sum(axis=0)[None, :] * J))
        np.testing.assert_allclose(area, 4.0, rtol=1e-12)

    def test_maps_match_coordinates(self):
        ctx = t_quad(3, (3, 5))
        x = ctx.x.numpy().reshape(-1)
        y = ctx.y.numpy().reshape(-1)
        vm = ctx.vmapM.numpy().reshape(-1)
        vp = ctx.vmapP.numpy().reshape(-1)
        np.testing.assert_allclose(x[vm], x[vp], atol=1e-12)
        np.testing.assert_allclose(y[vm], y[vp], atol=1e-12)

    def test_normals_unit_outward(self):
        ctx = t_quad(2, (2, 2))
        nx, ny = ctx.nx.numpy(), ctx.ny.numpy()
        np.testing.assert_allclose(nx**2 + ny**2, 1.0, atol=1e-12)
        x, y = ctx.x.numpy(), ctx.y.numpy()
        fm = ctx.fmask.numpy().reshape(-1)
        cx, cy = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
        dot = nx * (x[:, fm] - cx) + ny * (y[:, fm] - cy)
        assert np.all(dot > 0)

    def test_grad_linear_exact(self):
        ctx = t_quad(3, (3, 3))
        u = 2.0 * ctx.x - 1.5 * ctx.y
        ux, uy = ctx.grad(u)
        np.testing.assert_allclose(ux.numpy(), 2.0, atol=1e-10)
        np.testing.assert_allclose(uy.numpy(), -1.5, atol=1e-10)


@pytest.mark.parametrize("n_order,cells,kw,retag", [
    (3, (3, 5), {}, False),
    (2, (4, 4), dict(filter_cutoff=1.5, filter_order=4), True),
    (4, (2, 3), dict(filter_cutoff=3.6, filter_order=4), False),
])
def test_context_arrays_match_jax(n_order, cells, kw, retag):
    """Every field of the port's quad context equals the JAX one's: arrays
    at 1e-13, index maps and boundary sets exactly; and
    ``convert.context_from_numpy`` takes the JAX quad context."""
    tm, jm = box_quads(*cells), j_box_quads(*cells)
    if retag:
        retag_east_open(tm)
        jm.set_bc_type(tm.bc_type.copy())
        assert (tm.bc_type == BC_OUT).sum() == cells[1]
    tc = TQ.build_quad_context(n_order, tm, dtype=F64, device="cpu", **kw)
    jc = JQ.build_quad_context(n_order, jm, **kw)
    jd = jctx_mod.asdict(jc)
    for name in STATIC:
        assert getattr(tc, name) == jd[name]
    assert tc.n_faces == 4 and tc.n_p == (n_order + 1) ** 2
    for name, jv in jd.items():
        if name in STATIC or name == "bc_maps" or jv is None:
            continue
        tv = getattr(tc, name).numpy()
        if name in INDEX:
            np.testing.assert_array_equal(tv, np.asarray(jv), err_msg=name)
        else:
            np.testing.assert_allclose(tv, np.asarray(jv), rtol=0,
                                       atol=1e-13, err_msg=name)
    for tag, idx in jc.bc_maps.idx.items():
        np.testing.assert_array_equal(tc.bc_maps.idx[tag].numpy(),
                                      np.asarray(idx))
        np.testing.assert_array_equal(tc.bc_maps.mask[tag].numpy(),
                                      np.asarray(jc.bc_maps.mask[tag]))
    arrays, static = jax_arrays(jc)
    cc = convert.context_from_numpy(arrays, static, device="cpu", dtype=F64)
    assert cc.n_faces == 4
    for name in ("x", "lift", "nx", "vmapP", "mapP"):
        assert torch.equal(getattr(cc, name), getattr(tc, name))


def test_quad_context_needs_a_quad_mesh():
    from blitzdg_tpu_torch.mesh import box_triangles

    with pytest.raises(ValueError, match="quadrilateral"):
        TQ.build_quad_context(1, box_triangles(2, 2), device="cpu")


def _mass(ctx, h):
    V = ctx.V.numpy()
    w = np.linalg.inv(V @ V.T).sum(axis=0)
    return float(np.sum(w[None, :] * ctx.J.numpy() * np.asarray(h)))


def test_sw2d_on_quads_conserves_mass():
    """The sw2d RHS is element-shape agnostic: 100 SSP-RK2 steps on quads
    (N=1, the modal filter's context) conserve mass to 1e-10 and end at the
    JAX run's state to 1e-12."""
    kw = dict(filter_cutoff=0.9, filter_order=1)
    ctx, jc = t_quad(1, (4, 4), **kw), j_quad(1, (4, 4), **kw)
    phys = SWPhysics(g=9.81)
    eta = torch.exp(-10.0 * (ctx.x**2 + ctx.y**2))
    state = SWState(h=10.0 + eta, hu=torch.zeros_like(eta),
                    hv=torch.zeros_like(eta))
    mass0 = _mass(ctx, state.h)
    s, t = state, 0.0
    for _ in range(100):
        s = ssprk2_step(lambda ss, tt: sw2d_rhs(ctx, ss, tt, phys), s, t, 1e-3)
        t += 1e-3
    h = s.h.numpy()
    assert np.all(np.isfinite(h))
    np.testing.assert_allclose(_mass(ctx, h), mass0, rtol=1e-10)

    jphys = jsw.SWPhysics(g=9.81)
    jeta = jnp.exp(-10.0 * (jc.x**2 + jc.y**2))
    js = jsw.SWState(h=10.0 + jeta, hu=jnp.zeros_like(jeta),
                     hv=jnp.zeros_like(jeta))

    @jax.jit
    def run(st):
        def body(carry, _):
            st, tt = carry
            st = j_ssprk2(lambda a, b: jsw.sw2d_rhs(jc, a, b, jphys), st, tt,
                          1e-3)
            return (st, tt + 1e-3), None

        return jax.lax.scan(body, (st, 0.0), None, length=100)[0][0]

    want = run(js)
    for a, b in zip(s, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_sw2dquads_example_steps_match_jax():
    """The path of ``examples/sw2dquads.py`` at N=4 (filter at 0.9 N, order
    4, CFL 0.5, adaptive step) for 5 steps: every step's dt and the final
    state against the JAX functions, 1e-12."""
    N, cfl = 4, 0.5
    kw = dict(filter_cutoff=0.9 * N, filter_order=4)
    ctx, jc = t_quad(N, (3, 3), **kw), j_quad(N, (3, 3), **kw)
    phys, jphys = SWPhysics(g=9.81), jsw.SWPhysics(g=9.81)
    eta = torch.exp(-10.0 * (ctx.x**2 + ctx.y**2))
    s = SWState(h=10.0 + eta, hu=torch.zeros_like(eta), hv=torch.zeros_like(eta))
    jeta = jnp.exp(-10.0 * (jc.x**2 + jc.y**2))
    js = jsw.SWState(h=10.0 + jeta, hu=jnp.zeros_like(jeta),
                     hv=jnp.zeros_like(jeta))
    t = jt = 0.0
    for _ in range(5):
        dt = sw2d_timestep(ctx, s, phys.g, cfl)
        jdt = jsw.sw2d_timestep(jc, js, jphys.g, cfl)
        np.testing.assert_allclose(float(dt), float(jdt), rtol=1e-12)
        s = ssprk2_step(lambda a, b: sw2d_rhs(ctx, a, b, phys), s, t, dt,
                        post_stage=lambda f: apply_filter(ctx, f))
        js = j_ssprk2(lambda a, b: jsw.sw2d_rhs(jc, a, b, jphys), js, jt, jdt,
                      post_stage=lambda f: jsw.apply_filter(jc, f))
        t, jt = t + dt, jt + jdt
    for a, b in zip(s, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_retag_east_open_walks_every_face_of_a_quad():
    """Repair: ``retag_east_open`` walked faces 0..2 and joined vertex 2 to
    vertex 0, which on a quadrilateral misses face 3. With each quad's
    vertices rolled by two (still counter-clockwise) the east side of the
    box is face 3 of its elements, and it must be tagged."""
    m = box_quads(3, 2)
    rolled = build_mesh(m.verts, np.roll(m.etov, 2, axis=1))
    east = np.zeros_like(rolled.bc_type, dtype=bool)
    for k in range(rolled.num_elements):
        for f in range(4):
            a, b = rolled.etov[k, f], rolled.etov[k, (f + 1) % 4]
            east[k, f] = (rolled.verts[a, 0] == 1.0) and (rolled.verts[b, 0] == 1.0)
    assert east[:, 3].sum() == 2 and east.sum() == 2
    retag_east_open(rolled)
    assert ((rolled.bc_type == BC_OUT) == east).all()


# ---------------------------------------------------------------------------
# The blocked kernels' plain versions on a quad set
# ---------------------------------------------------------------------------

class QuadPair:
    """One quad discretization and physics on both sides, float64: the JAX
    blocked set and the port's, built from the JAX context's arrays."""

    def __init__(self, jc, phys_np=None, bu=None, bv=None, tidal=None,
                 wetdry=False):
        self.jc = jc
        phys_np = dict(g=9.81) if phys_np is None else phys_np
        as_j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        self.jphys = jsw.SWPhysics(**{k: as_j(v) for k, v in phys_np.items()})
        self.jops, self.jmeta = JB.build_blocked_step_ops(
            jc, self.jphys, bu, bv, dtype=jnp.float64, tidal=tidal,
            wetdry=wetdry)
        arrays, static = jax_arrays(jc)
        self.ops, self.meta = convert.blocked_step_ops_from_numpy(
            arrays, static, phys_np, bu, bv, tidal=tidal, wetdry=wetdry,
            device="cpu", dtype=F64)
        assert self.meta.n_faces == 4
        self.x, self.y = np.asarray(jc.x), np.asarray(jc.y)

    def pack(self, f):
        return JB.pack_state(self.jmeta, jnp.asarray(f))

    def flat(self, f):
        return torch.as_tensor(np.asarray(f), dtype=F64).reshape(f.shape[0], -1)

    def close(self, got, want_packed, atol=1e-12):
        want = np.asarray(JB.unpack_state(self.jmeta, want_packed))
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=0, atol=atol)


def test_blocked_step_quads_matches_jax_and_plain_step():
    """The counterpart of ``test_blocked_step_quads``: the port's B4 on
    ``build_quad_context(2, box_quads(4, 3))`` (its plain version, the
    tensors lying on the CPU) against the JAX kernel in interpret mode and
    against the plain SSP-RK2 step of ``sw2d_rhs`` with the filter."""
    jc = j_quad(2, (4, 3))
    p = QuadPair(jc)
    h = 10.0 + np.exp(-10.0 * (p.x**2 + p.y**2))
    s = (h[None], 0.2 * h[None], -0.1 * h[None])
    dt = 1e-3
    want = JB.sw2d_step_blocked(p.jops, p.jmeta, *map(p.pack, s), None, dt,
                                interpret=True)
    got = TB.sw2d_step_blocked(p.ops, p.meta, *map(p.flat, s), None, dt)
    for g, w in zip(got, want):
        p.close(g, w)
    ctx = t_quad(2, (4, 3))
    phys = SWPhysics(g=9.81)
    st = SWState(*(torch.as_tensor(f[0]) for f in s))
    ref = ssprk2_step(lambda a, b: sw2d_rhs(ctx, a, b, phys), st, 0.0, dt,
                      post_stage=lambda f: apply_filter(ctx, f))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy().reshape(r.shape), r.numpy(),
                                   rtol=0, atol=1e-12)


def _coastal_quad_pair():
    """Coastal physics on ``box_quads(4, 3)`` over the unit square at N=2
    (bathymetry with the well-balanced star fluxes, drag, Coriolis, tidal
    depth on the open east side, sponge, two injectors): the pair, two
    perturbed scenarios, controls of 3 steps, dt and t0 = 1."""
    from blitzdg_tpu.utils import build_sponge_coefficient as j_sponge

    jm = j_box_quads(4, 3, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    tm = box_quads(4, 3, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    retag_east_open(tm)
    jm.set_bc_type(tm.bc_type.copy())
    jc = JQ.build_quad_context(2, jm, filter_cutoff=1.8, filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    H = 10.0 + 5.0 * x + 2.0 * np.sin(3.0 * y)
    ob = np.asarray(jc.bc_table)[:, :, None].repeat(jc.n_fp, 2).reshape(
        jc.k_elem, -1) == BC_OUT
    phys = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=5.0 * np.ones_like(H),
                Hy=6.0 * np.cos(3.0 * y),
                sponge=np.asarray(j_sponge(jc, ob, width=0.3, strength=0.5)))
    bump = np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    tide = (12.0, 0.5, 2.0, 10.0)
    p = QuadPair(jc, phys, np.stack([bump, 0 * bump]),
                 np.stack([0 * bump, bump]), tidal=tide)
    assert p.meta.wb and p.meta.has_sponge and int(p.ops.obc.sum()) > 0
    hs = np.stack([H + 0.3 * np.exp(-20.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
                   + 0.02 * b for b in range(2)])
    s = (hs, 0.1 * hs, -0.05 * hs)
    ctrls = np.random.default_rng(5).normal(0.0, 0.3, (2, 3, 2))
    return p, s, ctrls, 2e-3, 1.0


def test_blocked_rollout_quads_coastal_controls_matches_jax():
    """B5's plain version on quads over 3 steps, a control row each, with
    coastal physics (bathymetry with the well-balanced star fluxes, drag,
    Coriolis, tidal depth on the open east side, sponge) from t0 = 1: every
    trajectory row and the final state against the JAX kernel, 1e-12; the
    step launched for each step in turn gives the rows."""
    p, s, ctrls, dt, t0 = _coastal_quad_pair()
    want = JB.sw2d_rollout_blocked(p.jops, p.jmeta, *map(p.pack, s),
                                   jnp.asarray(ctrls), dt, spc=1, t0=t0,
                                   store_traj=True, interpret=True)
    got = TB.sw2d_rollout_blocked(p.ops, p.meta, *map(p.flat, s),
                                  torch.as_tensor(ctrls), dt, spc=1, t0=t0,
                                  store_traj=True)
    for g, w in zip(got, want):
        p.close(g, w)
    st = tuple(map(p.flat, s))
    for t in range(3):
        st = TB.sw2d_step_blocked(p.ops, p.meta, *st,
                                  torch.as_tensor(ctrls[:, t]), dt,
                                  t0 + t * dt)
        for a, b in zip(st, got[:3]):
            assert torch.equal(a, b[:, t + 1])


def test_blocked_rollout_grad_quads_matches_jax_grad():
    """B6's plain version on quads: the gradient of a random linear
    functional of the trajectory through the port's ``make_rollout_blocked``
    (its backward the plain reverse sweep) against ``jax.grad`` through the
    JAX package's, whose backward is the JAX kernel in interpret mode, on
    the coastal quad set over 3 steps with controls from t0 = 1; the
    cotangents of the initial state and of the controls, 1e-12 of each
    one's largest entry. The states carry node-wise noise, so no face's
    maximum is tied and the packages' tie rules (C6) do not enter."""
    p, s, ctrls, dt, t0 = _coastal_quad_pair()
    rng = np.random.default_rng(9)
    s = tuple(f + 1e-3 * rng.standard_normal(f.shape) for f in s)
    w = [rng.standard_normal((2, 4) + s[0].shape[1:]) for _ in range(3)]
    jroll = JB.make_rollout_blocked(p.jops, p.jmeta, dt, 1, t0=t0,
                                    interpret=True)

    def jloss(h, hu, hv, c):
        traj = jroll(h, hu, hv, c)
        return sum(jnp.sum(JB.unpack_state(p.jmeta, t) * wi)
                   for t, wi in zip(traj, w))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(p.pack, s),
                                                 jnp.asarray(ctrls))
    xs = [p.flat(f).requires_grad_() for f in s]
    c = torch.as_tensor(ctrls).requires_grad_()
    traj = TB.make_rollout_blocked(p.ops, p.meta, dt, 1, t0=t0)(*xs, c)
    loss = sum((t * torch.as_tensor(wi).reshape(t.shape)).sum()
               for t, wi in zip(traj, w))
    loss.backward()
    for x, g in zip(xs, want[:3]):
        ref = np.asarray(JB.unpack_state(p.jmeta, g))
        np.testing.assert_allclose(x.grad.numpy().reshape(ref.shape), ref,
                                   rtol=0, atol=1e-12 * np.abs(ref).max())
    ref = np.asarray(want[3])
    np.testing.assert_allclose(c.grad.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_sharded_fused_step_quads_matches_jax():
    """The port's fused sharded step (its stages' plain versions, the
    stacked ring exchange) on ``partition_mesh(box_quads(8, 8), 4)`` at N=2
    with two injectors and a control vector a step, 2 steps: the states and
    the send buffer against the JAX package's
    ``make_sharded_blocked_step_fused`` in interpret mode under
    ``shard_map`` over 4 of the 8 virtual devices, 1e-12."""
    from jax.sharding import Mesh, PartitionSpec as P

    from blitzdg_tpu.parallel import partition_mesh as j_partition_mesh
    from blitzdg_tpu.parallel.blocked_shard import (
        build_sharded_blocked as j_build_sharded, initial_send_buffer as j_isb,
        make_sharded_blocked_step_fused as j_fused, pack_local)
    from blitzdg_tpu_torch.parallel import blocked_shard as BS

    S, B, n_steps, dt = 4, 2, 2, 5e-4
    jm, _, _ = j_partition_mesh(j_box_quads(8, 8), S)
    jc = JQ.build_quad_context(2, jm, filter_cutoff=1.8, filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    bu, bv = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
    rng = np.random.default_rng(12)
    cs = 0.3 * rng.standard_normal((n_steps, 2))
    h0 = 10.0 + np.exp(-8.0 * (x ** 2 + y ** 2))
    state = (np.stack([h0, h0 + 0.01 * (h0 - h0.mean())]),
             np.stack([0.05 * (h0 - h0.min()), 0.02 * (h0 - h0.min())]),
             np.stack([np.zeros_like(h0), 0.01 * (h0 - h0.min())]))

    jsb = j_build_sharded(jc, jsw.SWPhysics(g=9.81), S, dtype=jnp.float64,
                          forcing_bu=bu, forcing_bv=bv)
    meta, k_loc = jsb.meta, jsb.k_loc
    step = j_fused(jsb, dt, interpret=True)
    packed = tuple(jnp.concatenate([
        jnp.concatenate([pack_local(meta, f[b][s * k_loc:(s + 1) * k_loc])
                         for b in range(B)], axis=0)
        for s in range(S)], axis=0) for f in state)
    op_specs = jax.tree.map(lambda a: P("element", *([None] * (a.ndim - 1))),
                            jsb.ops)
    st, bs = P("element", None, None, None), P("element", None, None)

    def roll(ops_l, cs_l, *pk):
        def body(carry, c):
            st_, tt = carry
            return (step(ops_l, st_, tt, ctrl=c), tt + dt), None

        ((out, sbuf), _), _ = jax.lax.scan(
            body, ((tuple(pk), j_isb(jsb, ops_l, tuple(pk))), 0.0), cs_l)
        return (*out, sbuf)

    fn = jax.jit(jax.shard_map(
        roll, mesh=Mesh(np.array(jax.devices()[:S]), ("element",)),
        in_specs=(op_specs, P()) + (st,) * 3, out_specs=(st,) * 3 + (bs,),
        check_vma=False))
    out = fn(jsb.ops, jnp.asarray(cs), *packed)

    def unpack(a):
        a = np.asarray(a).transpose(0, 1, 3, 2).reshape(-1, meta.Kp, meta.NP)
        return a[:, :k_loc, :meta.n_p].reshape(S, B, -1)

    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(
        arrays, static, dict(g=9.81), S, forcing_bu=bu, forcing_bv=bv,
        device="cpu", dtype=F64)
    assert sb.meta.n_faces == 4 and len(sb.plan.offs) >= 2
    sts = tuple(BS.split_shards(torch.as_tensor(f), S) for f in state)
    carry = (sts, BS.initial_send_buffer(sb, sts))
    fstep = BS.make_sharded_blocked_step_fused(sb, dt)
    for i in range(n_steps):
        carry = fstep(carry, i * dt, torch.as_tensor(cs[i]))
    for g, want in zip(carry[0], out[:3]):
        np.testing.assert_allclose(g.numpy(), unpack(want), rtol=0,
                                   atol=1e-12)
    L = carry[1].shape[2]
    np.testing.assert_allclose(carry[1].numpy(),
                               np.asarray(out[3]).reshape(S, B, L, 3),
                               rtol=0, atol=1e-12)


def test_sharded_diff_step_quads_n4_matches_jax():
    """The port's differentiable sharded step (``make_sharded_blocked_step_
    diff``: B7's and B8's plain versions, the stacked ring exchange and its
    reverse) on ``partition_mesh(box_quads(2, 2), 4)`` at N=4 (the order at
    which B7 and B8 take eight lanes an element on the card), coastal
    physics (bathymetry with the well-balanced star fluxes, drag, Coriolis,
    tidal depth on the open east side, sponge) and two injectors, one
    scenario (the JAX backward's control cotangent holds for B = 1 only,
    ROADMAP C21), a control vector a step, 2 steps from t0 = 1, float64:
    the states and the send buffer against the JAX package's
    ``make_sharded_blocked_step_diff`` in interpret mode under ``shard_map``
    over 4 of the 8 virtual devices, 1e-12; the gradients of a scalar cost
    in the initial depth and the controls against ``jax.grad`` through it,
    1e-9 of each one's largest entry. A shard holds one element, two of
    whose faces are cut faces (on x = 0 and y = 0): three ring offsets, the
    smallest box that has them (about 30 s, the JAX kernels interpreted)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from blitzdg_tpu.parallel import partition_mesh as j_partition_mesh
    from blitzdg_tpu.parallel.blocked_shard import (
        build_sharded_blocked as j_build_sharded, initial_send_buffer as j_isb,
        make_sharded_blocked_step_diff as j_diff, pack_local, unpack_local)
    from blitzdg_tpu.utils import build_sponge_coefficient as j_sponge
    from blitzdg_tpu_torch.parallel import blocked_shard as BS

    S, n_steps, dt, t0, N = 4, 2, 5e-4, 1.0, 4
    tm = box_quads(2, 2)
    retag_east_open(tm)
    jm = j_box_quads(2, 2)
    jm.set_bc_type(tm.bc_type.copy())
    jm, _, _ = j_partition_mesh(jm, S)
    jc = JQ.build_quad_context(N, jm, filter_cutoff=0.9 * N, filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    H = 10.0 + 2.0 * x + np.sin(2.0 * y)
    ob = np.asarray(jc.bc_table)[:, :, None].repeat(jc.n_fp, 2).reshape(
        jc.k_elem, -1) == BC_OUT
    phys = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=2.0 * np.ones_like(H),
                Hy=2.0 * np.cos(2.0 * y),
                sponge=np.asarray(j_sponge(jc, ob, width=0.3, strength=0.5)))
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    kw = dict(forcing_bu=np.stack([bump, 0 * bump]),
              forcing_bv=np.stack([0 * bump, bump]),
              tidal=(12.0, 0.5, 2.0, 10.0))
    eta = np.exp(-8.0 * ((x - 0.2) ** 2 + (y + 0.3) ** 2))
    state = (H + 0.3 * eta, 0.1 * eta + 0.02 * x, 0.05 * eta - 0.01 * y)
    tgt = H + 0.1 * np.exp(-8.0 * x ** 2)
    cs = 0.3 * np.random.default_rng(13).standard_normal((n_steps, 2))

    # the JAX step: the end state, the send buffer and the cost's gradients
    as_j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
    jsb = j_build_sharded(jc, jsw.SWPhysics(**{k: as_j(v)
                                               for k, v in phys.items()}),
                          S, dtype=jnp.float64, **kw)
    meta, k_loc = jsb.meta, jsb.k_loc
    step = j_diff(jsb, dt, interpret=True)
    pk = lambda f: jnp.concatenate([pack_local(meta, f[s * k_loc:(s + 1)
                                                       * k_loc])
                                    for s in range(S)], axis=0)
    vm = jsb.ops.vmask[0][None]
    op_specs = jax.tree.map(lambda a: P("element", *([None] * (a.ndim - 1))),
                            jsb.ops)
    st, bs = P("element", None, None, None), P("element", None, None)

    def loss_local(ops_l, c_all, h_l, hu_l, hv_l, tgt_l):
        p3 = (h_l, hu_l, hv_l)

        def body(carry, c):
            st_, tt = carry
            return (step(ops_l, st_, tt, ctrl=c), tt + dt), None

        (((out, sbuf), _), _) = jax.lax.scan(
            body, ((p3, j_isb(jsb, ops_l, p3)), t0), c_all)
        loc = (jnp.sum(vm * (out[0] - tgt_l) ** 2)
               + 0.1 * jnp.sum(vm * out[1] ** 2) + jnp.sum(vm * out[2]))
        return jax.lax.psum(loc, "element"), (*out, sbuf)

    def total(h_pk, c_all, hu_pk, hv_pk, tgt_pk):
        fn = jax.shard_map(loss_local,
                           mesh=Mesh(np.array(jax.devices()[:S]),
                                     ("element",)),
                           in_specs=(op_specs, P()) + (st,) * 4,
                           out_specs=(P(), (st,) * 3 + (bs,)),
                           check_vma=False)
        return fn(jsb.ops, c_all, h_pk, hu_pk, hv_pk, tgt_pk)

    (v_ref, out), (gh, gc) = jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True)(
            pk(state[0]), jnp.asarray(cs), pk(state[1]), pk(state[2]),
            pk(tgt))
    unpack = lambda a: np.concatenate(
        [np.asarray(unpack_local(meta, a[s:s + 1])) for s in range(S)],
        axis=0).reshape(S, 1, -1)

    # the port's step on the same fields
    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(arrays, static, phys, S,
                                            device="cpu", dtype=F64, **kw)
    assert sb.meta.n_faces == 4 and sb.meta.n_p == 25
    assert sb.meta.has_sponge and sb.meta.wb and sb.meta.tidal is not None
    assert len(sb.plan.offs) >= 2 and int((sb.ops.vmapP >= sb.meta.n_v)
                                          .sum()) > 0
    split = lambda f: BS.split_shards(torch.as_tensor(f).reshape(1, -1), S)
    h0 = split(state[0]).requires_grad_(True)
    c = torch.as_tensor(cs).requires_grad_(True)
    sts = (h0, split(state[1]), split(state[2]))
    carry, t = (sts, BS.initial_send_buffer(sb, sts)), t0
    dstep = BS.make_sharded_blocked_step_diff(sb, dt)
    for i in range(n_steps):
        carry = dstep(carry, t, c[i])
        t += dt
    (h, hu, hv), sbuf = carry
    for g, want in zip((h, hu, hv), out[:3]):
        np.testing.assert_allclose(g.detach().numpy(), unpack(want), rtol=0,
                                   atol=1e-12)
    L = sbuf.shape[2]
    np.testing.assert_allclose(sbuf.detach().numpy(),
                               np.asarray(out[3]).reshape(S, 1, L, 3),
                               rtol=0, atol=1e-12)
    loss = (((h - split(tgt)) ** 2).sum() + 0.1 * (hu ** 2).sum()
            + hv.sum())
    np.testing.assert_allclose(loss.item(), float(v_ref), rtol=1e-12)
    got_h, got_c = torch.autograd.grad(loss, (h0, c))
    for g, want in ((got_h, unpack(gh)), (got_c, np.asarray(gc))):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


def test_blocked_rollout_quads_wetdry_matches_jax():
    """Wetting and drying on quads: the JAX blocked kernel runs its limiter
    on any element shape (an element's nodal mean), so the port's does too.
    A sloping beach, dry beyond x = 2/3, 3 steps: against the JAX kernel,
    1e-12."""
    jc = JQ.build_quad_context(2, j_box_quads(4, 4, xlim=(0.0, 1.0),
                                              ylim=(0.0, 1.0)),
                               filter_cutoff=1.8, filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    H = 1.0 - 1.5 * x
    p = QuadPair(jc, dict(g=9.81, cd=1e-3, H=H, Hx=-1.5 * np.ones_like(H),
                          Hy=np.zeros_like(H), well_balanced=False),
                 wetdry=True)
    wave = 0.05 * np.exp(-30.0 * ((x - 0.45) ** 2 + (y - 0.5) ** 2))
    h = np.maximum(H + wave, 1e-3)[None]
    assert (h <= 1e-3).any() and (h > 0.5).any()
    wet = (h > 5e-3).astype(float)
    s = (h, 0.3 * wet * h, 0.0 * h)
    dt = 2e-3
    want = JB.sw2d_rollout_blocked(p.jops, p.jmeta, *map(p.pack, s), None, dt,
                                   n_steps=3, interpret=True)
    got = TB.sw2d_rollout_blocked(p.ops, p.meta, *map(p.flat, s), None, dt,
                                  n_steps=3)
    for g, w in zip(got, want):
        p.close(g, w)


def test_assembled_poisson_on_quads_matches_jax():
    """The counterpart of ``tests/test_poisson.py::TestAssembledQuads``,
    which waited for the quad context: the port's assembled SIP operator
    and mass matrix on ``build_quad_context(3, box_quads(5, 5))`` equal the
    JAX package's to 1e-12 of their largest entry; the operator is
    symmetric positive semi-definite and a manufactured Dirichlet solve is
    within 5e-3 of sin(pi x) sin(pi y)."""
    import scipy.sparse.linalg as spla

    from blitzdg_tpu.ops.poisson import assemble_poisson2d as j_assemble

    from blitzdg_tpu_torch.ops.poisson import assemble_poisson2d

    ctx = t_quad(3, (5, 5))
    OP, MM = assemble_poisson2d(ctx)
    JOP, JMM = j_assemble(j_quad(3, (5, 5)))
    for a, b in ((OP, JOP), (MM, JMM)):
        A, B = a.toarray(), b.toarray()
        assert float(np.abs(A - B).max()) <= 1e-12 * float(np.abs(B).max())
    A = OP.toarray()
    np.testing.assert_allclose(A, A.T, atol=1e-8 * np.abs(A).max())
    assert np.all(np.linalg.eigvalsh(0.5 * (A + A.T)) > -1e-6)
    uex = (torch.sin(np.pi * ctx.x) * torch.sin(np.pi * ctx.y)).numpy()
    u = spla.spsolve(OP.tocsc(), MM @ (2.0 * np.pi**2 * uex.reshape(-1)))
    assert float(np.max(np.abs(u - uex.reshape(-1)))) < 5e-3
