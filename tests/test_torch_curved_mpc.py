"""The curved path as a whole: ``mpc/curved_blocked.py`` and
``mpc/curved_disk.py`` of the port against the JAX package's curved blocked
MPC on the same inputs, CPU, float64 on both sides (the JAX kernels in
interpret mode, the port's wrappers through their plain versions).

The curved configuration (``mpc/curved_disk.py``: rest start h = 1, two
Gaussian-bump injectors, Gaussian targets of 1e-3, q_terminal = 1,
r_control = 1e-10) is cut to ``disk_triangles(2)`` (K = 24), N = 2, B = 2
scenarios, horizon 3 x 2 steps.

Tolerances: cost 1e-9 relative against the JAX function (which is built in
float32 precision of its weights: see ``wj`` below) and 1e-10 against the
port's own ``mpc_cost`` with ``rhs_fn``; Adam's cost history, final cost and
controls 1e-8 (seen: 1e-12); Gauss-Newton as on the blocked path 1e-7 on
the costs (its Jv is a difference of two rollouts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.mpc import MPCProblem as JMPCProblem
from blitzdg_tpu.mpc import curved_blocked as JM
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_curved as JR
from blitzdg_tpu.ops import sw2d_curved_blocked as JC

from torch_parity import jax_arrays, jax_curved_contexts, jax_fields

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mpc import (MPCProblem, advance_plant_curved_blocked,
                                   build_curved_blocked_mpc, mpc_cost,
                                   mpc_cost_curved_blocked, solve_mpc,
                                   solve_mpc_curved_blocked,
                                   solve_mpc_curved_blocked_gn)
from blitzdg_tpu_torch.mpc import curved_disk as cdk
from blitzdg_tpu_torch.mpc.curved_blocked import _residuals_curved_blocked
from blitzdg_tpu_torch.ops import sw2d_curved as TR
from blitzdg_tpu_torch.ops.sw2d import SWPhysics

B, HORIZON, SPC, DT = 2, 3, 2, 2e-4
F64 = torch.float64
WEIGHTS = dict(q_eta=0.0, q_terminal=1.0, r_control=1e-10)
T = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)


class Cut:
    """The cut configuration on both sides, from one set of JAX contexts."""

    def __init__(self, **weights):
        jctx, jcub, jgauss = jax_curved_contexts("disk")
        self.x, self.y = x, y = np.asarray(jctx.x), np.asarray(jctx.y)
        bump = np.exp(-8.0 * (x ** 2 + y ** 2))
        self.bump = bump
        bu, bv = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
        weights = {**WEIGHTS, **weights}
        common = dict(dt=DT, horizon=HORIZON, steps_per_control=SPC, **weights)

        jphys = jsw.SWPhysics(g=9.81)
        self.jprob = JMPCProblem(ctx=jctx, phys=jphys, **common)
        # build_curved_blocked_mpc of the JAX package freezes float32 operators;
        # here they are frozen in float64
        jops, jmeta = JC.build_curved_blocked_ops(
            jctx, jcub, jgauss, jphys, forcing_bu=bu, forcing_bv=bv,
            dtype=jnp.float64, use_filter=True)
        w = (jctx.Vinv.T @ jctx.Vinv) @ jnp.ones((jctx.n_p,))
        self.jbm = JM.CurvedBlockedMPC(
            rollout=JC.make_curved_rollout_blocked(jops, jmeta, DT, SPC,
                                                   interpret=True),
            meta=jmeta, wj=JC.pack_curved(jmeta, (w[None, :] * jctx.J)[None])[0])

        arrays, static = jax_arrays(jctx)
        to = dict(device="cpu", dtype=F64)
        ctx = convert.context_from_numpy(arrays, static, **to)
        self.cub = convert.cubature_from_numpy(jax_fields(jcub), **to)
        self.gauss = convert.gauss_from_numpy(jax_fields(jgauss), **to)
        phys = SWPhysics(g=9.81)
        self.prob = MPCProblem(
            ctx=ctx, phys=phys, **common,
            rhs_fn=lambda s, t: TR.sw2d_curved_rhs(ctx, self.cub, self.gauss,
                                                   s, t, phys))
        self.bm = build_curved_blocked_mpc(self.prob, self.cub, self.gauss,
                                           bu, bv, **to)
        tb = T(bump)
        self.forcing = lambda c, u, s, t: (torch.zeros_like(s.h),
                                           u[..., 0, None, None] * tb,
                                           u[..., 1, None, None] * tb)

        h0 = np.ones((B,) + x.shape)
        self.s_np = (h0, 0 * h0, 0 * h0, 0 * h0)
        self.tg_np = np.stack([1e-3 * np.exp(-5.0 * ((x - o) ** 2 + y ** 2))
                               for o in (-0.1, 0.2)])
        self.states = TR.SWStateTracer(*map(T, self.s_np))
        self.targets = T(self.tg_np)
        self.jstates = JR.SWStateTracer(*map(jnp.asarray, self.s_np))
        self.jtargets = jnp.asarray(self.tg_np)
        self.ctrls = 0.05 * np.random.default_rng(1).standard_normal(
            (B, HORIZON, 2))


@pytest.fixture(scope="module")
def cut():
    return Cut()


def test_quadrature_row_matches_jax(cut):
    want = np.asarray(JC.unpack_curved(cut.jbm.meta, cut.jbm.wj[None]))[0]
    np.testing.assert_allclose(cut.bm.wj.numpy().reshape(want.shape), want,
                               rtol=1e-13, atol=1e-15)
    assert cut.bm.meta.n_ctrl == 2 and cut.bm.meta.mass_mode == "general"
    assert cut.bm.meta.filter_folded


@pytest.mark.parametrize("weights", [WEIGHTS, dict(q_eta=0.3, q_terminal=1.0,
                                                   r_control=1e-3)],
                         ids=["terminal", "running"])
def test_mpc_cost_matches_jax_and_the_plain_composite(weights):
    c = Cut(**weights)
    want = JM.mpc_cost_curved_blocked(c.jprob, c.jbm, c.jstates,
                                      jnp.asarray(c.ctrls), c.jtargets, 1.0)
    got = mpc_cost_curved_blocked(c.prob, c.bm, c.states, T(c.ctrls),
                                  c.targets, 1.0)
    assert got.shape == (B,) and float(got.min()) > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    # the same problem through mpc_cost with rhs_fn (no kernel module)
    plain = mpc_cost(c.prob, c.states, T(c.ctrls), c.targets, c.forcing,
                     H_rest=1.0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-10)


def test_solve_mpc_curved_blocked_matches_jax(cut):
    iters = 3
    kw = dict(iters=iters, learning_rate=cdk.LEARNING_RATE, H_rest=1.0)
    want = JM.solve_mpc_curved_blocked(
        cut.jprob, cut.jbm, cut.jstates, cut.jtargets, 2,
        init_controls=jnp.asarray(cut.ctrls), **kw)
    got = solve_mpc_curved_blocked(cut.prob, cut.bm, cut.states, cut.targets,
                                   2, init_controls=T(cut.ctrls), **kw)
    assert got.cost_history.shape == (iters, B)
    assert got.controls.shape == (B, HORIZON, 2)
    np.testing.assert_allclose(got.cost_history.numpy(),
                               np.asarray(want.cost_history), rtol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-8)
    np.testing.assert_allclose(got.controls.numpy(),
                               np.asarray(want.controls), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.grad_norm.numpy(),
                               np.asarray(want.grad_norm), rtol=1e-7)
    assert bool((got.cost < got.cost_history[0]).all())
    # and the plain composite takes the same path
    plain = solve_mpc(cut.prob, cut.states, cut.targets, cut.forcing, 2,
                      init_controls=T(cut.ctrls), **kw)
    np.testing.assert_allclose(got.cost.numpy(), plain.cost.numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(got.controls.numpy(), plain.controls.numpy(),
                               rtol=1e-8, atol=1e-10)


def test_solve_mpc_curved_blocked_gn_matches_jax(cut):
    kw = dict(gn_iters=1, cg_iters=2, H_rest=1.0)
    want = JM.solve_mpc_curved_blocked_gn(
        cut.jprob, cut.jbm, cut.jstates, cut.jtargets, 2,
        init_controls=jnp.asarray(cut.ctrls), **kw)
    got = solve_mpc_curved_blocked_gn(cut.prob, cut.bm, cut.states,
                                      cut.targets, 2,
                                      init_controls=T(cut.ctrls), **kw)
    assert got.cost_history.shape == (1, B)
    np.testing.assert_allclose(got.cost_history.numpy(),
                               np.asarray(want.cost_history), rtol=1e-7)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-7)
    scale = float(np.abs(np.asarray(want.controls)).max())
    np.testing.assert_allclose(got.controls.numpy(),
                               np.asarray(want.controls), rtol=0,
                               atol=1e-6 * scale)


def test_residuals_square_to_the_cost_and_gn_beats_adam():
    c = Cut(q_eta=0.1)
    ctrls = T(c.ctrls)
    R = _residuals_curved_blocked(c.prob, c.bm, c.states, c.targets, 1.0)
    cost = mpc_cost_curved_blocked(c.prob, c.bm, c.states, ctrls, c.targets,
                                   1.0)
    np.testing.assert_allclose((R(ctrls) ** 2).sum(1).numpy(), cost.numpy(),
                               rtol=1e-12)
    # quadrature weights with negative roundoff must not turn into NaN
    wj = c.bm.wj.clone()
    wj[0] = -1e-17
    R2 = _residuals_curved_blocked(c.prob, c.bm._replace(wj=wj), c.states,
                                   c.targets, 1.0)
    assert bool(torch.isfinite(R2(ctrls)).all())
    # Gauss-Newton against Adam at equal rollouts
    gn_iters, cg_iters = 3, 4
    gn = solve_mpc_curved_blocked_gn(c.prob, c.bm, c.states, c.targets, 2,
                                     gn_iters=gn_iters, cg_iters=cg_iters,
                                     init_controls=ctrls, H_rest=1.0)
    adam = solve_mpc_curved_blocked(c.prob, c.bm, c.states, c.targets, 2,
                                    iters=gn_iters * (2 + cg_iters),
                                    learning_rate=0.05, init_controls=ctrls,
                                    H_rest=1.0)
    assert bool(torch.isfinite(gn.controls).all())
    assert float(gn.cost.sum()) < float(cost.sum())
    assert float(gn.cost.sum()) < float(adam.cost.sum())


def test_advance_plant_is_the_rollouts_first_interval(cut):
    ctrls = T(cut.ctrls)
    flat = lambda f: f.reshape(B, -1)
    traj = cut.bm.rollout(*(flat(f) for f in cut.states), ctrls)
    plant = advance_plant_curved_blocked(cut.prob, cut.bm, cut.states,
                                         ctrls[:, 0])
    assert isinstance(plant, TR.SWStateTracer)
    assert plant.h.shape == cut.states.h.shape
    for got, want in zip(plant, traj):
        np.testing.assert_allclose(flat(got).numpy(), want[:, SPC].numpy(),
                                   rtol=0, atol=1e-14)


def test_solvers_refuse_a_wrong_control_count(cut):
    with pytest.raises(ValueError):
        solve_mpc_curved_blocked(cut.prob, cut.bm, cut.states, cut.targets,
                                 3, iters=1)
    with pytest.raises(ValueError):
        solve_mpc_curved_blocked_gn(cut.prob, cut.bm, cut.states,
                                    cut.targets, 1, gn_iters=1, cg_iters=1)


def test_unused_trajectories_get_no_cotangent(cut, monkeypatch):
    """The cost reads the depth alone: the backward wrapper must be handed
    ``None`` for the other three trajectories, not zero tensors."""
    from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC

    seen = []

    backward = TC.sw2d_curved_rollout_bwd_blocked

    def spy(ops, meta, traj, tb, *a):
        seen.append(tb)
        return backward(ops, meta, traj, tb, *a)

    monkeypatch.setattr(TC, "sw2d_curved_rollout_bwd_blocked", spy)
    c = T(cut.ctrls).requires_grad_(True)
    cost = mpc_cost_curved_blocked(cut.prob, cut.bm, cut.states, c,
                                   cut.targets)
    (g,) = torch.autograd.grad(cost.sum(), c)
    assert len(seen) == 1 and seen[0][0] is not None
    assert seen[0][1:] == (None, None, None)
    assert float(g.abs().max()) > 0.0


def test_curved_disk_configuration_cut_to_size():
    """The configuration module itself, at a small size on the CPU: the
    benchmark's constants, shapes, and the two solve routes agreeing."""
    assert cdk.SMALL == dict(rings=3, snap_tol=0.3, batch=256)
    assert cdk.LARGE == dict(rings=13, snap_tol=0.1, batch=32)
    assert (cdk.N_ORDER, cdk.HORIZON, cdk.STEPS_PER_CONTROL, cdk.ADAM_ITERS,
            cdk.LEARNING_RATE, cdk.H_REST, cdk.FD_EPS,
            cdk.FD_EPS_FLOAT32) == (3, 4, 2, 5, 0.05, 1.0, 1e-3, 1e-2)
    d = cdk.curved_disk_problem(rings=2, snap_tol=0.3, batch=3, n_order=2,
                                device="cpu")
    m = d.bm.meta
    assert (m.k_elem, m.n_p, m.n_cub, m.n_gauss) == (24, 6, 19, 6)
    assert m.mass_mode == "general" and d.bm.ops.fbuf.dtype == torch.float32
    assert d.states.h.shape == (3, 24, 6) and d.states.h.dtype == torch.float32
    assert (d.prob.q_eta, d.prob.q_terminal, d.prob.r_control) == \
        (0.0, 1.0, 1e-10)
    assert 0.5e-3 < float(d.targets.max()) < 1.001e-3
    np.testing.assert_allclose(float(d.cub.W.sum()), np.pi, rtol=2e-3)
    kw = dict(iters=2, learning_rate=cdk.LEARNING_RATE, H_rest=cdk.H_REST)
    a = solve_mpc_curved_blocked(d.prob, d.bm, d.states, d.targets, 2, **kw)
    b = solve_mpc(d.prob, d.states, d.targets, d.control_to_forcing, 2, **kw)
    np.testing.assert_allclose(a.cost.numpy(), b.cost.numpy(), rtol=1e-3)
    assert bool(torch.isfinite(a.grad_norm).all())
