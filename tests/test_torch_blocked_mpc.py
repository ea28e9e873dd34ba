"""The blocked path as a whole: ``mpc/blocked.py`` of the port against the
JAX package's blocked MPC on the same inputs, CPU, float64 on both sides
(the JAX kernels in interpret mode, the port's wrappers through their plain
versions).

The large-mesh configuration (``mpc/blocked_box.py``: rest start, two
Gaussian-bump injectors, reachable terminal target, q_terminal = 1e6) is cut
to K = 32 triangles, N = 2, B = 2 scenarios, horizon 2, 2 steps per control.

Tolerances: cost and Adam's cost history 1e-8 relative (seen: 4e-14 on the
history, 6e-13 on the controls; both sides run the same arithmetic in
another summation order). Gauss-Newton: 1e-7 relative on cost history and
final cost, 1e-7 of the largest entry on the controls, 1e-6 on the gradient
norm (seen: 3.6e-10, 8e-10, 8e-10). Its Jv is a forward difference of two
rollouts: the two packages' rounding differences (1e-13 relative in a
residual) are divided by eps |v| / |R| before they enter conjugate
gradients, which costs three to four digits against the Adam solve.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.mpc import MPCProblem as JMPCProblem
from blitzdg_tpu.mpc import blocked as JM
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_blocked as JB
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mpc import (MPCProblem, advance_plant_blocked,
                                   build_blocked_mpc, mpc_cost_blocked,
                                   solve_mpc_blocked, solve_mpc_blocked_gn)
from blitzdg_tpu_torch.mpc import blocked_box as bbx
from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState

B, HORIZON, SPC, N_ORDER, CELLS = 2, 2, 2, 2, (4, 4)
F64 = torch.float64
WEIGHTS = dict(q_eta=0.0, q_terminal=1e6, r_control=1e-8)


class Cut:
    """The cut configuration on both sides, from one JAX context."""

    def __init__(self, **weights):
        kw = dict(filter_cutoff=0.9 * N_ORDER, filter_order=4)
        self.jc = jc = j_build(N_ORDER, j_box_triangles(*CELLS), **kw)
        arrays, static = jax_arrays(jc)
        self.tc = tc = convert.context_from_numpy(arrays, static,
                                                  device="cpu", dtype=F64)
        self.dt = dt = cfl_dt(tc, 9.81, 11.0, cfl=0.7)
        x, y = np.asarray(jc.x), np.asarray(jc.y)
        bump = np.exp(-8.0 * (x ** 2 + y ** 2))
        self.bu, self.bv = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
        weights = {**WEIGHTS, **weights}

        self.jprob = JMPCProblem(ctx=jc, phys=jsw.SWPhysics(g=9.81), dt=dt,
                                 horizon=HORIZON, steps_per_control=SPC,
                                 **weights)
        jops, jmeta = JB.build_blocked_step_ops(
            jc, self.jprob.phys, self.bu, self.bv, dtype=jnp.float64)
        w = (jc.Vinv.T @ jc.Vinv) @ jnp.ones((jc.n_p,), dtype=jc.J.dtype)
        self.jbm = JM.BlockedMPC(
            rollout=JB.make_rollout_blocked(jops, jmeta, dt, SPC,
                                            interpret=True),
            meta=jmeta, wj=JB.pack_state(jmeta, (w[None, :] * jc.J)[None])[0])

        self.prob = MPCProblem(ctx=tc, phys=SWPhysics(g=9.81), dt=dt,
                               horizon=HORIZON, steps_per_control=SPC,
                               **weights)
        self.bm = build_blocked_mpc(self.prob, self.bu, self.bv, dtype=F64,
                                    device="cpu")

        # rest start; reachable target: the terminal elevation under the
        # hidden controls, scenario b scaled by (1 + b / 2)
        h0 = np.full((B,) + x.shape, bbx.H_REST)
        self.s_np = (h0, 0 * h0, 0 * h0)
        hidden = (bbx.HIDDEN_CONTROL
                  * (1.0 + 0.5 * np.arange(B))[:, None, None]
                  * np.ones((B, HORIZON, 2)))
        flat = lambda a: torch.as_tensor(a, dtype=F64).reshape(B, -1)
        with torch.no_grad():
            th, _, _ = self.bm.rollout(*map(flat, self.s_np),
                                       torch.as_tensor(hidden))
        self.tg_np = (th[:, -1] - bbx.H_REST).reshape(h0.shape).numpy()
        self.states = SWState(*(torch.as_tensor(a, dtype=F64)
                                for a in self.s_np))
        self.targets = torch.as_tensor(self.tg_np)
        self.jstates = jsw.SWState(*map(jnp.asarray, self.s_np))
        self.jtargets = jnp.asarray(self.tg_np)


@pytest.fixture(scope="module")
def cut():
    return Cut()


def test_quadrature_row_matches_jax(cut):
    want = np.asarray(JB.unpack_state(cut.jbm.meta, cut.jbm.wj[None]))[0]
    # entries that vanish analytically are 1e-17 roundoff on both sides
    np.testing.assert_allclose(cut.bm.wj.numpy().reshape(want.shape), want,
                               rtol=1e-13, atol=1e-15)
    assert cut.bm.meta.n_ctrl == 2 and not cut.bm.meta.coastal


@pytest.mark.parametrize("weights", [WEIGHTS, dict(q_eta=0.3, q_terminal=1.0,
                                                   r_control=1e-3)],
                         ids=["terminal", "running"])
def test_mpc_cost_blocked_matches_jax(weights):
    c = Cut(**weights)
    ctrls = 5.0 * np.random.default_rng(5).standard_normal((B, HORIZON, 2))
    want = JM.mpc_cost_blocked(c.jprob, c.jbm, c.jstates, jnp.asarray(ctrls),
                               c.jtargets, bbx.H_REST)
    got = mpc_cost_blocked(c.prob, c.bm, c.states, torch.as_tensor(ctrls),
                           c.targets, bbx.H_REST)
    assert got.shape == (B,) and float(got.min()) > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)
    # a (K, Np) rest-depth field is taken as well as a scalar
    field = torch.full(c.states.h.shape[1:], bbx.H_REST, dtype=F64)
    again = mpc_cost_blocked(c.prob, c.bm, c.states, torch.as_tensor(ctrls),
                             c.targets, field)
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-14)


def test_solve_mpc_blocked_matches_jax(cut):
    iters = 3
    want = JM.solve_mpc_blocked(cut.jprob, cut.jbm, cut.jstates, cut.jtargets,
                                2, iters=iters,
                                learning_rate=bbx.LEARNING_RATE,
                                H_rest=bbx.H_REST)
    got = solve_mpc_blocked(cut.prob, cut.bm, cut.states, cut.targets, 2,
                            iters=iters, learning_rate=bbx.LEARNING_RATE,
                            H_rest=bbx.H_REST)
    assert got.cost_history.shape == (iters, B)
    assert got.controls.shape == (B, HORIZON, 2)
    np.testing.assert_allclose(got.cost_history.numpy(),
                               np.asarray(want.cost_history), rtol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-8)
    np.testing.assert_allclose(got.controls.numpy(),
                               np.asarray(want.controls), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.grad_norm.numpy(),
                               np.asarray(want.grad_norm), rtol=1e-7)
    assert bool((got.cost < got.cost_history[0]).all())


def test_solve_mpc_blocked_gn_matches_jax(cut):
    kw = dict(gn_iters=1, cg_iters=2, fd_eps=bbx.FD_EPS, H_rest=bbx.H_REST)
    want = JM.solve_mpc_blocked_gn(cut.jprob, cut.jbm, cut.jstates,
                                   cut.jtargets, 2, **kw)
    got = solve_mpc_blocked_gn(cut.prob, cut.bm, cut.states, cut.targets, 2,
                               **kw)
    assert got.cost_history.shape == (1, B)
    np.testing.assert_allclose(got.cost_history.numpy(),
                               np.asarray(want.cost_history), rtol=1e-7)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-7)
    scale = float(np.abs(np.asarray(want.controls)).max())
    assert scale > 0.0  # a step was accepted
    np.testing.assert_allclose(got.controls.numpy(),
                               np.asarray(want.controls), rtol=0,
                               atol=1e-7 * scale)
    np.testing.assert_allclose(got.grad_norm.numpy(),
                               np.asarray(want.grad_norm), rtol=1e-6)


def test_gn_residuals_square_to_the_cost_and_clamp_the_weights(cut):
    from blitzdg_tpu_torch.mpc.blocked import _residuals_blocked

    ctrls = torch.as_tensor(
        5.0 * np.random.default_rng(6).standard_normal((B, HORIZON, 2)))
    R = _residuals_blocked(cut.prob, cut.bm, cut.states, cut.targets,
                           bbx.H_REST)
    cost = mpc_cost_blocked(cut.prob, cut.bm, cut.states, ctrls, cut.targets,
                            bbx.H_REST)
    np.testing.assert_allclose((R(ctrls) ** 2).sum(1).numpy(), cost.numpy(),
                               rtol=1e-12)
    # quadrature weights with negative roundoff must not turn into NaN
    wj = cut.bm.wj.clone()
    wj[0] = -1e-17
    R2 = _residuals_blocked(cut.prob, cut.bm._replace(wj=wj), cut.states,
                            cut.targets, bbx.H_REST)
    assert bool(torch.isfinite(R2(ctrls)).all())


def test_advance_plant_blocked_is_the_rollouts_first_interval(cut):
    ctrls = torch.as_tensor(
        5.0 * np.random.default_rng(7).standard_normal((B, HORIZON, 2)))
    flat = lambda f: f.reshape(B, -1)
    th, thu, thv = cut.bm.rollout(*(flat(f) for f in cut.states), ctrls)
    plant = advance_plant_blocked(cut.prob, cut.bm, cut.states, ctrls[:, 0])
    assert plant.h.shape == cut.states.h.shape
    for got, want in zip(plant, (th, thu, thv)):
        np.testing.assert_allclose(flat(got).numpy(), want[:, SPC].numpy(),
                                   rtol=0, atol=1e-13)


def test_solvers_refuse_a_wrong_control_count(cut):
    with pytest.raises(ValueError):
        solve_mpc_blocked(cut.prob, cut.bm, cut.states, cut.targets, 3,
                          iters=1)
    with pytest.raises(ValueError):
        solve_mpc_blocked_gn(cut.prob, cut.bm, cut.states, cut.targets, 1,
                             gn_iters=1, cg_iters=1)


def test_blocked_box_configuration_cut_to_size():
    """The configuration module itself, at a small size on the CPU: shapes,
    the benchmark's constants, and a target the hidden controls reach."""
    assert (bbx.CELLS, bbx.N_ORDER, bbx.BATCH, bbx.ROLLOUT_STEPS) == \
        ((32, 32), 3, 8, 2048)
    assert (bbx.HORIZON, bbx.STEPS_PER_CONTROL, bbx.ADAM_ITERS,
            bbx.LEARNING_RATE) == (4, 2, 5, 6.0)
    assert (bbx.GN_ITERS, bbx.CG_ITERS, bbx.FD_EPS) == (2, 2, 0.3)
    box = bbx.blocked_box_problem(batch=2, horizon=2, n_order=1, cells=(3, 3),
                                  device="cpu")
    assert box.states.h.shape == (2, 18, 3) and box.hidden.shape == (2, 2, 2)
    assert (box.prob.q_eta, box.prob.q_terminal, box.prob.r_control) == \
        (0.0, 1e6, 1e-8)
    at_hidden = mpc_cost_blocked(box.prob, box.bm, box.states, box.hidden,
                                 box.targets, bbx.H_REST)
    at_zero = mpc_cost_blocked(box.prob, box.bm, box.states,
                               torch.zeros_like(box.hidden), box.targets,
                               bbx.H_REST)
    # at the hidden controls only the effort term is left
    effort = 1e-8 * float((box.hidden[0] ** 2).sum())
    assert float(at_hidden.max()) < 2.0 * effort < float(at_zero.min())
    roll = bbx.blocked_rollout_problem(n_order=1, batch=2, cells=(3, 3),
                                       n_steps=4, device="cpu")
    assert roll.states.h.shape == (2, 18 * 3) and roll.n_steps == 4
    assert float(roll.states.h.max()) > bbx.H_REST + 0.05  # the hump
    out = TB.sw2d_rollout_blocked(roll.ops, roll.meta, *roll.states, None,
                                  roll.dt, n_steps=roll.n_steps)
    assert all(bool(torch.isfinite(f).all()) for f in out)
