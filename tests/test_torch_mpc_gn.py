"""The rest of the port's ``mpc/solver.py`` against the JAX package's
(CPU, float64): the Gauss-Newton residual, ``solve_mpc_gn`` and
``receding_horizon`` on ``tests/test_mpc.py``'s problem (``make_problem``:
``box_triangles(3, 3)``, N=1, Gaussian momentum sources, dt 2e-3, 4 steps
per control).

 - ``_mpc_residuals``: sum(R^2) equals ``mpc_cost`` to 1e-12 and R equals
   the JAX residual to 1e-14 of the depth (R is of order 1e-5: depths of
   about 10 less 10, so its rounding is the depth's);
 - ``solve_mpc_gn`` at horizon 6 on the reachable target, 4 outer x 6 CG
   iterations: the same accept pattern, cost history and final cost to
   1e-10, controls to 1e-9, and |grad| < 1e-12, as the JAX test has it;
 - three scenarios at once (one of them with nothing to do: zero target,
   so its steps are rejected while the others' are accepted) against the
   JAX solve under vmap: a dot product or an accept test over the batch
   would couple them and show here;
 - ``receding_horizon`` at 3 cycles of 5 Adam iterations: applied controls,
   per-cycle costs and the plant's end state equal JAX's; and the plant
   step runs the problem's own ``rhs_fn`` (ROADMAP C22).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_mpc import gaussian_source_forcing, make_problem  # noqa: E402

from blitzdg_tpu.mpc import receding_horizon as j_receding  # noqa: E402
from blitzdg_tpu.mpc import rollout_controls as j_rollout  # noqa: E402
from blitzdg_tpu.mpc import solve_mpc_gn as j_gn  # noqa: E402
from blitzdg_tpu.mpc.solver import _mpc_residuals as j_residuals  # noqa: E402

from blitzdg_tpu_torch.mesh import box_triangles  # noqa: E402
from blitzdg_tpu_torch.mpc import (MPCProblem, mpc_cost,  # noqa: E402
                                   receding_horizon, solve_mpc_gn)
from blitzdg_tpu_torch.mpc.solver import _mpc_residuals  # noqa: E402
from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState, sw2d_rhs  # noqa: E402
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context  # noqa: E402

F64 = torch.float64


def port_problem(horizon, rhs_fn=None):
    """The port's counterpart of ``make_problem(horizon=...)``."""
    ctx = build_triangle_context(1, box_triangles(3, 3), filter_cutoff=0.9,
                                 filter_order=1, dtype=F64, device="cpu")
    prob = MPCProblem(ctx=ctx, phys=SWPhysics(g=9.81), dt=2e-3,
                      horizon=horizon, steps_per_control=4, q_eta=0.0,
                      q_terminal=1.0, r_control=1e-10, rhs_fn=rhs_fn)
    bump = torch.exp(-8.0 * (ctx.x ** 2 + ctx.y ** 2))

    def forcing(c, control, state, t):
        return (torch.zeros_like(state.h), control[..., 0, None, None] * bump,
                control[..., 1, None, None] * bump)

    h0 = torch.full((ctx.k_elem, ctx.n_p), 10.0, dtype=F64)
    return prob, SWState(h0, torch.zeros_like(h0), torch.zeros_like(h0)), forcing


@pytest.fixture(scope="module")
def reachable():
    """Horizon 6 and the reachable target of the JAX GN test."""
    jprob, jstate0 = make_problem(horizon=6)
    final, _ = j_rollout(jprob, jstate0, 0.5 * jnp.ones((6, 2)),
                         gaussian_source_forcing)
    jtarget = final.h - 10.0
    prob, state0, forcing = port_problem(6)
    return (jprob, jstate0, jtarget, prob, state0, forcing,
            torch.as_tensor(np.array(jtarget)))


def test_residuals_match_cost_and_jax(reachable):
    jprob, jstate0, jtarget, prob, state0, forcing, target = reachable
    for seed in (0, 1):
        c = 0.2 + 0.1 * np.random.default_rng(seed).standard_normal((6, 2))
        r = _mpc_residuals(prob, state0, torch.as_tensor(c), target, forcing,
                           10.0)
        cost = mpc_cost(prob, state0, torch.as_tensor(c), target, forcing,
                        10.0)
        np.testing.assert_allclose(float(torch.sum(r * r)), float(cost),
                                   rtol=1e-12)
        rj = np.asarray(j_residuals(jprob, jstate0, jnp.asarray(c), jtarget,
                                    gaussian_source_forcing, 10.0))
        assert r.shape == rj.shape
        np.testing.assert_allclose(r.numpy(), rj, rtol=0, atol=1e-14 * 10.0)


def accepts(history, cost0):
    """Which outer iterations were accepted: the recorded cost fell."""
    prev = np.concatenate([[cost0], history[:-1]])
    return history < prev


def test_solve_mpc_gn_matches_jax(reachable):
    jprob, jstate0, jtarget, prob, state0, forcing, target = reachable
    sj = jax.jit(lambda s, tg: j_gn(jprob, s, tg, gaussian_source_forcing, 2,
                                    gn_iters=4, cg_iters=6))(jstate0, jtarget)
    st = solve_mpc_gn(prob, state0, target, forcing, 2, gn_iters=4,
                      cg_iters=6)
    hj, ht = np.asarray(sj.cost_history), st.cost_history.numpy()
    assert ht.shape == hj.shape == (4,)
    cost0 = float(mpc_cost(prob, state0, torch.zeros(6, 2, dtype=F64), target,
                           forcing, 10.0))
    np.testing.assert_array_equal(accepts(ht, cost0), accepts(hj, cost0))
    np.testing.assert_allclose(ht, hj, rtol=1e-10)
    np.testing.assert_allclose(float(st.cost), float(sj.cost), rtol=1e-10)
    np.testing.assert_allclose(st.controls.numpy(), np.asarray(sj.controls),
                               rtol=0, atol=1e-9)
    assert float(st.grad_norm) < 1e-12
    assert float(st.cost) < 0.02 * cost0


def test_solve_mpc_gn_batch_matches_vmap(reachable):
    """Three scenarios: the reachable target, half of it, and zero (rest is
    already optimal there: every step of that scenario is rejected, its λ
    grows while the others' shrinks)."""
    jprob, jstate0, jtarget, prob, state0, forcing, target = reachable
    scale = np.array([1.0, 0.5, 0.0])
    jtargets = jnp.asarray(scale)[:, None, None] * jtarget
    jstates = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape),
                           jstate0)
    sj = jax.jit(jax.vmap(lambda s, tg: j_gn(
        jprob, s, tg, gaussian_source_forcing, 2, gn_iters=2,
        cg_iters=4)))(jstates, jtargets)
    states = SWState(*(f.expand(3, *f.shape).contiguous() for f in state0))
    targets = torch.as_tensor(scale)[:, None, None] * target
    st = solve_mpc_gn(prob, states, targets, forcing, 2, gn_iters=2,
                      cg_iters=4)
    hj, ht = np.asarray(sj.cost_history), st.cost_history.numpy()
    assert ht.shape == (2, 3) and hj.shape == (3, 2)  # (iters, B) / (B, iters)
    np.testing.assert_allclose(ht.T, hj, rtol=1e-10, atol=1e-300)
    assert np.all(ht[:, 2] == 0.0) and np.all(ht[-1, :2] < ht[0, :2])
    np.testing.assert_allclose(st.cost.numpy(), np.asarray(sj.cost),
                               rtol=1e-10, atol=1e-300)
    np.testing.assert_allclose(st.controls.numpy(), np.asarray(sj.controls),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(st.grad_norm.numpy(), np.asarray(sj.grad_norm),
                               rtol=1e-6, atol=1e-12)
    assert st.controls.shape == (3, 6, 2)
    assert np.all(st.controls[2].numpy() == 0.0)


def test_receding_horizon_matches_jax():
    jprob, jstate0 = make_problem(horizon=3)
    prob, state0, forcing = port_problem(3)
    x, y = prob.ctx.x.numpy(), prob.ctx.y.numpy()
    tg = 0.01 * np.exp(-5.0 * ((x - 0.2) ** 2 + y ** 2))
    sj, aj, cj = jax.jit(lambda s: j_receding(
        jprob, s, jnp.asarray(tg), gaussian_source_forcing, 2, n_cycles=3,
        iters=5))(jstate0)
    st, at, ct = receding_horizon(prob, state0, torch.as_tensor(tg), forcing,
                                  2, n_cycles=3, iters=5)
    assert at.shape == (3, 2) and ct.shape == (3,)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-10)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-10)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_receding_horizon_plant_runs_the_problems_rhs_fn():
    """The plant problem is the solve's problem with horizon 1: a custom
    ``rhs_fn`` drives the plant step too (the JAX function drops it)."""
    calls = []

    def rhs_fn(state, t):
        calls.append(state.h.shape)
        return sw2d_rhs(prob.ctx, state, t, prob.phys)

    prob, state0, forcing = port_problem(2, rhs_fn=rhs_fn)
    tg = torch.zeros_like(prob.ctx.x)
    states = SWState(*(f.expand(2, *f.shape).contiguous() for f in state0))
    st, at, ct = receding_horizon(prob, states, tg, forcing, 2, n_cycles=1,
                                  iters=1)
    # one Adam iteration and the final cost: 2 rollouts of 2 x 4 steps,
    # then the plant: 4 steps; two RHS calls a step
    assert len(calls) == 2 * (2 * 2 * 4) + 2 * 4
    assert at.shape == (2, 1, 2) and ct.shape == (2, 1)
    ref = port_problem(2)
    st2, at2, _ = receding_horizon(ref[0], states, tg, forcing, 2, n_cycles=1,
                                   iters=1)
    np.testing.assert_array_equal(at.numpy(), at2.numpy())
    for a, b in zip(st, st2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
