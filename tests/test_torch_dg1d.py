"""The 1D solvers of the port (``ops/advec1d.py``, ``ops/burgers1d.py``) and
its LSERK4 integrators (``timestepping.lserk4_step``, ``integrate``,
``integrate_trajectory``) against the JAX package (CPU, float64).

Mirrors ``tests/test_advec1d.py`` (the zero state, the Gaussian carried to
T=20 against the exact solution and the independent numpy oracle, spectral
convergence, batched scenarios) and ``tests/test_burgers1d.py`` (the
traveling wave against the exact solution and its oracle, and the
gradient of a terminal cost, here through ``torch.autograd`` against
``jax.grad``). Parity with the JAX functions on the same inputs: each
right-hand side at 1e-13 on seeded random states, one LSERK4 step at
1e-13, whole rollouts at 1e-12, the stacked trajectory row for row at
1e-12, the gradient at 1e-12 relative.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blitzdg_tpu import timestepping as JT
from blitzdg_tpu.ops.advec1d import advec1d_rhs as j_advec
from blitzdg_tpu.ops.burgers1d import burgers1d_rhs as j_burgers
from blitzdg_tpu.ops.burgers1d import burgers_exact as j_exact
from blitzdg_tpu.specgrid.nodes1d import build_nodes1d as j_nodes1d

from blitzdg_tpu_torch.ops import advec1d_rhs, burgers1d_rhs, burgers_exact
from blitzdg_tpu_torch.specgrid import build_nodes1d
from blitzdg_tpu_torch.timestepping import (integrate, integrate_trajectory,
                                            lserk4_step)

sys.path.insert(0, str(Path(__file__).parent))

F64 = torch.float64


def nodes(n_order, k_elem, xmin, xmax):
    tc = build_nodes1d(n_order, k_elem, xmin, xmax, device="cpu")
    jc = j_nodes1d(n_order, k_elem, xmin, xmax)
    np.testing.assert_allclose(tc.x.numpy(), np.asarray(jc.x), rtol=0,
                               atol=1e-14)
    return tc, jc


def reference_config():
    tc, jc = nodes(4, 30, -1.0, 4.0)
    c, CFL = 0.1, 0.8
    x = tc.x.numpy()
    dt = CFL * (x[0, 1] - x[0, 0]) / abs(c)
    return tc, jc, c, dt


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_rhs_and_one_lserk4_step_match_jax():
    """advec1d_rhs (upwind and central) and burgers1d_rhs on seeded random
    states; one LSERK4 step of each."""
    rng = np.random.default_rng(0)
    tc, jc, c, dt = reference_config()
    u = rng.standard_normal((tc.k_elem, tc.n_p))
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    for alpha in (0.0, 1.0):
        close(advec1d_rhs(tc, tu, 0.3, c, alpha), j_advec(jc, ju, 0.3, c, alpha),
              1e-13)
    close(lserk4_step(lambda v, t: advec1d_rhs(tc, v, t, c), tu, 0.0, dt),
          JT.lserk4_step(lambda v, t: j_advec(jc, v, t, c), ju, 0.0, dt),
          1e-13)
    bc, bj = nodes(6, 40, -5.0, 5.0)
    w = 0.5 + 0.2 * rng.standard_normal((bc.k_elem, bc.n_p))
    tw, jw = torch.as_tensor(w), jnp.asarray(w)
    kw = dict(c=0.5, alpha=1.0, nu=0.1)
    close(burgers1d_rhs(bc, tw, 0.05, **kw), j_burgers(bj, jw, 0.05, **kw),
          1e-12)
    close(lserk4_step(lambda v, t: burgers1d_rhs(bc, v, t, **kw), tw, 0.0,
                      1e-3),
          JT.lserk4_step(lambda v, t: j_burgers(bj, v, t, **kw), jw, 0.0,
                         1e-3), 1e-13)


def test_advec1d_rhs_zero_for_constant_zero():
    tc, _, c, _ = reference_config()
    u = torch.zeros((tc.k_elem, tc.n_p), dtype=F64)
    assert float(advec1d_rhs(tc, u, 0.0, c).abs().max()) == 0.0


def test_advec1d_gaussian_transport_error():
    """The full run to T=20: the exact shifted Gaussian to spectral
    accuracy, the independent oracle's final solution to 1e-6, and the JAX
    rollout to 1e-12."""
    from oracle.advec1d_oracle import run_reference_config

    tc, jc, c, dt = reference_config()
    num_steps = int(np.ceil(20.0 / dt))
    t_final = num_steps * dt
    u = integrate(lserk4_step, lambda v, t: advec1d_rhs(tc, v, t, c),
                  torch.exp(-10.0 * tc.x**2), 0.0, dt, num_steps)
    exact = torch.exp(-10.0 * (tc.x - c * t_final) ** 2)
    err = float((u - exact).abs().max())

    x_o, u_o, err_o = run_reference_config()
    np.testing.assert_allclose(tc.x.numpy(), x_o, atol=1e-12)
    assert np.max(np.abs(u.numpy() - u_o)) < 1e-6
    assert abs(err - err_o) < 1e-6
    assert err < 5e-4

    ju = jax.jit(lambda v: JT.integrate(
        JT.lserk4_step, lambda w, t: j_advec(jc, w, t, c), v, 0.0, dt,
        num_steps))(jnp.exp(-10.0 * jc.x**2))
    close(u, ju, 1e-12)


def test_advec1d_convergence():
    """Error decreases with polynomial order (spectral convergence)."""
    errs = []
    for N in [2, 4, 6]:
        ctx = build_nodes1d(N, 20, -1.0, 4.0, device="cpu")
        c = 0.1
        x = ctx.x.numpy()
        dt = 0.5 * (x[0, 1] - x[0, 0]) / abs(c)
        steps = int(np.ceil(5.0 / dt))
        u = integrate(lserk4_step, lambda v, t: advec1d_rhs(ctx, v, t, c),
                      torch.exp(-10.0 * ctx.x**2), 0.0, dt, steps)
        exact = torch.exp(-10.0 * (ctx.x - c * steps * dt) ** 2)
        errs.append(float((u - exact).abs().max()))
    assert errs[1] < errs[0] * 0.2
    assert errs[2] < errs[1]


def test_advec1d_batched_scenarios():
    """A leading scenario axis (the place of the JAX test's vmap) agrees
    with the unbatched solve per scenario; the stacked trajectory matches
    the JAX ``integrate_trajectory`` row for row."""
    tc, jc, c, dt = reference_config()
    shifts = torch.tensor([0.0, 0.5, 1.0, 1.5], dtype=F64)[:, None, None]
    u0 = torch.exp(-10.0 * (tc.x - shifts) ** 2)
    rhs = lambda u, t: advec1d_rhs(tc, u, t, c)
    batched = integrate(lserk4_step, rhs, u0, 0.0, dt, 50)
    single = integrate(lserk4_step, rhs, u0[2], 0.0, dt, 50)
    assert float((batched[2] - single).abs().max()) < 1e-12
    end, traj = integrate_trajectory(lserk4_step, rhs, u0[1], 0.0, dt, 10)
    jend, jtraj = JT.integrate_trajectory(
        JT.lserk4_step, lambda u, t: j_advec(jc, u, t, c),
        jnp.exp(-10.0 * (jc.x - 0.5) ** 2), 0.0, dt, 10)
    assert traj.shape == (10, tc.k_elem, tc.n_p)
    assert torch.equal(traj[-1], end)
    close(traj, jtraj, 1e-12)
    close(end, jend, 1e-12)


def test_burgers1d_traveling_wave():
    """N=6, K=40, nu=0.1, c=0.5, CFL=0.75 to T=0.1: the exact wave to
    spectral accuracy, the oracle's solution to 1e-6, the JAX rollout to
    1e-12."""
    sys.path.insert(0, str(Path(__file__).parent / "oracle"))
    from burgers1d_oracle import run_reference_config

    nu, c, alpha, CFL = 0.1, 0.5, 1.0, 0.75
    tc, jc = nodes(6, 40, -5.0, 5.0)
    x = tc.x.numpy()
    min_dx = x[0, 1] - x[0, 0]
    dt = CFL * min(min_dx / abs(c), min_dx**2 / np.sqrt(nu))
    num_steps = int(np.ceil(0.1 / dt))
    kw = dict(c=c, alpha=alpha, nu=nu)
    u = integrate(lserk4_step, lambda v, t: burgers1d_rhs(tc, v, t, **kw),
                  burgers_exact(tc.x, 0.0, alpha, nu, c), 0.0, dt, num_steps)
    t_end = num_steps * dt
    err = float((u - burgers_exact(tc.x, t_end, alpha, nu, c)).abs().max())

    x_o, u_o, err_o, t_o = run_reference_config()
    np.testing.assert_allclose(x, x_o, atol=1e-12)
    assert abs(t_end - t_o) < 1e-12
    assert np.max(np.abs(u.numpy() - u_o)) < 1e-6
    assert abs(err - err_o) < 1e-6
    assert err < 1e-5

    ju = JT.integrate(JT.lserk4_step,
                      lambda v, t: j_burgers(jc, v, t, **kw),
                      j_exact(jc.x, 0.0, alpha, nu, c), 0.0, dt, num_steps)
    close(u, ju, 1e-12)


def test_burgers1d_differentiable():
    """The rollout is differentiable: the gradient of a terminal cost with
    respect to the initial condition through ``torch.autograd`` is finite,
    nonzero and equal to ``jax.grad``'s to 1e-12 relative."""
    tc, jc = nodes(4, 10, -5.0, 5.0)
    dt = 1e-3

    u0 = burgers_exact(tc.x, 0.0, 1.0, 0.1, 0.5).clone().requires_grad_(True)
    u = integrate(lserk4_step, lambda v, t: burgers1d_rhs(tc, v, t), u0, 0.0,
                  dt, 5)
    (g,) = torch.autograd.grad((u**2).sum(), u0)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0

    def loss(v0):
        v = JT.integrate(JT.lserk4_step, lambda w, t: j_burgers(jc, w, t),
                         v0, 0.0, dt, 5)
        return jnp.sum(v**2)

    jg = np.asarray(jax.grad(loss)(j_exact(jc.x, 0.0, 1.0, 0.1, 0.5)))
    assert float(np.abs(g.numpy() - jg).max() / np.abs(jg).max()) < 1e-12


def test_integrators_keep_tuple_states():
    """A NamedTuple state keeps its type through LSERK4, ``integrate`` and
    ``integrate_trajectory``; zero steps give the start state and an empty
    trajectory (what the JAX scan of length 0 gives)."""
    from typing import NamedTuple

    class S(NamedTuple):
        a: torch.Tensor
        b: torch.Tensor

    rhs = lambda s, t: S(-s.b, s.a)  # rotation: the state stays on a circle
    s0 = S(torch.ones(3, dtype=F64), torch.zeros(3, dtype=F64))
    end = integrate(lserk4_step, rhs, s0, 0.0, 0.01, 100)
    assert isinstance(end, S)
    np.testing.assert_allclose(end.a.numpy(), np.cos(1.0), atol=1e-9)
    np.testing.assert_allclose(end.b.numpy(), np.sin(1.0), atol=1e-9)
    last, traj = integrate_trajectory(lserk4_step, rhs, s0, 0.0, 0.01, 4)
    assert isinstance(traj, S) and traj.a.shape == (4, 3)
    last, traj = integrate_trajectory(lserk4_step, rhs, s0, 0.0, 0.01, 0)
    assert last is s0 and isinstance(traj, S) and traj.b.shape == (0, 3)
