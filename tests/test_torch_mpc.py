"""The slice as a whole: MPC costs and solves of the port against the JAX
package on the same inputs (CPU; JAX kernels in interpret mode at
precision="highest").

The headline configuration (coastal coarse box, see
``blitzdg_tpu_torch/mpc/coastal_box.py``) is cut to B=4 scenarios, horizon 4,
2 steps per control and 10 Adam iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.mpc import MPCProblem as JMPCProblem
from blitzdg_tpu.mpc import mpc_cost as j_mpc_cost
from blitzdg_tpu.mpc import mpc_cost_pallas, solve_mpc as j_solve_mpc
from blitzdg_tpu.mpc import solve_mpc_pallas
from blitzdg_tpu.mpc.pallas import PallasMPC
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops.sw2d_dense import build_dense_trace_ops as j_dense
from blitzdg_tpu.ops.sw2d_pallas import (build_pallas_step_ops,
                                         make_rollout as j_make_rollout)
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from blitzdg_tpu_torch.mpc import (advance_plant_fused, build_fused_mpc,
                                   mpc_cost, mpc_cost_fused, solve_mpc,
                                   solve_mpc_fused)
from blitzdg_tpu_torch.mpc import coastal_box as cbx
from blitzdg_tpu_torch.mpc.solver import adam_init, adam_update
from blitzdg_tpu_torch.ops.sw2d import SWState

B, HORIZON, SPC, ITERS, LR = 4, 4, 2, 10, 0.05


@pytest.fixture(scope="module")
def headline():
    """The cut headline on both sides. The JAX side follows the benchmark's
    set-up, except precision='highest' (the port has no bf16x3 mode)."""
    cb = cbx.coastal_box_problem(batch=B, horizon=HORIZON,
                                 steps_per_control=SPC, device="cpu")
    fm = build_fused_mpc(cb.prob, cb.forcing_bu, cb.forcing_bv,
                         tidal=cb.tidal, device="cpu")

    jm = j_box_triangles(4, 5)
    cbx.retag_east_open(jm)
    jc = j_build(1, jm, filter_cutoff=0.9, filter_order=1, dtype=jnp.float32)
    H = jnp.asarray(cb.H_rest.numpy())
    jphys = jsw.SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                          Hx=jnp.asarray(cb.prob.phys.Hx.numpy()),
                          Hy=jnp.asarray(cb.prob.phys.Hy.numpy()))
    jops, jmeta = build_pallas_step_ops(
        jc, j_dense(jc), jphys, cb.forcing_bu, cb.forcing_bv,
        precision="highest", tidal=cb.tidal)
    jprob = JMPCProblem(ctx=jc, phys=jphys, dt=cb.prob.dt, horizon=HORIZON,
                        steps_per_control=SPC, q_eta=0.0, q_terminal=1.0,
                        r_control=1e-10)
    w = (jc.Vinv.T @ jc.Vinv) @ jnp.ones((jc.n_p,), dtype=jc.J.dtype)
    pad = jmeta.n_vp - jmeta.n_v
    pm = PallasMPC(
        rollout=j_make_rollout(jops, jmeta, cb.prob.dt, SPC, tile_b=B,
                               interpret=True),
        meta=jmeta,
        wj=jnp.pad((w[None, :] * jc.J).reshape(-1), (0, pad)).astype(jnp.float32),
        vmask=(jnp.arange(jmeta.n_vp) < jmeta.n_v).astype(jnp.float32))
    jstates = jsw.SWState(*(jnp.asarray(f.numpy()) for f in cb.states))
    jtargets = jnp.asarray(cb.targets.numpy())
    h_rest = jnp.pad(H.reshape(-1), (0, pad)).astype(jnp.float32)
    return cb, fm, jprob, pm, jstates, jtargets, h_rest


def test_mpc_cost_fused_matches_pallas(headline):
    cb, fm, jprob, pm, jstates, jtargets, h_rest = headline
    ctrls = 0.3 * np.random.default_rng(5).standard_normal((B, HORIZON, 2))
    cpd = jnp.pad(jnp.asarray(ctrls, jnp.float32),
                  ((0, 0), (0, 0), (0, pm.meta.cp - 2)))
    ref = mpc_cost_pallas(jprob, pm, jstates, cpd, jtargets, h_rest)
    got = mpc_cost_fused(cb.prob, fm, cb.states,
                         torch.as_tensor(ctrls, dtype=torch.float32),
                         cb.targets, cb.H_rest)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5)


def test_mpc_cost_matches_jax_and_fused():
    """Flat-bottom wall box with running + terminal + effort weights, as in
    the JAX package's own MPC test: the port's autograd cost, its fused
    cost and the JAX cost agree at rtol 2e-5 (float32)."""
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import MPCProblem
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    dt, Hn, spc, nb = 2e-3, 4, 2, 3
    kw = dict(filter_cutoff=0.9, filter_order=1)
    jc = j_build(1, j_box_triangles(3, 3), dtype=jnp.float32, **kw)
    tc = build_triangle_context(1, box_triangles(3, 3), dtype=torch.float32,
                                device="cpu", **kw)
    bump = np.exp(-8.0 * (np.asarray(jc.x, np.float64) ** 2
                          + np.asarray(jc.y, np.float64) ** 2))
    BU, BV = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
    weights = dict(q_eta=0.3, q_terminal=1.0, r_control=1e-8)
    jprob = JMPCProblem(ctx=jc, phys=jsw.SWPhysics(g=9.81), dt=dt, horizon=Hn,
                        steps_per_control=spc, **weights)
    tprob = MPCProblem(ctx=tc, phys=SWPhysics(g=9.81), dt=dt, horizon=Hn,
                       steps_per_control=spc, **weights)
    rng = np.random.default_rng(5)
    ctrls = 0.3 * rng.standard_normal((nb, Hn, 2))
    offs = np.linspace(-0.2, 0.2, nb)
    x, y = np.asarray(jc.x, np.float64), np.asarray(jc.y, np.float64)
    tg = 0.01 * np.exp(-5.0 * ((x[None] - offs[:, None, None]) ** 2 + y[None] ** 2))
    h0 = np.full((nb,) + x.shape, 10.0)

    def jforcing(c, control, state, t):
        bmp = jnp.asarray(bump, dtype=state.h.dtype)
        return jnp.zeros_like(state.h), control[0] * bmp, control[1] * bmp

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    jstates = jsw.SWState(f32(h0), f32(0 * h0), f32(0 * h0))
    ref = jax.vmap(lambda s, c, t: j_mpc_cost(jprob, s, c, t, jforcing))(
        jstates, f32(ctrls), f32(tg))

    tb = torch.as_tensor(bump, dtype=torch.float32)

    def tforcing(c, control, state, t):
        return (torch.zeros_like(state.h), control[..., 0, None, None] * tb,
                control[..., 1, None, None] * tb)

    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    tstates = SWState(t32(h0), t32(0 * h0), t32(0 * h0))
    got = mpc_cost(tprob, tstates, t32(ctrls), t32(tg), tforcing)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5)
    fm = build_fused_mpc(tprob, BU, BV, device="cpu")
    got_f = mpc_cost_fused(tprob, fm, tstates, t32(ctrls), t32(tg))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref), rtol=2e-5)


def test_solve_mpc_fused_matches_solve_mpc_pallas(headline):
    """Cost history within rtol 1e-2 at every iteration, final controls
    within 5e-2 of the largest control, and the cost falls.

    Adam divides by sqrt(v) + 1e-8 and the gradients here are about 1e-6 and
    smaller, so float32 roundoff in a near-zero gradient component is
    amplified into the control; the tolerances leave room for that. Seen on
    this configuration: cost history relative difference 2e-6 at most,
    controls 3e-3 of the largest control.
    """
    cb, fm, jprob, pm, jstates, jtargets, h_rest = headline
    ref = solve_mpc_pallas(jprob, pm, jstates, jtargets, 2, iters=ITERS,
                           learning_rate=LR, H_rest=h_rest)
    sol = solve_mpc_fused(cb.prob, fm, cb.states, cb.targets, 2, iters=ITERS,
                          learning_rate=LR, H_rest=cb.H_rest)
    hist, jhist = sol.cost_history.numpy(), np.asarray(ref.cost_history)
    assert hist.shape == jhist.shape == (ITERS, B)
    assert np.all(np.isfinite(hist))
    np.testing.assert_allclose(hist, jhist, rtol=1e-2)
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(ref.cost), rtol=1e-2)
    jc = np.asarray(ref.controls)
    assert sol.controls.shape == jc.shape == (B, HORIZON, 2)
    assert np.max(np.abs(sol.controls.numpy() - jc)) <= 5e-2 * np.max(np.abs(jc))
    assert np.all(sol.cost.numpy() < hist[0])
    print("max rel cost-history diff", np.max(np.abs(hist / jhist - 1)),
          "controls diff / max control",
          np.max(np.abs(sol.controls.numpy() - jc)) / np.max(np.abs(jc)))


def test_advance_plant_follows_the_rollout(headline):
    cb, fm, *_ = headline
    ctrls = torch.as_tensor(
        0.3 * np.random.default_rng(2).standard_normal((B, HORIZON, 2)),
        dtype=torch.float32)
    flat = lambda f: f.reshape(B, -1)
    th, thu, thv = fm.rollout(flat(cb.states.h), flat(cb.states.hu),
                              flat(cb.states.hv), ctrls)
    s = advance_plant_fused(cb.prob, fm, cb.states, ctrls[:, 0])
    for a, b in ((s.h, th), (s.hu, thu), (s.hv, thv)):
        np.testing.assert_allclose(flat(a).numpy(), b[:, SPC].numpy(),
                                   rtol=0, atol=1e-6)


def test_adam_update_matches_optax():
    """Fed the same gradient sequence, the port's update equals optax.adam
    to 1e-6 over 10 steps (float32)."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((3, 4, 2)) * 10.0 ** rng.integers(-6, 1)
             for _ in range(10)]
    p0 = rng.standard_normal((3, 4, 2))
    opt = optax.adam(LR)
    jp = jnp.asarray(p0, jnp.float32)
    jstate = opt.init(jp)
    tp = torch.as_tensor(p0, dtype=torch.float32)
    tstate = adam_init(tp)
    for g in grads:
        upd, jstate = opt.update(jnp.asarray(g, jnp.float32), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tstate = adam_update(torch.as_tensor(g, dtype=torch.float32),
                                 tstate, tp, LR)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-6)


def test_solve_mpc_float64_matches_jax():
    """One scenario, float64, gather RHS with autograd against the JAX
    scan + jax.grad: cost history at 1e-8 (relative)."""
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import MPCProblem
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    dt, Hn, spc, iters = 2e-3, 3, 2, 6
    kw = dict(filter_cutoff=0.9, filter_order=1)
    jc = j_build(1, j_box_triangles(3, 3), dtype=jnp.float64, **kw)
    tc = build_triangle_context(1, box_triangles(3, 3), dtype=torch.float64,
                                device="cpu", **kw)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    tg = 0.01 * np.exp(-5.0 * ((x - 0.1) ** 2 + y ** 2))
    h0 = 10.0 + 0.05 * np.exp(-6.0 * (x ** 2 + (y - 0.2) ** 2))
    weights = dict(q_eta=0.3, q_terminal=1.0, r_control=1e-6)
    jprob = JMPCProblem(ctx=jc, phys=jsw.SWPhysics(g=9.81), dt=dt, horizon=Hn,
                        steps_per_control=spc, **weights)
    tprob = MPCProblem(ctx=tc, phys=SWPhysics(g=9.81), dt=dt, horizon=Hn,
                       steps_per_control=spc, **weights)

    def jforcing(c, control, state, t):
        bmp = jnp.asarray(bump)
        return jnp.zeros_like(state.h), control[0] * bmp, control[1] * bmp

    tb = torch.as_tensor(bump)

    def tforcing(c, control, state, t):
        return (torch.zeros_like(state.h), control[..., 0, None, None] * tb,
                control[..., 1, None, None] * tb)

    z = np.zeros_like(h0)
    ref = j_solve_mpc(jprob, jsw.SWState(*(jnp.asarray(a) for a in (h0, z, z))),
                      jnp.asarray(tg), jforcing, 2, iters=iters,
                      learning_rate=LR)
    sol = solve_mpc(tprob, SWState(*(torch.as_tensor(a) for a in (h0, z, z))),
                    torch.as_tensor(tg), tforcing, 2, iters=iters,
                    learning_rate=LR)
    np.testing.assert_allclose(sol.cost_history.numpy(),
                               np.asarray(ref.cost_history), rtol=1e-8)
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-8)
    assert sol.controls.shape == (Hn, 2)
    assert float(sol.cost) < float(sol.cost_history[0])
