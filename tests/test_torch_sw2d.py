"""Parity of the port's shallow-water RHS and SSP-RK2 step with the JAX
package (CPU, float64, 1e-12): flat bottom and full coastal physics
with tidal forcing, gather and dense-trace forms, plus lake at rest over
discontinuous bathymetry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops.sw2d_dense import build_dense_trace_ops as j_dense
from blitzdg_tpu.ops.sw2d_dense import sw2d_rhs_dense as j_rhs_dense
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build
from blitzdg_tpu.timestepping import ssprk2_step as j_ssprk2

from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.ops import sw2d as tsw
from blitzdg_tpu_torch.ops.sw2d_dense import (build_dense_trace_ops,
                                              sw2d_rhs_dense)
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
from blitzdg_tpu_torch.timestepping import ssprk2_step

# float64 on both sides; the two differ only in summation order. The RHS of
# the rough test states reaches a few hundred, so 1e-12 is taken relative to
# the value where that is larger than 1 (seen: 1.5e-12 absolute at 1.4e-14
# relative).
TOL = 1e-12
TIDE = (12.0, 0.5, 2.0, 10.0)
B, T0, DT = 3, 1.0, 2e-3


def tidal_np(t):
    h0, amp, omega, tau = TIDE
    return h0 + amp * np.cos(omega * t) * min(t / tau, 1.0)


def tidal_jax(t):
    h0, amp, omega, tau = TIDE
    return h0 + amp * jnp.cos(omega * t) * jnp.minimum(t / tau, 1.0)


@pytest.fixture(scope="module", params=["flat", "coastal"])
def setup(request):
    coastal = request.param == "coastal"
    jm, tm = j_box_triangles(3, 3), box_triangles(3, 3)
    retag_east_open(tm)
    jm.set_bc_type(tm.bc_type.copy())
    kw = dict(filter_cutoff=0.9 * 2, filter_order=2)
    jc = j_build(2, jm, dtype=jnp.float64, **kw)
    tc = build_triangle_context(2, tm, dtype=torch.float64, device="cpu", **kw)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    rng = np.random.default_rng(7)
    if coastal:
        H = 10.0 + 3.0 * x + np.sin(2.0 * y)
        Hx, Hy = 3.0 * np.ones_like(H), 2.0 * np.cos(2.0 * y)
        jp = jsw.SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=jnp.asarray(H),
                           Hx=jnp.asarray(Hx), Hy=jnp.asarray(Hy))
        tp = tsw.SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4,
                           H=torch.as_tensor(H), Hx=torch.as_tensor(Hx),
                           Hy=torch.as_tensor(Hy))
        tides = (tidal_jax, tidal_np)
    else:
        H = 10.0 + 0.0 * x
        jp, tp = jsw.SWPhysics(g=9.81), tsw.SWPhysics(g=9.81)
        tides = (None, None)
    h = H[None] + 0.1 * rng.standard_normal((B,) + H.shape)
    hu = 0.1 * rng.standard_normal(h.shape)
    hv = 0.1 * rng.standard_normal(h.shape)
    return jc, tc, jp, tp, tides, (h, hu, hv)


def _states(s):
    js = jsw.SWState(*(jnp.asarray(a) for a in s))
    ts = tsw.SWState(*(torch.as_tensor(a) for a in s))
    return js, ts


def _close(tstate, jstate):
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_sw2d_rhs_matches_jax(setup):
    jc, tc, jp, tp, (jt, tt), s = setup
    js, ts = _states(s)
    ref = jax.vmap(lambda one: jsw.sw2d_rhs(jc, one, T0, jp,
                                            tidal_forcing=jt))(js)
    _close(tsw.sw2d_rhs(tc, ts, T0, tp, tidal_forcing=tt), ref)


def test_sw2d_rhs_dense_matches_jax(setup):
    jc, tc, jp, tp, (jt, tt), s = setup
    js, ts = _states(s)
    ref = j_rhs_dense(jc, j_dense(jc), js, T0, jp, tidal_forcing=jt)
    got = sw2d_rhs_dense(tc, build_dense_trace_ops(tc), ts, T0, tp,
                         tidal_forcing=tt)
    _close(got, ref)


def test_ssprk2_step_with_filter_matches_jax(setup):
    jc, tc, jp, tp, (jt, tt), s = setup
    js, ts = _states(s)
    jrhs = lambda ss, t: jax.vmap(
        lambda one: jsw.sw2d_rhs(jc, one, t, jp, tidal_forcing=jt))(ss)
    trhs = lambda ss, t: tsw.sw2d_rhs(tc, ss, t, tp, tidal_forcing=tt)
    ref = j_ssprk2(jrhs, js, T0, DT,
                   post_stage=lambda f: jsw.apply_filter(jc, f))
    got = ssprk2_step(trhs, ts, T0, DT,
                      post_stage=lambda f: tsw.apply_filter(tc, f))
    _close(got, ref)


def test_timestep_matches_jax(setup):
    jc, tc, _, _, _, s = setup
    js, ts = _states(tuple(a[0] for a in s))
    ref = float(jsw.sw2d_timestep(jc, js, 9.81, 0.7))
    got = float(tsw.sw2d_timestep(tc, ts, 9.81, 0.7))
    assert abs(got - ref) <= 1e-14 * abs(ref) * 10


def test_lake_at_rest_discontinuous_bathymetry():
    """h + b constant, u = 0, bathymetry that jumps between elements: the
    well-balanced RHS is zero to machine precision."""
    tm = box_triangles(3, 3)
    tc = build_triangle_context(2, tm, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    step = torch.as_tensor(rng.uniform(-2.0, 2.0, (tc.k_elem, 1)))
    H = 10.0 + step.expand(tc.k_elem, tc.n_p).contiguous()
    phys = tsw.SWPhysics(g=9.81, H=H)
    z = torch.zeros_like(H)
    r = tsw.sw2d_rhs(tc, tsw.SWState(H, z, z), 0.0, phys)
    assert float(r.h.abs().max()) == 0.0
    # momentum: the derivative of the piecewise-constant pressure g h^2/2
    # (about 500) is zero only to roundoff, 2e-12 here; the face terms cancel
    # exactly
    assert float(r.hu.abs().max()) < 1e-11
    assert float(r.hv.abs().max()) < 1e-11


def test_sponge_relax_matches_jax():
    rng = np.random.default_rng(5)
    shape = (4, 3)
    H, sp = 10.0 + rng.random(shape), rng.random(shape)
    s = tuple(rng.standard_normal(shape) + off for off in (10.0, 0.0, 0.0))
    jp = jsw.SWPhysics(H=jnp.asarray(H), sponge=jnp.asarray(sp))
    tp = tsw.SWPhysics(H=torch.as_tensor(H), sponge=torch.as_tensor(sp))
    js, ts = _states(s)
    _close(tsw.sponge_relax(ts, tp, 0.01), jsw.sponge_relax(js, jp, 0.01))
