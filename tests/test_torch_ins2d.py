"""The Boussinesq projection solver (``ops/ins2d.py``) and the namelist
reader of the port against the JAX package (CPU).

Mirrors ``tests/test_ins2d.py``: the projection lowers the divergence, the
stratified gravity-wave run on quads stays bounded (float64 and, over 100
steps, float32), the namelist round trip, the rotational form (volume
identity, agreement with the conservative form, a stable run) and the sign
of the advective dissipation. Parity with the JAX functions on the same
inputs (float64): ``ins2d_advection_rhs``, ``ins2d_rotational_rhs`` and
``divergence`` at 1e-12 on ``build_quad_context(2, box_quads(4, 4))``;
``pressure_project`` and three ``ins2d_step``s (both forms) with the CG held
to a fixed iteration count (tolerance 0, 12 iterations, short of the
rounding floor), so that a residual landing on either side of the tolerance
cannot make the two iterate differently: velocities and states 1e-12, the
pressure (of order 1/dt) 1e-10, the relative residual to 1e-8 of itself. (Past the floor, at 60 iterations, the CG amplifies the
float64 rounding of the two sides' orders of summation to 1e-8.)
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu import config as jcfg
from blitzdg_tpu.mesh import box_quads as j_box_quads
from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.ops import ins2d as JI
from blitzdg_tpu.specgrid.quad import build_quad_context as j_quad
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_tri

from blitzdg_tpu_torch.config import namelist_get, read_namelist
from blitzdg_tpu_torch.mesh import box_quads, box_triangles
from blitzdg_tpu_torch.ops import ins2d as TI
from blitzdg_tpu_torch.ops.ins2d import (INSState, divergence, ins2d_step,
                                         pressure_project)
from blitzdg_tpu_torch.specgrid.quad import build_quad_context
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

F64 = torch.float64
FILT = dict(filter_cutoff=1.5, filter_order=4)
FIXED_CG = dict(tol=0.0, maxiter=12)


def t_quad(n_order, cells, dtype=F64, **kw):
    return build_quad_context(n_order, box_quads(*cells), dtype=dtype,
                              device="cpu", **kw)


def blob(ctx):
    rho = 0.01 * torch.exp(-8.0 * (ctx.x**2 + ctx.y**2))
    return INSState(rho=rho, u=torch.zeros_like(rho), v=torch.zeros_like(rho))


def vortex_state(x, y, lib):
    """A smooth state with a swirling velocity and a density bump (numpy or
    the JAX module as ``lib``)."""
    u = 0.3 * lib.sin(np.pi * x) * lib.cos(np.pi * y) + 0.05 * x
    v = -0.3 * lib.cos(np.pi * x) * lib.sin(np.pi * y) + 0.02 * y * y
    rho = lib.exp(-4.0 * ((x - 0.2) ** 2 + y**2))
    return rho, u, v


@pytest.fixture(scope="module")
def pair():
    jc = j_quad(2, j_box_quads(4, 4), **FILT)
    tc = t_quad(2, (4, 4), **FILT)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    np.testing.assert_allclose(tc.x.numpy(), x, rtol=0, atol=1e-13)
    st = vortex_state(x, y, np)
    return (jc, JI.INSState(*map(jnp.asarray, st)), tc,
            INSState(*(torch.as_tensor(f) for f in st)))


def close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("form", ["conservative", "rotational"])
def test_rhs_matches_jax(pair, form):
    jc, js, tc, ts = pair
    jf = JI.ins2d_rotational_rhs if form == "rotational" else \
        JI.ins2d_advection_rhs
    tf = TI.ins2d_rotational_rhs if form == "rotational" else \
        TI.ins2d_advection_rhs
    for got, want in zip(tf(tc, ts, 0.0, g=9.81), jf(jc, js, 0.0, g=9.81)):
        close(got, want, 1e-12)


def test_divergence_and_projection_match_jax(pair):
    jc, js, tc, ts = pair
    close(divergence(tc, ts.u, ts.v), JI.divergence(jc, js.u, js.v), 1e-12)
    got = pressure_project(tc, ts.u, ts.v, 1e-2, **FIXED_CG)
    want = JI.pressure_project(jc, js.u, js.v, 1e-2, **FIXED_CG)
    for g, w, tol in zip(got[:3], want[:3], (1e-12, 1e-12, 1e-10)):
        close(g, w, tol)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-8)


@pytest.mark.parametrize("form", ["conservative", "rotational"])
def test_steps_match_jax(pair, form, monkeypatch):
    """Three ``ins2d_step``s from the blob at rest plus the vortex, the
    pressure solve at a fixed CG iteration count on both sides."""
    jc, js, tc, ts = pair
    monkeypatch.setattr(TI, "pressure_project",
                        functools.partial(TI.pressure_project, **FIXED_CG))
    monkeypatch.setattr(JI, "pressure_project",
                        functools.partial(JI.pressure_project, **FIXED_CG))
    dt = 2e-3
    for i in range(3):
        ts, tp = ins2d_step(tc, ts, i * dt, dt, form=form)
        js, jp = JI.ins2d_step(jc, js, i * dt, dt, form=form)
    for g, w, tol in zip((*ts, tp), (*js, jp), (1e-12,) * 3 + (1e-10,)):
        close(g, w, tol)


def test_projection_reduces_divergence():
    ctx = build_triangle_context(3, box_triangles(4, 4), device="cpu")
    u = ctx.x**2
    v = ctx.y**2 * 0.5
    div0 = float(divergence(ctx, u, v).abs().max())
    u2, v2, p, relres = pressure_project(ctx, u, v, dt=1e-2)
    div1 = float(divergence(ctx, u2, v2).abs().max())
    assert div1 < 0.2 * div0, (div0, div1)
    # the same on the JAX side, and the same projected field
    jc = j_tri(3, j_box_triangles(4, 4))
    ju2, jv2, _, _ = JI.pressure_project(jc, jc.x**2, jc.y**2 * 0.5, 1e-2)
    close(u2, ju2, 1e-7)
    close(v2, jv2, 1e-7)


def test_boussinesq_gravity_waves_stable_quads():
    """Stable stratification + perturbation on quads: energy stays bounded
    over a short run, the divergence stays small."""
    ctx = t_quad(2, (4, 4), **FILT)
    state = blob(ctx)
    dt = 2e-3
    for i in range(10):
        state, p = ins2d_step(ctx, state, i * dt, dt)
    for f in state:
        assert bool(torch.isfinite(f).all())
    assert float(state.u.abs().max()) < 1.0
    assert float(divergence(ctx, state.u, state.v).abs().max()) < 1.0


def test_long_run_stable_f32():
    """100 projection steps in float32 stay bounded (the symmetric
    Euclidean deflation of the Neumann nullspace)."""
    ctx = t_quad(2, (4, 4), dtype=torch.float32, **FILT)
    state = blob(ctx)
    dt = 2e-3
    for i in range(100):
        state, p = ins2d_step(ctx, state, i * dt, dt)
    assert bool(torch.isfinite(state.rho).all())
    assert float(state.u.abs().max()) < 1e-3
    assert float(p.abs().max()) < 1e-2


def test_namelist_roundtrip(tmp_path):
    p = tmp_path / "run.nml"
    p.write_text(
        """# test namelist
gravitationalAcceleration = 9.81
finalTime = 100.0
initialTime = 0
polynomialOrder = 3

CFL = 0.5
meshFile = input/box.msh
"""
    )
    cfg = read_namelist(str(p))
    assert namelist_get(cfg, "polynomialOrder", int) == 3
    assert namelist_get(cfg, "CFL", float) == 0.5
    assert namelist_get(cfg, "MESHFILE") == "input/box.msh"
    assert namelist_get(cfg, "missing", int, default=7) == 7
    with pytest.raises(KeyError):
        namelist_get(cfg, "missing")
    assert cfg == jcfg.read_namelist(str(p))
    bad = tmp_path / "bad.nml"
    bad.write_text("a = b = c\n")
    with pytest.raises(ValueError):
        read_namelist(str(bad))


class TestRotationalForm:
    """The vorticity-energy momentum form, with the vorticity computed."""

    def _divfree(self, ctx):
        # u = psi_y, v = -psi_x with psi = sin(pi x) sin(pi y): div-free
        pi = np.pi
        u = pi * torch.sin(pi * ctx.x) * torch.cos(pi * ctx.y)
        v = -pi * torch.cos(pi * ctx.x) * torch.sin(pi * ctx.y)
        rho = torch.exp(-4.0 * (ctx.x**2 + ctx.y**2))
        return INSState(rho=rho, u=u, v=v)

    def test_rotational_volume_identity(self):
        """For a smooth divergence-free field, -grad E + u x omega equals
        -(u.grad)u to interpolation accuracy."""
        ctx = t_quad(8, (3, 3))
        s = self._divfree(ctx)
        r = TI.ins2d_rotational_rhs(ctx, s, 0.0, g=0.0)
        pi = np.pi
        x, y = ctx.x, ctx.y
        ux = pi**2 * torch.cos(pi * x) * torch.cos(pi * y)
        uy = -pi**2 * torch.sin(pi * x) * torch.sin(pi * y)
        vx = pi**2 * torch.sin(pi * x) * torch.sin(pi * y)
        vy = -pi**2 * torch.cos(pi * x) * torch.cos(pi * y)
        adv_u = -(s.u * ux + s.v * uy)
        adv_v = -(s.u * vx + s.v * vy)
        scale = float(adv_u.abs().max())
        assert float((r.u - adv_u).abs().max()) < 1e-3 * scale
        assert float((r.v - adv_v).abs().max()) < 1e-3 * scale

    def test_rotational_matches_conservative_divfree(self):
        ctx = t_quad(6, (4, 4))
        s = self._divfree(ctx)
        ra = TI.ins2d_advection_rhs(ctx, s, 0.0, g=9.81)
        rr = TI.ins2d_rotational_rhs(ctx, s, 0.0, g=9.81)
        for a, b in zip(ra, rr):
            scale = float(b.abs().max()) + 1e-30
            assert float((a - b).abs().max()) < 1e-2 * scale

    def test_rotational_step_stable(self):
        ctx = t_quad(2, (4, 4), **FILT)
        s = blob(ctx)
        for i in range(10):
            s, p = ins2d_step(ctx, s, i * 1e-3, 1e-3, form="rotational")
        for f in s:
            assert bool(torch.isfinite(f).all())


def test_advection_dissipation_sign():
    """Advecting a sharp blob in a frozen wall-compatible vortex must not
    grow rho's L2 energy past the interpolant's own divergence floor, and
    the inverted dissipation sign must end with more energy."""
    ctx = t_quad(3, (6, 6))
    x, y = ctx.x, ctx.y
    rho = torch.exp(-40.0 * ((x - 0.3) ** 2 + y**2))
    u = 0.3 * np.pi * torch.sin(np.pi * x) * torch.cos(np.pi * y)
    v = -0.3 * np.pi * torch.cos(np.pi * x) * torch.sin(np.pi * y)
    dt = 1e-3
    s = INSState(rho=rho, u=u, v=v)
    for _ in range(200):
        r = TI.ins2d_advection_rhs(ctx, s, 0.0, g=0.0)
        s1 = INSState(rho=s.rho + 0.5 * dt * r.rho, u=u, v=v)
        r = TI.ins2d_advection_rhs(ctx, s1, 0.0, g=0.0)
        s = INSState(rho=s.rho + dt * r.rho, u=u, v=v)
    e0 = float((rho**2).sum())
    e1 = float((s.rho**2).sum())
    assert np.isfinite(e1)
    assert e1 <= 1.05 * e0, (e0, e1)

    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    nxf, nyf = ctx.nx.reshape(-1), ctx.ny.reshape(-1)
    uM, uP = ctx.surface_trace(u)
    vM, vP = ctx.surface_trace(v)
    lam = torch.maximum((uM * nxf + vM * nyf).abs(), (uP * nxf + vP * nyf).abs())

    def anti_rhs(q):
        qM, qP = ctx.surface_trace(q)
        Fq, Gq = u * q, v * q
        vol = -(ctx.rx * (Fq @ ctx.Dr.T) + ctx.sx * (Fq @ ctx.Ds.T)
                + ctx.ry * (Gq @ ctx.Dr.T) + ctx.sy * (Gq @ ctx.Ds.T))
        FM = uM * qM * nxf + vM * qM * nyf
        FP = uP * qP * nxf + vP * qP * nyf
        dflux = 0.5 * (FM - FP + lam * (qM - qP))  # inverted sign
        return vol + (ctx.fscale * dflux.reshape(K, n_tr)) @ ctx.lift.T

    q = rho
    for _ in range(200):
        q = q + dt * anti_rhs(q + 0.5 * dt * anti_rhs(q))
    assert e1 < float((q**2).sum())
