"""2D incompressible Boussinesq solver (projection method).

Counterpart of the JAX package's ``blitzdg_tpu/ops/ins2d.py``: density
advection and momentum with buoyancy, made incompressible by a Chorin
projection each step:

  1. advect:   (rho*, u*, v*) = SSP-RK2 step of advection + buoyancy
  2. project:  solve  Lap p = div(u*)/dt  (all-Neumann, mean-zero)
  3. correct:  u = u* - dt grad p   (discretely divergence-reducing)

The pressure solve is the matrix-free IP Laplacian (``poisson2d_op``) with
Neumann tags, made solvable by mean-deflated CG (``solvers.krylov.cg``) on
the device. Plain tensor code (no kernel of its own); the wall traces are
set on gathered indices through ``torch.where`` on a copy, so autograd can
run through a step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import check_matmul_precision
from ..context import BC_NEUMAN, BC_WALL, DGContext2D
from ..solvers.krylov import cg
from .poisson import _set_where, apply_mass, poisson2d_op


class INSState(NamedTuple):
    rho: torch.Tensor  # density perturbation (K, Np)
    u: torch.Tensor
    v: torch.Tensor


def _wall_traces(ctx: DGContext2D, uM, uP, vM, vP, rhoM, rhoP):
    """Free-slip walls: the '+' velocity is the '-' one with its normal
    component reflected, the '+' density the '-' one."""
    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)
    wall = ctx.bc_maps.idx[BC_WALL]
    wmask = ctx.bc_maps.mask[BC_WALL]
    un2 = 2.0 * (uM[..., wall] * nxf[wall] + vM[..., wall] * nyf[wall])
    uP = _set_where(uP, wall, wmask, uM[..., wall] - un2 * nxf[wall])
    vP = _set_where(vP, wall, wmask, vM[..., wall] - un2 * nyf[wall])
    rhoP = _set_where(rhoP, wall, wmask, rhoM[..., wall])
    return uP, vP, rhoP


def ins2d_advection_rhs(
    ctx: DGContext2D, state: INSState, t, g: float = 9.81, rho0: float = 1000.0
) -> INSState:
    """Advective RHS with upwind-stabilized fluxes + buoyancy source.

    Conservation-form advection of (rho, u, v) by the velocity field with a
    local Lax-Friedrichs interface flux; buoyancy -g rho/rho0 on v.
    """
    check_matmul_precision(state.u)
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    rho, u, v = state

    uM, uP = ctx.surface_trace(u)
    vM, vP = ctx.surface_trace(v)
    rhoM, rhoP = ctx.surface_trace(rho)
    uP, vP, rhoP = _wall_traces(ctx, uM, uP, vM, vP, rhoM, rhoP)

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)
    lam = torch.maximum(
        torch.abs(uM * nxf + vM * nyf), torch.abs(uP * nxf + vP * nyf)
    )

    def advect(q, qM, qP):
        # volume: -(div(u q)) in conservation form
        Fq, Gq = u * q, v * q
        Fr, Fs = Fq @ ctx.Dr.T, Fq @ ctx.Ds.T
        Gr, Gs = Gq @ ctx.Dr.T, Gq @ ctx.Ds.T
        vol = -(ctx.rx * Fr + ctx.sx * Fs + ctx.ry * Gr + ctx.sy * Gs)
        # surface: (F_M - F*).n with the LF flux, dissipation -lam (qM - qP)
        FM = uM * qM * nxf + vM * qM * nyf
        FP = uP * qP * nxf + vP * qP * nyf
        dflux = 0.5 * (FM - FP - lam * (qM - qP))
        return vol + (ctx.fscale * dflux.reshape(*q.shape[:-2], K, n_tr)) @ ctx.lift.T

    rhs_rho = advect(rho, rhoM, rhoP)
    rhs_u = advect(u, uM, uP)
    rhs_v = advect(v, vM, vP) - g * rho / rho0
    return INSState(rho=rhs_rho, u=rhs_u, v=rhs_v)


def ins2d_rotational_rhs(
    ctx: DGContext2D, state: INSState, t, g: float = 9.81, rho0: float = 1000.0
) -> INSState:
    """The vorticity-energy (rotational) momentum form:

        du/dt = -grad(E)_x - v*vort + face terms
        dv/dt = -grad(E)_y + u*vort - g*rho/rho0 + face terms
        E = (u^2 + v^2)/2,   vort = u_y - v_x

    (equal to conservative advection for divergence-free fields). The face
    terms are jumps of (rho u, rho v), (u^2, uv), (uv, v^2) with the
    advective trace-max |u| stabilization on the primitive-variable jumps;
    the wall traces are reflected as in ``ins2d_advection_rhs``.
    """
    check_matmul_precision(state.u)
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    rho, u, v = state

    uM, uP = ctx.surface_trace(u)
    vM, vP = ctx.surface_trace(v)
    rhoM, rhoP = ctx.surface_trace(rho)
    uP, vP, rhoP = _wall_traces(ctx, uM, uP, vM, vP, rhoM, rhoP)

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # advective trace-max wavespeed per face
    spd = torch.maximum(torch.sqrt(uM * uM + vM * vM),
                        torch.sqrt(uP * uP + vP * vP))
    spd = spd.reshape(*spd.shape[:-1], -1, ctx.n_fp)
    lam = torch.amax(spd, dim=-1, keepdim=True).expand(spd.shape)
    lam = lam.reshape(*lam.shape[:-2], -1)

    # face flux jumps
    d1 = 0.5 * ((rhoM * uM - rhoP * uP) * nxf
                + (rhoM * vM - rhoP * vP) * nyf - lam * (rhoM - rhoP))
    d2 = 0.5 * ((uM * uM - uP * uP) * nxf
                + (uM * vM - uP * vP) * nyf - lam * (uM - uP))
    d3 = 0.5 * ((uM * vM - uP * vP) * nxf
                + (vM * vM - vP * vP) * nyf - lam * (vM - vP))

    # volume: nonconservative rho advection + rotational momentum
    rhox, rhoy = ctx.grad(rho)
    ener = 0.5 * (u * u + v * v)
    enerx, enery = ctx.grad(ener)
    ux, uy = ctx.grad(u)
    vx, vy = ctx.grad(v)
    vort = uy - vx

    def surf(d):
        return (ctx.fscale * d.reshape(*rho.shape[:-2], K, n_tr)) @ ctx.lift.T

    rhs_rho = -u * rhox - v * rhoy + surf(d1)
    rhs_u = -enerx - v * vort + surf(d2)
    rhs_v = -enery + u * vort - g * rho / rho0 + surf(d3)
    return INSState(rho=rhs_rho, u=rhs_u, v=rhs_v)


def divergence(ctx: DGContext2D, u, v):
    check_matmul_precision(u)
    ur, us = u @ ctx.Dr.T, u @ ctx.Ds.T
    vr, vs = v @ ctx.Dr.T, v @ ctx.Ds.T
    return ctx.rx * ur + ctx.sx * us + ctx.ry * vr + ctx.sy * vs


def pressure_project(
    ctx: DGContext2D, u, v, dt, tol: float = 1e-8, maxiter: int = 400
):
    """Chorin projection: solve the mean-deflated Neumann Poisson problem
    Lap p = div(u)/dt and subtract dt grad p. Returns (u', v', p, relres).

    Nullspace handling: the symmetrized Neumann SIP operator L is symmetric
    PSD with kernel = constants, so CG is run on P L P where
    P = I - 11^T/n is the Euclidean-orthogonal projector onto the
    constants' complement; P L P stays symmetric, which CG requires. The
    quadrature-weighted demean is applied only to the reported p, to pin
    its physical mean."""
    w = _quad_weights(ctx)

    def demean_quad(f):
        tot = torch.sum(w * f) / torch.sum(w)
        return f - tot

    def proj(v_flat):
        return v_flat - torch.mean(v_flat)

    # a tolerance below ~50*eps of the working dtype is unreachable; clamp
    # so low-precision runs terminate on stagnation instead of spinning
    tol = max(tol, 50.0 * float(torch.finfo(u.dtype).eps))

    rhs = divergence(ctx, u, v) / dt
    b = proj(-apply_mass(ctx, demean_quad(rhs)).reshape(-1))

    def matvec(p):
        pm = proj(p).reshape(ctx.k_elem, ctx.n_p)
        lap = poisson2d_op(
            ctx, pm, dirichlet_tags=(), neumann_tags=(BC_WALL, BC_NEUMAN),
            symmetrize=True,
        )
        return proj(-lap.reshape(-1))

    res = cg(matvec, b, tol=tol, maxiter=maxiter)
    p = demean_quad(res.x.reshape(ctx.k_elem, ctx.n_p))
    px, py = ctx.grad(p)
    return u - dt * px, v - dt * py, p, res.relres


def _quad_weights(ctx):
    M = ctx.Vinv.T @ ctx.Vinv
    return ctx.J * (M @ torch.ones(ctx.n_p, dtype=ctx.J.dtype,
                                   device=ctx.J.device))[None, :]


def ins2d_step(ctx: DGContext2D, state: INSState, t, dt, g=9.81, rho0=1000.0,
               use_filter: bool = True, form: str = "conservative"):
    """One SSP-RK2 advection step followed by pressure projection; returns
    (state, p). ``form``: 'conservative' (div(u q) advection) or
    'rotational' (the vorticity-energy momentum form). Runs on the device
    of ``ctx`` and ``state``."""
    filt = (lambda f: f @ ctx.filter.T) if use_filter else (lambda f: f)
    rhs_fn = (ins2d_rotational_rhs if form == "rotational"
              else ins2d_advection_rhs)

    def rhs(s, tt):
        out = rhs_fn(ctx, s, tt, g=g, rho0=rho0)
        return INSState(*(filt(f) for f in out))

    k1 = rhs(state, t)
    s1 = INSState(*(a + 0.5 * dt * b for a, b in zip(state, k1)))
    k2 = rhs(s1, t + 0.5 * dt)
    s2 = INSState(*(a + dt * b for a, b in zip(state, k2)))

    u2, v2, p, relres = pressure_project(ctx, s2.u, s2.v, dt)
    return INSState(rho=s2.rho, u=u2, v=v2), p
