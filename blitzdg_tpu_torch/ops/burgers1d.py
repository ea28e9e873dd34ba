"""1D viscous Burgers equation: LDG right-hand side.

Counterpart of the JAX package's ``blitzdg_tpu/ops/burgers1d.py``: the
auxiliary gradient variable q = sqrt(nu) (rx Dr u - Lift(0.5 Fscale n du)),
a nonlinear Lax-Friedrichs-type flux with the global maximum wavespeed, and
exact traveling-wave Dirichlet data at both ends. Plain tensor code,
differentiable by ``torch.autograd`` (the boundary values are set in the
jumps, which each line computes afresh).
"""
from __future__ import annotations

import torch

from ..config import check_matmul_precision
from ..context import DGContext1D


def burgers_exact(x, t, alpha: float, nu: float, c: float):
    """Traveling-wave solution u = c/a - (c/a) tanh((c/2nu)(x - c t))."""
    return (c / alpha) - (c / alpha) * torch.tanh(0.5 * (c / nu) * (x - c * t))


def burgers1d_rhs(
    ctx: DGContext1D,
    u: torch.Tensor,
    t,
    c: float = 0.5,
    alpha: float = 1.0,
    nu: float = 0.1,
) -> torch.Tensor:
    """du/dt for the viscous Burgers equation, u: (K, Np)."""
    check_matmul_precision(u)
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    uf = u.reshape(-1)
    uM, uP = ctx.surface_trace(u)
    nxf = ctx.nx.reshape(-1)
    sqrt_nu = torch.sqrt(torch.tensor(nu, dtype=u.dtype, device=u.device))

    maxvel = torch.max(torch.abs(u))

    # Dirichlet data from the exact solution at the domain ends.
    xf = ctx.x.reshape(-1)
    uL = burgers_exact(xf[ctx.vmapI], t, alpha, nu, c)
    uR = burgers_exact(xf[ctx.vmapO], t, alpha, nu, c)

    du = uM - uP
    du[..., ctx.mapI] = 2.0 * (uf[ctx.vmapI] - uL)
    du[..., ctx.mapO] = 2.0 * (uf[ctx.vmapO] - uR)

    # Auxiliary variable q ~ sqrt(nu) u_x (LDG with central gradient flux).
    surf_q = (0.5 * ctx.fscale * ctx.nx * du.reshape(K, n_tr)) @ ctx.lift.T
    q = sqrt_nu * (ctx.rx * (u @ ctx.Dr.T) - surf_q)

    qM, qP = ctx.surface_trace(q)
    dq = 0.5 * (qM - qP)
    dq[..., ctx.mapI] = 0.0
    dq[..., ctx.mapO] = 0.0

    # Nonlinear flux jump 0.5 (uM^2 - uP^2), with exact-data boundary jumps.
    du2 = 0.5 * (uM * uM - uP * uP)
    du2[..., ctx.mapI] = uf[ctx.vmapI] ** 2 - uL * uL
    du2[..., ctx.mapO] = uf[ctx.vmapO] ** 2 - uR * uR

    flux = nxf * (0.5 * du2 - sqrt_nu * dq) - 0.5 * maxvel * du

    vol = -(ctx.rx * ((0.5 * u * u - sqrt_nu * q) @ ctx.Dr.T))
    surf = (ctx.fscale * flux.reshape(K, n_tr)) @ ctx.lift.T
    return vol + surf
