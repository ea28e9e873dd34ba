"""Large-mesh kernel-accelerated MPC: shooting optimization over the
element-BLOCKED rollout (``ops/sw2d_blocked.py``).

Counterpart of the JAX package's ``blitzdg_tpu/mpc/blocked.py``
(``BlockedMPC``, ``build_blocked_mpc``, ``mpc_cost_blocked``,
``solve_mpc_blocked``, ``solve_mpc_blocked_gn``). Same optimization problem
as ``mpc_cost``/``solve_mpc`` and the dense-kernel ``mpc/fused.py``, but the
dynamics kernels scale to meshes of thousands of elements. Use this above
the dense path's K of about 200 (the dense path stays the one for tiny
meshes with huge scenario batches).

Scope: what the blocked kernels differentiate, i.e. the full coastal physics
(wall and tidal BC_OUT boundaries, well-balanced bathymetry, drag, Coriolis,
sponge) with a control forcing linear in the controls; not wetting/drying.
Scenario batching is native.

Cost, Adam, conjugate gradients and the Levenberg-Marquardt loop are plain
tensor code around the two kernels. ``advance_plant_blocked`` is the
closed-loop half: it moves the plant one control interval with the step
kernel.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.sw2d import SWState
from ..ops.sw2d_blocked import (BlockedMeta, BlockedOps,
                                build_blocked_step_ops, make_rollout_blocked,
                                sw2d_step_blocked)
from .problem import MPCProblem
from .solver import MPCSolution, adam_minimize


class BlockedMPC(NamedTuple):
    rollout: Callable
    ops: BlockedOps
    meta: BlockedMeta
    wj: torch.Tensor  # (nV,) mass-weighted quadrature row


def build_blocked_mpc(
    prob: MPCProblem,
    forcing_bu: np.ndarray,  # (n_ctrl, K, Np) linear hu-forcing injector
    forcing_bv: np.ndarray,
    tidal: tuple | None = None,  # (h0, amp, omega, ramp_tau) BC_OUT forcing
    dtype: torch.dtype = torch.float32,
    device="cuda",
    forward=None,
    backward=None,
) -> BlockedMPC:
    """Freeze the blocked operator set on ``device`` and wrap the
    differentiable rollout. ``forward``/``backward`` are passed on to
    ``make_rollout_blocked``."""
    ctx = prob.ctx
    ops, meta = build_blocked_step_ops(ctx, prob.phys, forcing_bu, forcing_bv,
                                       dtype=dtype, tidal=tidal, device=device)
    rollout = make_rollout_blocked(ops, meta, prob.dt, prob.steps_per_control,
                                   use_filter=prob.use_filter,
                                   forward=forward, backward=backward)
    Vinv = ctx.Vinv.double().cpu()
    w = (Vinv.T @ Vinv) @ torch.ones((ctx.n_p,), dtype=torch.float64)
    wj = (w[None, :] * ctx.J.double().cpu()).reshape(-1)
    return BlockedMPC(rollout=rollout, ops=ops, meta=meta,
                      wj=wj.to(device=device, dtype=dtype))


def _flat(f: torch.Tensor) -> torch.Tensor:
    return f.reshape(f.shape[0], -1).contiguous()


def _tracking_error(prob, bm, states0, controls, targets, H_rest):
    """Elevation error (B, horizon, nV) after each control block."""
    spc = prob.steps_per_control
    th, _, _ = bm.rollout(_flat(states0.h), _flat(states0.hu),
                          _flat(states0.hv), controls.contiguous())
    sel = th[:, spc::spc]  # step indices (j+1)*spc, j = 0..H-1
    rest = H_rest.reshape(-1) if isinstance(H_rest, torch.Tensor) else H_rest
    return (sel - rest) - _flat(targets)[:, None, :]


def mpc_cost_blocked(
    prob: MPCProblem,
    bm: BlockedMPC,
    states0: SWState,  # (B, K, Np) fields
    controls: torch.Tensor,  # (B, horizon, n_ctrl)
    targets: torch.Tensor,  # (B, K, Np) target eta
    H_rest: float | torch.Tensor = 10.0,
) -> torch.Tensor:
    """Per-scenario quadratic tracking cost (B,): the blocked analog of
    ``mpc_cost_fused``, batched natively. ``H_rest``: scalar rest depth or a
    (K, Np) still-water depth field."""
    err = _tracking_error(prob, bm, states0, controls, targets, H_rest)
    per_step = torch.sum(bm.wj * err * err, dim=-1)  # (B, H)
    running = torch.sum(per_step, dim=-1) / prob.horizon
    terminal = per_step[:, -1]
    effort = torch.sum(controls * controls, dim=(-2, -1))
    return (prob.q_eta * running + prob.q_terminal * terminal
            + prob.r_control * effort)


def _init_controls(prob, bm, states0, n_controls, init_controls):
    if n_controls != bm.meta.n_ctrl:
        raise ValueError(f"n_controls={n_controls}, but the operator set has "
                         f"{bm.meta.n_ctrl} control injectors")
    if init_controls is not None:
        return init_controls
    h = states0.h
    return torch.zeros((h.shape[0], prob.horizon, n_controls), dtype=h.dtype,
                       device=h.device)


def solve_mpc_blocked(
    prob: MPCProblem,
    bm: BlockedMPC,
    states0: SWState,  # (B, K, Np) fields
    targets: torch.Tensor,  # (B, K, Np)
    n_controls: int,
    *,
    iters: int = 50,
    learning_rate: float = 0.1,
    init_controls: torch.Tensor | None = None,  # (B, horizon, n_controls)
    H_rest: float | torch.Tensor = 10.0,
) -> MPCSolution:
    """Batched Adam shooting solve on the blocked rollout.

    The solution reports the per-scenario cost plus ``grad_norm``, the TRUE
    gradient norm per scenario at the returned controls (one extra value and
    gradient): the convergence measure that a solves-per-second figure is
    conditioned on."""
    c0 = _init_controls(prob, bm, states0, n_controls, init_controls)
    total = lambda c: mpc_cost_blocked(prob, bm, states0, c, targets, H_rest)
    controls, _, history = adam_minimize(total, c0, iters, learning_rate,
                                         final_cost=False)
    c = controls.detach().requires_grad_(True)
    costs = total(c)
    (gfin,) = torch.autograd.grad(costs.sum(), c)
    grad_norm = torch.sqrt(torch.sum(gfin * gfin, dim=(-2, -1)))  # (B,)
    return MPCSolution(controls=controls, cost=costs.detach(),
                       cost_history=history, grad_norm=grad_norm)


def _residuals_blocked(prob, bm, states0, targets, H_rest):
    """Per-scenario stacked least-squares residuals R(c) (B, n_res) with
    sum(R**2, dim=1) == mpc_cost_blocked."""
    # wj carries ~1e-17 negative roundoff on some meshes: harmless when
    # squared (the cost path) but NaN under sqrt
    swj = torch.sqrt(torch.clamp_min(bm.wj, 0.0))

    def R(c):
        err = _tracking_error(prob, bm, states0, c, targets, H_rest)
        B = c.shape[0]
        run = ((prob.q_eta / prob.horizon) ** 0.5 * swj * err).reshape(B, -1)
        term = (prob.q_terminal ** 0.5 * swj * err[:, -1]).reshape(B, -1)
        eff = (prob.r_control ** 0.5 * c).reshape(B, -1)
        return torch.cat([run, term, eff], dim=1)

    return R


def _bdot(a, b):
    return torch.sum(a * b, dim=tuple(range(1, a.dim())))


def _gn_lm_fd(R, c0, *, gn_iters, cg_iters, lm_lambda0, fd_eps):
    """Batched Gauss-Newton/Levenberg-Marquardt with forward-difference Jv
    and exact J^T (the adjoint kernel). R: (B, H, n_ctrl) -> (B, n_res).

    One forward keeps its graph per Gauss-Newton iteration; every J^T u is
    one ``torch.autograd.grad`` through it, i.e. one adjoint launch."""
    one = lambda x: torch.ones_like(x)

    def linearize(c):
        c = c.detach().requires_grad_(True)
        r = R(c)

        def pullback(u):
            (g,) = torch.autograd.grad(r, c, u, retain_graph=True)
            return g

        return r.detach(), pullback

    def R_nograd(c):
        with torch.no_grad():
            return R(c)

    c = c0.detach().clone()
    lam = torch.full((c.shape[0],), lm_lambda0, dtype=c.dtype, device=c.device)
    history = []
    for _ in range(gn_iters):
        r, pullback = linearize(c)
        cost = _bdot(r, r)  # (B,)
        g = pullback(r)  # (B, H, n_ctrl)

        def jv_fd(v):
            vn = torch.sqrt(_bdot(v, v))[:, None, None]
            cn = torch.sqrt(_bdot(c, c))[:, None, None]
            eps = fd_eps * (cn + 1.0) / torch.where(vn > 0, vn, one(vn))
            return (R_nograd(c + eps * v) - r) / eps[:, :, 0]

        gn2 = _bdot(g, g)
        Jg = jv_fd(g)
        curv = _bdot(Jg, Jg) / torch.where(gn2 > 0, gn2, one(gn2))
        lam_eff = (lam * torch.where(curv > 0, curv, one(curv)))[:, None, None]

        jtjv = lambda v: pullback(jv_fd(v)) + lam_eff * v

        x = torch.zeros_like(g)
        rr = -g
        p = rr
        rs = _bdot(rr, rr)
        for _ in range(cg_iters):
            Ap = jtjv(p)
            denom = _bdot(p, Ap)
            ok = denom > 0
            zero = torch.zeros_like(rs)
            alpha = torch.where(ok, rs / torch.where(ok, denom, one(denom)),
                                zero)[:, None, None]
            x = x + alpha * p
            rr = rr - alpha * Ap
            rs_new = _bdot(rr, rr)
            beta = torch.where(ok, rs_new / torch.where(rs > 0, rs, one(rs)),
                               zero)[:, None, None]
            p = rr + beta * p
            rs = rs_new
        delta = x

        r_new = R_nograd(c + delta)
        new_cost = _bdot(r_new, r_new)
        accept = new_cost < cost
        c = torch.where(accept[:, None, None], c + delta, c)
        lam = torch.where(accept, lam * 0.4, lam * 4.0)
        history.append(torch.where(accept, new_cost, cost))

    r_fin, pb_fin = linearize(c)
    gfin = pb_fin(r_fin)
    return MPCSolution(
        controls=c, cost=_bdot(r_fin, r_fin),
        cost_history=torch.stack(history, dim=0),
        grad_norm=2.0 * torch.sqrt(_bdot(gfin, gfin)))


def solve_mpc_blocked_gn(
    prob: MPCProblem,
    bm: BlockedMPC,
    states0: SWState,
    targets: torch.Tensor,
    n_controls: int,
    *,
    gn_iters: int = 3,
    cg_iters: int = 4,
    lm_lambda0: float = 1e-2,
    init_controls: torch.Tensor | None = None,
    H_rest: float | torch.Tensor = 10.0,
    fd_eps: float = 1e-3,
) -> MPCSolution:
    """Gauss-Newton/Levenberg-Marquardt on the blocked rollout, batched over
    scenarios: (J^T J + lambda curv I) delta = -J^T R by matrix-free
    conjugate gradients per scenario.

    J^T u rides the adjoint kernel exactly; Jv uses a FORWARD DIFFERENCE
    through the rollout kernel (the rollout defines a backward only).
    ``fd_eps`` is scaled per scenario by |c|/|v|, and the damping absorbs the
    O(fd_eps) noise of the product. One CG step costs one extra rollout and
    one adjoint."""
    c0 = _init_controls(prob, bm, states0, n_controls, init_controls)
    R = _residuals_blocked(prob, bm, states0, targets, H_rest)
    return _gn_lm_fd(R, c0, gn_iters=gn_iters, cg_iters=cg_iters,
                     lm_lambda0=lm_lambda0, fd_eps=fd_eps)


def advance_plant_blocked(
    prob: MPCProblem,
    bm: BlockedMPC,
    states: SWState,  # (B, K, Np) fields
    control: torch.Tensor,  # (B, n_ctrl): the control to apply
    t0: float = 0.0,
) -> SWState:
    """Apply one control for one control interval: ``steps_per_control``
    blocked SSP-RK2 steps, one kernel launch each (the closed-loop half of
    MPC, as ``advance_plant_fused`` on the dense path)."""
    shape = states.h.shape
    h, hu, hv = (_flat(f) for f in states)
    control = control.contiguous()
    for i in range(prob.steps_per_control):
        h, hu, hv = sw2d_step_blocked(bm.ops, bm.meta, h, hu, hv, control,
                                      prob.dt, t0 + i * prob.dt,
                                      prob.use_filter)
    return SWState(h.reshape(shape), hu.reshape(shape), hv.reshape(shape))
