"""MPC solvers over control sequences, batched over scenarios.

Counterpart of the JAX package's ``blitzdg_tpu/mpc/solver.py`` (the whole
file), over the plain composite rollout (``problem.rollout_controls``):

 - ``solve_mpc``: fixed-iteration Adam, gradients by reverse-mode autograd
   through the rollout. The update is written out with the defaults the
   JAX package gets from its optimizer library: b1 = 0.9, b2 = 0.999,
   eps = 1e-8 added to sqrt(v_hat), bias correction on both moments.
 - ``solve_mpc_gn``: Gauss-Newton with Levenberg-Marquardt damping on the
   stacked residual R(c) of ``_mpc_residuals`` (cost == sum(R**2)): each
   outer iteration runs ``cg_iters`` steps of matrix-free CG on
   (JᵀJ + λI) δ = -JᵀR. One rollout with its autograd graph is recorded an
   outer iteration; Jᵀu is a backward pass through it, and Jv the
   derivative of that pullback, J v = ∂/∂u ⟨Jᵀu, v⟩: one backward pass
   through the pullback's own graph, recorded once (``create_graph``).
   This is the double-backward form of the JAX module's ``jax.jvp``: the
   same values (to rounding) at about a fifth of the cost of PyTorch's
   forward mode (``torch.func.jvp``), whose product of a dual tensor with
   a plain one (every constant of the dynamics) takes a slow path.
 - ``receding_horizon``: optimize, apply the first control to the plant
   for one control step, re-optimize warm-started by shifting.

Scenario batching is native: states with leading batch axes give one
problem per scenario. Every scalar of Gauss-Newton (cost, |g|², the
curvature, the damping, CG's alpha, beta and residual, the accept test) is
per scenario, and its dot products reduce over the controls' own axes, so
the scenarios never couple; the JAX functions are unbatched and vmapped.

Deviations from the JAX module, kept on purpose:
 - the square root of the quadrature weights w·J is clamped at 0 (the JAX
   residual takes it unclamped, which gives NaN on a weight of -1e-17
   roundoff);
 - the receding-horizon plant problem is ``dataclasses.replace(prob,
   horizon=1)``: it keeps the problem's ``rhs_fn`` and ``dense_ops``, where
   the JAX module rebuilds a one-step problem without them (and so
   advances a custom-dynamics plant by the built-in RHS).
The clock restarts at t = 0 in every receding-horizon cycle, for the solve
and for the plant step, as in the JAX module (a tidal boundary sees the
same phase in every cycle).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..ops.sw2d import SWState
from .problem import MPCProblem, mpc_cost, rollout_controls


class MPCSolution(NamedTuple):
    controls: torch.Tensor  # (horizon, n_controls)
    cost: torch.Tensor
    cost_history: torch.Tensor  # (iters,)
    grad_norm: torch.Tensor | None = None  # ||grad cost|| at the solution


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def adam_init(params: torch.Tensor) -> AdamState:
    return AdamState(0, torch.zeros_like(params), torch.zeros_like(params))


def adam_update(grad: torch.Tensor, state: AdamState, params: torch.Tensor,
                learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[torch.Tensor, AdamState]:
    """One Adam step; returns (new params, new state)."""
    count = state.count + 1
    mu = b1 * state.mu + (1.0 - b1) * grad
    nu = b2 * state.nu + (1.0 - b2) * grad * grad
    mu_hat = mu / (1.0 - b1 ** count)
    nu_hat = nu / (1.0 - b2 ** count)
    new = params - learning_rate * mu_hat / (torch.sqrt(nu_hat) + eps)
    return new, AdamState(count, mu, nu)


def adam_minimize(total: Callable, init: torch.Tensor, iters: int,
                  learning_rate: float, final_cost: bool = True):
    """Fixed-iteration Adam over ``total(c) -> per-scenario costs``; the sum
    of the costs is differentiated. Returns (controls, final costs, history
    stacked over iterations); without ``final_cost`` the costs at the
    returned controls are not evaluated and None stands in their place."""
    c = init.detach().clone()
    opt_state = adam_init(c)
    history = []
    for _ in range(iters):
        c.requires_grad_(True)
        costs = total(c)
        (grad,) = torch.autograd.grad(costs.sum(), c)
        history.append(costs.detach())
        c, opt_state = adam_update(grad, opt_state, c.detach(), learning_rate)
    final = None
    if final_cost:
        with torch.no_grad():
            final = total(c)
    return c, final, torch.stack(history, dim=0)


def solve_mpc(
    prob: MPCProblem,
    state0: SWState,
    target_eta: torch.Tensor,
    control_to_forcing: Callable,
    n_controls: int,
    *,
    iters: int = 50,
    learning_rate: float = 0.1,
    init_controls: torch.Tensor | None = None,
    H_rest=10.0,
) -> MPCSolution:
    """Solve shooting problems with Adam over the control sequence.

    Unbatched ``state0`` fields (K, Np) give controls (horizon, n_controls);
    with leading batch axes every scenario is solved independently (the
    sum of per-scenario costs is differentiated, so gradients do not mix).
    """
    h = state0.h
    lead = h.shape[:-2]
    if init_controls is None:
        init_controls = torch.zeros((*lead, prob.horizon, n_controls),
                                    dtype=h.dtype, device=h.device)

    loss = lambda c: mpc_cost(prob, state0, c, target_eta, control_to_forcing,
                              H_rest)
    controls, cost, history = adam_minimize(loss, init_controls, iters,
                                            learning_rate)
    return MPCSolution(controls=controls, cost=cost, cost_history=history)


def _mpc_residuals(
    prob: MPCProblem,
    state0: SWState,
    controls: torch.Tensor,
    target_eta: torch.Tensor,
    control_to_forcing: Callable,
    H_rest,
) -> torch.Tensor:
    """Stacked least-squares residual R(c), (..., n_res), with cost ==
    sum(R**2) over the last axis: the quadratic tracking cost of
    ``mpc_cost`` as a nonlinear least-squares problem (sqrt-weighted running
    elevation errors per control step, the terminal error, the control
    effort), in the JAX module's order for each scenario."""
    ctx = prob.ctx
    M = ctx.Vinv.T @ ctx.Vinv
    w = M @ torch.ones((ctx.n_p,), dtype=ctx.J.dtype, device=ctx.J.device)
    sw = torch.sqrt(torch.clamp_min(w[None, :] * ctx.J, 0.0))  # (K, Np)

    lead = controls.shape[:-2]
    final, traj = rollout_controls(prob, state0, controls, control_to_forcing)
    traj_h = traj.h.movedim(0, -3)  # (..., horizon, K, Np)
    run = (prob.q_eta / prob.horizon) ** 0.5 * (
        sw * ((traj_h - H_rest) - target_eta.unsqueeze(-3)))
    term = prob.q_terminal ** 0.5 * (sw * ((final.h - H_rest) - target_eta))
    eff = prob.r_control ** 0.5 * controls
    return torch.cat([run.reshape(*lead, -1), term.reshape(*lead, -1),
                      eff.reshape(*lead, -1)], dim=-1)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-scenario dot product of two control-shaped tensors
    (..., horizon, n_controls): a sum over the last two axes only."""
    return torch.sum(a * b, dim=(-2, -1))


def solve_mpc_gn(
    prob: MPCProblem,
    state0: SWState,
    target_eta: torch.Tensor,
    control_to_forcing: Callable,
    n_controls: int,
    *,
    gn_iters: int = 5,
    cg_iters: int = 8,
    lm_lambda0: float = 1e-2,
    init_controls: torch.Tensor | None = None,
    H_rest=10.0,
) -> MPCSolution:
    """Gauss-Newton/Levenberg-Marquardt shooting solve.

    Each outer iteration: R, its pullback and J v at c (see the module
    docstring), g = JᵀR; λ relative to the curvature along g (the Rayleigh
    quotient |Jg|²/|g|², so an absolute λ does not swamp small-scale
    problems); ``cg_iters`` steps of CG on (JᵀJ + λI) δ = -g, each one
    product J v and one pullback; then accept c + δ if it lowers the cost
    (λ × 0.4) or keep c (λ × 4). ``cost_history`` holds the cost after each
    outer iteration (the accepted one, or the kept one); ``grad_norm`` is
    |∇cost| = 2|JᵀR| at the solution. With leading batch axes on the state
    every scenario is solved on its own (per-scenario λ and accept).
    """
    h = state0.h
    lead = h.shape[:-2]
    if init_controls is None:
        init_controls = torch.zeros((*lead, prob.horizon, n_controls),
                                    dtype=h.dtype, device=h.device)

    def R(c):
        return _mpc_residuals(prob, state0, c, target_eta, control_to_forcing,
                              H_rest)

    def cost_of(c):
        with torch.no_grad():
            r = R(c)
        return torch.sum(r * r, dim=-1)

    def col(s):  # a per-scenario scalar against control-shaped tensors
        return s[..., None, None]

    def linearize(c):
        """R(c), u -> Jᵀu and v -> J v at c."""
        c = c.detach().requires_grad_(True)
        r = R(c)
        u = torch.zeros_like(r, requires_grad=True)
        jtu = torch.autograd.grad(r, c, u, create_graph=True)[0]

        def pullback(w):
            return torch.autograd.grad(r, c, w, retain_graph=True)[0]

        def jv(v):
            return torch.autograd.grad(jtu, u, v, retain_graph=True)[0]

        return r.detach(), pullback, jv

    c = init_controls.detach().clone()
    lam = torch.full(lead, lm_lambda0, dtype=h.dtype, device=h.device)
    history = []
    for _ in range(gn_iters):
        r, pullback, jv = linearize(c)
        cost = torch.sum(r * r, dim=-1)
        g = pullback(r)  # JᵀR = ∇cost/2

        gn2 = _vdot(g, g)
        Jg = jv(g)
        curv = torch.sum(Jg * Jg, dim=-1) / torch.where(
            gn2 > 0, gn2, torch.ones_like(gn2))
        lam_eff = lam * torch.where(curv > 0, curv, torch.ones_like(curv))

        # fixed-iteration CG on the damped normal equations
        b = -g
        x = torch.zeros_like(b)
        rr, p = b, b
        rs = _vdot(rr, rr)
        for _ in range(cg_iters):
            Ap = pullback(jv(p)) + col(lam_eff) * p
            denom = _vdot(p, Ap)
            ok = denom > 0
            alpha = torch.where(ok, rs / torch.where(ok, denom,
                                                     torch.ones_like(denom)),
                                torch.zeros_like(denom))
            x = x + col(alpha) * p
            rr = rr - col(alpha) * Ap
            rs_new = _vdot(rr, rr)
            beta = torch.where(ok, rs_new / torch.where(rs > 0, rs,
                                                        torch.ones_like(rs)),
                               torch.zeros_like(rs))
            p = rr + col(beta) * p
            rs = rs_new
        del pullback, jv

        new_cost = cost_of(c + x)
        accept = new_cost < cost
        c = torch.where(col(accept), c + x, c)
        lam = torch.where(accept, lam * 0.4, lam * 4.0)
        history.append(torch.where(accept, new_cost, cost))

    c_req = c.detach().requires_grad_(True)
    r_fin = R(c_req)
    grad = torch.autograd.grad(r_fin, c_req, r_fin.detach())[0]
    r_fin = r_fin.detach()
    hist = (torch.stack(history, dim=0) if history
            else torch.zeros((0, *lead), dtype=h.dtype, device=h.device))
    return MPCSolution(controls=c.detach(),
                       cost=torch.sum(r_fin * r_fin, dim=-1),
                       cost_history=hist,
                       grad_norm=2.0 * torch.sqrt(_vdot(grad, grad)))


def receding_horizon(
    prob: MPCProblem,
    state0: SWState,
    target_eta: torch.Tensor,
    control_to_forcing: Callable,
    n_controls: int,
    *,
    n_cycles: int,
    iters: int = 30,
    learning_rate: float = 0.1,
    H_rest=10.0,
):
    """Receding-horizon MPC: optimize (Adam, ``solve_mpc``), apply the first
    control to the plant for one control step, re-optimize warm-started by
    the shifted sequence (its last control repeated).

    Returns (final plant state, applied controls (..., n_cycles,
    n_controls), per-cycle costs (..., n_cycles)); leading batch axes of
    the state are scenarios, laid out as the JAX function's under vmap.
    """
    h = state0.h
    lead = h.shape[:-2]
    plant = dataclasses.replace(prob, horizon=1)
    state = state0
    warm = torch.zeros((*lead, prob.horizon, n_controls), dtype=h.dtype,
                       device=h.device)
    applied, costs = [], []
    for _ in range(n_cycles):
        sol = solve_mpc(prob, state, target_eta, control_to_forcing,
                        n_controls, iters=iters, learning_rate=learning_rate,
                        init_controls=warm, H_rest=H_rest)
        with torch.no_grad():
            state, _ = rollout_controls(plant, state,
                                        sol.controls[..., :1, :],
                                        control_to_forcing)
        warm = torch.cat([sol.controls[..., 1:, :], sol.controls[..., -1:, :]],
                         dim=-2)
        applied.append(sol.controls[..., 0, :])
        costs.append(sol.cost)
    return state, torch.stack(applied, dim=-2), torch.stack(costs, dim=-1)
