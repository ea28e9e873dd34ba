"""MPC problem definition: controlled DG rollouts + quadratic costs.

Counterpart of the JAX package's ``blitzdg_tpu/mpc/problem.py``: batched
shooting MPC whose dynamics model is the nodal-DG shallow-water
discretization.

 - controls are a (horizon, n_controls) sequence entering the dynamics
   through a user-supplied ``control_to_forcing`` map;
 - a rollout is a Python loop over the horizon (fixed dt, so the step count
   is static); gradients come from ``torch.autograd``;
 - scenario batching is native: states may carry leading batch axes
   (``(B, K, Np)`` with controls ``(B, horizon, n_controls)``), where the
   JAX package vmaps an unbatched function.

``rhs_fn`` replaces the built-in dynamics, e.g. by the curved weak-form RHS
(``ops.sw2d_curved.sw2d_curved_rhs`` closed over its cubature and Gauss
contexts); the state may then carry further fields (the tracer ``hN``): the
cost reads ``state.h`` only and the control forcing enters h, hu, hv. The JAX
problem's ``remat`` flag (an XLA memory trade) has no meaning here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..context import DGContext2D
from ..ops.sw2d import SWPhysics, SWState, apply_filter, sw2d_rhs
from ..ops.sw2d_dense import DenseTraceOps, sw2d_rhs_dense
from ..timestepping import ssprk2_step


@dataclass(frozen=True)
class MPCProblem:
    """Shooting MPC over the shallow-water dynamics."""

    ctx: DGContext2D
    phys: SWPhysics
    dt: float
    horizon: int  # control steps
    steps_per_control: int = 1
    # weights
    q_eta: float = 1.0
    q_terminal: float = 10.0
    r_control: float = 1e-3
    use_filter: bool = True
    # dense-trace path: trace extraction as matrix products instead of
    # gathers; build with `build_dense_trace_ops`
    dense_ops: DenseTraceOps | None = None
    # custom dynamics: rhs_fn(state, t) -> RHS of the state's own type
    rhs_fn: Callable | None = None


def quadrature_row(ctx: DGContext2D, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """The mass-weighted quadrature weights of every node, flat (K*Np,): the
    row sums of the mass matrix times the Jacobian, formed in float64 on the
    host. The kernel paths' costs sum ``row * err**2``."""
    Vinv = ctx.Vinv.double().cpu()
    w = (Vinv.T @ Vinv) @ torch.ones((ctx.n_p,), dtype=torch.float64)
    wj = (w[None, :] * ctx.J.double().cpu()).reshape(-1)
    return wj.to(device=device, dtype=dtype)


def _controlled_rhs(prob: MPCProblem, control: torch.Tensor,
                    control_to_forcing: Callable):
    """RHS with the control injected as a momentum/elevation forcing."""

    def rhs(state: SWState, t):
        if prob.rhs_fn is not None:
            base = prob.rhs_fn(state, t)
        elif prob.dense_ops is not None:
            base = sw2d_rhs_dense(prob.ctx, prob.dense_ops, state, t, prob.phys)
        else:
            base = sw2d_rhs(prob.ctx, state, t, prob.phys)
        fh, fhu, fhv = control_to_forcing(prob.ctx, control, state, t)
        return base._replace(h=base.h + fh, hu=base.hu + fhu,
                             hv=base.hv + fhv)

    return rhs


def rollout_controls(
    prob: MPCProblem,
    state0: SWState,
    controls: torch.Tensor,  # (..., horizon, n_controls)
    control_to_forcing: Callable,
) -> tuple[SWState, SWState]:
    """Roll the dynamics over the horizon; returns (final state, trajectory
    of per-control-step states stacked on a leading axis)."""
    post = (lambda f: apply_filter(prob.ctx, f)) if prob.use_filter else None
    state, t = state0, 0.0
    traj = []
    for j in range(prob.horizon):
        rhs = _controlled_rhs(prob, controls[..., j, :], control_to_forcing)
        for _ in range(prob.steps_per_control):
            state = ssprk2_step(rhs, state, t, prob.dt, post_stage=post)
            t = t + prob.dt
        traj.append(state)
    stacked = type(state0)(*(torch.stack(f, dim=0) for f in zip(*traj)))
    return state, stacked


def mpc_cost(
    prob: MPCProblem,
    state0: SWState,
    controls: torch.Tensor,
    target_eta: torch.Tensor,  # (..., K, Np) desired surface elevation
    control_to_forcing: Callable,
    H_rest: torch.Tensor | float = 10.0,
) -> torch.Tensor:
    """Quadratic tracking cost: running + terminal elevation error in the
    mass-weighted norm, plus control effort. Scalar for an unbatched state,
    one cost per scenario for a batched one."""
    ctx = prob.ctx
    M = ctx.Vinv.T @ ctx.Vinv
    w = M @ torch.ones((ctx.n_p,), dtype=ctx.J.dtype, device=ctx.J.device)
    wj = w[None, :] * ctx.J  # row sums = quadrature weights

    def eta_err_sq(h):
        err = (h - H_rest) - target_eta
        return torch.sum(wj * err * err, dim=(-2, -1))

    final, traj = rollout_controls(prob, state0, controls, control_to_forcing)
    running = torch.sum(eta_err_sq(traj.h), dim=0) / prob.horizon
    terminal = eta_err_sq(final.h)
    effort = torch.sum(controls * controls, dim=(-2, -1))
    return prob.q_eta * running + prob.q_terminal * terminal + prob.r_control * effort
