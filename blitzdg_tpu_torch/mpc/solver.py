"""MPC solvers over control sequences.

Counterpart of the JAX package's ``blitzdg_tpu/mpc/solver.py``; only the
fixed-iteration Adam solver is ported so far (not ``solve_mpc_gn``, not the
receding-horizon loop; the blocked path's Gauss-Newton solver is in
``mpc/blocked.py``). The Adam update is written out with the defaults
the JAX package gets from its optimizer library: b1 = 0.9, b2 = 0.999,
eps = 1e-8 added to sqrt(v_hat), bias correction on both moments.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.sw2d import SWState
from .problem import MPCProblem, mpc_cost


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
