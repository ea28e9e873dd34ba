"""Kernel-accelerated MPC: shooting optimization over the fused rollout.

Counterpart of the JAX package's ``blitzdg_tpu/mpc/pallas.py``
(``build_pallas_mpc`` -> ``build_fused_mpc``, ``mpc_cost_pallas`` ->
``mpc_cost_fused``, ``solve_mpc_pallas`` -> ``solve_mpc_fused``,
``PallasMPC`` -> ``FusedMPC``). Same optimization problem as
``mpc_cost``/``solve_mpc`` (problem.py/solver.py), but the entire forward
rollout AND its adjoint are single kernel launches (``ops/sw2d_fused.py``).

Scope: what the kernels cover, i.e. full coastal physics (wall and tidal
BC_OUT boundaries, well-balanced bathymetry, drag, Coriolis) with a control
forcing linear in the controls (rhs_hu += c @ BU, rhs_hv += c @ BV).
Scenario batching is native: one block per scenario.

The cost and the Adam update are plain tensor code, as they are plain XLA
code around the kernels in the JAX package. One solve is a Python loop of
``iters`` iterations: forward kernel, cost, ``backward()`` (the adjoint
kernel), Adam update; then one more forward for the final cost.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.sw2d import SWState
from ..ops.sw2d_fused import (FusedStepMeta, FusedStepOps,
                              build_fused_step_ops, make_rollout,
                              sw2d_step_fused)
from .problem import MPCProblem, quadrature_row
from .solver import MPCSolution, adam_minimize


class FusedMPC(NamedTuple):
    rollout: Callable
    ops: FusedStepOps
    meta: FusedStepMeta
    wj: torch.Tensor  # (nV,) mass-weighted quadrature row


def build_fused_mpc(
    prob: MPCProblem,
    forcing_bu: np.ndarray,  # (n_ctrl, K, Np) linear hu-forcing injector
    forcing_bv: np.ndarray,
    tidal: tuple | None = None,  # (h0, amp, omega, ramp_tau) BC_OUT forcing
    dtype: torch.dtype = torch.float32,
    device="cuda",
    forward=None,
    backward=None,
) -> FusedMPC:
    """Freeze the operator set on ``device`` and wrap the differentiable
    rollout. ``forward``/``backward`` are passed on to ``make_rollout``."""
    ctx = prob.ctx
    ops, meta = build_fused_step_ops(ctx, prob.phys, forcing_bu, forcing_bv,
                                     dtype=dtype, tidal=tidal, device=device)
    rollout = make_rollout(ops, meta, prob.dt, prob.steps_per_control,
                           use_filter=prob.use_filter, forward=forward,
                           backward=backward)
    return FusedMPC(rollout=rollout, ops=ops, meta=meta,
                    wj=quadrature_row(ctx, dtype, device))


def mpc_cost_fused(
    prob: MPCProblem,
    fm: FusedMPC,
    states0: SWState,  # (B, K, Np) fields
    controls: torch.Tensor,  # (B, horizon, n_ctrl)
    targets: torch.Tensor,  # (B, K, Np)
    H_rest: float | torch.Tensor = 10.0,
) -> torch.Tensor:
    """Per-scenario quadratic tracking cost (B,): the fused analog of
    problem.mpc_cost, batched natively. ``H_rest``: scalar rest depth, or a
    (K, Np) still-water depth field for coastal problems where rest is
    h = H(x, y)."""
    spc, B = prob.steps_per_control, states0.h.shape[0]
    flat = lambda f: f.reshape(B, -1).contiguous()
    th, _, _ = fm.rollout(flat(states0.h), flat(states0.hu), flat(states0.hv),
                          controls.contiguous())
    # states after each control block: step indices (j+1)*spc, j=0..H-1
    sel = th[:, spc::spc]  # (B, H, nV)
    rest = (H_rest.reshape(-1) if isinstance(H_rest, torch.Tensor)
            else H_rest)
    err = (sel - rest) - flat(targets)[:, None, :]
    per_step = torch.sum(fm.wj * err * err, dim=-1)  # (B, H)
    running = torch.sum(per_step, dim=-1) / prob.horizon
    terminal = per_step[:, -1]
    effort = torch.sum(controls * controls, dim=(-2, -1))
    return prob.q_eta * running + prob.q_terminal * terminal + prob.r_control * effort


def solve_mpc_fused(
    prob: MPCProblem,
    fm: FusedMPC,
    states0: SWState,  # (B, K, Np) fields
    targets: torch.Tensor,  # (B, K, Np)
    n_controls: int,
    *,
    iters: int = 50,
    learning_rate: float = 0.1,
    init_controls: torch.Tensor | None = None,  # (B, horizon, n_controls)
    H_rest: float | torch.Tensor = 10.0,
) -> MPCSolution:
    """Batched Adam shooting solve on the fused rollout.

    Returns an MPCSolution with leading batch axes: controls
    (B, horizon, n_controls), cost (B,), cost_history (iters, B).
    """
    if n_controls != fm.meta.n_ctrl:
        raise ValueError(f"n_controls={n_controls}, but the operator set has "
                         f"{fm.meta.n_ctrl} control injectors")
    h = states0.h
    if init_controls is None:
        init_controls = torch.zeros((h.shape[0], prob.horizon, n_controls),
                                    dtype=h.dtype, device=h.device)
    total = lambda c: mpc_cost_fused(prob, fm, states0, c, targets, H_rest)
    controls, cost, history = adam_minimize(total, init_controls, iters,
                                            learning_rate)
    return MPCSolution(controls=controls, cost=cost, cost_history=history)


def advance_plant_fused(
    prob: MPCProblem,
    fm: FusedMPC,
    states: SWState,  # (B, K, Np) fields
    control: torch.Tensor,  # (B, n_ctrl): the control to apply
    t0: float = 0.0,
) -> SWState:
    """Apply one control for one control interval: ``steps_per_control``
    fused SSP-RK2 steps, one kernel launch each. This is the closed-loop
    half of MPC: after a solve, the first control of the optimized sequence
    moves the plant to the next control step."""
    shape, B = states.h.shape, states.h.shape[0]
    h, hu, hv = (f.reshape(B, -1).contiguous() for f in states)
    control = control.contiguous()
    for i in range(prob.steps_per_control):
        h, hu, hv = sw2d_step_fused(fm.ops, fm.meta, h, hu, hv, control,
                                    prob.dt, prob.use_filter, t0 + i * prob.dt)
    return SWState(h.reshape(shape), hu.reshape(shape), hv.reshape(shape))
