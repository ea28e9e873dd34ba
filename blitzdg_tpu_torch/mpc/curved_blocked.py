"""Batched shooting MPC over the CURVED weak-form dynamics through the curved
kernels (``ops/sw2d_curved_blocked.py``).

Counterpart of the JAX package's ``blitzdg_tpu/mpc/curved_blocked.py``
(``CurvedBlockedMPC``, ``build_curved_blocked_mpc``,
``mpc_cost_curved_blocked``, ``solve_mpc_curved_blocked``,
``solve_mpc_curved_blocked_gn``). Same optimization problem as
``mpc/blocked.py`` but with the four-field tracer state, over-integrated
volume and face terms and per-element (possibly curved) mass inverses in
the kernels; the adjoint is the hand-derived backward rollout. The same
problem through plain tensor code is ``solve_mpc`` with
``MPCProblem.rhs_fn = sw2d_curved_rhs``.

Cost, Adam, conjugate gradients and the Levenberg-Marquardt loop are plain
tensor code around the two rollout kernels. ``advance_plant_curved_blocked``
is the closed-loop half: it moves the plant one control interval with the
step kernel.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.sw2d_curved import SWStateTracer
from ..ops.sw2d_curved_blocked import (CurvedBlockedMeta, CurvedBlockedOps,
                                       build_curved_blocked_ops,
                                       make_curved_rollout_blocked,
                                       sw2d_curved_step_blocked)
from .blocked import _adam_solve, _flat, _gn_lm_fd, _init_controls
from .problem import MPCProblem, quadrature_row
from .solver import MPCSolution


class CurvedBlockedMPC(NamedTuple):
    rollout: Callable
    ops: CurvedBlockedOps
    meta: CurvedBlockedMeta
    wj: torch.Tensor  # (nV,) mass-weighted quadrature row


def build_curved_blocked_mpc(
    prob: MPCProblem,
    cub,
    gauss,
    forcing_bu: np.ndarray,  # (n_ctrl, K, Np) linear hu-forcing injector
    forcing_bv: np.ndarray,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> CurvedBlockedMPC:
    """Freeze the curved operator set on ``device`` and wrap the
    differentiable rollout."""
    ctx = prob.ctx
    ops, meta = build_curved_blocked_ops(
        ctx, cub, gauss, prob.phys, forcing_bu=forcing_bu,
        forcing_bv=forcing_bv, dtype=dtype, use_filter=prob.use_filter,
        device=device)
    rollout = make_curved_rollout_blocked(
        ops, meta, prob.dt, prob.steps_per_control,
        use_filter=prob.use_filter)
    return CurvedBlockedMPC(rollout=rollout, ops=ops, meta=meta,
                            wj=quadrature_row(ctx, dtype, device))


def _tracking_error(prob, bm, states0, controls, targets, H_rest):
    """Elevation error (B, horizon, nV) after each control block. Only the
    depth trajectory is read: the other three get no cotangent."""
    spc = prob.steps_per_control
    th, _, _, _ = bm.rollout(*(_flat(f) for f in states0),
                             controls.contiguous())
    sel = th[:, spc::spc]  # step indices (j+1)*spc, j = 0..H-1
    return (sel - H_rest) - _flat(targets)[:, None, :]


def mpc_cost_curved_blocked(
    prob: MPCProblem,
    bm: CurvedBlockedMPC,
    states0: SWStateTracer,  # (B, K, Np) fields
    controls: torch.Tensor,  # (B, horizon, n_ctrl)
    targets: torch.Tensor,  # (B, K, Np) target eta
    H_rest: float = 1.0,
) -> torch.Tensor:
    """Per-scenario quadratic tracking cost (B,)."""
    err = _tracking_error(prob, bm, states0, controls, targets, H_rest)
    per_step = torch.sum(bm.wj * err * err, dim=-1)  # (B, H)
    running = torch.sum(per_step, dim=-1) / prob.horizon
    terminal = per_step[:, -1]
    effort = torch.sum(controls * controls, dim=(-2, -1))
    return (prob.q_eta * running + prob.q_terminal * terminal
            + prob.r_control * effort)


def _residuals_curved_blocked(prob, bm, states0, targets, H_rest):
    """Per-scenario stacked least-squares residuals R(c) (B, n_res) with
    sum(R**2, dim=1) == mpc_cost_curved_blocked."""
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


def solve_mpc_curved_blocked_gn(
    prob: MPCProblem,
    bm: CurvedBlockedMPC,
    states0: SWStateTracer,
    targets: torch.Tensor,
    n_controls: int,
    *,
    gn_iters: int = 3,
    cg_iters: int = 4,
    lm_lambda0: float = 1e-2,
    init_controls: torch.Tensor | None = None,
    H_rest: float = 1.0,
    fd_eps: float = 1e-3,
) -> MPCSolution:
    """Gauss-Newton/Levenberg-Marquardt on the curved rollout: the loop of
    ``blocked.solve_mpc_blocked_gn`` (forward-difference Jv through the
    rollout kernel, exact J^T through the adjoint kernel) on the four-field
    curved dynamics."""
    c0 = _init_controls(prob, bm, states0, n_controls, init_controls)
    R = _residuals_curved_blocked(prob, bm, states0, targets, H_rest)
    return _gn_lm_fd(R, c0, gn_iters=gn_iters, cg_iters=cg_iters,
                     lm_lambda0=lm_lambda0, fd_eps=fd_eps)


def solve_mpc_curved_blocked(
    prob: MPCProblem,
    bm: CurvedBlockedMPC,
    states0: SWStateTracer,  # (B, K, Np) fields
    targets: torch.Tensor,  # (B, K, Np)
    n_controls: int,
    *,
    iters: int = 50,
    learning_rate: float = 0.1,
    init_controls: torch.Tensor | None = None,  # (B, horizon, n_controls)
    H_rest: float = 1.0,
) -> MPCSolution:
    """Batched Adam shooting solve on the curved rollout; reports the cost
    and the true gradient norm per scenario at the returned controls (one
    extra value and gradient)."""
    c0 = _init_controls(prob, bm, states0, n_controls, init_controls)
    total = lambda c: mpc_cost_curved_blocked(prob, bm, states0, c, targets,
                                              H_rest)
    return _adam_solve(total, c0, iters, learning_rate)


def advance_plant_curved_blocked(
    prob: MPCProblem,
    bm: CurvedBlockedMPC,
    states: SWStateTracer,  # (B, K, Np) fields
    control: torch.Tensor,  # (B, n_ctrl): the control to apply
) -> SWStateTracer:
    """Apply one control for one control interval: ``steps_per_control``
    curved SSP-RK2 steps, one kernel launch each (the closed-loop half of
    MPC, as ``advance_plant_blocked`` on the blocked path)."""
    shape = states.h.shape
    S = tuple(_flat(f) for f in states)
    control = control.contiguous()
    for _ in range(prob.steps_per_control):
        S = sw2d_curved_step_blocked(bm.ops, bm.meta, *S, control, prob.dt,
                                     prob.use_filter)
    return SWStateTracer(*(f.reshape(shape) for f in S))
