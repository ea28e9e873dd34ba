"""Explicit time integrators.

Counterpart of the JAX package's ``blitzdg_tpu/timestepping.py``: LSERK4
(Carpenter-Kennedy 4th-order 5-stage low-storage RK) and SSP-RK2 steps, and
the fixed-step rollouts ``integrate`` / ``integrate_trajectory``, whose
``lax.scan`` is a Python loop here that returns what the scan returns. A
state is a tensor or any tuple (or NamedTuple) of tensors; a step is plain
eager tensor code, differentiable by ``torch.autograd``.
"""
from __future__ import annotations

from typing import Callable, TypeVar

import torch

State = TypeVar("State")

# Carpenter-Kennedy 4th-order 5-stage low-storage RK coefficients (the
# published constants, as in the JAX package).
LSERK4_A = (
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0,
)
LSERK4_B = (
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0,
)
LSERK4_C = (
    0.0,
    1432997174477.0 / 9575080441755.0,
    2526269341429.0 / 6820363962896.0,
    2006345519317.0 / 3224310063776.0,
    2802321613138.0 / 2924317926251.0,
)


def _map(fn: Callable, *states):
    """Apply ``fn`` field by field, keeping the (named) tuple type; a bare
    tensor is a state of one field."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return fn(*states)
    out = [fn(*fields) for fields in zip(*states)]
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


def lserk4_step(rhs: Callable, u: State, t, dt) -> State:
    """One LSERK4 step of du/dt = rhs(u, t) over a tensor or tuple state."""
    res = _map(torch.zeros_like, u)
    for a, b, c in zip(LSERK4_A, LSERK4_B, LSERK4_C):
        k = rhs(u, t + c * dt)
        res = _map(lambda r, kk: a * r + dt * kk, res, k)
        u = _map(lambda uu, r: uu + b * r, u, res)
    return u


def ssprk2_step(rhs: Callable, u: State, t, dt,
                post_stage: Callable | None = None) -> State:
    """SSP-RK2 (Heun-type predictor-corrector):

        u1 = u + (dt/2) R(u);   u <- u + dt R(u1)

    ``post_stage`` (e.g. a modal filter) is applied to each RHS before use.
    """
    def eval_rhs(v, tt):
        k = rhs(v, tt)
        return _map(post_stage, k) if post_stage is not None else k

    k1 = eval_rhs(u, t)
    u1 = _map(lambda uu, kk: uu + 0.5 * dt * kk, u, k1)
    k2 = eval_rhs(u1, t + 0.5 * dt)
    return _map(lambda uu, kk: uu + dt * kk, u, k2)


def integrate(step: Callable, rhs: Callable, u0: State, t0, dt,
              num_steps: int) -> State:
    """Fixed-step rollout: ``num_steps`` steps of ``step(rhs, u, t, dt)``
    from ``(u0, t0)``, t advanced by dt each step. Returns the final
    state."""
    u, t = u0, t0
    for _ in range(num_steps):
        u = step(rhs, u, t, dt)
        t = t + dt
    return u


def integrate_trajectory(step: Callable, rhs: Callable, u0: State, t0, dt,
                         num_steps: int):
    """Rollout that also stacks the state after every step: returns
    (final state, trajectory), the trajectory's fields each with a leading
    axis of ``num_steps`` (as the JAX scan stacks them; empty for none)."""
    u, t, traj = u0, t0, []
    for _ in range(num_steps):
        u = step(rhs, u, t, dt)
        t = t + dt
        traj.append(u)
    if not traj:
        return u, _map(lambda f: f.new_empty((0, *f.shape)), u0)
    return u, _map(lambda *fs: torch.stack(fs), *traj)
