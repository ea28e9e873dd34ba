"""Explicit time integrators.

Counterpart of the JAX package's ``blitzdg_tpu/timestepping.py``; only
SSP-RK2 with ``post_stage`` is ported so far. A state is any tuple (or
NamedTuple) of tensors; a step is plain eager tensor code, differentiable
by ``torch.autograd``.
"""
from __future__ import annotations

from typing import Callable, TypeVar

State = TypeVar("State")


def _map(fn: Callable, *states):
    """Apply ``fn`` field by field, keeping the (named) tuple type."""
    first = states[0]
    out = [fn(*fields) for fields in zip(*states)]
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


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
