"""The plain reference of the benchmark's MPC cells.

Each configuration's dynamics, cost, optimizer and plant step, written as
plain PyTorch over the frozen host builders and right-hand sides of
``reference/dg`` and computed in whatever dtype the model is built in
(float64 for the check; the control builds it in float32 and runs its
products in TF32). It imports nothing of the measured package and takes
nothing that package made: mesh, nodes, operators, cubature, time step,
bathymetry and injectors are all formed here from the configuration file.

A model is built on the host (``build_model``) and moved whole with
``Model.to(device, dtype)``. States are tuples of (B, K, Np) fields;
controls are (B, horizon, n_ctrl).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Callable

import torch



def _tree(obj, fn):
    """``fn`` on every floating tensor of a nested dataclass/dict/tuple."""
    if isinstance(obj, torch.Tensor):
        return fn(obj) if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _tree(getattr(obj, f.name), fn)
                    for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _tree(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_tree(v, fn) for v in obj))
    if isinstance(obj, tuple):
        return tuple(_tree(v, fn) for v in obj)
    return obj


def _moved(obj, device, dtype):
    """Floating tensors cast to ``dtype``, every tensor moved to ``device``."""
    def fn(t):
        return t.to(device=device, dtype=dtype)
    out = _tree(obj, fn)

    def idx(o):
        if isinstance(o, torch.Tensor) and not o.is_floating_point():
            return o.to(device)
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return dataclasses.replace(
                o, **{f.name: idx(getattr(o, f.name))
                      for f in dataclasses.fields(o)})
        if isinstance(o, dict):
            return {k: idx(v) for k, v in o.items()}
        if isinstance(o, tuple) and hasattr(o, "_fields"):
            return type(o)(*(idx(v) for v in o))
        return o
    return idx(out)


@dataclasses.dataclass
class Model:
    """One configuration's MPC problem, reference side."""

    fields: tuple  # state field names
    x: torch.Tensor  # (K, Np) node coordinates
    y: torch.Tensor
    rest: tuple  # (K, Np) rest value of each field
    H_rest: torch.Tensor  # (K, Np) still-water depth the cost measures from
    wj: torch.Tensor  # (K, Np) quadrature weights (mass row sums x J)
    bump: torch.Tensor  # (K, Np) the control injector's shape
    dt: float
    parts: dict  # contexts and physics the RHS reads
    rhs: Callable  # rhs(parts, state, t) -> state-shaped tuple, unfiltered
    filt: Callable  # filt(parts, f) -> f filtered
    q_eta: float
    q_terminal: float
    r_control: float

    def to(self, device, dtype) -> "Model":
        return dataclasses.replace(
            self, x=self.x.to(device, dtype), y=self.y.to(device, dtype),
            rest=tuple(r.to(device, dtype) for r in self.rest),
            H_rest=self.H_rest.to(device, dtype),
            wj=self.wj.to(device, dtype), bump=self.bump.to(device, dtype),
            parts=_moved(self.parts, device, dtype))


def cfl_dt(ctx, g: float, h_max: float, cfl: float) -> float:
    """dt from the CFL number at a rest state of depth h_max (float64
    context)."""
    c = math.sqrt(g * h_max)
    fs = float(ctx.fscale.abs().max())
    return cfl / (((ctx.n_order + 1) ** 2) * 0.5 * fs * c)


def quadrature_weights(ctx) -> torch.Tensor:
    """Row sums of the nodal mass matrix times the Jacobian, (K, Np)."""
    Vinv = ctx.Vinv.double()
    w = (Vinv.T @ Vinv) @ torch.ones((ctx.n_p,), dtype=torch.float64)
    return w[None, :] * ctx.J.double()


def build_model(cfg: dict) -> Model:
    """The configuration's model in float64 on the host: the ``build`` of
    ``reference/<cfg["reference"]>.py``."""
    name = cfg["reference"]
    if not name.isidentifier():
        raise ValueError(f"not a reference model: {name!r}")
    return importlib.import_module(f".{name}", __package__).build(cfg)


# ---------------------------------------------------------------------------
# Dynamics, cost, plant
# ---------------------------------------------------------------------------

def _forced_rhs(m: Model, state, t, ctrl):
    """Filtered RHS with the control injected into the two momenta:
    hu += c0 * bump, hv += c1 * bump."""
    r = list(m.rhs(m.parts, state, t))
    r[1] = r[1] + ctrl[:, 0, None, None] * m.bump
    r[2] = r[2] + ctrl[:, 1, None, None] * m.bump
    return tuple(m.filt(m.parts, f) for f in r)


def ssprk2(m: Model, state, t: float, ctrl):
    """u1 = u + dt/2 R(u, t);  u <- u + dt R(u1, t + dt/2)."""
    dt = m.dt
    k1 = _forced_rhs(m, state, t, ctrl)
    mid = tuple(u + 0.5 * dt * k for u, k in zip(state, k1))
    k2 = _forced_rhs(m, mid, t + 0.5 * dt, ctrl)
    return tuple(u + dt * k for u, k in zip(state, k2))


def control_blocks(m: Model, state0, controls, spc: int):
    """Depth after each control block: a list of horizon (B, K, Np)."""
    state, t, out = state0, 0.0, []
    for j in range(controls.shape[1]):
        for _ in range(spc):
            state = ssprk2(m, state, t, controls[:, j])
            t += m.dt
        out.append(state[0])
    return out


def tracking_errors(m: Model, state0, controls, targets, spc: int):
    """Elevation error (B, horizon, K, Np) after each control block."""
    hs = torch.stack(control_blocks(m, state0, controls, spc), dim=1)
    return (hs - m.H_rest) - targets[:, None]


def cost(m: Model, state0, controls, targets, spc: int) -> torch.Tensor:
    """Per-scenario tracking cost (B,): q_eta times the mean over the
    horizon plus q_terminal times the last block of sum(wj err^2), plus
    r_control times the control effort."""
    err = tracking_errors(m, state0, controls, targets, spc)
    per_step = torch.sum(m.wj * err * err, dim=(-2, -1))
    running = per_step.sum(dim=1) / controls.shape[1]
    effort = torch.sum(controls * controls, dim=(-2, -1))
    return (m.q_eta * running + m.q_terminal * per_step[:, -1]
            + m.r_control * effort)


def residuals(m: Model, state0, targets, spc: int) -> Callable:
    """R(c) (B, n_res) with sum(R**2, dim=1) == cost."""
    swj = torch.sqrt(torch.clamp_min(m.wj, 0.0))

    def R(c):
        err = tracking_errors(m, state0, c, targets, spc)
        B, Hn = c.shape[0], c.shape[1]
        run = ((m.q_eta / Hn) ** 0.5 * swj * err).reshape(B, -1)
        term = (m.q_terminal ** 0.5 * swj * err[:, -1]).reshape(B, -1)
        eff = (m.r_control ** 0.5 * c).reshape(B, -1)
        return torch.cat([run, term, eff], dim=1)

    return R


def plant(m: Model, state0, control, spc: int):
    """One control interval from t = 0 under ``control`` (B, n_ctrl)."""
    state, t = state0, 0.0
    for _ in range(spc):
        state = ssprk2(m, state, t, control)
        t += m.dt
    return state
