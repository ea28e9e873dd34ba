"""The large-mesh workload: rollouts and blocked MPC on the 32 x 32 box.

The configuration that the JAX package's benchmark reports from its blocked
path (``bench.py``, "blocked K=2048" rows), rebuilt for the port:
``box_triangles(32, 32)`` (K=2048, all walls), order N=3 (Np=10, Nfp=4) or
N=6 (Np=28, Nfp=7) with the modal filter (cutoff 0.9 N, order 4), flat
bottom, g=9.81, dt from the CFL number 0.7 at depth 11.

 - forward rollout: 8 scenarios, h = 10 + exp(-10 (x^2+y^2)) at rest, no
   controls, 2048 steps;
 - blocked MPC: 8 scenarios from rest at depth 10, horizon 4 x 2 steps, two
   Gaussian-bump momentum injectors, q_eta=0, q_terminal=1e6,
   r_control=1e-8, a REACHABLE target (the terminal elevation under the
   hidden controls 30.0), Adam 5 iterations at learning rate 6.0, or
   Gauss-Newton 2 x 2 with fd_eps=0.3 (and 3.0, see ``FD_EPS_FLOAT32``).

Nothing here is random. Everything float32 unless ``dtype`` says otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mesh import box_triangles
from ..ops.sw2d import SWPhysics, SWState
from ..ops.sw2d_blocked import (BlockedMeta, BlockedOps,
                                build_blocked_step_ops)
from ..specgrid.triangle import build_triangle_context
from .blocked import BlockedMPC, build_blocked_mpc
from .coastal_box import cfl_dt
from .problem import MPCProblem

CELLS = (32, 32)  # K = 2048 triangles
N_ORDER = 3
BATCH = 8  # scenarios
ROLLOUT_STEPS = 2048
HORIZON = 4  # control steps
STEPS_PER_CONTROL = 2
ADAM_ITERS = 5
LEARNING_RATE = 6.0
GN_ITERS, CG_ITERS, FD_EPS = 2, 2, 0.3
# The difference step that the Gauss-Newton solve needs in plain float32
# here: the whole tracking error is some 30 ulp of h = 10 (the hidden
# controls 30.0 move the surface by 3e-5), so a control perturbation of norm
# 0.3 moves it by less than one ulp, Jv is rounding noise and no step is
# accepted; from a norm of 3 on the solve converges.
FD_EPS_FLOAT32 = 3.0
HIDDEN_CONTROL = 30.0
H_REST = 10.0


def _context_and_dt(n_order: int, cells: tuple, dtype, device):
    mesh = box_triangles(*cells)
    kw = dict(filter_cutoff=0.9 * n_order, filter_order=4)
    ctx = build_triangle_context(n_order, mesh, dtype=dtype, device=device, **kw)
    # dt from a float64 host context, as the benchmark takes it
    ctx_host = build_triangle_context(n_order, mesh, dtype=torch.float64,
                                      device="cpu", **kw)
    return ctx, cfl_dt(ctx_host, 9.81, 11.0, cfl=0.7)


class BlockedRollout(NamedTuple):
    ops: BlockedOps
    meta: BlockedMeta
    dt: float
    states: SWState  # (B, K*Np) flat fields, ready for the kernels
    n_steps: int


def blocked_rollout_problem(n_order: int = N_ORDER, batch: int = BATCH,
                            cells: tuple = CELLS,
                            n_steps: int = ROLLOUT_STEPS,
                            dtype: torch.dtype = torch.float32,
                            device="cuda") -> BlockedRollout:
    """The forward-rollout rows: a Gaussian hump at rest on the flat box."""
    ctx, dt = _context_and_dt(n_order, cells, dtype, device)
    ops, meta = build_blocked_step_ops(ctx, SWPhysics(g=9.81), dtype=dtype,
                                       device=device)
    h = (H_REST + torch.exp(-10.0 * (ctx.x ** 2 + ctx.y ** 2))).reshape(1, -1)
    h = h.expand(batch, -1).contiguous()
    states = SWState(h=h, hu=torch.zeros_like(h), hv=torch.zeros_like(h))
    return BlockedRollout(ops, meta, dt, states, n_steps)


class BlockedBox(NamedTuple):
    prob: MPCProblem
    bm: BlockedMPC
    states: SWState  # (B, K, Np) rest start
    targets: torch.Tensor  # (B, K, Np) reachable elevation target
    hidden: torch.Tensor  # (B, horizon, 2) the controls that reach it


def blocked_box_problem(batch: int = BATCH, horizon: int = HORIZON,
                        steps_per_control: int = STEPS_PER_CONTROL,
                        n_order: int = N_ORDER, cells: tuple = CELLS,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        forward=None, backward=None) -> BlockedBox:
    """The blocked MPC rows. ``forward``/``backward`` are passed on to
    ``build_blocked_mpc`` (e.g. the plain versions for a cross-check)."""
    ctx, dt = _context_and_dt(n_order, cells, dtype, device)
    xs, ys = ctx.x.double().cpu().numpy(), ctx.y.double().cpu().numpy()
    bump = np.exp(-8.0 * (xs ** 2 + ys ** 2))
    forcing_bu = np.stack([bump, 0 * bump])
    forcing_bv = np.stack([0 * bump, bump])
    prob = MPCProblem(ctx=ctx, phys=SWPhysics(g=9.81), dt=dt, horizon=horizon,
                      steps_per_control=steps_per_control, q_eta=0.0,
                      q_terminal=1e6, r_control=1e-8)
    bm = build_blocked_mpc(prob, forcing_bu, forcing_bv, dtype=dtype,
                           device=device, forward=forward, backward=backward)

    h0 = torch.full((batch, ctx.k_elem, ctx.n_p), H_REST, dtype=dtype,
                    device=device)
    states = SWState(h=h0, hu=torch.zeros_like(h0), hv=torch.zeros_like(h0))
    hidden = torch.full((batch, horizon, 2), HIDDEN_CONTROL, dtype=dtype,
                        device=device)
    flat = lambda f: f.reshape(batch, -1).contiguous()
    with torch.no_grad():
        th, _, _ = bm.rollout(flat(states.h), flat(states.hu), flat(states.hv),
                              hidden)
    targets = (th[:, -1] - H_REST).reshape(h0.shape).contiguous()
    return BlockedBox(prob, bm, states, targets, hidden)
