"""The headline workload: batched coastal shooting MPC on the coarse box.

The configuration that the JAX package's benchmark reports as its headline
(``bench.py``, "headline: dense-kernel MPC"), rebuilt for the port:
``box_triangles(4, 5)`` (K=40) with the east boundary faces retagged BC_OUT,
N=1, modal filter (cutoff 0.9 N, order N), shelf bathymetry
H = 8 + 4 (x - xmin)/span, drag 2.5e-3, Coriolis 1e-4, tidal BC_OUT depth
(12.0, 0.2, 2.0, 0.02), two Gaussian-bump momentum controls, dt from the CFL
number 0.7 at depth 12.4, rest start h = H, and per-scenario Gaussian
elevation targets. Everything float32 unless ``dtype`` says otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..context import BC_OUT, DGContext2D
from ..mesh import Mesh2D, box_triangles
from ..ops.sw2d import SWPhysics, SWState
from ..specgrid.triangle import build_triangle_context
from .problem import MPCProblem

HORIZON = 8  # control steps
STEPS_PER_CONTROL = 4  # SSP-RK2 steps per control step
ITERS = 20  # Adam iterations per MPC solve
BATCH = 2048  # scenarios
LEARNING_RATE = 0.05
TIDAL = (12.0, 0.2, 2.0, 0.02)  # h0, amp, omega, ramp_tau


def cfl_dt(ctx: DGContext2D, g: float, h_max: float, cfl: float = 0.7) -> float:
    """dt from the CFL number at a rest state of depth h_max."""
    c = float(np.sqrt(g * h_max))
    fs = float(ctx.fscale.abs().max())
    return cfl / (((ctx.n_order + 1) ** 2) * 0.5 * fs * c)


def retag_east_open(mesh: Mesh2D) -> None:
    """Retag the boundary faces on the east side (x = xmax) as BC_OUT
    (face f of an element joins its vertices f and f+1, triangles or
    quadrilaterals)."""
    xmax = float(mesh.verts[:, 0].max())
    bc = np.asarray(mesh.bc_type).copy()
    nf = mesh.num_faces
    for k in range(mesh.num_elements):
        for f in range(nf):
            a, b = mesh.etov[k, f], mesh.etov[k, (f + 1) % nf]
            mx = 0.5 * (mesh.verts[a, 0] + mesh.verts[b, 0])
            if bc[k, f] > 0 and abs(mx - xmax) < 1e-9 * max(1.0, abs(xmax)):
                bc[k, f] = BC_OUT
    mesh.set_bc_type(bc)


class CoastalBox(NamedTuple):
    prob: MPCProblem
    forcing_bu: np.ndarray  # (2, K, Np)
    forcing_bv: np.ndarray
    tidal: tuple
    states: SWState  # (B, K, Np) rest start h = H
    targets: torch.Tensor  # (B, K, Np)
    H_rest: torch.Tensor  # (K, Np)


def coastal_box_problem(batch: int = BATCH, horizon: int = HORIZON,
                        steps_per_control: int = STEPS_PER_CONTROL,
                        n_order: int = 1, cells: tuple = (4, 5),
                        dtype: torch.dtype = torch.float32,
                        device="cuda") -> CoastalBox:
    mesh = box_triangles(*cells)
    retag_east_open(mesh)
    xv = mesh.verts[:, 0]
    xmin, xmax = float(xv.min()), float(xv.max())
    kw = dict(filter_cutoff=0.9 * n_order, filter_order=n_order)
    ctx = build_triangle_context(n_order, mesh, dtype=dtype, device=device, **kw)
    # dt from a float64 host context, as the benchmark takes it
    ctx_host = build_triangle_context(n_order, mesh, dtype=torch.float64,
                                      device="cpu", **kw)
    dt = cfl_dt(ctx_host, 9.81, TIDAL[0] + 2.0 * TIDAL[1], cfl=0.7)

    # shelf: depth 8 m at the west wall to 12 m at the open east side
    span = max(xmax - xmin, 1e-30)
    H = 8.0 + 4.0 * (ctx.x - xmin) / span
    Hx = (4.0 / span) * torch.ones_like(H)
    Hy = torch.zeros_like(H)
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy)

    xs, ys = ctx.x.double().cpu().numpy(), ctx.y.double().cpu().numpy()
    bump = np.exp(-8.0 * (xs ** 2 + ys ** 2))
    forcing_bu = np.stack([bump, 0 * bump])
    forcing_bv = np.stack([0 * bump, bump])

    h0 = H.expand(batch, *H.shape).contiguous()
    states = SWState(h=h0, hu=torch.zeros_like(h0), hv=torch.zeros_like(h0))
    offs = torch.linspace(-0.3, 0.3, batch, dtype=dtype, device=device)
    targets = 1e-3 * torch.exp(
        -5.0 * ((ctx.x[None] - offs[:, None, None]) ** 2 + ctx.y[None] ** 2))

    prob = MPCProblem(ctx=ctx, phys=phys, dt=dt, horizon=horizon,
                      steps_per_control=steps_per_control, q_eta=0.0,
                      q_terminal=1.0, r_control=1e-10)
    return CoastalBox(prob, forcing_bu, forcing_bv, TIDAL, states, targets, H)
