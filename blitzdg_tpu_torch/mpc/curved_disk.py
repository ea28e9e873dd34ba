"""The curved workload: batched MPC over the curved weak-form dynamics on a
Gordon-Hall deformed disk.

The two configurations that the JAX package's benchmark reports from its
curved path (``bench.py``, "curved-dynamics batched MPC"), rebuilt for the
port: ``disk_triangles(rings)`` with the boundary vertices snapped onto the
unit circle and the boundary elements deformed, order N=3 (Np=10) with the
modal filter (cutoff 0.9 N, order 4), cubature order 3(N+1)=12 (34 points),
2(N+1)=8 Gauss points per face, flat bottom, g=9.81, walls, dt from the CFL
number 0.5 at depth 1.1; scenarios from rest (h=1), horizon 4 x 2 steps, two
Gaussian-bump momentum injectors, q_eta=0, q_terminal=1, r_control=1e-10,
per-scenario targets 1e-3 exp(-5((x-o)^2+y^2)) with o from -0.3 to 0.3, Adam
5 iterations at learning rate 0.05.

 - small disk: 3 rings (K=54), snap tolerance 0.3, 256 scenarios;
 - large disk: 13 rings (K=1014), snap tolerance 0.1, 32 scenarios.

Each problem can be solved two ways: ``solve_mpc_curved_blocked`` (the
curved kernels) and ``solve_mpc`` with ``rhs_fn = sw2d_curved_rhs`` (plain
tensor code), which is the benchmark's own cross-check.

Nothing here is random. Everything float32 unless ``dtype`` says otherwise;
the operator set of the kernels is formed from float64 host contexts and
cast once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..mesh import disk_triangles
from ..mesh.curved import (circle_projection, gordon_hall_deform,
                           snap_boundary_vertices)
from ..ops.sw2d import SWPhysics
from ..ops.sw2d_curved import SWStateTracer, sw2d_curved_rhs
from ..specgrid.cubature import (CubatureContext2D, GaussFaceContext2D,
                                 build_cubature_context,
                                 build_gauss_face_context)
from ..specgrid.triangle import build_triangle_context
from .coastal_box import cfl_dt
from .curved_blocked import CurvedBlockedMPC, build_curved_blocked_mpc
from .problem import MPCProblem

N_ORDER = 3
SMALL = dict(rings=3, snap_tol=0.3, batch=256)  # K = 54
LARGE = dict(rings=13, snap_tol=0.1, batch=32)  # K = 1014
HORIZON = 4  # control steps
STEPS_PER_CONTROL = 2
ADAM_ITERS = 5
LEARNING_RATE = 0.05
H_REST = 1.0
GN_ITERS, CG_ITERS = 2, 2
FD_EPS = 1e-3  # the Gauss-Newton solver's default difference step
# The difference step that the Gauss-Newton solve needs in plain float32 on
# the small disk: a control perturbation of norm 1e-3 moves the surface by
# less than one ulp of h = 1 there, Jv is rounding noise and no step is
# accepted; from 1e-2 on the solve converges. (The large disk converges at
# either.)
FD_EPS_FLOAT32 = 1e-2


def curved_disk_contexts(rings: int, snap_tol: float, n_order: int = N_ORDER,
                         dtype: torch.dtype = torch.float32, device="cuda"):
    """The disk's nodal, cubature and Gauss-face contexts on ``device`` in
    ``dtype``, and the same three in float64 on the host."""
    mesh = disk_triangles(rings, radius=1.0)
    proj = circle_projection(0.0, 0.0, 1.0)
    curved_faces = snap_boundary_vertices(mesh, proj, tol=snap_tol)
    straight = build_triangle_context(n_order, mesh, dtype=torch.float64,
                                      device="cpu")
    V = straight.V.numpy()
    x, y, _ = gordon_hall_deform(n_order, mesh, straight.x.numpy(),
                                 straight.y.numpy(), curved_faces, proj)

    def build(dt_, dev):
        ctx = build_triangle_context(n_order, mesh, coords=(x, y),
                                     filter_cutoff=0.9 * n_order,
                                     filter_order=4, dtype=dt_, device=dev)
        cub = build_cubature_context(n_order, mesh, x, y, V, dtype=dt_,
                                     device=dev)
        gauss = build_gauss_face_context(n_order, mesh, x, y, V, dtype=dt_,
                                         device=dev)
        return ctx, cub, gauss

    return build(dtype, device), build(torch.float64, "cpu")


class CurvedDisk(NamedTuple):
    prob: MPCProblem  # rhs_fn = sw2d_curved_rhs: the plain composite
    cub: CubatureContext2D
    gauss: GaussFaceContext2D
    bm: CurvedBlockedMPC
    states: SWStateTracer  # (B, K, Np) rest start
    targets: torch.Tensor  # (B, K, Np)
    control_to_forcing: Callable  # the injectors, for ``solve_mpc``


def curved_disk_problem(rings: int = LARGE["rings"],
                        snap_tol: float = LARGE["snap_tol"],
                        batch: int = LARGE["batch"], horizon: int = HORIZON,
                        steps_per_control: int = STEPS_PER_CONTROL,
                        n_order: int = N_ORDER,
                        dtype: torch.dtype = torch.float32,
                        device="cuda") -> CurvedDisk:
    """One curved-disk MPC problem (default: the large disk)."""
    (ctx, cub, gauss), (ctx64, cub64, gauss64) = curved_disk_contexts(
        rings, snap_tol, n_order, dtype, device)
    phys = SWPhysics(g=9.81)
    dt = cfl_dt(ctx64, 9.81, 1.1, cfl=0.5)

    def curved_rhs(s, t):
        return sw2d_curved_rhs(ctx, cub, gauss, s, t, phys)

    prob = MPCProblem(ctx=ctx, phys=phys, dt=dt, horizon=horizon,
                      steps_per_control=steps_per_control, q_eta=0.0,
                      q_terminal=1.0, r_control=1e-10, rhs_fn=curved_rhs)
    xs, ys = ctx64.x.numpy(), ctx64.y.numpy()
    bump64 = np.exp(-8.0 * (xs ** 2 + ys ** 2))
    bm = build_curved_blocked_mpc(
        dataclasses.replace(prob, ctx=ctx64), cub64, gauss64,
        np.stack([bump64, 0 * bump64]), np.stack([0 * bump64, bump64]),
        dtype=dtype, device=device)

    bump = torch.exp(-8.0 * (ctx.x ** 2 + ctx.y ** 2))

    def control_to_forcing(c, control, s, t):
        return (torch.zeros_like(s.h), control[..., 0, None, None] * bump,
                control[..., 1, None, None] * bump)

    h0 = torch.ones((batch, ctx.k_elem, ctx.n_p), dtype=dtype, device=device)
    zero = torch.zeros_like(h0)
    states = SWStateTracer(h=h0, hu=zero, hv=zero.clone(), hN=zero.clone())
    offs = torch.linspace(-0.3, 0.3, batch, dtype=dtype, device=device)
    targets = 1e-3 * torch.exp(
        -5.0 * ((ctx.x[None] - offs[:, None, None]) ** 2 + ctx.y[None] ** 2))
    return CurvedDisk(prob, cub, gauss, bm, states, targets,
                      control_to_forcing)
