"""The coastal box through the dense kernels: ``solve_mpc_fused`` over the
fused rollout (B2) and its adjoint (B3), then ``advance_plant_fused`` (B1)
for one control interval."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc import (advance_plant_fused, build_fused_mpc,
                                   solve_mpc_fused)
from blitzdg_tpu_torch.mpc import coastal_box as cbx
from blitzdg_tpu_torch.ops import sw2d_fused as F
from blitzdg_tpu_torch.ops.sw2d import SWState
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context


class Sut(NamedTuple):
    prob: object
    fm: object
    H_rest: torch.Tensor
    n_ctrl: int


def build(cfg: dict, load: dict, device,
          dtype: torch.dtype = torch.float32) -> Sut:
    """The program's problem and operator set. Its coastal box fixes the
    tide and physics in code: refuse to run where they are not the
    configuration's. The time step is the configuration's CFL number's,
    formed as the program forms its own (a float64 host context)."""
    ph, tid = cfg["physics"], cfg["physics"]["tidal"]
    stated = (tid["h0"], tid["amp"], tid["omega"], tid["ramp_tau"])
    if cfg["mesh"]["generator"] != "box_triangles" or cbx.TIDAL != stated:
        raise RuntimeError("the program's coastal box is not the "
                           "configuration's")
    cb = cbx.coastal_box_problem(
        batch=1, horizon=load["horizon"],
        steps_per_control=load["steps_per_control"],
        n_order=cfg["mesh"]["N"], cells=tuple(cfg["mesh"]["cells"]),
        dtype=dtype, device=device)
    phys = cb.prob.phys
    if (phys.g, phys.cd, phys.f_cor) != (ph["g"], ph["drag"], ph["coriolis"]):
        raise RuntimeError("the program's physics is not the configuration's")
    n = cfg["mesh"]["N"]
    mesh = box_triangles(*cfg["mesh"]["cells"])
    cbx.retag_east_open(mesh)
    host = build_triangle_context(n, mesh, dtype=torch.float64, device="cpu",
                                  filter_cutoff=cfg["filter"]["cutoff"],
                                  filter_order=cfg["filter"]["order"])
    dt = cbx.cfl_dt(host, ph["g"], tid["h0"] + 2.0 * tid["amp"], cfg["cfl"])
    prob = dataclasses.replace(cb.prob, dt=dt)
    fm = build_fused_mpc(prob, cb.forcing_bu, cb.forcing_bv,
                         tidal=cb.tidal, dtype=dtype, device=device)
    return Sut(prob, fm, cb.H_rest, cfg["injector"]["controls"])


def solve(sut: Sut, batch, solver: dict):
    """The MPC solve of one request: (controls, cost, history, None)."""
    if solver["kind"] != "adam":
        raise ValueError(f"the dense path has no {solver['kind']} solver")
    sol = solve_mpc_fused(sut.prob, sut.fm, SWState(*batch.state),
                          batch.targets, sut.n_ctrl, iters=solver["iters"],
                          learning_rate=solver["lr"], H_rest=sut.H_rest)
    return sol.controls, sol.cost, sol.cost_history, None


def plant(sut: Sut, batch, control) -> tuple:
    """The plant after one control interval under ``control`` (B, n_ctrl)."""
    return tuple(advance_plant_fused(sut.prob, sut.fm, SWState(*batch.state),
                                     control))


def wrappers() -> dict:
    """The kernel wrappers by role; each counts its launches."""
    return {"step": F.sw2d_step_fused, "fwd_rollout": F.sw2d_rollout_fused,
            "bwd_rollout": F.sw2d_rollout_bwd_fused}
