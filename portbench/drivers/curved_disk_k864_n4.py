"""The curved disk through the curved kernels: ``solve_mpc_curved_blocked``
(Adam) or ``solve_mpc_curved_blocked_gn`` (Gauss-Newton) over the curved
rollout (B11) and its adjoint (B12), then ``advance_plant_curved_blocked``
(B10) for one control interval."""
from __future__ import annotations

from typing import NamedTuple

import torch

from blitzdg_tpu_torch.mpc import (advance_plant_curved_blocked,
                                   solve_mpc_curved_blocked,
                                   solve_mpc_curved_blocked_gn)
from blitzdg_tpu_torch.mpc import curved_disk as cdk
from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC
from blitzdg_tpu_torch.ops.sw2d_curved import SWStateTracer


class Sut(NamedTuple):
    prob: object
    bm: object
    h_rest: float
    n_ctrl: int


def build(cfg: dict, load: dict, device,
          dtype: torch.dtype = torch.float32) -> Sut:
    """The program's disk problem and operator set; refuse to run where
    its mesh, cubature, filter or time step is not the configuration's."""
    m = cfg["mesh"]
    if m["generator"] != "disk_triangles" or m["radius"] != 1.0:
        raise RuntimeError("this driver runs the unit disk only")
    d = cdk.curved_disk_problem(
        rings=m["rings"], snap_tol=m["snap_tol"], batch=1,
        horizon=load["horizon"], steps_per_control=load["steps_per_control"],
        n_order=m["N"], dtype=dtype, device=device)
    meta, ph = d.bm.meta, cfg["physics"]
    if ((meta.k_elem, meta.n_p, meta.n_cub, meta.n_gauss)
            != (m["K"], (m["N"] + 1) * (m["N"] + 2) // 2,
                m["cubature_points"], m["gauss_per_face"])):
        raise RuntimeError("the program's mesh or cubature is not the "
                           "configuration's")
    if ((cdk.H_REST, cfg["cfl"], ph["h_cfl"], cfg["filter"]["cutoff"])
            != (ph["h_rest"], 0.5, 1.1, 0.9 * m["N"])):
        raise RuntimeError("the program's disk fixes depth 1, the CFL "
                           "number 0.5 at depth 1.1 and the filter's cutoff "
                           "0.9 N; the configuration states others")
    return Sut(d.prob, d.bm, cfg["physics"]["h_rest"],
               cfg["injector"]["controls"])


def solve(sut: Sut, batch, solver: dict):
    """The MPC solve of one request: (controls, cost, history, grad norm)."""
    states = SWStateTracer(*batch.state)
    if solver["kind"] == "adam":
        sol = solve_mpc_curved_blocked(
            sut.prob, sut.bm, states, batch.targets, sut.n_ctrl,
            iters=solver["iters"], learning_rate=solver["lr"],
            H_rest=sut.h_rest)
    elif solver["kind"] == "gn":
        sol = solve_mpc_curved_blocked_gn(
            sut.prob, sut.bm, states, batch.targets, sut.n_ctrl,
            gn_iters=solver["gn_iters"], cg_iters=solver["cg_iters"],
            lm_lambda0=solver["lm_lambda0"], fd_eps=solver["fd_eps"],
            H_rest=sut.h_rest)
    else:
        raise ValueError(f"no {solver['kind']} solver on the curved path")
    return sol.controls, sol.cost, sol.cost_history, sol.grad_norm


def plant(sut: Sut, batch, control) -> tuple:
    """The plant after one control interval under ``control`` (B, n_ctrl)."""
    return tuple(advance_plant_curved_blocked(
        sut.prob, sut.bm, SWStateTracer(*batch.state), control))


def wrappers() -> dict:
    return {"step": TC.sw2d_curved_step_blocked,
            "fwd_rollout": TC.sw2d_curved_rollout_blocked,
            "bwd_rollout": TC.sw2d_curved_rollout_bwd_blocked}
