"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run drives the
program's plain versions on the CPU, with one fault planted at a time.

 - ``step_unchanged``: the plant's time step returns its state unchanged;
 - ``update_unchanged``: the optimizer's update leaves the controls where
   they were;
 - ``half_batch``: half the scenarios are solved, the other half answered
   with their answers;
 - ``answer_altered``: the controls are altered where they are produced,
   by a tenth of the largest (Gauss-Newton's forward differences in
   float32 leave about a hundredth of noise in its controls, so a
   hundredth is below what a check of them can tell).

(One chip: no exchange between chips to leave out.)
"""
import time

import pytest
import torch

import blitzdg_tpu_torch.mpc.curved_blocked as crv
import blitzdg_tpu_torch.mpc.fused as fused
import blitzdg_tpu_torch.mpc.solver as solver
from portbench.drivers import coastal_box_k40_n1 as coastal_drv
from portbench.drivers import curved_disk_k864_n4 as curved_drv
from portbench.run import run_cell
from portbench.tests.small import SMALL, small

ENTRY = {"coastal.adam_b8192": (coastal_drv, "solve_mpc_fused"),
         "curved.adam_b32": (curved_drv, "solve_mpc_curved_blocked"),
         "curved.gn_b32": (curved_drv, "solve_mpc_curved_blocked_gn")}


def _half_batch(fn):
    def solve(prob, m, states0, targets, n, **kw):
        h = targets.shape[0] // 2
        sol = fn(prob, m, type(states0)(*(f[:h] for f in states0)),
                 targets[:h], n, **kw)
        twice = lambda t, d=0: None if t is None else torch.cat([t, t], d)
        return sol._replace(controls=twice(sol.controls),
                            cost=twice(sol.cost),
                            cost_history=twice(sol.cost_history, 1),
                            grad_norm=twice(sol.grad_norm))
    return solve


def _altered(fn):
    def solve(*a, **kw):
        sol = fn(*a, **kw)
        c = sol.controls
        return sol._replace(controls=c + 0.1 * c.abs().max())
    return solve


def _gn_unchanged(fn):
    def gn(R, c0, **kw):
        sol = fn(R, c0, **kw)
        with torch.no_grad():
            r = R(c0)
        cost0 = (r * r).sum(dim=1)
        return sol._replace(controls=c0.detach().clone(), cost=cost0,
                            cost_history=cost0.expand_as(sol.cost_history))
    return gn


def plant(monkeypatch, cell, fault):
    drv, entry = ENTRY[cell]
    if fault == "step_unchanged":
        monkeypatch.setattr(fused, "sw2d_step_fused",
                            lambda o, m, h, hu, hv, *a: (h, hu, hv))
        monkeypatch.setattr(crv, "sw2d_curved_step_blocked",
                            lambda o, m, h, hu, hv, hN, *a: (h, hu, hv, hN))
    elif fault == "update_unchanged" and cell.startswith("curved.gn"):
        monkeypatch.setattr(crv, "_gn_lm_fd", _gn_unchanged(crv._gn_lm_fd))
    elif fault == "update_unchanged":
        monkeypatch.setattr(solver, "adam_update",
                            lambda g, st, p, *a, **k: (p, st))
    elif fault == "half_batch":
        monkeypatch.setattr(drv, entry, _half_batch(getattr(drv, entry)))
    elif fault == "answer_altered":
        monkeypatch.setattr(drv, entry, _altered(getattr(drv, entry)))


@pytest.mark.parametrize("fault", ["step_unchanged", "update_unchanged",
                                   "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, cell, fault)
    result, checks = run_cell(cell, 987654321987, 0.0, False, "cpu",
                              time.perf_counter(), small(cell),
                              min_requests=2)
    assert result["correct"] is False, checks
