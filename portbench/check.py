"""The comparison that decides ``correct``.

After the window the plain reference (``reference/``, float64) takes the
kept answers of the timed path and, from the same inputs, works out what
each should have been:

 - ``cost_at_controls``: the program's cost at its returned controls
   against the reference's cost there, relative, the widest over the
   checked scenarios (the set-up's operators and time step, the forward
   rollout kernel, the cost; for Gauss-Newton, the objective it
   minimizes and reports, the sum of squared residuals);
 - ``controls``: the returned controls against the reference's own solve
   from the same start (zero controls): a scenario's widest gap as a share
   of the largest of its reference controls, read at the 90th percentile of
   the checked scenarios (the answer itself: the optimizer's updates
   through forward and adjoint kernels; a scenario or two whose controls
   barely move the cost read several times the rest, and the percentile
   keeps them from setting the number, where a fault in a share of the
   batch or in every scenario still moves it);
 - ``descent``: each iteration's cost in the program's history against the
   reference's own solve, as a share of the starting cost, the widest over
   iterations and scenarios;
 - ``plant``: the next plant state against the reference's step under the
   program's first control, the widest gap of a field over the checked
   scenarios as a share of that field's largest change over the interval
   among them (the step kernel).

A cell compares the numbers its workload file gives a limit (``limits``),
each held to it; a number that is not finite fails.
"""
from __future__ import annotations

import torch

from .reference import models, optim


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() - b).abs() / b.abs()


def reference_readings(model, load: dict, state0, targets,
                       controls: torch.Tensor, device) -> dict:
    """What the reference says of the checked scenarios, in float64:
    the cost at the program's controls, its own solve's
    controls and history from zero controls, the starting cost, and the
    plant step under the program's first control."""
    m = model.to(device, torch.float64)
    s0 = tuple(f.to(device, torch.float64) for f in state0)
    tg = targets.to(device, torch.float64)
    spc = load["steps_per_control"]

    def total(c):
        return models.cost(m, s0, c, tg, spc)

    c_p = controls.to(device, torch.float64)
    zeros = torch.zeros_like(c_p)
    solver = load["solver"]
    if solver["kind"] == "adam":
        solved, history = optim.adam_minimize(total, zeros, solver["iters"],
                                              solver["lr"])
    else:
        # Gauss-Newton minimizes and reports the sum of squared residuals,
        # whose weights are the quadrature weights clamped at 0: the same
        # as the cost where no weight is negative (N <= 3), not at N = 4
        R = models.residuals(m, s0, tg, spc)
        solved, _, history, _ = optim.gauss_newton(
            R, zeros, gn_iters=solver["gn_iters"], cg_iters=solver["cg_iters"],
            lm_lambda0=solver["lm_lambda0"], fd_eps=solver["fd_eps"])

        def total(c):
            r = R(c)
            return (r * r).sum(dim=1)
    with torch.no_grad():
        cost_cp = total(c_p)
        start = total(zeros)
        plant = models.plant(m, s0, c_p[:, 0], spc)
    return {"cost": cost_cp, "controls": solved,
            "history": history, "start": start, "plant": plant, "s0": s0}


def readings(answers, ref: dict) -> dict:
    """The numbers compared, each the widest over the checked scenarios
    (``controls``: their 90th percentile)."""
    out = {"cost_at_controls": float(_rel(answers.cost, ref["cost"]).max())}
    gap = (answers.controls.double() - ref["controls"]).abs()
    scale = ref["controls"].abs().amax(dim=(-2, -1))
    out["controls"] = float(torch.quantile(gap.amax(dim=(-2, -1)) / scale,
                                           0.9))
    gap = (answers.history.double() - ref["history"]).abs()
    out["descent"] = float((gap / ref["start"].abs()[None]).max())
    out["plant"] = max(
        float((got.double() - want).abs().max() / (want - s0).abs().max())
        for got, want, s0 in zip(answers.plant, ref["plant"], ref["s0"]))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": lim}
             for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in shown.values())  # NaN fails
    return ok, shown
