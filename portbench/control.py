"""The control of the benchmark's check, and readings over many seeds.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \\
        [--system control|program] [--seconds 2]

``--system control`` (the default) puts the plain reference in the
program's place, in float32 with every matrix product's factors rounded
to TF32: the nearest precision below the float32, TF32 off, that the
configurations state. It runs the cell's own load through ``run.py``'s
window and check, and its numbers have to fail the check.
``--system program`` runs the measured program the same way. Either
prints one JSON line a seed with every compared number; a short window
serves, with as many answers checked as a full run checks. Needs an
NVIDIA GPU, like ``run.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import spec  # noqa: E402
from portbench.reference import models, optim  # noqa: E402
from portbench.reference.dg.prec import tf32_products  # noqa: E402
from portbench.run import _fixed_caches, run_cell  # noqa: E402


class Control:
    """The reference in the program's place: float32, TF32 products."""

    def build(self, cfg: dict, load: dict, device):
        self.m = models.build_model(cfg).to(device, torch.float32)
        self.spc = load["steps_per_control"]
        self.horizon = load["horizon"]
        self.n_ctrl = cfg["injector"]["controls"]
        return self

    def solve(self, sut, batch, solver: dict):
        m, s0, tg = self.m, batch.state, batch.targets
        zeros = torch.zeros((tg.shape[0], self.horizon, self.n_ctrl),
                            dtype=tg.dtype, device=tg.device)
        with tf32_products():
            def total(c):
                return models.cost(m, s0, c, tg, self.spc)

            if solver["kind"] == "gn":
                sol = optim.gauss_newton(
                    models.residuals(m, s0, tg, self.spc), zeros,
                    gn_iters=solver["gn_iters"], cg_iters=solver["cg_iters"],
                    lm_lambda0=solver["lm_lambda0"], fd_eps=solver["fd_eps"])
            else:
                sol = optim.adam_final_cost(total, zeros, solver["iters"],
                                            solver["lr"])
        return sol.controls, sol.cost, sol.cost_history, sol.grad_norm

    def plant(self, sut, batch, control) -> tuple:
        with tf32_products(), torch.no_grad():
            return models.plant(self.m, batch.state, control, self.spc)

    def wrappers(self) -> dict:
        return {}


def readings(cell: str, seeds: list, system: str, seconds: float,
             device="cuda", load_overrides: dict | None = None) -> list:
    """One record a seed: the compared numbers and ``correct``."""
    load = {**spec.workload(cell)["load"], **(load_overrides or {})}
    n = load["sample"]["checked"]
    per = min(n, load["batch"])
    over = {**(load_overrides or {}),
            "sample": {"per_request": per, "checked": n}}
    out = []
    for seed in seeds:
        sut = Control() if system == "control" else None
        res, checks = run_cell(cell, seed, seconds, False, device,
                               time.perf_counter(), over, system=sut,
                               min_requests=-(-n // per))
        out.append({"cell": cell, "system": system, "seed": seed,
                    "correct": res["correct"], "attempted": res["attempted"],
                    "checks": {k: c["value"] for k, c in checks.items()}})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--system", choices=("control", "program"),
                    default="control")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    _fixed_caches()
    if not torch.cuda.is_available():
        print("portbench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for rec in readings(args.workload, args.seeds, args.system,
                        args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
