from .fused import (FusedMPC, advance_plant_fused, build_fused_mpc,
                    mpc_cost_fused, solve_mpc_fused)
from .problem import MPCProblem, mpc_cost, rollout_controls
from .solver import MPCSolution, solve_mpc

__all__ = [
    "MPCProblem",
    "mpc_cost",
    "rollout_controls",
    "MPCSolution",
    "solve_mpc",
    "FusedMPC",
    "build_fused_mpc",
    "mpc_cost_fused",
    "solve_mpc_fused",
    "advance_plant_fused",
]
