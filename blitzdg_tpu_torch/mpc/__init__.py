from .blocked import (BlockedMPC, advance_plant_blocked, build_blocked_mpc,
                      mpc_cost_blocked, solve_mpc_blocked,
                      solve_mpc_blocked_gn)
from .curved_blocked import (CurvedBlockedMPC, advance_plant_curved_blocked,
                             build_curved_blocked_mpc,
                             mpc_cost_curved_blocked,
                             solve_mpc_curved_blocked,
                             solve_mpc_curved_blocked_gn)
from .fused import (FusedMPC, advance_plant_fused, build_fused_mpc,
                    mpc_cost_fused, solve_mpc_fused)
from .problem import MPCProblem, mpc_cost, rollout_controls
from .sharded_box import (ShardedMPC, sharded_mpc_cost, sharded_mpc_problem,
                          solve_sharded_mpc)
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
    "BlockedMPC",
    "build_blocked_mpc",
    "mpc_cost_blocked",
    "solve_mpc_blocked",
    "solve_mpc_blocked_gn",
    "advance_plant_blocked",
    "CurvedBlockedMPC",
    "build_curved_blocked_mpc",
    "mpc_cost_curved_blocked",
    "solve_mpc_curved_blocked",
    "solve_mpc_curved_blocked_gn",
    "advance_plant_curved_blocked",
    "ShardedMPC",
    "sharded_mpc_problem",
    "sharded_mpc_cost",
    "solve_sharded_mpc",
]
