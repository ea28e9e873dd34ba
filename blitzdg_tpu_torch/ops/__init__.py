"""Shallow-water operators of the port (see each module's docstring).

Three kernel paths: the dense one for small meshes (``sw2d_fused``, kernels
in ``csrc/sw2d_dense.cu``), the element-blocked one for large meshes
(``sw2d_blocked``, kernels in ``csrc/sw2d_blocked.cu``, with the stage and
one-launch step kernels of the element-sharded path) and the curved
weak-form one (``sw2d_curved_blocked``, kernels in ``csrc/sw2d_curved.cu``).
The names below are the kernel wrappers and what builds their operator sets,
and the 1D right-hand sides (plain tensor code, as the JAX package exports
them).
"""
from .advec1d import advec1d_rhs
from .burgers1d import burgers1d_rhs, burgers_exact
from .sw2d_blocked import (BlockedMeta, BlockedOps, ShardOps,
                           build_blocked_step_ops, make_rollout_blocked,
                           matmul_flops_per_step, sw2d_rollout_blocked,
                           sw2d_rollout_bwd_blocked, sw2d_stage_blocked,
                           sw2d_stage_bwd_blocked_v2, sw2d_step_blocked,
                           sw2d_step_rdma_blocked)
from .sw2d_curved_blocked import (CurvedBlockedMeta, CurvedBlockedOps,
                                  build_curved_blocked_ops,
                                  make_curved_rollout_blocked,
                                  sw2d_curved_rollout_blocked,
                                  sw2d_curved_rollout_bwd_blocked,
                                  sw2d_curved_step_blocked)
from .sw2d_fused import (FusedStepMeta, FusedStepOps, build_fused_step_ops,
                         make_rollout, sw2d_rollout_bwd_fused,
                         sw2d_rollout_fused, sw2d_step_fused)

__all__ = [
    "advec1d_rhs", "burgers1d_rhs", "burgers_exact",
    "FusedStepOps", "FusedStepMeta", "build_fused_step_ops", "make_rollout",
    "sw2d_step_fused", "sw2d_rollout_fused", "sw2d_rollout_bwd_fused",
    "BlockedOps", "BlockedMeta", "build_blocked_step_ops",
    "make_rollout_blocked", "matmul_flops_per_step", "sw2d_step_blocked",
    "sw2d_rollout_blocked", "sw2d_rollout_bwd_blocked",
    "ShardOps", "sw2d_stage_blocked", "sw2d_stage_bwd_blocked_v2",
    "sw2d_step_rdma_blocked",
    "CurvedBlockedOps", "CurvedBlockedMeta", "build_curved_blocked_ops",
    "make_curved_rollout_blocked", "sw2d_curved_step_blocked",
    "sw2d_curved_rollout_blocked", "sw2d_curved_rollout_bwd_blocked",
]
