"""Shallow-water operators of the port (see each module's docstring).

Two kernel paths: the dense one for small meshes (``sw2d_fused``, kernels in
``csrc/sw2d_dense.cu``) and the element-blocked one for large meshes
(``sw2d_blocked``, kernels in ``csrc/sw2d_blocked.cu``). The names below are
the kernel wrappers and what builds their operator sets.
"""
from .sw2d_blocked import (BlockedMeta, BlockedOps, build_blocked_step_ops,
                           make_rollout_blocked, matmul_flops_per_step,
                           sw2d_rollout_blocked, sw2d_rollout_bwd_blocked,
                           sw2d_step_blocked)
from .sw2d_fused import (FusedStepMeta, FusedStepOps, build_fused_step_ops,
                         make_rollout, sw2d_rollout_bwd_fused,
                         sw2d_rollout_fused, sw2d_step_fused)

__all__ = [
    "FusedStepOps", "FusedStepMeta", "build_fused_step_ops", "make_rollout",
    "sw2d_step_fused", "sw2d_rollout_fused", "sw2d_rollout_bwd_fused",
    "BlockedOps", "BlockedMeta", "build_blocked_step_ops",
    "make_rollout_blocked", "matmul_flops_per_step", "sw2d_step_blocked",
    "sw2d_rollout_blocked", "sw2d_rollout_bwd_blocked",
]
