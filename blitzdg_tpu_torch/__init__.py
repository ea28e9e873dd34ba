"""blitzdg_tpu_torch: the PyTorch/CUDA port of ``blitzdg_tpu``.

A second package beside the JAX one, named after it. Host-side setup is
numpy, device code is plain ``torch`` tensor code, and every kernel the JAX
package wrote in Pallas becomes a CUDA C++ kernel for Hopper (``ops/csrc``).
The directory structure, function names and field names follow the JAX
package so that a reader finds each counterpart; each module's docstring
names it. This package imports ``torch`` and ``numpy`` only: never ``jax``,
``flax``, ``optax`` or anything of ``blitzdg_tpu``.

Four paths run through kernels so far. The dense path (small meshes, huge
scenario batches): ``mpc.solve_mpc_fused`` over ``ops.sw2d_fused``, a
tile of scenarios' whole meshes per thread block, a thread an element. The blocked path (meshes of thousands of elements):
``ops.sw2d_blocked`` (``sw2d_step_blocked``, ``sw2d_rollout_blocked``,
``make_rollout_blocked``) and ``mpc.solve_mpc_blocked`` /
``mpc.solve_mpc_blocked_gn`` over it, mesh split over thread blocks. The
curved weak-form path (Gordon-Hall deformed elements, cubature volume and
Gauss face integrals, a tracer as fourth field): ``ops.sw2d_curved_blocked``
and ``mpc.solve_mpc_curved_blocked`` / ``mpc.solve_mpc_curved_blocked_gn``.
The element-sharded path (the mesh partitioned into element shards, the
halo exchanged between the RK stages): ``parallel.blocked_shard``
(``make_sharded_blocked_step_fused``, ``make_sharded_blocked_step_diff``)
over the stage kernels ``ops.sw2d_stage_blocked`` /
``ops.sw2d_stage_bwd_blocked_v2``, ``mpc.solve_sharded_mpc``, and the
one-launch step ``make_sharded_blocked_step_rdma`` over
``ops.sw2d_step_rdma_blocked`` (both stages and the halo between them in
one kernel).

The MPC solvers (``mpc.solve_mpc``, ``mpc.solve_mpc_gn``,
``mpc.receding_horizon``) over the plain composite rollout, and the
elliptic solvers (``solvers``: CG, GMRES, block-Jacobi and two-level
preconditioning; ``ops.poisson``, ``ops.sem``), are plain tensor code, as
they are plain XLA code in the JAX package.

Entry points take ``device=`` and default to ``"cuda"``; on a machine
without CUDA the default raises, it does not fall back to the CPU.
"""
from . import context, timestepping
from .context import (BC_DIRICHLET, BC_IN, BC_NEUMAN, BC_OUT, BC_WALL,
                      DGContext2D)

__version__ = "0.1.0"

__all__ = [
    "context",
    "timestepping",
    "DGContext2D",
    "BC_IN",
    "BC_OUT",
    "BC_WALL",
    "BC_DIRICHLET",
    "BC_NEUMAN",
]
