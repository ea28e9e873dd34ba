"""blitzdg_tpu_torch: the PyTorch/CUDA port of ``blitzdg_tpu``.

A second package beside the JAX one, named after it. Host-side setup is
numpy, device code is plain ``torch`` tensor code, and every kernel the JAX
package wrote in Pallas becomes a CUDA C++ kernel for Hopper (``ops/csrc``).
The directory structure, function names and field names follow the JAX
package so that a reader finds each counterpart; each module's docstring
names it. This package imports ``torch`` and ``numpy`` only: never ``jax``,
``flax``, ``optax`` or anything of ``blitzdg_tpu``.

Two paths run through kernels so far. The dense path (small meshes, huge
scenario batches): ``mpc.solve_mpc_fused`` over ``ops.sw2d_fused``, whole
mesh per thread block. The blocked path (meshes of thousands of elements):
``ops.sw2d_blocked`` (``sw2d_step_blocked``, ``sw2d_rollout_blocked``,
``make_rollout_blocked``) and ``mpc.solve_mpc_blocked`` /
``mpc.solve_mpc_blocked_gn`` over it, mesh split over thread blocks.

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
