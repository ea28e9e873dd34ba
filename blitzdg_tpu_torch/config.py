"""Numeric precision policy of the port.

Counterpart of the precision scope in the JAX package's
``blitzdg_tpu/config.py`` (``dg_op``) and of ``blitzdg_tpu/ops/_mxu.py``:
DG operators need full float32, because O(1e-3) surface perturbations ride
on depths of about 10. PyTorch's float32 ``matmul`` is full float32 on the
card unless TF32 was switched on, so the port leaves
``torch.backends.cuda.matmul.allow_tf32`` False and asserts it wherever it
multiplies matrices on the card. The hand-built bf16x3 split of the JAX
package is not ported.
"""
from __future__ import annotations

import torch


def check_matmul_precision(t: torch.Tensor) -> None:
    """Raise if ``t`` lives on a CUDA device and TF32 matmuls are enabled."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: DG operators "
            "need full float32 matrix products")
