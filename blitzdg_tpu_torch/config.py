"""Numeric precision policy of the port, and the namelist reader.

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


# ---------------------------------------------------------------------------
# Namelist configuration files
# ---------------------------------------------------------------------------

def read_namelist(path: str) -> dict:
    """Parse a KEY = value namelist file: '#' comments, blank lines ignored,
    keys upper-cased. Values are returned as str; use typed accessors or
    cast at the call site."""
    config = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split("=")]
            if len(parts) != 2:
                raise ValueError(f"cannot parse namelist line: {line!r}")
            config[parts[0].upper()] = parts[1]
    return config


def namelist_get(config: dict, key: str, cast=str, default=None):
    """Typed accessor with optional default."""
    k = key.upper()
    if k not in config:
        if default is not None:
            return default
        raise KeyError(f"missing namelist key {k}")
    return cast(config[k])
