"""1D linear advection: upwind-flux DG right-hand side.

Counterpart of the JAX package's ``blitzdg_tpu/ops/advec1d.py``:

    RHS = -c * rx * (Dr u) + Lift (Fscale * du),
    du  = (uM - uP) * 0.5 * (c n - (1-alpha)|c n|),  alpha=0 (upwind)

with inflow uP=0 at mapI and outflow uP=uM at mapO, element-major (K, Np)
with any leading batch axes. Plain tensor code (no kernel of its own),
differentiable by ``torch.autograd`` (the boundary values are set on a
copy of the gathered trace).
"""
from __future__ import annotations

import torch

from ..config import check_matmul_precision
from ..context import DGContext1D


def advec1d_rhs(ctx: DGContext1D, u: torch.Tensor, t, c: float,
                alpha: float = 0.0) -> torch.Tensor:
    """du/dt for u: (K, Np) (or any leading-batched (..., K, Np))."""
    check_matmul_precision(u)
    uM, uP = ctx.surface_trace(u)

    # Boundary conditions: outflow copies the interior trace, inflow is 0.
    uP = uP.clone()
    uP[..., ctx.mapO] = uM[..., ctx.mapO]
    uP[..., ctx.mapI] = 0.0

    nxf = ctx.nx.reshape(-1)
    cn = c * nxf
    du = (uM - uP) * 0.5 * (cn - (1.0 - alpha) * torch.abs(cn))
    du = du.reshape(*u.shape[:-2], ctx.k_elem, ctx.n_faces * ctx.n_fp)

    vol = -c * ctx.rx * (u @ ctx.Dr.T)
    surf = (ctx.fscale * du) @ ctx.lift.T
    return vol + surf
