"""Host-side helpers.

Counterpart of the JAX package's ``blitzdg_tpu/utils.py``; only
``build_sponge_coefficient`` is ported so far.
"""
from __future__ import annotations

import numpy as np
import torch


def build_sponge_coefficient(ctx, open_boundary_mask, width: float,
                             strength: float = 1.0) -> torch.Tensor:
    """Sponge-layer relaxation coefficient: quadratic ramp within ``width``
    of the open-boundary nodes (vectorized distance to the node set).

    open_boundary_mask: boolean (K, Nfaces*Nfp) marking open face nodes.
    Returns a (K, Np) coefficient in [0, strength], on ``ctx.x``'s device
    and in its dtype.
    """
    x = ctx.x.detach().double().cpu().numpy()
    y = ctx.y.detach().double().cpu().numpy()
    vm = ctx.vmapM.reshape(-1).cpu().numpy()
    mask = np.asarray(open_boundary_mask).reshape(-1)
    if not mask.any():
        return torch.zeros_like(ctx.x)
    ob = vm[mask]
    xo = x.reshape(-1)[ob]
    yo = y.reshape(-1)[ob]
    d = np.sqrt(
        (x.reshape(-1)[:, None] - xo[None, :]) ** 2
        + (y.reshape(-1)[:, None] - yo[None, :]) ** 2
    ).min(axis=1)
    ramp = np.clip(1.0 - d / width, 0.0, 1.0) ** 2
    return torch.as_tensor(strength * ramp.reshape(x.shape),
                           dtype=ctx.x.dtype, device=ctx.x.device)
