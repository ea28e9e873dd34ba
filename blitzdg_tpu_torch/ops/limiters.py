"""Slope/positivity limiters for shallow-water wetting and drying.

Counterpart of the JAX package's ``blitzdg_tpu/ops/limiters.py``:
``positivity_preserving_limiter`` (mean-preserving squash toward the cell
mean), ``minmod`` and ``surface_reconstruction`` (hydrostatic minmod
reconstruction of face traces). Plain elementwise tensor code on any
leading shape; the element's nodes lie on the last axis.
"""
from __future__ import annotations

import torch


def positivity_preserving_limiter(h, hu, hv, h_floor: float = 1e-3,
                                  weights: torch.Tensor | None = None):
    """Mean-preserving linear squash keeping h >= ~h_floor.

    ``weights`` (Np,) gives true cell averages (quadrature weights / total);
    None takes the arithmetic nodal mean.
    """
    if weights is None:
        mean = lambda f: torch.mean(f, dim=-1, keepdim=True)
    else:
        wsum = torch.sum(weights)
        mean = lambda f: torch.sum(f * weights, dim=-1, keepdim=True) / wsum

    # Standard Zhang-Shu squash factor: engages only where the element's
    # minimum is below the floor, and never pushes the mean.
    hmin = torch.amin(h, dim=-1, keepdim=True)
    hmean = mean(h)
    need = hmin < h_floor
    one = torch.ones_like(hmean)
    denom = torch.where(need, hmean - hmin, one)
    theta = torch.where(
        need,
        torch.clamp((hmean - h_floor) / torch.where(denom > 0, denom, one),
                    0.0, 1.0),
        one,
    )

    humean, hvmean = mean(hu), mean(hv)
    return (
        hmean + theta * (h - hmean),
        humean + theta * (hu - humean),
        hvmean + theta * (hv - hvmean),
    )


def minmod(a, b):
    """Elementwise minmod with comparison semantics: the smaller *value*
    when signs agree, else 0. NOTE: this is NOT the textbook
    smaller-magnitude minmod for negative pairs; ``surface_reconstruction``'s
    clamping against the fixed +-1e-3 arguments relies on exactly this."""
    same_sign = a * b > 0
    pick_a = (a < b) & same_sign
    pick_b = (b < a) & same_sign
    zero = torch.zeros_like(a)
    return torch.where(pick_a, a, torch.where(pick_b, b, zero))


def surface_reconstruction(etaM, hM, etaP, hP, h_floor: float = 1e-3):
    """Hydrostatic (well-balanced) reconstruction of face traces for
    wetting/drying: reconstruct bed elevations, limit the '+' surface, and
    floor the water columns."""
    zM = etaM - hM
    zP = etaP - hP
    ones = torch.full_like(zM, 1e-3)
    dz = (zP - 0.5 * minmod(zP - zM, ones)) - (zM + 0.5 * minmod(zM - zP, -ones))

    etaCorrP = zM - zP - dz
    etaCorrP = torch.minimum(etaCorrP, etaM - etaP)
    etaP = torch.where(etaCorrP > 0, etaP + etaCorrP, etaP)

    zP = etaP - hP
    maxz = torch.maximum(zM, zP)
    hM_new = torch.clamp_min(etaM - maxz, h_floor)
    hP_new = torch.clamp_min(etaP - maxz, h_floor)
    return hM_new, hP_new
