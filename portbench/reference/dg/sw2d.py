"""Frozen copy of ``blitzdg_tpu_torch/ops/sw2d.py`` at commit dfe7828, every
product of a field with an operator through prec.mm; no time-step or sponge
helper.

2D nonlinear shallow-water equations on triangles (conservative form).

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d.py`` and the oracle
for every shallow-water kernel of the port: conservative (h, hu, hv),
per-face trace-max Lax-Friedrichs flux, wall-reflection BCs, tidal
open-boundary forcing, hydrostatic-reconstruction well-balancing over
bathymetry, bed-slope sources, quadratic bottom drag (-cd|u|u in both
momentum equations), Coriolis, sponge relaxation. Plain eager tensor code,
differentiable by ``torch.autograd``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .context import BC_OUT, BC_WALL, DGContext2D, _tree_to
from .prec import mm


class SWState(NamedTuple):
    """Conservative shallow-water state, each (K, Np) (or leading-batched)."""

    h: torch.Tensor
    hu: torch.Tensor
    hv: torch.Tensor


@dataclass(frozen=True)
class SWPhysics:
    """Physical configuration."""

    g: float = 9.81
    cd: float = 0.0  # bottom drag
    f_cor: float = 0.0  # Coriolis
    # bathymetry fields; None for flat-bottom problems
    H: torch.Tensor | None = None  # still-water depth (K, Np)
    Hx: torch.Tensor | None = None  # bed slopes (K, Np)
    Hy: torch.Tensor | None = None
    sponge: torch.Tensor | None = None  # relaxation coefficient (K, Np)
    # hydrostatic-reconstruction well-balancing at faces; active only when
    # bathymetry (H) is present
    well_balanced: bool = True

    def to(self, device) -> "SWPhysics":
        return _tree_to(self, device)


def _safe_norm(u, v):
    """sqrt(u^2+v^2) with a zero (not NaN) gradient at the origin: required
    for differentiable rollouts through lake-at-rest states."""
    r2 = u * u + v * v
    pos = r2 > 0.0
    r = torch.sqrt(torch.where(pos, r2, torch.ones_like(r2)))
    return torch.where(pos, r, torch.zeros_like(r))


def _lf_flux_jumps(g, n_fp, nxf, nyf, hM, hP, huM, huP, hvM, hvP,
                   HM=None, HP=None):
    """Strong-form flux jumps (F(UM) - F^).n with per-face trace-max
    Lax-Friedrichs stabilization, on traces flattened over the last axis.

    Without bathymetry traces (HM/HP None) this is the plain LF flux. With
    them it applies hydrostatic-reconstruction well-balancing (Audusse et
    al.):

      b* = max(bM, bP),  h* = max(0, h + b - b*),  u* = u (velocity kept)
      F^ = 1/2 (F(U*M)+F(U*P)).n - 1/2 lam (q*P-q*M) + (0, g/2(hM^2-h*M^2).n)

    In strong form the pressure corrections cancel against F(UM)-F(U*M),
    leaving purely advective consistency terms (hM-h*M)(u.n)M.(1, uM, vM).
    At a lake at rest (h+b continuous, u=0) every term vanishes exactly.
    """
    if HM is not None:
        uM, vM = huM / hM, hvM / hM
        uP, vP = huP / hP, hvP / hP
        bstar = torch.maximum(-HM, -HP)
        hMs = torch.clamp_min(hM - HM - bstar, 0.0)
        hPs = torch.clamp_min(hP - HP - bstar, 0.0)
        corr = (hM - hMs) * (uM * nxf + vM * nyf)

        # flux tensors from (h*, u, v): no division by the (possibly dry)
        # starred depth anywhere
        def flux_uv(hh, uu, vv):
            p = 0.5 * g * hh * hh
            F1, G1 = hh * uu, hh * vv
            F2 = hh * uu * uu + p
            G2 = hh * uu * vv
            G3 = hh * vv * vv + p
            return F1, F2, G2, G1, G2, G3

        F1M, F2M, F3M, G1M, G2M, G3M = flux_uv(hMs, uM, vM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux_uv(hPs, uP, vP)
        spdM = _safe_norm(uM, vM) + torch.sqrt(g * hMs)
        spdP = _safe_norm(uP, vP) + torch.sqrt(g * hPs)
        dh, dhu, dhv = hMs - hPs, F1M - F1P, G1M - G1P
    else:
        def flux(hh, hhu, hhv):
            inv_h = 1.0 / hh
            p = 0.5 * g * hh * hh
            F2 = hhu * hhu * inv_h + p
            G2 = hhu * hhv * inv_h
            G3 = hhv * hhv * inv_h + p
            return hhu, F2, G2, hhv, G2, G3

        F1M, F2M, F3M, G1M, G2M, G3M = flux(hM, huM, hvM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux(hP, huP, hvP)
        spdM = _safe_norm(huM / hM, hvM / hM) + torch.sqrt(g * hM)
        spdP = _safe_norm(huP / hP, hvP / hP) + torch.sqrt(g * hP)
        dh, dhu, dhv = hM - hP, huM - huP, hvM - hvP
        corr = None

    spd = torch.maximum(spdM, spdP)
    lead = spd.shape[:-1]
    spd = spd.reshape(*lead, -1, n_fp)
    lam = torch.amax(spd, dim=-1, keepdim=True)  # max over each face
    lam = lam.expand(spd.shape).reshape(*lead, -1)

    dflux1 = 0.5 * ((F1M - F1P) * nxf + (G1M - G1P) * nyf - lam * dh)
    dflux2 = 0.5 * ((F2M - F2P) * nxf + (G2M - G2P) * nyf - lam * dhu)
    dflux3 = 0.5 * ((F3M - F3P) * nxf + (G3M - G3P) * nyf - lam * dhv)
    if corr is not None:
        dflux1 = dflux1 + corr
        dflux2 = dflux2 + corr * uM
        dflux3 = dflux3 + corr * vM
    return dflux1, dflux2, dflux3


def _volume_and_sources(ctx, phys, h, hu, hv, d1, d2, d3):
    """Volume flux divergence + lifted face jumps + source terms, for
    (..., K, Np) fields and (..., K*n_tr) flux jumps."""
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    g = phys.g
    lead = h.shape[:-2]

    inv_h = 1.0 / h
    F1, G1 = hu, hv
    F2 = hu * hu * inv_h + 0.5 * g * h * h
    G2 = hu * hv * inv_h
    F3 = G2
    G3 = hv * hv * inv_h + 0.5 * g * h * h

    def div(F, G):
        Fr, Fs = mm(F, ctx.Dr.T), mm(F, ctx.Ds.T)
        Gr, Gs = mm(G, ctx.Dr.T), mm(G, ctx.Ds.T)
        return ctx.rx * Fr + ctx.sx * Fs + ctx.ry * Gr + ctx.sy * Gs

    surf = lambda d: mm(ctx.fscale * d.reshape(*lead, K, n_tr), ctx.lift.T)
    rhs1 = -div(F1, G1) + surf(d1)
    rhs2 = -div(F2, G2) + surf(d2)
    rhs3 = -div(F3, G3) + surf(d3)

    # Source terms: bed slope, quadratic drag, Coriolis.
    if phys.Hx is not None:
        rhs2 = rhs2 + g * h * phys.Hx
        rhs3 = rhs3 + g * h * phys.Hy
    if phys.cd != 0.0:
        u, v = hu / h, hv / h
        norm_u = _safe_norm(u, v)
        rhs2 = rhs2 - phys.cd * norm_u * u
        rhs3 = rhs3 - phys.cd * norm_u * v
    if phys.f_cor != 0.0:
        rhs2 = rhs2 + phys.f_cor * hv
        rhs3 = rhs3 - phys.f_cor * hu
    return SWState(h=rhs1, hu=rhs2, hv=rhs3)


def sw2d_rhs(
    ctx: DGContext2D,
    state: SWState,
    t,
    phys: SWPhysics,
    tidal_forcing=None,
) -> SWState:
    """Strong-form DG RHS with per-face trace-max Lax-Friedrichs flux.

    ``state`` fields are (K, Np) or (..., K, Np) with leading batch axes
    (the JAX function is unbatched and vmapped; here batching is native).
    ``tidal_forcing(t)`` optionally returns the prescribed total water depth
    for BC_OUT open-boundary nodes.

    When bathymetry is present (phys.H) and phys.well_balanced, the face
    fluxes use hydrostatic-reconstruction star variables with the pressure
    correction (see _lf_flux_jumps) so lake-at-rest states over arbitrary,
    even inter-element-discontinuous, bathymetry produce a machine-zero RHS.
    """
    h, hu, hv = state
    hM, hP = ctx.surface_trace(h)
    huM, huP = ctx.surface_trace(hu)
    hvM, hvP = ctx.surface_trace(hv)

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # Wall BC: reflect the normal momentum component.
    wall_idx = ctx.bc_maps.idx[BC_WALL][ctx.bc_maps.mask[BC_WALL]]
    if wall_idx.numel() > 0:
        nxw, nyw = nxf[wall_idx], nyf[wall_idx]
        un2 = 2.0 * (huM[..., wall_idx] * nxw + hvM[..., wall_idx] * nyw)
        huP = huP.index_copy(-1, wall_idx, huM[..., wall_idx] - un2 * nxw)
        hvP = hvP.index_copy(-1, wall_idx, hvM[..., wall_idx] - un2 * nyw)

    # Open-boundary tidal forcing: prescribe h on BC_OUT nodes.
    if tidal_forcing is not None:
        ob_idx = ctx.bc_maps.idx[BC_OUT][ctx.bc_maps.mask[BC_OUT]]
        if ob_idx.numel() > 0:
            h_bc = torch.as_tensor(tidal_forcing(t), dtype=hP.dtype,
                                   device=hP.device)
            hP = hP.index_copy(
                -1, ob_idx,
                h_bc.expand(*hP.shape[:-1], ob_idx.numel()).contiguous())

    # Bathymetry traces for hydrostatic-reconstruction well-balancing.
    HMt = HPt = None
    if phys.H is not None and phys.well_balanced:
        HMt, HPt = ctx.surface_trace(phys.H)

    d1, d2, d3 = _lf_flux_jumps(
        phys.g, ctx.n_fp, nxf, nyf, hM, hP, huM, huP, hvM, hvP, HMt, HPt
    )
    return _volume_and_sources(ctx, phys, h, hu, hv, d1, d2, d3)


def apply_filter(ctx: DGContext2D, f: torch.Tensor) -> torch.Tensor:
    """Modal exponential filter application."""
    return mm(f, ctx.filter.T)
