"""Wetting/drying shallow water on the gather RHS: the oracle for the
wet/dry branch of the blocked kernels.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_wetdry.py``:

 - ``sw2d_rhs_wetdry``: the shallow-water RHS with ``surface_reconstruction``
   applied to the face traces. Bed elevations are reconstructed with the
   minmod of the inter-element bed jump, the '+' surface is corrected, and
   both water columns are floored at ``h_floor``. Momentum traces keep the
   trace VELOCITY (hu* = h* u), the hydrostatic-reconstruction idea of the
   well-balanced flux.
 - ``ssprk2_step_wetdry``: RK2 with ``positivity_preserving_limiter`` and a
   near-dry momentum taper applied after EVERY stage, so that h stays
   >= ~h_floor through drying events.

States are (K, Np) or (..., K, Np) with leading batch axes.
"""
from __future__ import annotations

import torch

from ..config import check_matmul_precision
from ..context import BC_WALL, DGContext2D
from .limiters import positivity_preserving_limiter, surface_reconstruction
from .sw2d import SWPhysics, SWState, _safe_norm, apply_filter


def sw2d_rhs_wetdry(
    ctx: DGContext2D,
    state: SWState,
    t,
    phys: SWPhysics,
    h_floor: float = 1e-3,
) -> SWState:
    """Shallow-water RHS with hydrostatic minmod surface reconstruction of
    the face traces (requires ``phys.H`` bathymetry; bed z = -H)."""
    if phys.H is None:
        raise ValueError("wetting/drying needs bathymetry (phys.H)")
    K, n_fp, n_faces = ctx.k_elem, ctx.n_fp, ctx.n_faces
    n_tr = n_faces * n_fp
    g = phys.g

    h, hu, hv = state
    lead = h.shape[:-2]
    hM, hP = ctx.surface_trace(h)
    huM, huP = ctx.surface_trace(hu)
    hvM, hvP = ctx.surface_trace(hv)
    HMt, HPt = ctx.surface_trace(phys.H)

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # Wall reflection before reconstruction (same order as sw2d_rhs).
    wall_idx = ctx.bc_maps.idx[BC_WALL][ctx.bc_maps.mask[BC_WALL]]
    if wall_idx.numel() > 0:
        nxw, nyw = nxf[wall_idx], nyf[wall_idx]
        un2 = 2.0 * (huM[..., wall_idx] * nxw + hvM[..., wall_idx] * nyw)
        huP = huP.index_copy(-1, wall_idx, huM[..., wall_idx] - un2 * nxw)
        hvP = hvP.index_copy(-1, wall_idx, hvM[..., wall_idx] - un2 * nyw)

    # Hydrostatic minmod reconstruction: eta = h - H (free surface), then
    # floor the reconstructed columns.
    etaM, etaP = hM - HMt, hP - HPt
    hMs, hPs = surface_reconstruction(etaM, hM, etaP, hP, h_floor)

    # Keep trace velocities: hu* = h* u. Desingularized division: near the
    # floor depth the effective velocity is damped toward zero instead of
    # blowing up as hu/h -> momentum/(tiny).
    eps2 = (4.0 * h_floor) ** 2

    def vel(hh, hhu, hhv):
        inv = hh / (hh * hh + torch.clamp_min(hh * hh, eps2)) * 2.0
        return hhu * inv, hhv * inv

    uM, vM = vel(hM, huM, hvM)
    uP, vP = vel(hP, huP, hvP)

    def flux_uv(hh, uu, vv):
        p = 0.5 * g * hh * hh
        return (hh * uu, hh * uu * uu + p, hh * uu * vv,
                hh * vv, hh * uu * vv, hh * vv * vv + p)

    F1M, F2M, F3M, G1M, G2M, G3M = flux_uv(hMs, uM, vM)
    F1P, F2P, F3P, G1P, G2P, G3P = flux_uv(hPs, uP, vP)
    spdM = _safe_norm(uM, vM) + torch.sqrt(g * hMs)
    spdP = _safe_norm(uP, vP) + torch.sqrt(g * hPs)
    # advective consistency correction (strong form)
    corr = (hM - hMs) * (uM * nxf + vM * nyf)

    spd = torch.maximum(spdM, spdP).reshape(*lead, -1, n_fp)
    lam = torch.amax(spd, dim=-1, keepdim=True)
    lam = lam.expand(spd.shape).reshape(*lead, -1)

    dflux1 = 0.5 * ((F1M - F1P) * nxf + (G1M - G1P) * nyf - lam * (hMs - hPs))
    dflux2 = 0.5 * ((F2M - F2P) * nxf + (G2M - G2P) * nyf - lam * (F1M - F1P))
    dflux3 = 0.5 * ((F3M - F3P) * nxf + (G3M - G3P) * nyf - lam * (G1M - G1P))
    dflux1 = dflux1 + corr
    dflux2 = dflux2 + corr * uM
    dflux3 = dflux3 + corr * vM

    # Volume terms with desingularized velocities.
    inv = 2.0 * h / (h * h + torch.clamp_min(h * h, eps2))
    u, v = hu * inv, hv * inv
    F1, F2, F3 = hu, h * u * u + 0.5 * g * h * h, h * u * v
    G1, G2, G3 = hv, h * u * v, h * v * v + 0.5 * g * h * h

    check_matmul_precision(h)

    def div(F, G):
        Fr, Fs = F @ ctx.Dr.T, F @ ctx.Ds.T
        Gr, Gs = G @ ctx.Dr.T, G @ ctx.Ds.T
        return ctx.rx * Fr + ctx.sx * Fs + ctx.ry * Gr + ctx.sy * Gs

    surf = lambda d: (ctx.fscale * d.reshape(*lead, K, n_tr)) @ ctx.lift.T
    rhs1 = -div(F1, G1) + surf(dflux1)
    rhs2 = -div(F2, G2) + surf(dflux2)
    rhs3 = -div(F3, G3) + surf(dflux3)

    if phys.Hx is not None:
        # Mask the bed-slope source in DRY cells (h at the floor): there the
        # pressure-gradient term it is meant to balance is zero, so an
        # unmasked source drives downhill creep that slowly drains dry cells
        # negative (standard wet/dry treatment).
        wet = (h > 5.0 * h_floor).to(h.dtype)
        rhs2 = rhs2 + g * h * phys.Hx * wet
        rhs3 = rhs3 + g * h * phys.Hy * wet
    if phys.cd != 0.0:
        nrm = _safe_norm(u, v)
        rhs2 = rhs2 - phys.cd * nrm * u
        rhs3 = rhs3 - phys.cd * nrm * v

    return SWState(h=rhs1, hu=rhs2, hv=rhs3)


def ssprk2_step_wetdry(
    ctx: DGContext2D,
    state: SWState,
    t,
    dt,
    phys: SWPhysics,
    h_floor: float = 1e-3,
    use_filter: bool = True,
    scheme: str = "heun",
) -> SWState:
    """RK2 with the positivity limiter applied after every stage.

    ``scheme='heun'`` (DEFAULT) is true SSP-RK2
    (u1 = u + dt R(u); u <- u/2 + (u1 + dt R(u1))/2): each stage is a
    forward-Euler step and the final update a convex combination of limited
    states, so per-stage limiting preserves cell-mean positivity under the
    SSP CFL. ``scheme='midpoint'`` is the predictor-corrector that the
    blocked kernels run (u1 = u + dt/2 R(u); u <- u + dt R(u1)); there the
    positivity guarantee is only empirical."""

    def limit(s: SWState) -> SWState:
        h, hu, hv = positivity_preserving_limiter(
            s.h, s.hu, s.hv, h_floor=h_floor)
        # near-dry momentum taper: water that thin carries no resolvable
        # momentum; without this the wetting front's u = hu/h violates any
        # fixed-dt CFL and blows up.
        taper = torch.clamp((h - h_floor) / (4.0 * h_floor), 0.0, 1.0)
        return SWState(h=h, hu=hu * taper, hv=hv * taper)

    def eval_rhs(s, tt):
        r = sw2d_rhs_wetdry(ctx, s, tt, phys, h_floor)
        if use_filter:
            r = SWState(*(apply_filter(ctx, f) for f in r))
        return r

    if scheme == "heun":
        k1 = eval_rhs(state, t)
        s1 = limit(SWState(*(u + dt * k for u, k in zip(state, k1))))
        k2 = eval_rhs(s1, t + dt)
        s2 = SWState(*(0.5 * u + 0.5 * (u1 + dt * k)
                       for u, u1, k in zip(state, s1, k2)))
        return limit(s2)
    k1 = eval_rhs(state, t)
    s1 = limit(SWState(*(u + 0.5 * dt * k for u, k in zip(state, k1))))
    k2 = eval_rhs(s1, t + 0.5 * dt)
    s2 = SWState(*(u + dt * k for u, k in zip(state, k2)))
    return limit(s2)
