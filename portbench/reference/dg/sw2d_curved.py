"""Frozen copy of ``blitzdg_tpu_torch/ops/sw2d_curved.py`` at commit dfe7828,
without the wetting and drying branch; every product through prec.mm or
prec.emm.

Curved/over-integrated shallow water: weak-form cubature volume integrals
+ Gauss-node surface integrals + per-element mass inverses.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_curved.py``
(``SWStateTracer``, ``sw2d_curved_rhs``, ``ssprk2_step_curved_wetdry``) and
the oracle of the curved kernels (``ops/sw2d_curved_blocked.py``): fields
interpolated to cubature nodes, weak derivatives Dr^T W (rx F + ry G),
Gauss-node traces with central + Lax-Friedrichs flux
0.5((FM+FP).n + lam (qM-qP)), per-element mass inverses applied as one
batched product, source terms (Coriolis, drag, bed slope), and a passive
tracer hN as fourth equation. Optional tidal depth on BC_OUT Gauss nodes
and wetting/drying on the traces. Plain eager tensor code, differentiable
by ``torch.autograd``; fields are (K, Np) or (..., K, Np) with leading batch
axes (the JAX function is unbatched and vmapped).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .context import BC_OUT, BC_WALL, DGContext2D
from .cubature import CubatureContext2D, GaussFaceContext2D
from .prec import emm, mm
from .sw2d import SWPhysics, _safe_norm


class SWStateTracer(NamedTuple):
    h: torch.Tensor
    hu: torch.Tensor
    hv: torch.Tensor
    hN: torch.Tensor  # passive tracer


def _fluxes(h, hu, hv, hN, g):
    inv_h = 1.0 / h
    u, v = hu * inv_h, hv * inv_h
    F1, G1 = hu, hv
    F2 = hu * u + 0.5 * g * h * h
    G2 = hu * v
    F3 = G2
    G3 = hv * v + 0.5 * g * h * h
    F4, G4 = hN * u, hN * v
    return (F1, F2, F3, F4), (G1, G2, G3, G4)


def sw2d_curved_rhs(
    ctx: DGContext2D,
    cub: CubatureContext2D,
    gauss: GaussFaceContext2D,
    state: SWStateTracer,
    t,
    phys: SWPhysics,
    zx: torch.Tensor | None = None,  # bed slope d(z)/dx at nodal points
    zy: torch.Tensor | None = None,
    tidal_forcing=None,  # callable t -> prescribed total depth on BC_OUT
) -> SWStateTracer:
    """Weak-form RHS."""
    K = ctx.k_elem
    g = phys.g
    h, hu, hv, hN = state
    lead = h.shape[:-2]

    # --- volume: interpolate to cubature, weak derivatives ---
    at_cub = lambda f: mm(f, cub.V.T)  # (..., K, Ncub)
    ch, chu, chv, chN = at_cub(h), at_cub(hu), at_cub(hv), at_cub(hN)
    (F1, F2, F3, F4), (G1, G2, G3, G4) = _fluxes(ch, chu, chv, chN, g)

    def weak_div(F, G):
        tr = cub.W * (cub.rx * F + cub.ry * G)
        ts = cub.W * (cub.sx * F + cub.sy * G)
        return mm(tr, cub.Dr) + mm(ts, cub.Ds)  # (..., K, Np): Dr^T from the right

    MMRHS1 = weak_div(F1, G1)
    MMRHS2 = weak_div(F2, G2)
    MMRHS3 = weak_div(F3, G3)
    MMRHS4 = weak_div(F4, G4)

    # --- surface: Gauss traces ---
    at_g = lambda f: mm(f, gauss.interp.T).reshape(*lead, -1)  # (..., K*3NG)
    gh, ghu, ghv, ghN = at_g(h), at_g(hu), at_g(hv), at_g(hN)
    mM = gauss.mapM.reshape(-1)
    mP = gauss.mapP.reshape(-1)
    hM, hP = gh[..., mM], gh[..., mP]
    huM, huP = ghu[..., mM], ghu[..., mP]
    hvM, hvP = ghv[..., mM], ghv[..., mP]
    hNM, hNP = ghN[..., mM], ghN[..., mP]

    nxf = gauss.nx.reshape(-1)
    nyf = gauss.ny.reshape(-1)

    # wall: reflect the normal momentum
    wall = gauss.bc_idx[BC_WALL][gauss.bc_mask[BC_WALL]]
    if wall.numel() > 0:
        nxw, nyw = nxf[wall], nyf[wall]
        un2 = 2.0 * (huM[..., wall] * nxw + hvM[..., wall] * nyw)
        huP = huP.index_copy(-1, wall, huM[..., wall] - un2 * nxw)
        hvP = hvP.index_copy(-1, wall, hvM[..., wall] - un2 * nyw)

    # tidal open boundary: prescribe the total depth on BC_OUT Gauss nodes
    if tidal_forcing is not None:
        ob = gauss.bc_idx[BC_OUT][gauss.bc_mask[BC_OUT]]
        if ob.numel() > 0:
            h_bc = torch.as_tensor(tidal_forcing(t), dtype=hP.dtype,
                                   device=hP.device)
            hP = hP.index_copy(
                -1, ob, h_bc.expand(*hP.shape[:-1], ob.numel()).contiguous())

    NG = gauss.n_gauss
    shape = (*lead, K, 3 * NG)
    (F1M, F2M, F3M, F4M), (G1M, G2M, G3M, G4M) = _fluxes(hM, huM, hvM, hNM, g)
    (F1P, F2P, F3P, F4P), (G1P, G2P, G3P, G4P) = _fluxes(hP, huP, hvP, hNP, g)
    spdM = _safe_norm(huM / hM, hvM / hM) + torch.sqrt(g * hM)
    spdP = _safe_norm(huP / hP, hvP / hP) + torch.sqrt(g * hP)
    q1M, q1P = hM, hP
    q2M, q2P = huM, huP
    q3M, q3P = hvM, hvP
    q4M, q4P = hNM, hNP

    spd = torch.maximum(spdM, spdP).reshape(*lead, K * 3, NG)
    lam = torch.amax(spd, dim=-1, keepdim=True).expand(spd.shape)
    lam = lam.reshape(*lead, -1)

    def face_flux(FM, FP, GM, GP, qM, qP):
        return (0.5 * ((FM + FP) * nxf + (GM + GP) * nyf
                       + lam * (qM - qP))).reshape(shape)

    flux1 = face_flux(F1M, F1P, G1M, G1P, q1M, q1P)
    flux2 = face_flux(F2M, F2P, G2M, G2P, q2M, q2P)
    flux3 = face_flux(F3M, F3P, G3M, G3P, q3M, q3P)
    flux4 = face_flux(F4M, F4P, G4M, G4P, q4M, q4P)

    MMRHS1 = MMRHS1 - mm(gauss.W * flux1, gauss.interp)
    MMRHS2 = MMRHS2 - mm(gauss.W * flux2, gauss.interp)
    MMRHS3 = MMRHS3 - mm(gauss.W * flux3, gauss.interp)
    MMRHS4 = MMRHS4 - mm(gauss.W * flux4, gauss.interp)

    # --- per-element mass inverse: one batched product over K ---
    inv = lambda f: emm(cub.MMinv, f)
    RHS1 = inv(MMRHS1)
    RHS2 = inv(MMRHS2)
    RHS3 = inv(MMRHS3)
    RHS4 = inv(MMRHS4)

    # --- sources (-cd |u| u in both momentum equations) ---
    u, v = hu / h, hv / h
    cd_norm = phys.cd * _safe_norm(u, v)
    RHS2 = RHS2 + phys.f_cor * hv - cd_norm * u
    RHS3 = RHS3 - phys.f_cor * hu - cd_norm * v
    if zx is not None:
        RHS2 = RHS2 - g * h * zx
        RHS3 = RHS3 - g * h * zy

    return SWStateTracer(h=RHS1, hu=RHS2, hv=RHS3, hN=RHS4)
