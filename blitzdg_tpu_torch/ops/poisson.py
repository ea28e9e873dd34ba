"""Matrix-free interior-penalty Poisson/Laplacian operators (1D and 2D),
and their host-assembled counterparts.

Counterpart of the JAX package's ``blitzdg_tpu/ops/poisson.py`` (same
names, same conventions): the 1D SIP operator (tau = Np^2/hmin, symmetrized
by J*M), the 2D LDG/IP operator (central gradient flux, Dirichlet uP = -uM
on Wall/Dirichlet tags, Neumann gradient mirror, tau = (N+1)^2 max Fscale),
the curved cubature/Gauss LDG and SIP operators, the mass weightings, and
the scipy assemblies of the nodal and curved SIP operators and of the
boundary-data load vector.

The device operators are plain tensor code and take fields ``(..., K, Np)``
with any leading batch axes (the JAX functions are unbatched and vmapped).
On the card they check that matrix products are full float32
(``config.check_matmul_precision``, the counterpart of ``dg_op``). They are
written for any ``n_faces``. The assemblies are host numpy/scipy in float64
from the context's fields.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import check_matmul_precision
from ..context import BC_DIRICHLET, BC_NEUMAN, BC_WALL, DGContext1D, DGContext2D


def _set_where(t: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
               value: torch.Tensor) -> torch.Tensor:
    """Copy of ``t`` with ``t[..., idx] = value`` where ``mask`` holds (the
    padded per-tag boundary lists)."""
    out = t.clone()
    out[..., idx] = torch.where(mask, value, t[..., idx])
    return out


def _host(a) -> np.ndarray:
    return a.detach().to("cpu", torch.float64).numpy()


def _idx(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def poisson2d_op(
    ctx: DGContext2D,
    u: torch.Tensor,
    tau: float | None = None,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
    symmetrize: bool = False,
) -> torch.Tensor:
    """Apply the 2D IP Laplacian to u: (..., K, Np) -> (..., K, Np).

    With ``symmetrize`` the output is J*M*(L u): the operator is then
    symmetric negative definite (use CG on -A).
    """
    check_matmul_precision(u)
    lead = u.shape[:-2]
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    if tau is None:
        # standard SIP penalty (N+1)^2 / h (not the reference's Np max(J)/2,
        # which is below the coercivity threshold)
        tau = (ctx.n_order + 1) ** 2 * torch.max(ctx.fscale)

    ux, uy = ctx.grad(u)
    uM, uP = ctx.surface_trace(u)
    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    # Dirichlet: uP = -uM (zero trace); Neumann handled on the gradient
    for tag in dirichlet_tags:
        idx, mask = ctx.bc_maps.idx[tag], ctx.bc_maps.mask[tag]
        uP = _set_where(uP, idx, mask, -uM[..., idx])

    du = uM - uP
    du_mat = du.reshape(*lead, K, n_tr)

    # auxiliary gradient with central flux: q = grad u - Lift(n du / 2)
    qx = ux - ((ctx.fscale * ctx.nx * du_mat * 0.5) @ ctx.lift.T)
    qy = uy - ((ctx.fscale * ctx.ny * du_mat * 0.5) @ ctx.lift.T)

    uxM, uxP = ctx.surface_trace(ux)
    uyM, uyP = ctx.surface_trace(uy)
    qxM, _ = ctx.surface_trace(qx)
    qyM, _ = ctx.surface_trace(qy)

    # Neumann: mirror the gradient so the normal component cancels
    for tag in neumann_tags:
        idx, mask = ctx.bc_maps.idx[tag], ctx.bc_maps.mask[tag]
        un = uxM[..., idx] * nxf[idx] + uyM[..., idx] * nyf[idx]
        uxP = _set_where(uxP, idx, mask, uxM[..., idx] - 2.0 * nxf[idx] * un)
        uyP = _set_where(uyP, idx, mask, uyM[..., idx] - 2.0 * nyf[idx] * un)

    # interior-penalty flux of the divergence stage: q* = {grad u}
    dqx = qxM - 0.5 * (uxM + uxP)
    dqy = qyM - 0.5 * (uyM + uyP)
    surf = (ctx.nx * dqx.reshape(*lead, K, n_tr)
            + ctx.ny * dqy.reshape(*lead, K, n_tr) + tau * du_mat)

    qxr, qxs = qx @ ctx.Dr.T, qx @ ctx.Ds.T
    qyr, qys = qy @ ctx.Dr.T, qy @ ctx.Ds.T
    lap = (ctx.rx * qxr + ctx.sx * qxs + ctx.ry * qyr + ctx.sy * qys
           - (ctx.fscale * surf) @ ctx.lift.T)

    if symmetrize:
        M = ctx.Vinv.T @ ctx.Vinv
        lap = ctx.J * (lap @ M.T)
    return lap


def poisson1d_op(
    ctx: DGContext1D,
    u: torch.Tensor,
    tau: float | None = None,
    symmetrize: bool = True,
) -> torch.Tensor:
    """1D SIP Laplacian (Dirichlet u=0 at both ends), u: (..., K, Np) ->
    (..., K, Np)."""
    check_matmul_precision(u)
    lead = u.shape[:-2]
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    n_p = ctx.n_p
    if tau is None:
        tau = n_p * n_p * torch.max(1.0 / ctx.J) / 2.0  # Np^2/hmin

    ux = ctx.rx * (u @ ctx.Dr.T)
    uM, uP = ctx.surface_trace(u)
    # Dirichlet at both domain ends: uP = -uM
    uP = uP.clone()
    uP[..., ctx.mapI] = -uM[..., ctx.mapI]
    uP[..., ctx.mapO] = -uM[..., ctx.mapO]
    du = (uM - uP).reshape(*lead, K, n_tr)

    q = ux - ((ctx.fscale * ctx.nx * du * 0.5) @ ctx.lift.T)
    qM, _ = ctx.surface_trace(q)
    uxM, uxP = ctx.surface_trace(ux)
    dq = (qM - 0.5 * (uxM + uxP)).reshape(*lead, K, n_tr)

    # nx*(dq + tau*nx*du) with nx^2 = 1
    surf = ctx.nx * dq + tau * du
    lap = ctx.rx * (q @ ctx.Dr.T) - (ctx.fscale * surf) @ ctx.lift.T
    if symmetrize:
        M = ctx.Vinv.T @ ctx.Vinv
        lap = ctx.J * (lap @ M.T)
    return lap


def apply_mass(ctx, f: torch.Tensor) -> torch.Tensor:
    """J * (M f): the weak-form load-vector weighting."""
    check_matmul_precision(f)
    M = ctx.Vinv.T @ ctx.Vinv
    return ctx.J * (f @ M.T)


def apply_mass_curved(cub, f: torch.Tensor) -> torch.Tensor:
    """Curved weak load (f, v) by cubature, exact for curved Jacobians."""
    check_matmul_precision(f)
    fc = f @ cub.V.T
    return (cub.W * fc) @ cub.V


def poisson2d_curved_op(
    ctx: DGContext2D,
    cub,
    gauss,
    u: torch.Tensor,
    tau: float | None = None,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
) -> torch.Tensor:
    """Curved, over-integrated matrix-free LDG Poisson operator: cubature
    volume integrals and Gauss-node surface integrals, central gradient
    flux plus penalty, Dirichlet by uP = -uM, Neumann by the gradient
    mirror. Returns the M-weighted residual (M A u), symmetric positive
    semi-definite: pair it with ``apply_mass_curved`` and CG."""
    check_matmul_precision(u)
    lead = u.shape[:-2]
    K = ctx.k_elem
    n_g = ctx.n_faces * gauss.n_gauss
    if tau is None:
        tau = (ctx.n_order + 1) ** 2 * torch.max(ctx.fscale)

    def at_g(f):
        return (f @ gauss.interp.T).reshape(*lead, -1)

    gu = at_g(u)
    mM = gauss.mapM.reshape(-1)
    mP = gauss.mapP.reshape(-1)
    uM, uP = gu[..., mM], gu[..., mP]
    for tag in dirichlet_tags:
        idx, mask = gauss.bc_idx[tag], gauss.bc_mask[tag]
        uP = _set_where(uP, idx, mask, -uM[..., idx])
    ustar = 0.5 * (uM + uP)
    du = (uM - uP).reshape(*lead, K, n_g)
    nxf = gauss.nx.reshape(-1)
    nyf = gauss.ny.reshape(-1)

    # pass 1: weak gradient, (q, v) = -(u, grad v) + <u* n, v>
    uc = u @ cub.V.T

    def weak(tx, ty):
        return (cub.W * tx) @ cub.Dr + (cub.W * ty) @ cub.Ds

    sx_u = (gauss.W * (ustar * nxf).reshape(*lead, K, n_g)) @ gauss.interp
    sy_u = (gauss.W * (ustar * nyf).reshape(*lead, K, n_g)) @ gauss.interp
    MMqx = -weak(cub.rx * uc, cub.sx * uc) + sx_u
    MMqy = -weak(cub.ry * uc, cub.sy * uc) + sy_u

    def inv(mm):
        return torch.einsum("kij,...kj->...ki", cub.MMinv, mm)

    qx, qy = inv(MMqx), inv(MMqy)

    # traces of q, Neumann gradient mirror
    gqx, gqy = at_g(qx), at_g(qy)
    qxM, qxP = gqx[..., mM], gqx[..., mP]
    qyM, qyP = gqy[..., mM], gqy[..., mP]
    for tag in neumann_tags:
        idx, mask = gauss.bc_idx[tag], gauss.bc_mask[tag]
        qn = qxM[..., idx] * nxf[idx] + qyM[..., idx] * nyf[idx]
        qxP = _set_where(qxP, idx, mask, qxM[..., idx] - 2.0 * nxf[idx] * qn)
        qyP = _set_where(qyP, idx, mask, qyM[..., idx] - 2.0 * nyf[idx] * qn)

    qnstar = (0.5 * ((qxM + qxP) * nxf + (qyM + qyP) * nyf)
              ).reshape(*lead, K, n_g) - tau * du

    # pass 2: weak divergence, (M A u) = (q, grad v) - <qn*, v>
    qxc, qyc = qx @ cub.V.T, qy @ cub.V.T
    vol = weak(cub.rx * qxc + cub.ry * qyc, cub.sx * qxc + cub.sy * qyc)
    return vol - (gauss.W * qnstar) @ gauss.interp


def poisson2d_curved_sip_op(
    ctx: DGContext2D,
    cub,
    gauss,
    u: torch.Tensor,
    tau_scale: float = 1.0,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
) -> torch.Tensor:
    """Curved SIP (primal) Poisson operator, matrix-free: cubature volume
    integrals (grad u, grad v) plus Gauss-node face terms

        + int_f [ tau (uM-uP)/2 - (DnM u + DnP u)/2 ] v
        - int_f (uM-uP)/2 Dn v

    with tau = tau_scale 100^2 2 (N+1)^2 max(hinvM, hinvP): the bilinear
    form ``assemble_poisson2d_curved`` assembles. Dirichlet faces: uP = -uM,
    DnP = DnM; Neumann faces: natural (zero jump, zero mean normal
    derivative). Returns the M-weighted SPD residual (M A u)."""
    check_matmul_precision(u)
    if gauss.Dr is None:
        raise ValueError("gauss context lacks derivative factors; rebuild")
    lead = u.shape[:-2]
    K, nf = ctx.k_elem, ctx.n_faces
    NG = gauss.n_gauss
    n_g = nf * NG

    # volume: (grad u, grad v) over cubature
    ur, us = u @ cub.Dr.T, u @ cub.Ds.T
    ux = cub.rx * ur + cub.sx * us
    uy = cub.ry * ur + cub.sy * us
    vol = ((cub.W * (ux * cub.rx + uy * cub.ry)) @ cub.Dr
           + (cub.W * (ux * cub.sx + uy * cub.sy)) @ cub.Ds)

    # traces and one-sided normal derivatives at the face Gauss nodes
    gu = (u @ gauss.interp.T).reshape(*lead, -1)
    gur, gus = u @ gauss.Dr.T, u @ gauss.Ds.T
    gux = gauss.rx * gur + gauss.sx * gus
    guy = gauss.ry * gur + gauss.sy * gus
    dn = (gauss.nx * gux + gauss.ny * guy).reshape(*lead, -1)

    mM = gauss.mapM.reshape(-1)
    mP = gauss.mapP.reshape(-1)
    uM, uP = gu[..., mM], gu[..., mP]
    dnM = dn[..., mM]
    dnP = -dn[..., mP]  # neighbor derivative along the '-' normal
    for tag in dirichlet_tags:
        idx, mask = gauss.bc_idx[tag], gauss.bc_mask[tag]
        uP = _set_where(uP, idx, mask, -uM[..., idx])
        dnP = _set_where(dnP, idx, mask, dnM[..., idx])

    # penalty from the nodal Fscale's first face node, two-sided max
    hinv_face = ctx.fscale.reshape(K, nf, ctx.n_fp)[:, :, 0]
    hM = torch.repeat_interleave(hinv_face, NG, dim=1).reshape(-1)
    hP = hinv_face.reshape(-1)[mP // NG]
    gtau = (tau_scale * 100.0 ** 2 * 2.0 * (ctx.n_order + 1) ** 2
            * torch.maximum(hM, hP))

    jump = uM - uP
    s1 = (0.5 * gtau * jump - 0.5 * (dnM + dnP)).reshape(*lead, K, n_g)
    out = vol + (gauss.W * s1) @ gauss.interp

    # symmetry term: -(1/2) jump lifted through the normal derivative
    z = gauss.W * (0.5 * jump).reshape(*lead, K, n_g)
    zx, zy = z * gauss.nx, z * gauss.ny
    return out - ((zx * gauss.rx + zy * gauss.ry) @ gauss.Dr
                  + (zx * gauss.sx + zy * gauss.sy) @ gauss.Ds)


# ---------------------------------------------------------------------------
# Host-side assembled SIP operators (verification oracle, direct solves,
# preconditioner set-up)
# ---------------------------------------------------------------------------

def _edge_masses(ctx: DGContext2D) -> list:
    """1D mass matrices on each face's nodes: the face coordinate is the
    one that varies along the face, (r, r, s) on triangles and (r, s, r, s)
    on quadrilaterals (f0: s=-1, f1: r=+1, f2: s=+1, f3: r=-1)."""
    from ..specgrid.vandermonde import vandermonde_1d

    r, s = _host(ctx.r), _host(ctx.s)
    fmask = _idx(ctx.fmask)
    face_coord = (r, r, s) if ctx.n_faces == 3 else (r, s, r, s)
    out = []
    for f in range(ctx.n_faces):
        v1d = vandermonde_1d(ctx.n_order, face_coord[f][fmask[f]])
        out.append(np.linalg.inv(v1d @ v1d.T))
    return out


def assemble_poisson2d(ctx: DGContext2D, bordered: bool = False):
    """Assemble the global sparse SIP Poisson operator and mass matrix on
    the host (scipy): volume term J (Dx^T M Dx + Dy^T M Dy), SIP face terms
    with penalty gtau = 100^2 2 (N+1)^2 hinv per face (hinv the larger of
    the two sides), Dirichlet on Wall/Dirichlet tags, nothing on Neumann
    faces. Returns (OP, MM) as scipy CSR over the (K*Np,) element-major
    numbering. ``bordered`` appends the row and column of ones for
    pure-Neumann solvability."""
    import scipy.sparse as sp

    K, n_p, n_fp, n_faces = ctx.k_elem, ctx.n_p, ctx.n_fp, ctx.n_faces
    Dr, Ds, V = _host(ctx.Dr), _host(ctx.Ds), _host(ctx.V)
    M = np.linalg.inv(V @ V.T)
    fmask = _idx(ctx.fmask).reshape(n_faces, n_fp)
    rx, ry = _host(ctx.rx), _host(ctx.ry)
    sx, sy = _host(ctx.sx), _host(ctx.sy)
    J = _host(ctx.J)
    sJ = _host(ctx.sJ).reshape(K, n_faces, n_fp)
    nx = _host(ctx.nx).reshape(K, n_faces, n_fp)
    ny = _host(ctx.ny).reshape(K, n_faces, n_fp)
    fscale = _host(ctx.fscale).reshape(K, n_faces, n_fp)
    vmapM = _idx(ctx.vmapM).reshape(K, n_faces, n_fp)
    vmapP = _idx(ctx.vmapP).reshape(K, n_faces, n_fp)
    mass_edge = _edge_masses(ctx)
    bc_table = _idx(ctx.bc_table) if ctx.bc_table is not None else None
    face_nbr = (_idx(ctx.face_nbr).reshape(K, n_faces)
                if ctx.face_nbr is not None else None)

    rows, cols, vals = [], [], []
    mrows, mcols, mvals = [], [], []
    for k in range(K):
        Dx = rx[k, 0] * Dr + sx[k, 0] * Ds  # affine: constant metric
        Dy = ry[k, 0] * Dr + sy[k, 0] * Ds
        OP11 = J[k, 0] * (Dx.T @ M @ Dx + Dy.T @ M @ Dy)
        gids = k * n_p + np.arange(n_p)
        for f in range(n_faces):
            fm = fmask[f]
            ndotdx = nx[k, f, 0] * Dx[fm, :] + ny[k, f, 0] * Dy[fm, :]
            mass_f = mass_edge[f] * sJ[k, f, 0]
            # a symmetric penalty: the larger hinv of the two sides
            hinv = fscale[k, f, 0]
            if face_nbr is not None:
                nbr = face_nbr[k, f]
                hinv = max(hinv, fscale[nbr // n_faces, nbr % n_faces, 0])
            gtau = 100.0 ** 2 * 2.0 * (ctx.n_order + 1) ** 2 * hinv

            if np.all(vmapP[k, f, :] == vmapM[k, f, :]):  # boundary face
                if bc_table is not None and bc_table[k, f] == BC_NEUMAN:
                    continue  # natural BC: data enters assemble_bc_rhs only
                OP11[np.ix_(fm, fm)] += gtau * mass_f
                OP11[fm, :] -= mass_f @ ndotdx
                OP11[:, fm] -= ndotdx.T @ mass_f
            else:
                k2 = vmapP[k, f, 0] // n_p
                fm2_nodes = vmapP[k, f, :] - k2 * n_p
                Dx2 = rx[k2, 0] * Dr + sx[k2, 0] * Ds
                Dy2 = ry[k2, 0] * Dr + sy[k2, 0] * Ds
                ndotdx2 = (nx[k, f, 0] * Dx2[fm2_nodes, :]
                           + ny[k, f, 0] * Dy2[fm2_nodes, :])
                OP11[np.ix_(fm, fm)] += gtau * mass_f
                OP11[fm, :] -= 0.5 * (mass_f @ ndotdx)
                OP11[:, fm] -= 0.5 * (ndotdx.T @ mass_f)

                # coupling: penalty -gtau [u][v], consistency
                # -1/2 (n.grad u+) v-, symmetry +1/2 (n.grad v-) u+
                OP12 = np.zeros((n_p, n_p))
                OP12[np.ix_(fm, fm2_nodes)] = -gtau * mass_f
                OP12[fm, :] -= 0.5 * (mass_f @ ndotdx2)
                OP12[:, fm2_nodes] += 0.5 * (ndotdx.T @ mass_f)
                gids2 = k2 * n_p + np.arange(n_p)
                rows.append(np.repeat(gids, n_p))
                cols.append(np.tile(gids2, n_p))
                vals.append(OP12.reshape(-1))

        rows.append(np.repeat(gids, n_p))
        cols.append(np.tile(gids, n_p))
        vals.append(OP11.reshape(-1))
        mrows.append(np.repeat(gids, n_p))
        mcols.append(np.tile(gids, n_p))
        mvals.append((J[k, 0] * M).reshape(-1))

    n = K * n_p
    shape = (n + 1, n + 1) if bordered else (n, n)
    if bordered:
        ones = np.arange(n)
        rows += [np.full(n, n), ones]
        cols += [ones, np.full(n, n)]
        vals += [np.ones(n), np.ones(n)]
    OP = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=shape)
    MM = sp.csr_matrix(
        (np.concatenate(mvals), (np.concatenate(mrows), np.concatenate(mcols))),
        shape=(n, n))
    return OP, MM


def assemble_poisson2d_curved(
    ctx: DGContext2D,
    cub,
    gauss,
    tau_scale: float = 1.0,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
    bordered: bool = False,
):
    """Assemble the curved (cubature/Gauss) SIP Poisson operator and the
    per-element cubature mass matrices on the host (scipy): the oracle of
    ``poisson2d_curved_sip_op``. Per element the volume term
    cDx^T diag(W) cDx + cDy^T diag(W) cDy; per face Gauss-node SIP terms
    with gtau = tau_scale 100^2 2 (N+1)^2 max(hinvM, hinvP) and the
    neighbor coupling in the '+' trace's node order (with the reference's
    defects corrected as in the JAX package: the neighbor's own Jacobian,
    the standard Dirichlet triple, a proper (Np, Np) coupling block).
    Returns (OP, MM) scipy CSR over the (K*Np,) element-major numbering."""
    import scipy.sparse as sp

    if gauss.Dr is None:
        raise ValueError("gauss context lacks derivative factors; rebuild")
    K, n_p, n_faces = ctx.k_elem, ctx.n_p, ctx.n_faces
    NG = gauss.n_gauss
    n_g = n_faces * NG

    cDr, cDs = _host(cub.Dr), _host(cub.Ds)
    cW = _host(cub.W)
    crx, cry = _host(cub.rx), _host(cub.ry)
    csx, csy = _host(cub.sx), _host(cub.sy)
    MMk = _host(cub.MM)
    ginterp = _host(gauss.interp)
    gDr, gDs = _host(gauss.Dr), _host(gauss.Ds)
    grx, gry = _host(gauss.rx), _host(gauss.ry)
    gsx, gsy = _host(gauss.sx), _host(gauss.sy)
    gW = _host(gauss.W).reshape(K, n_faces, NG)
    gnx = _host(gauss.nx).reshape(K, n_faces, NG)
    gny = _host(gauss.ny).reshape(K, n_faces, NG)
    mapM = _idx(gauss.mapM).reshape(K, n_faces, NG)
    mapP = _idx(gauss.mapP).reshape(K, n_faces, NG)
    fscale = _host(ctx.fscale).reshape(K, n_faces, ctx.n_fp)
    bc_table = _idx(ctx.bc_table)

    # per-element cartesian derivative matrices at the face Gauss nodes
    gDx = grx[:, :, None] * gDr[None] + gsx[:, :, None] * gDs[None]
    gDy = gry[:, :, None] * gDr[None] + gsy[:, :, None] * gDs[None]

    rows, cols, vals = [], [], []
    mrows, mcols, mvals = [], [], []
    blk = np.arange(n_p)

    def insert(kr, kc, block):
        rows.append(np.repeat(kr * n_p + blk, n_p))
        cols.append(np.tile(kc * n_p + blk, n_p))
        vals.append(np.asarray(block).ravel())

    for k in range(K):
        cDx = crx[k][:, None] * cDr + csx[k][:, None] * cDs
        cDy = cry[k][:, None] * cDr + csy[k][:, None] * cDs
        OP11 = cDx.T @ (cW[k][:, None] * cDx) + cDy.T @ (cW[k][:, None] * cDy)
        for f in range(n_faces):
            iM = slice(f * NG, (f + 1) * NG)
            jP = mapP[k, f]
            w = gW[k, f]
            gVM = ginterp[iM]
            gDnM = (gnx[k, f][:, None] * gDx[k][iM]
                    + gny[k, f][:, None] * gDy[k][iM])
            WgVM = w[:, None] * gVM
            if bool(np.all(jP == mapM[k, f])):  # boundary face
                if bc_table[k, f] in dirichlet_tags:
                    gtau = (tau_scale * 100.0 ** 2 * 2.0
                            * (ctx.n_order + 1) ** 2 * fscale[k, f, 0])
                    OP11 += (gtau * (gVM.T @ WgVM)
                             - gVM.T @ (w[:, None] * gDnM) - gDnM.T @ WgVM)
                continue  # Neumann/other: natural BC, no face terms

            k2 = int(jP[0] // n_g)
            j2 = jP % n_g
            f2 = int(j2[0] // NG)
            gVP = ginterp[j2]  # '+' rows in matched (reversed) order
            gDnP = (gnx[k, f][:, None] * gDx[k2][j2]
                    + gny[k, f][:, None] * gDy[k2][j2])
            WgVP = w[:, None] * gVP
            hinv = max(fscale[k, f, 0], fscale[k2, f2, 0])
            gtau = tau_scale * 100.0 ** 2 * 2.0 * (ctx.n_order + 1) ** 2 * hinv
            OP11 += 0.5 * (gtau * (gVM.T @ WgVM)
                           - gVM.T @ (w[:, None] * gDnM) - gDnM.T @ WgVM)
            OP12 = (-0.5 * gtau * (gVM.T @ WgVP)
                    - 0.5 * gVM.T @ (w[:, None] * gDnP)
                    + 0.5 * gDnM.T @ WgVP)
            insert(k, k2, OP12)
        insert(k, k, OP11)
        mrows.append(np.repeat(k * n_p + blk, n_p))
        mcols.append(np.tile(k * n_p + blk, n_p))
        mvals.append(MMk[k].ravel())

    n = K * n_p
    OP = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    MM = sp.coo_matrix(
        (np.concatenate(mvals), (np.concatenate(mrows), np.concatenate(mcols))),
        shape=(n, n)).tocsr()
    if bordered:
        ones = np.ones((n, 1))
        OP = sp.bmat([[OP, ones], [ones.T, None]], format="csr")
    return OP, MM


def assemble_bc_rhs(
    ctx: DGContext2D,
    ubc: np.ndarray,
    qbc: np.ndarray,
    dirichlet_tags=(BC_WALL, BC_DIRICHLET),
    neumann_tags=(BC_NEUMAN,),
) -> np.ndarray:
    """Boundary-data load vector of the assembled SIP operator: with the
    prescribed Dirichlet trace ``ubc`` and Neumann flux ``qbc`` (both
    (K, Nfaces*Nfp)) it returns b, (K, Np), with OP u = MM f + b:
    Dirichlet faces give int_f ubc (gtau v - n.grad v), Neumann faces
    int_f qbc v."""
    K, n_p, n_fp, n_faces = ctx.k_elem, ctx.n_p, ctx.n_fp, ctx.n_faces
    Dr, Ds = _host(ctx.Dr), _host(ctx.Ds)
    fmask = _idx(ctx.fmask).reshape(n_faces, n_fp)
    rx, ry = _host(ctx.rx), _host(ctx.ry)
    sx, sy = _host(ctx.sx), _host(ctx.sy)
    sJ = _host(ctx.sJ).reshape(K, n_faces, n_fp)
    nx = _host(ctx.nx).reshape(K, n_faces, n_fp)
    ny = _host(ctx.ny).reshape(K, n_faces, n_fp)
    fscale = _host(ctx.fscale).reshape(K, n_faces, n_fp)
    bc_table = _idx(ctx.bc_table)
    ubc = np.asarray(ubc).reshape(K, n_faces, n_fp)
    qbc = np.asarray(qbc).reshape(K, n_faces, n_fp)
    mass_edge = _edge_masses(ctx)

    b = np.zeros((K, n_p))
    for k in range(K):
        Dx = rx[k, 0] * Dr + sx[k, 0] * Ds
        Dy = ry[k, 0] * Dr + sy[k, 0] * Ds
        for f in range(n_faces):
            tag = bc_table[k, f]
            if tag == 0:
                continue
            fm = fmask[f]
            mass_f = mass_edge[f] * sJ[k, f, 0]
            if tag in neumann_tags:
                b[k, fm] += mass_f @ qbc[k, f]
            elif tag in dirichlet_tags:
                gtau = (100.0 ** 2 * 2.0 * (ctx.n_order + 1) ** 2
                        * fscale[k, f, 0])
                ndotdx = nx[k, f, 0] * Dx[fm, :] + ny[k, f, 0] * Dy[fm, :]
                b[k, fm] += gtau * (mass_f @ ubc[k, f])
                b[k, :] -= ndotdx.T @ (mass_f @ ubc[k, f])
    return b
