"""CUDA kernels for the CURVED weak-form shallow-water path, with their plain
PyTorch versions and the differentiable rollout built on them.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_curved_blocked.py``
(``build_curved_blocked_ops``, ``sw2d_curved_step_blocked``,
``sw2d_curved_rollout_blocked``, ``sw2d_curved_rollout_bwd_blocked``,
``make_curved_rollout_blocked``). Same mathematics as
``ops.sw2d_curved.sw2d_curved_rhs``: four fields (h, hu, hv and the passive
tracer hN) interpolated to cubature nodes, weak derivatives
Dr^T W (rx F + ry G), Gauss-node traces with central + Lax-Friedrichs flux
under the per-face maximum speed, per-element mass inverses, Coriolis, drag
and bed-slope sources, the modal filter on the whole RHS, then a control
forcing linear in the controls; SSP-RK2 (midpoint) in time.

Scope, as in the JAX kernels: wall boundaries, no tidal boundary, no
wetting/drying (``sw2d_curved_rhs`` keeps those).

Two mass modes: 'affine' (straight-sided elements, MM_k = J_k Mref, so the
inverse is (V V^T) / J_k) and 'general' (a stored inverse per element, exact
for Gordon-Hall deformed elements).

What is ported is the contract, not the TPU layout:
 - no packing, no lane stacking, no pad masks: states are ``(B, K*Np)`` per
   field, trajectories ``(B, n_steps+1, K*Np)``, controls
   ``(B, n_ctrl_steps, n_ctrl)``;
 - no roll-combination tables: the '+' value at a Gauss point is read
   through ``gauss.mapP`` for any element numbering;
 - no split-precision products: plain float32 FMAs;
 - the adjoint is derived by hand (the TPU kernel traces ``jax.vjp`` inside
   the kernel); ``sw2d_curved_rollout_bwd_blocked_plain`` is that derivation
   in tensor code, tested against ``torch.autograd``;
 - cotangents of trajectories that nothing used arrive as ``None`` and are
   taken as zero without being allocated.

The filter acts on RHS + forcing. As in the JAX package the injectors are
multiplied by filter^T when the operator set is frozen (``use_filter``) and
added after the filter; a wrapper refuses a ``use_filter`` that differs from
the one the set was frozen with while controls are given.

Tie rules of the hand adjoint (as on the other two kernel paths): at
``max(spdM, spdP)`` a tie gives half of the cotangent to each side; the
per-face maximum over the NG Gauss points splits its cotangent evenly over
the points that attain it; the velocity norm has zero gradient at the
origin.

Every wrapper takes the plain version only for tensors that lie on the CPU.
For CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import check_matmul_precision
from ..context import BC_WALL, DGContext2D, _tree_to
from .sw2d import SWPhysics
from .sw2d_blocked import _n_steps, _ptr, _stream
from .sw2d_fused import (MAX_SMEM_BYTES, _check_tensor, _inverse_map,
                         _launch_check, _np64, _safe_norm)

N_FIELDS = 4  # h, hu, hv, hN
# Largest block of the forward kernels (MAX_THREADS in their source): one
# thread per (element, scenario) of a work unit. The adjoint's blocks may
# have twice as many: two threads per (element, scenario) where the card
# holds all of those blocks at once (the kernels' launcher decides, from
# the occupancy the device reports: ``last_parts``).
THREADS = 128
# Thread stride of the threads' scratch slots in shared memory (SLOT_STRIDE
# in the kernels' source).
SLOT_STRIDE = 128
# Scenarios of one work unit (at most): the unit's geometry, read once,
# serves them all.
SCEN_TILE = 4
# Largest sizes of the run-time-size instantiation (MAX_NP, MAX_NG in the
# kernels' source): N=6. N=3 (Np=10, Ncub=34, NG=8) has an instantiation of
# its own.
MAX_NP, MAX_NG = 28, 14
# Kernel launches on the device per call of a wrapper: one persistent
# cooperative launch each, the stages separated by grid barriers inside it.
DEVICE_LAUNCHES_PER_CALL = 1


class CurvedBlockedMeta(NamedTuple):
    k_elem: int
    n_p: int
    n_cub: int  # cubature points per element
    n_gauss: int  # Gauss points per face (NG)
    n_faces: int
    n_v: int  # K * Np
    n_t: int  # K * Nfaces * NG
    n_ctrl: int
    g: float
    cd: float
    f_cor: float
    has_bed: bool
    mass_mode: str  # 'affine' | 'general'
    filter_folded: bool  # the injectors carry filter^T

    @property
    def n_tr(self) -> int:
        """Gauss points per element."""
        return self.n_faces * self.n_gauss


@dataclass(frozen=True)
class CurvedBlockedOps:
    """Operator set of the curved kernels, unpadded. The named tensors serve
    the plain versions; ``fbuf``/``ibuf`` are the same data packed for the
    kernels (order: ``_FORDER`` below and ``make_cops`` in the kernels'
    source)."""

    # reference-element operators
    V: torch.Tensor  # (Ncub, Np) nodal -> cubature interpolation
    DrT: torch.Tensor  # (Np, Ncub) weak Dr^T
    DsT: torch.Tensor
    GI: torch.Tensor  # (NT, Np) nodal -> Gauss-face interpolation
    filt: torch.Tensor  # (Np, Np)
    VVT: torch.Tensor  # (Np, Np) reference mass inverse V V^T
    # cubature points (K*Ncub,): W*rx, W*ry, W*sx, W*sy
    WRX: torch.Tensor
    WRY: torch.Tensor
    WSX: torch.Tensor
    WSY: torch.Tensor
    # Gauss points (K*NT,)
    GNX: torch.Tensor
    GNY: torch.Tensor
    GW: torch.Tensor
    WALL: torch.Tensor  # bool: reflect the normal momentum
    # mass inverse
    INVJ: torch.Tensor  # (K,) 1/J per element ('affine'; ones otherwise)
    MINV: torch.Tensor  # (K, Np, Np) per element ('general'; empty otherwise)
    # bed slopes (nV,) (zeros when absent)
    ZX: torch.Tensor
    ZY: torch.Tensor
    # control injectors (n_ctrl, nV), filter-folded when the step filters
    BU: torch.Tensor
    BV: torch.Tensor
    mapP: torch.Tensor  # (K*NT,) int64 '+' Gauss point of each Gauss point
    # packed for the kernels
    fbuf: torch.Tensor  # float32
    ibuf: torch.Tensor  # int32: mapP and its inverse (CSR)

    def to(self, device) -> "CurvedBlockedOps":
        return _tree_to(self, device)


_FORDER = ("V", "DrT", "DsT", "GI", "filt", "VVT", "WRX", "WRY", "WSX", "WSY",
           "GNX", "GNY", "GW", "WALL", "INVJ", "MINV", "ZX", "ZY", "BU", "BV")


def build_curved_blocked_ops(
    ctx: DGContext2D,
    cub,
    gauss,
    phys: SWPhysics,
    forcing_bu: np.ndarray | None = None,  # (n_ctrl, K, Np)
    forcing_bv: np.ndarray | None = None,
    zx: np.ndarray | None = None,  # (K, Np) bed slopes
    zy: np.ndarray | None = None,
    dtype: torch.dtype = torch.float32,
    mass_mode: str = "auto",
    use_filter: bool = True,
    device="cuda",
) -> tuple[CurvedBlockedOps, CurvedBlockedMeta]:
    """Freeze the curved operator set (host-side, once). Everything is
    formed in float64 from the given contexts and cast once.

    ``mass_mode='auto'``: 'affine' when every element's cubature Jacobian is
    constant (straight-sided mesh), else 'general' (a stored inverse mass
    matrix per element: the curved case)."""
    K, n_p = ctx.k_elem, ctx.n_p
    NG, n_faces = gauss.n_gauss, 3
    n_tr, n_cub = n_faces * NG, cub.n_cub
    n_v, n_t = K * n_p, K * n_tr

    Jc = _np64(cub.J)
    affine = float(np.ptp(Jc, axis=1).max(initial=0.0)) < 1e-10 * float(
        np.abs(Jc).max())
    if mass_mode == "auto":
        mass_mode = "affine" if affine else "general"
    if mass_mode not in ("affine", "general"):
        raise ValueError(f"mass_mode={mass_mode!r}")
    if mass_mode == "affine" and not affine:
        raise ValueError("mass_mode='affine' needs constant per-element J")

    Wc = _np64(cub.W)
    wall = np.zeros(n_t, dtype=bool)
    w_idx = gauss.bc_idx[BC_WALL].cpu().numpy()
    w_msk = gauss.bc_mask[BC_WALL].cpu().numpy()
    wall[w_idx[w_msk]] = True

    if forcing_bu is None:
        forcing_bu = np.zeros((1, K, n_p))
        forcing_bv = np.zeros((1, K, n_p))
    forcing_bu, forcing_bv = _np64(forcing_bu), _np64(forcing_bv)
    n_ctrl = forcing_bu.shape[0]
    filt = _np64(ctx.filter)
    fold = (lambda a: a @ filt.T) if use_filter else (lambda a: a)
    Vn = _np64(ctx.V)
    has_bed = zx is not None
    flat = lambda a: _np64(a).reshape(-1)
    arr = {
        "V": _np64(cub.V), "DrT": _np64(cub.Dr).T, "DsT": _np64(cub.Ds).T,
        "GI": _np64(gauss.interp), "filt": filt, "VVT": Vn @ Vn.T,
        "WRX": (Wc * _np64(cub.rx)).reshape(-1),
        "WRY": (Wc * _np64(cub.ry)).reshape(-1),
        "WSX": (Wc * _np64(cub.sx)).reshape(-1),
        "WSY": (Wc * _np64(cub.sy)).reshape(-1),
        "GNX": flat(gauss.nx), "GNY": flat(gauss.ny), "GW": flat(gauss.W),
        "WALL": wall,
        "INVJ": 1.0 / Jc[:, 0] if mass_mode == "affine" else np.ones(K),
        "MINV": (_np64(cub.MMinv) if mass_mode == "general"
                 else np.zeros((0, n_p, n_p))),
        "ZX": flat(zx) if has_bed else np.zeros(n_v),
        "ZY": flat(zy) if has_bed else np.zeros(n_v),
        "BU": fold(forcing_bu).reshape(n_ctrl, -1),
        "BV": fold(forcing_bv).reshape(n_ctrl, -1),
    }
    mapP = gauss.mapP.reshape(-1).cpu().numpy().astype(np.int64)
    meta = CurvedBlockedMeta(
        k_elem=K, n_p=n_p, n_cub=n_cub, n_gauss=NG, n_faces=n_faces, n_v=n_v,
        n_t=n_t, n_ctrl=n_ctrl, g=float(phys.g),
        cd=float(phys.cd), f_cor=float(phys.f_cor), has_bed=has_bed,
        mass_mode=mass_mode, filter_folded=bool(use_filter))

    fbuf = np.concatenate([np.asarray(arr[k], dtype=np.float32).reshape(-1)
                           for k in _FORDER])
    pptr, pidx = _inverse_map(mapP, n_t)
    ibuf = np.concatenate([mapP.astype(np.int32), pptr, pidx])
    fields = {k: torch.as_tensor(np.ascontiguousarray(arr[k]), dtype=dtype,
                                 device=device)
              for k in _FORDER if k != "WALL"}
    ops = CurvedBlockedOps(
        **fields, WALL=torch.as_tensor(wall, device=device),
        mapP=torch.as_tensor(mapP, device=device),
        fbuf=torch.as_tensor(fbuf, device=device),
        ibuf=torch.as_tensor(ibuf, device=device))
    return ops, meta


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic, in tensor code)
# ---------------------------------------------------------------------------

def _fluxes4(q, g):
    """F and G of the four-field system at point values q = (h, hu, hv, hN)."""
    h, hu, hv, hN = q
    inv = 1.0 / h
    u, v = hu * inv, hv * inv
    pr = 0.5 * g * h * h
    return ((hu, hu * u + pr, hu * v, hN * u),
            (hv, hu * v, hv * v + pr, hN * v))


def _fluxes4_vjp(q, g, Fb, Gb):
    """Cotangent of q from the cotangents of F(q) and G(q)."""
    h, hu, hv, hN = q
    inv = 1.0 / h
    u, v, c = hu * inv, hv * inv, hN * inv
    w23 = Fb[2] + Gb[1]
    t4 = u * Fb[3] + v * Gb[3]
    hub = Fb[0] + 2.0 * u * Fb[1] + v * w23 + c * Fb[3]
    hvb = Gb[0] + 2.0 * v * Gb[2] + u * w23 + c * Gb[3]
    hb = ((g * h - u * u) * Fb[1] + (g * h - v * v) * Gb[2] - u * v * w23
          - c * t4)
    return hb, hub, hvb, t4


def _speed(q, g):
    return _safe_norm(q[1] / q[0], q[2] / q[0]) + torch.sqrt(g * q[0])


def _speed_vjp(q, g, sbar):
    """Cotangent of (h, hu, hv) from the cotangent of |(u, v)| + sqrt(g h)."""
    h, hu, hv = q[0], q[1], q[2]
    u, v = hu / h, hv / h
    nrm = _safe_norm(u, v)
    pos = nrm > 0.0
    inn = torch.where(pos, 1.0 / torch.where(pos, nrm, torch.ones_like(nrm)),
                      torch.zeros_like(nrm))
    hb = sbar * (0.5 * torch.sqrt(g / h) - nrm / h)
    return hb, sbar * u * inn / h, sbar * v * inn / h


def _elems(m: CurvedBlockedMeta, f, n: int):
    return f.reshape(f.shape[0], m.k_elem, n)


def _gauss_values(o: CurvedBlockedOps, m: CurvedBlockedMeta, N):
    """'-' and '+' values (B, nT) of the four fields at the Gauss points,
    the wall reflection applied. N: fields as (B, K, Np)."""
    B = N[0].shape[0]
    M = [(f @ o.GI.T).reshape(B, -1) for f in N]
    P = [f[:, o.mapP] for f in M]
    un2 = 2.0 * (M[1] * o.GNX + M[2] * o.GNY)
    P[1] = torch.where(o.WALL, M[1] - un2 * o.GNX, P[1])
    P[2] = torch.where(o.WALL, M[2] - un2 * o.GNY, P[2])
    return M, P


def _face_max(m: CurvedBlockedMeta, spd):
    B = spd.shape[0]
    s = spd.reshape(B, -1, m.n_gauss)
    return torch.amax(s, dim=-1, keepdim=True).expand(s.shape).reshape(B, -1)


def _mass_inverse(o, m, mm):
    """mm: (B, K, Np) -> M_k^{-1} mm."""
    if m.mass_mode == "affine":
        return (mm @ o.VVT.T) * o.INVJ[None, :, None]
    return torch.einsum("kij,bkj->bki", o.MINV, mm)


def _mass_inverse_T(o, m, w):
    if m.mass_mode == "affine":
        return (w * o.INVJ[None, :, None]) @ o.VVT
    return torch.einsum("kij,bki->bkj", o.MINV, w)


def _curved_rhs_plain(o: CurvedBlockedOps, m: CurvedBlockedMeta, S, ctrl,
                      use_filter: bool):
    """One weak-form RHS on four (B, nV) fields: filtered, then forced."""
    g, K = m.g, m.k_elem
    B = S[0].shape[0]
    check_matmul_precision(S[0])
    N = [_elems(m, f, m.n_p) for f in S]

    # ---- volume: cubature interpolation + weak divergence ----
    C = [f @ o.V.T for f in N]  # (B, K, Ncub)
    F, G = _fluxes4(C, g)
    wrx, wry, wsx, wsy = (a.reshape(K, m.n_cub)
                          for a in (o.WRX, o.WRY, o.WSX, o.WSY))
    MM = [(wrx * F[i] + wry * G[i]) @ o.DrT.T
          + (wsx * F[i] + wsy * G[i]) @ o.DsT.T for i in range(N_FIELDS)]

    # ---- surface: Gauss traces, central + Lax-Friedrichs flux ----
    M, P = _gauss_values(o, m, N)
    FM, GM = _fluxes4(M, g)
    FP, GP = _fluxes4(P, g)
    lam = _face_max(m, torch.maximum(_speed(M, g), _speed(P, g)))
    for i in range(N_FIELDS):
        flx = o.GW * (0.5 * ((FM[i] + FP[i]) * o.GNX + (GM[i] + GP[i]) * o.GNY
                             + lam * (M[i] - P[i])))
        MM[i] = MM[i] - _elems(m, flx, m.n_tr) @ o.GI

    # ---- per-element mass inverse, nodal sources ----
    R = [_mass_inverse(o, m, mm).reshape(B, -1) for mm in MM]
    h, hu, hv = S[0], S[1], S[2]
    if m.cd != 0.0 or m.f_cor != 0.0:
        u, v = hu / h, hv / h
        cdn = m.cd * _safe_norm(u, v)
        R[1] = R[1] + m.f_cor * hv - cdn * u
        R[2] = R[2] - m.f_cor * hu - cdn * v
    if m.has_bed:
        R[1] = R[1] - g * h * o.ZX
        R[2] = R[2] - g * h * o.ZY

    if use_filter:
        R = [(_elems(m, r, m.n_p) @ o.filt.T).reshape(B, -1) for r in R]
    if ctrl is not None:
        R[1] = R[1] + ctrl @ o.BU
        R[2] = R[2] + ctrl @ o.BV
    return tuple(R)


def _curved_rhs_vjp_plain(o: CurvedBlockedOps, m: CurvedBlockedMeta, S, W,
                          use_filter: bool):
    """Hand-derived VJP of ``_curved_rhs_plain`` at state S against the
    cotangent W (four (B, nV) fields each): the state cotangents and the
    control cotangent (B, n_ctrl). The kernel does the same, point by
    point."""
    g, K = m.g, m.k_elem
    B = S[0].shape[0]
    check_matmul_precision(S[0])
    # the control enters after the filter
    cb = W[1] @ o.BU.T + W[2] @ o.BV.T
    if use_filter:
        W = [(_elems(m, w, m.n_p) @ o.filt).reshape(B, -1) for w in W]
    h, hu, hv = S[0], S[1], S[2]
    w2, w3 = W[1], W[2]
    out = [torch.zeros_like(h) for _ in range(N_FIELDS)]

    # ---- sources ----
    if m.cd != 0.0 or m.f_cor != 0.0:
        inv = 1.0 / h
        u, v = hu * inv, hv * inv
        nrm = _safe_norm(u, v)
        pos = nrm > 0.0
        inn = 1.0 / torch.where(pos, nrm, torch.ones_like(nrm))
        a2, a3 = -m.cd * w2, -m.cd * w3
        zero = torch.zeros_like(h)
        ub = torch.where(pos, a2 * (nrm + u * u * inn) + a3 * (u * v * inn),
                         zero)
        vb = torch.where(pos, a2 * (u * v * inn) + a3 * (nrm + v * v * inn),
                         zero)
        out[0] = out[0] - (ub * u + vb * v) * inv
        out[1] = out[1] + ub * inv - m.f_cor * w3
        out[2] = out[2] + vb * inv + m.f_cor * w2
    if m.has_bed:
        out[0] = out[0] - g * (o.ZX * w2 + o.ZY * w3)

    # ---- mass inverse transposed ----
    mb = [_mass_inverse_T(o, m, _elems(m, w, m.n_p)) for w in W]  # (B, K, Np)
    N = [_elems(m, f, m.n_p) for f in S]

    # ---- volume ----
    C = [f @ o.V.T for f in N]
    wrx, wry, wsx, wsy = (a.reshape(K, m.n_cub)
                          for a in (o.WRX, o.WRY, o.WSX, o.WSY))
    trb = [w @ o.DrT for w in mb]  # (B, K, Ncub)
    tsb = [w @ o.DsT for w in mb]
    Fb = [wrx * a + wsx * b for a, b in zip(trb, tsb)]
    Gb = [wry * a + wsy * b for a, b in zip(trb, tsb)]
    Cb = _fluxes4_vjp(C, g, Fb, Gb)
    Nb = [c @ o.V for c in Cb]  # (B, K, Np)

    # ---- surface ----
    M, P = _gauss_values(o, m, N)
    spdM, spdP = _speed(M, g), _speed(P, g)
    spd = torch.maximum(spdM, spdP)
    lam = _face_max(m, spd)
    # cotangent of the bracket 0.5*(...) of each flux, halved
    e = [0.5 * o.GW * (-(w @ o.GI.T)).reshape(B, -1) for w in mb]
    lamb = sum(e[i] * (M[i] - P[i]) for i in range(N_FIELDS))
    # lam = face max of max(spdM, spdP): the face-summed cotangent is split
    # evenly over the points that attain the maximum; an M/P tie is halved
    is_max = (spd == lam).to(spd.dtype).reshape(B, -1, m.n_gauss)
    cnt = is_max.sum(dim=-1, keepdim=True)
    lsum = lamb.reshape(B, -1, m.n_gauss).sum(dim=-1, keepdim=True)
    sb = (lsum * is_max / cnt).reshape(B, -1)
    wM = torch.where(spdM > spdP, 1.0,
                     torch.where(spdM == spdP, 0.5, 0.0)).to(spd.dtype)
    Fe = [a * o.GNX for a in e]
    Ge = [a * o.GNY for a in e]
    Mb = list(_fluxes4_vjp(M, g, Fe, Ge))
    Pb = list(_fluxes4_vjp(P, g, Fe, Ge))
    for i in range(N_FIELDS):
        Mb[i] = Mb[i] + lam * e[i]
        Pb[i] = Pb[i] - lam * e[i]
    for side, sbar in ((Mb, sb * wM), (Pb, sb * (1.0 - wM))):
        vals = M if side is Mb else P
        for i, a in enumerate(_speed_vjp(vals, g, sbar)):
            side[i] = side[i] + a
    # wall reflection: the '+' momentum is a map of the '-' momentum
    zero = torch.zeros_like(Mb[0])
    unb = -2.0 * (o.GNX * Pb[1] + o.GNY * Pb[2])
    Mb[1] = Mb[1] + torch.where(o.WALL, Pb[1] + o.GNX * unb, zero)
    Mb[2] = Mb[2] + torch.where(o.WALL, Pb[2] + o.GNY * unb, zero)
    Pb[1] = torch.where(o.WALL, zero, Pb[1])
    Pb[2] = torch.where(o.WALL, zero, Pb[2])
    for i in range(N_FIELDS):
        gb = Mb[i].index_add(1, o.mapP, Pb[i])  # back through the gather
        Nb[i] = Nb[i] + _elems(m, gb, m.n_tr) @ o.GI
        out[i] = out[i] + Nb[i].reshape(B, -1)
    return tuple(out), cb


def _curved_step_values(o, m, S, ctrl, dt, use_filter):
    """One SSP-RK2 (midpoint) step, the same control in both stages."""
    k1 = _curved_rhs_plain(o, m, S, ctrl, use_filter)
    s1 = tuple(u + 0.5 * dt * k for u, k in zip(S, k1))
    k2 = _curved_rhs_plain(o, m, s1, ctrl, use_filter)
    return tuple(u + dt * k for u, k in zip(S, k2))


def sw2d_curved_step_blocked_plain(ops, meta, h, hu, hv, hN, ctrl, dt: float,
                                   use_filter: bool = True):
    """Plain version of ``sw2d_curved_step_blocked``."""
    return _curved_step_values(ops, meta, (h, hu, hv, hN), ctrl, dt,
                               use_filter)


def sw2d_curved_rollout_blocked_plain(ops, meta, h, hu, hv, hN, ctrls,
                                      dt: float, spc: int = 1, n_steps=None,
                                      use_filter: bool = True,
                                      store_traj: bool = False):
    """Plain version of ``sw2d_curved_rollout_blocked``."""
    n_steps = _n_steps(ctrls, spc, n_steps)
    S = (h, hu, hv, hN)
    rows = [[f] for f in S]
    for t in range(n_steps):
        ctrl = None if ctrls is None else ctrls[:, t // spc]
        S = _curved_step_values(ops, meta, S, ctrl, dt, use_filter)
        if store_traj:
            for r, f in zip(rows, S):
                r.append(f)
    if not store_traj:
        return S
    return (*(torch.stack(r, dim=1) for r in rows), *S)


def sw2d_curved_rollout_bwd_blocked_plain(ops, meta, traj, tb, ctrls,
                                          dt: float, spc: int,
                                          use_filter: bool = True):
    """Plain version of ``sw2d_curved_rollout_bwd_blocked``: the reverse
    sweep with the hand-derived RHS adjoint (no autograd).

    For each step t (T-1 .. 0), with lambda the adjoint of s_{t+1}:
      lambda_t = lambda + tbar_{t+1}
      g1       = VJP_R(s1)[dt lambda_t],  s1 = s_t + dt/2 R(s_t) recomputed
      g0       = VJP_R(s_t)[dt/2 g1]
      lambda   = lambda_t + g1 + g0,
    the control cotangents of both products summed per control step.
    ``traj``/``tb``: four (B, n_steps+1, nV) tensors each; an entry of ``tb``
    may be None (a trajectory that nothing used). Returns the cotangents of
    (h0, hu0, hv0, hN0) and of ctrls."""
    o, m = ops, meta
    n_steps = traj[0].shape[1] - 1
    add = lambda lam, row: [l if t is None else l + t[:, row]
                            for l, t in zip(lam, tb)]
    lam = [torch.zeros_like(traj[0][:, 0]) for _ in range(N_FIELDS)]
    cb = torch.zeros_like(ctrls)
    for t in range(n_steps - 1, -1, -1):
        j = t // spc
        ctrl = ctrls[:, j]
        lam = add(lam, t + 1)
        S = tuple(f[:, t] for f in traj)
        k1 = _curved_rhs_plain(o, m, S, ctrl, use_filter)
        s1 = tuple(u + 0.5 * dt * k for u, k in zip(S, k1))
        g1, cbB = _curved_rhs_vjp_plain(o, m, s1, [dt * l for l in lam],
                                        use_filter)
        g0, cbA = _curved_rhs_vjp_plain(o, m, S, [0.5 * dt * a for a in g1],
                                        use_filter)
        lam = [l + a + b for l, a, b in zip(lam, g1, g0)]
        cb[:, j] = cb[:, j] + cbB + cbA
    return (*add(lam, 0), cb)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class _CurvedDesc(ctypes.Structure):
    """Mirror of ``struct CurvedDesc`` in the kernels' source."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "K", "Np", "Ncub", "NG", "n_ctrl", "affine", "has_bed")
    ] + [(n, ctypes.c_float) for n in ("g", "cd", "fcor")]


def _desc(meta: CurvedBlockedMeta) -> _CurvedDesc:
    return _CurvedDesc(meta.k_elem, meta.n_p, meta.n_cub, meta.n_gauss,
                       meta.n_ctrl, int(meta.mass_mode == "affine"),
                       int(meta.has_bed), meta.g, meta.cd, meta.f_cor)


class UnitShape(NamedTuple):
    """Work units of the curved kernels: ``elems`` elements x ``scens``
    scenarios each, one thread per (element, scenario), ``threads`` per
    block (a multiple of 32)."""

    elems: int
    scens: int
    threads: int


def _al4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(meta: CurvedBlockedMeta, elems: int, threads: int,
               parts: int = 1) -> int:
    """Dynamic shared memory of one block of ``threads`` with chunks of
    ``elems`` elements and ``parts`` threads a lane (``csmem_floats`` in the
    kernels' source): the reference operators; per element its cubature
    weights, Gauss-point data, the indices of each Gauss point's '+' point
    and of the point that reads it, and its mass inverse; per thread its
    scratch; with two parts, per lane the slots in which they add their
    sums."""
    n_p, n_cub, n_tr = meta.n_p, meta.n_cub, meta.n_tr
    ops = (12 * -(-n_cub // 4) * n_p + _al4(n_tr * n_p)
           + 2 * _al4(n_p * n_p))
    minv = 1 if meta.mass_mode == "affine" else n_p * n_p
    chunk = (4 * n_cub * elems + 4 * n_tr * elems + 2 * _al4(n_tr * elems)
             + _al4(minv * elems))
    per_thread = _al4(max(8 * n_p, max(4 * n_p, 9 * meta.n_gauss) + 4 * n_p))
    slots = per_thread * SLOT_STRIDE * -(-threads // SLOT_STRIDE)
    xch = 4 * n_p * SLOT_STRIDE if parts > 1 else 0
    return 4 * (ops + chunk + slots + xch)


def _threads(elems: int, scens: int) -> int:
    return 32 * -(-(elems * scens) // 32)


def _order3(meta: CurvedBlockedMeta) -> bool:
    return (meta.n_p, meta.n_cub, meta.n_gauss) == (10, 34, 8)


def unit_shape(meta: CurvedBlockedMeta, batch: int) -> UnitShape:
    """The work unit of the curved kernels for ``batch`` scenarios: tiles of
    up to ``SCEN_TILE`` scenarios (a ragged last tile is masked) times
    chunks of elements, as many as fill a block of ``THREADS`` and fit its
    shared memory (fewer for high orders), evened out over the mesh so that
    the last chunk is not mostly empty."""
    if not _order3(meta) and (meta.n_p > MAX_NP or meta.n_gauss > MAX_NG):
        raise ValueError(
            f"Np={meta.n_p}, NG={meta.n_gauss}: the curved kernels take at "
            f"most Np={MAX_NP} and NG={MAX_NG}")
    scens = max(1, min(SCEN_TILE, batch))
    elems = max(1, min(meta.k_elem, THREADS // scens))
    need = lambda e: smem_bytes(meta, e, _threads(e, scens))
    while elems > 1 and need(elems) > MAX_SMEM_BYTES:
        elems = max(1, elems // 2)
    if need(elems) > MAX_SMEM_BYTES:
        raise ValueError(
            f"Np={meta.n_p}, Ncub={meta.n_cub} needs {need(1)} bytes of "
            f"shared memory per block even with one element per block; a "
            f"block can have {MAX_SMEM_BYTES}")
    n_chunks = -(-meta.k_elem // elems)
    elems = -(-meta.k_elem // n_chunks)
    return UnitShape(elems, scens, _threads(elems, scens))


def n_units(meta: CurvedBlockedMeta, batch: int) -> int:
    """Work units of one launch for ``batch`` scenarios."""
    u = unit_shape(meta, batch)
    return -(-meta.k_elem // u.elems) * -(-batch // u.scens)


def _lib():
    """The compiled kernels with their argument types set (built at first
    use; needs nvcc and a CUDA device)."""
    from ._build import load

    lib = load("sw2d_curved")
    if getattr(lib, "_sw2d_typed", False):
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    D = ctypes.POINTER(_CurvedDesc)
    lib.sw2d_curved_smem_bytes.argtypes = [D, I, I, I]
    lib.sw2d_curved_smem_bytes.restype = ctypes.c_longlong
    lib.sw2d_curved_fwd_work_floats.argtypes = [D, I]
    lib.sw2d_curved_fwd_work_floats.restype = ctypes.c_longlong
    lib.sw2d_curved_bwd_work_floats.argtypes = [D, I, I]
    lib.sw2d_curved_bwd_work_floats.restype = ctypes.c_longlong
    lib.sw2d_curved_last_grid.argtypes = []
    lib.sw2d_curved_last_grid.restype = I
    lib.sw2d_curved_last_parts.argtypes = []
    lib.sw2d_curved_last_parts.restype = I
    lib.sw2d_curved_step.argtypes = (
        [D, P, P] + [P] * 10 + [I, F, I, I, I, I, P])
    lib.sw2d_curved_rollout.argtypes = (
        [D, P, P] + [P] * 14 + [I, I, I, I, F, I, I, I, I, P])
    lib.sw2d_curved_rollout_bwd.argtypes = (
        [D, P, P] + [P] * 15 + [I, I, I, F, I, I, I, I, P])
    for fn in (lib.sw2d_curved_step, lib.sw2d_curved_rollout,
               lib.sw2d_curved_rollout_bwd):
        fn.restype = I
    lib._sw2d_typed = True
    return lib


def _check_kernel_inputs(ops: CurvedBlockedOps, meta: CurvedBlockedMeta,
                         ref: torch.Tensor):
    """What the kernels do not take raises here (no fallback)."""
    if ref.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels are float32, got {ref.dtype}")
    if ops.fbuf.device != ref.device or ops.ibuf.device != ref.device:
        raise ValueError("operator set and state lie on different devices")
    return _lib(), _desc(meta)


def last_grid() -> int:
    """Thread blocks of the last kernel launch of this module."""
    return int(_lib().sw2d_curved_last_grid())


def last_parts() -> int:
    """Threads per (element, scenario) of the last adjoint launch."""
    return int(_lib().sw2d_curved_last_parts())


def _check_state(meta, S) -> int:
    B = S[0].shape[0]
    for name, t in zip(("h", "hu", "hv", "hN"), S):
        _check_tensor(name, t, (B, meta.n_v), S[0])
    return B


def _check_fold(meta, has_ctrl: bool, use_filter: bool):
    if has_ctrl and bool(use_filter) != meta.filter_folded:
        raise ValueError(
            f"use_filter={bool(use_filter)}, but the operator set's control "
            f"injectors were frozen with use_filter={meta.filter_folded}")


def sw2d_curved_step_blocked(ops: CurvedBlockedOps, meta: CurvedBlockedMeta,
                             h, hu, hv, hN, ctrl, dt: float,
                             use_filter: bool = True):
    """One curved weak-form SSP-RK2 step on four (B, nV) fields; controls
    (B, n_ctrl) or None.

    Replaces the TPU kernel ``_step_kernel`` / ``sw2d_curved_step_blocked``
    of ``blitzdg_tpu/ops/sw2d_curved_blocked.py``. Bound by operations: 8 nV
    floats of traffic against some two thousand operations per node (the
    cubature and Gauss interpolations and their transposes). Work unit:
    chunk of elements x tile of scenarios (``unit_shape``), one thread per
    (element, scenario); the stages are separated by grid barriers inside
    one cooperative launch; design: the kernels' source.
    """
    S = (h, hu, hv, hN)
    B = _check_state(meta, S)
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (B, meta.n_ctrl), h)
    _check_fold(meta, ctrl is not None, use_filter)
    if h.device.type == "cpu":
        return sw2d_curved_step_blocked_plain(ops, meta, *S, ctrl, dt,
                                              use_filter)
    out = _run_step(ops, meta, S, ctrl, dt, use_filter)
    sw2d_curved_step_blocked.launches += 1
    return out


def _launch_stream(t: torch.Tensor):
    """The stream a launch goes to: the current one of a CUDA tensor's
    device; none for the CPU (a build of the kernels' source for the host,
    in the tests)."""
    return _stream(t) if t.is_cuda else None


def _run_step(ops, meta, S, ctrl, dt, use_filter):
    """The step kernel's launch (no checks of S beyond the kernels' own)."""
    h, B = S[0], S[0].shape[0]
    lib, desc = _check_kernel_inputs(ops, meta, h)
    u = unit_shape(meta, B)
    out = [torch.empty_like(h) for _ in range(N_FIELDS)]
    work = torch.empty(lib.sw2d_curved_fwd_work_floats(ctypes.byref(desc), B),
                       dtype=h.dtype, device=h.device)
    err = lib.sw2d_curved_step(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        *(f.data_ptr() for f in S), _ptr(ctrl), *(f.data_ptr() for f in out),
        work.data_ptr(), B, float(dt), int(use_filter), u.elems, u.scens,
        u.threads, _launch_stream(h))
    _launch_check(err, "sw2d_curved_step_blocked")
    return tuple(out)


sw2d_curved_step_blocked.launches = 0


def sw2d_curved_rollout_blocked(ops: CurvedBlockedOps,
                                meta: CurvedBlockedMeta, h, hu, hv, hN, ctrls,
                                dt: float, spc: int = 1,
                                n_steps: int | None = None,
                                use_filter: bool = True,
                                store_traj: bool = False):
    """Curved SSP-RK2 rollout in one launch. ``ctrls`` is
    (B, n_ctrl_steps, n_ctrl), the control of step t being
    ``ctrls[:, t // spc]``, or None with ``n_steps`` given. Returns the four
    final fields; with ``store_traj`` the four step-start trajectories
    (B, n_steps+1, nV) first, then the final fields (views of their last
    rows).

    Replaces the TPU kernel ``_rollout_kernel`` /
    ``sw2d_curved_rollout_blocked`` of
    ``blitzdg_tpu/ops/sw2d_curved_blocked.py``. Bound by operations:
    2 n_steps RHS evaluations against one state in and one out (plus the
    trajectory when stored). Each stage ends in a grid barrier; the stage
    that writes a state writes its Gauss traces too, from which the next
    stage reads both sides of every face, so a stage needs no second
    barrier.
    """
    S = (h, hu, hv, hN)
    B = _check_state(meta, S)
    if ctrls is not None:
        if ctrls.dim() != 3:
            raise ValueError("ctrls: expected (B, n_ctrl_steps, n_ctrl)")
        _check_tensor("ctrls", ctrls, (B, ctrls.shape[1], meta.n_ctrl), h)
    _check_fold(meta, ctrls is not None, use_filter)
    n_steps = _n_steps(ctrls, spc, n_steps)
    if n_steps < 1 or spc < 1:
        raise ValueError("the rollout needs at least one step")
    if h.device.type == "cpu":
        return sw2d_curved_rollout_blocked_plain(
            ops, meta, *S, ctrls, dt, spc, n_steps, use_filter, store_traj)
    out = _run_rollout(ops, meta, S, ctrls, dt, spc, n_steps, use_filter,
                       store_traj)
    sw2d_curved_rollout_blocked.launches += 1
    return out


def _run_rollout(ops, meta, S, ctrls, dt, spc, n_steps, use_filter,
                 store_traj):
    """The rollout kernel's launch (no checks of S beyond the kernels'
    own)."""
    h, B = S[0], S[0].shape[0]
    lib, desc = _check_kernel_inputs(ops, meta, h)
    u = unit_shape(meta, B)
    new = lambda *shape: torch.empty(shape, dtype=h.dtype, device=h.device)
    work = new(lib.sw2d_curved_fwd_work_floats(ctypes.byref(desc), B))
    if store_traj:
        traj = [new(B, n_steps + 1, meta.n_v) for _ in range(N_FIELDS)]
        final = [None] * N_FIELDS
    else:
        traj = [None] * N_FIELDS
        final = [new(B, meta.n_v) for _ in range(N_FIELDS)]
    err = lib.sw2d_curved_rollout(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        *(f.data_ptr() for f in S), _ptr(ctrls), *(_ptr(f) for f in final),
        *(_ptr(f) for f in traj), work.data_ptr(), B, n_steps,
        0 if ctrls is None else ctrls.shape[1], int(spc), float(dt),
        int(use_filter), u.elems, u.scens, u.threads, _launch_stream(h))
    _launch_check(err, "sw2d_curved_rollout_blocked")
    if store_traj:
        return (*traj, *(f[:, -1] for f in traj))
    return tuple(final)


sw2d_curved_rollout_blocked.launches = 0


def sw2d_curved_rollout_bwd_blocked(ops: CurvedBlockedOps,
                                    meta: CurvedBlockedMeta, traj, tb, ctrls,
                                    dt: float, spc: int,
                                    use_filter: bool = True):
    """Adjoint of ``sw2d_curved_rollout_blocked`` in one launch. ``traj``:
    the four stored trajectories; ``tb``: their cotangents, None for a
    trajectory that nothing used (taken as zero, not allocated). Returns the
    cotangents of (h0, hu0, hv0, hN0) and of ctrls.

    Replaces the TPU kernel ``_rollout_bwd_kernel`` /
    ``sw2d_curved_rollout_bwd_blocked`` of
    ``blitzdg_tpu/ops/sw2d_curved_blocked.py``, whose pullback comes from
    ``jax.vjp`` traced in the kernel; here it is derived by hand (see
    ``sw2d_curved_rollout_bwd_blocked_plain``). Bound by operations (one RHS
    recompute and two adjoint applications per step against one read of
    trajectory and cotangent). The transposed '+' gather crosses blocks, so
    each adjoint application runs in two phases around a grid barrier (three
    barriers per step); two threads share each (element, scenario) where
    the card holds all the blocks of twice the threads at once
    (``last_parts``); sums are taken in a fixed order, no atomics.
    """
    traj, tb = tuple(traj), tuple(tb)
    if len(traj) != N_FIELDS or len(tb) != N_FIELDS:
        raise ValueError("traj and tb: four trajectories each")
    B, n1, _ = traj[0].shape
    n_cs = ctrls.shape[1]
    if n_cs * spc + 1 != n1:
        raise ValueError(f"trajectory of {n1} states does not match "
                         f"{n_cs} control steps x {spc}")
    for name, t in zip(("traj_h", "traj_hu", "traj_hv", "traj_hN", "tb_h",
                        "tb_hu", "tb_hv", "tb_hN"), traj + tb):
        if t is not None:
            _check_tensor(name, t, (B, n1, meta.n_v), traj[0])
    _check_tensor("ctrls", ctrls, (B, n_cs, meta.n_ctrl), traj[0])
    _check_fold(meta, True, use_filter)
    if traj[0].device.type == "cpu":
        return sw2d_curved_rollout_bwd_blocked_plain(
            ops, meta, traj, tb, ctrls, dt, spc, use_filter)
    out = _run_rollout_bwd(ops, meta, traj, tb, ctrls, dt, spc, use_filter)
    sw2d_curved_rollout_bwd_blocked.launches += 1
    return out


def _run_rollout_bwd(ops, meta, traj, tb, ctrls, dt, spc, use_filter,
                     parts=0):
    """The adjoint kernel's launch (no checks of the trajectories beyond the
    kernels' own); ``parts``: threads per (element, scenario), 1 or 2, or 0
    for the launcher's choice from the device's occupancy."""
    lib, desc = _check_kernel_inputs(ops, meta, traj[0])
    B, n_cs = traj[0].shape[0], ctrls.shape[1]
    u = unit_shape(meta, B)
    new = lambda *shape: torch.empty(shape, dtype=traj[0].dtype,
                                     device=traj[0].device)
    xb = [new(B, meta.n_v) for _ in range(N_FIELDS)]
    cb = torch.empty_like(ctrls)
    work = new(lib.sw2d_curved_bwd_work_floats(ctypes.byref(desc), B, n_cs))
    err = lib.sw2d_curved_rollout_bwd(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        *(f.data_ptr() for f in traj), *(_ptr(f) for f in tb),
        ctrls.data_ptr(), *(f.data_ptr() for f in xb), cb.data_ptr(),
        work.data_ptr(), B, n_cs, int(spc), float(dt), int(use_filter),
        u.elems, u.scens, int(parts), _launch_stream(traj[0]))
    _launch_check(err, "sw2d_curved_rollout_bwd_blocked")
    return (*xb, cb)


sw2d_curved_rollout_bwd_blocked.launches = 0


def make_curved_rollout_blocked(ops: CurvedBlockedOps,
                                meta: CurvedBlockedMeta, dt: float, spc: int,
                                use_filter: bool = True):
    """Differentiable curved rollout: returns ``rollout(h, hu, hv, hN,
    ctrls) -> (traj_h, traj_hu, traj_hv, traj_hN)`` of step-start states
    (B, n_steps+1, nV), a ``torch.autograd.Function`` whose forward is
    ``sw2d_curved_rollout_blocked`` with the trajectories stored and whose
    backward is ``sw2d_curved_rollout_bwd_blocked`` (the kernels on CUDA
    tensors, their plain versions on CPU tensors).
    """

    class _Rollout(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, hu, hv, hN, ctrls):
            traj = sw2d_curved_rollout_blocked(
                ops, meta, h, hu, hv, hN, ctrls, dt, spc,
                use_filter=use_filter, store_traj=True)[:N_FIELDS]
            ctx.save_for_backward(*traj, ctrls)
            # a trajectory that nothing used gets None, not a zero tensor
            ctx.set_materialize_grads(False)
            return tuple(traj)

        @staticmethod
        def backward(ctx, *tb):
            *traj, ctrls = ctx.saved_tensors
            tb = tuple(None if t is None else t.contiguous() for t in tb)
            return sw2d_curved_rollout_bwd_blocked(
                ops, meta, tuple(traj), tb, ctrls, dt, spc, use_filter)

    return _Rollout.apply
