"""Fused CUDA kernels for the shallow-water MPC hot path, with their plain
PyTorch versions and the differentiable rollout built on them.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_pallas.py``. One
SSP-RK2 step is 2 RHS evaluations + modal filter + axpy updates; a rollout
is the whole horizon; the backward rollout is its adjoint sweep. Each is one
kernel launch in which the state never leaves the SM: one thread per
(element, scenario), the state in registers (``csrc/sw2d_dense.cu``, built
by ``_build.py``).

Physics, as in the JAX kernels: wall reflection, tidal BC_OUT forcing
hP = h0 + amp*cos(omega t)*ramp, hydrostatic-reconstruction well-balanced
star fluxes over bathymetry, bed-slope sources, quadratic bottom drag,
Coriolis, and a control forcing LINEAR in the controls and t-independent:
rhs_{hu,hv} += control @ BU/BV.

What differs from the TPU design, on purpose:
 - no dense trace operators: '-'/'+' traces are index gathers through
   ``vmapM``/``vmapP`` with wall reflection and the tidal depth applied on
   flagged trace nodes;
 - derivative, lift and filter are per-element (Np x Np) products scaled by
   the metric, not block-diagonal matrices;
 - no 128-lane padding, no pad masks, no padding of the control width:
   states are ``(B, K*Np)``, controls ``(B, H, n_ctrl)``;
 - the adjoint of the coastal RHS is derived by hand (the TPU kernel traces
   ``jax.vjp`` inside the kernel). ``sw2d_rollout_bwd_plain`` is that
   derivation in tensor code, step by step, so that it can be tested against
   ``torch.autograd`` on a CPU.

Tie rules of the hand adjoint: at ``max(spdM, spdP)`` a tie gives half of the
cotangent to each side (as ``jax.vjp`` and ``torch.maximum`` do); the
per-face maximum splits its cotangent evenly over the nodes that attain it
(as ``torch.amax`` does; equal to ``jax.vjp`` of the JAX kernel's roll chain
for faces of up to two nodes); ``max(0, x)`` of the star depths passes the
cotangent where ``x > 0``; the velocity norm has zero gradient at the origin.

Every wrapper (``sw2d_step_fused``, ``sw2d_rollout_fused``,
``sw2d_rollout_bwd_fused``) takes the plain version only for tensors that
lie on the CPU. For CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import check_matmul_precision
from ..context import BC_OUT, BC_WALL, DGContext2D, _tree_to
from .limiters import surface_reconstruction
from .sw2d import SWPhysics

# Dynamic shared memory one block can have on an H100: the unit sizing of
# the blocked and curved wrappers reads it. The dense kernels' launcher asks
# the device itself and picks its tile of scenarios there.
MAX_SMEM_BYTES = 232448


class FusedStepMeta(NamedTuple):
    k_elem: int
    n_p: int
    n_faces: int
    n_fp: int
    n_v: int  # K * Np
    n_t: int  # K * Nfaces * Nfp
    n_ctrl: int
    g: float
    cd: float = 0.0  # quadratic bottom drag
    f_cor: float = 0.0  # Coriolis parameter
    wb: bool = False  # hydrostatic-reconstruction well-balancing
    has_bathy: bool = False  # bed-slope sources
    # tidal BC_OUT params (h0, amp, omega, ramp_tau) or None
    tidal: tuple | None = None
    # the switches below are set by the blocked operator set only
    # (ops/sw2d_blocked.py); the dense kernels of this module refuse them
    has_sponge: bool = False  # sponge relaxation after each step
    wetdry: bool = False  # minmod surface reconstruction + positivity limiter
    h_floor: float = 1e-3  # dry-cell depth floor of the wet/dry branch

    @property
    def coastal(self) -> bool:
        """Any physics beyond the flat-bottom wall-only regime."""
        return (self.wb or self.has_bathy or self.cd != 0.0
                or self.f_cor != 0.0 or self.tidal is not None)


@dataclass(frozen=True)
class FusedStepOps:
    """Operator set of the fused step, unpadded. The named tensors serve the
    plain versions; ``fbuf``/``ibuf`` are the same data packed for the
    kernels (order: see ``_pack_buffers`` and ``make_ops`` in the source of
    the kernels)."""

    # reference-element operators
    Dr: torch.Tensor  # (Np, Np)
    Ds: torch.Tensor
    lift: torch.Tensor  # (Np, Nfaces*Nfp)
    filt: torch.Tensor  # (Np, Np)
    # metric at volume nodes (nV,)
    rx: torch.Tensor
    sx: torch.Tensor
    ry: torch.Tensor
    sy: torch.Tensor
    # trace nodes (nT,)
    nx: torch.Tensor
    ny: torch.Tensor
    fscale: torch.Tensor
    wall: torch.Tensor  # bool: reflect the normal momentum
    obc: torch.Tensor  # bool: BC_OUT, prescribed tidal depth
    HMt: torch.Tensor  # still-water depth traces (zeros without wb)
    HPt: torch.Tensor
    # bed slopes (nV,) (zeros without bathymetry)
    Hx: torch.Tensor
    Hy: torch.Tensor
    # control forcing injectors (n_ctrl, nV)
    BU: torch.Tensor
    BV: torch.Tensor
    # gather maps (nT,) int64
    vmapM: torch.Tensor
    vmapP: torch.Tensor
    # packed for the kernels
    fbuf: torch.Tensor  # float32
    ibuf: torch.Tensor  # int32

    def to(self, device) -> "FusedStepOps":
        return _tree_to(self, device)


def _inverse_map(vmap: np.ndarray, n_v: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR lists of the trace nodes that read each volume node: the
    transpose of a gather, as a gather (no atomics in the adjoint)."""
    order = np.argsort(vmap, kind="stable")
    counts = np.bincount(vmap, minlength=n_v)
    ptr = np.concatenate(([0], np.cumsum(counts)))
    return ptr.astype(np.int32), order.astype(np.int32)


def _mirror_map(vmapM: np.ndarray, vmapP: np.ndarray,
                n_v: int) -> np.ndarray:
    """The trace node j that reads trace node i's '-' node as its '+' node
    and i's '+' node as its '-' node: the other side of i's face, as that
    face's other element sees it; i itself on a boundary face (vmapP = vmapM
    there); -1 where vmapP points past the ``n_v`` nodes (a receive slot of
    a shard). The blocked adjoint recomputes the other side's flux through
    it instead of scattering. Raises where a '+' node has no such trace
    node (a non-conforming mesh)."""
    vm, vp = vmapM.astype(np.int64), vmapP.astype(np.int64)
    span = int(max(vm.max(), vp.max())) + 1
    key = vm * span + vp
    order = np.argsort(key, kind="stable")
    want = vp * span + vm
    pos = np.minimum(np.searchsorted(key[order], want), key.size - 1)
    found = key[order][pos] == want
    mirror = np.where(found, order[pos], -1)
    boundary, cut = vp == vm, vp >= n_v
    mirror[boundary] = np.flatnonzero(boundary)
    mirror[cut] = -1
    if not found[~cut].all():
        raise ValueError("a '+' trace node has no trace node that reads it "
                         "back: the blocked adjoint needs a conforming mesh")
    return mirror


def _pack_buffers(arr: dict, n_v: int, extra: tuple = (), n_recv: int = 0,
                  mirror: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """``extra``: names of further float fields appended after ``BV``.
    ``n_recv``: receive slots of one shard of a sharded set, which ``vmapP``
    numbers after the ``n_v`` local nodes; such a set also carries its send
    list ``arr["send"]`` (local node of each send slot, -1 for an empty
    slot), packed with its inverse after the maps. ``mirror``: append
    ``_mirror_map`` (the blocked sets), after checking that each receive
    slot is read by at most one trace node (its cotangent has one
    writer)."""
    forder = ("Dr", "Ds", "lift", "filt", "rx", "sx", "ry", "sy", "nx", "ny",
              "fscale", "wall", "obc", "HMt", "HPt", "Hx", "Hy", "BU", "BV",
              *extra)
    fbuf = np.concatenate(
        [np.asarray(arr[k], dtype=np.float32).reshape(-1) for k in forder])
    mptr, midx = _inverse_map(arr["vmapM"], n_v)
    pptr, pidx = _inverse_map(arr["vmapP"], n_v + n_recv)
    parts = [arr["vmapM"].astype(np.int32), arr["vmapP"].astype(np.int32),
             mptr, midx, pptr, pidx]
    if "send" in arr:
        send = np.asarray(arr["send"])
        slots = np.flatnonzero(send >= 0)
        sptr, sidx = _inverse_map(send[slots], n_v)
        # padded to the slot count, so that every shard's buffer has one size
        sidx = np.concatenate([slots[sidx], np.zeros(send.size - slots.size)])
        parts += [send.astype(np.int32), sptr, sidx.astype(np.int32)]
    if mirror:
        if n_recv and (pptr[n_v + 1:] - pptr[n_v:-1]).max(initial=0) > 1:
            raise ValueError("a receive slot is read by more than one trace "
                             "node")
        parts.append(_mirror_map(arr["vmapM"], arr["vmapP"], n_v)
                     .astype(np.int32))
    return fbuf, np.concatenate(parts)


def _ops_from_arrays(arr: dict, meta: FusedStepMeta, dtype: torch.dtype,
                     device, cls=None, extra: tuple = (), n_recv: int = 0,
                     mirror: bool = False):
    """``arr``: numpy float64/int/bool arrays keyed by field name. ``cls``:
    ``FusedStepOps`` or a dataclass that extends it by the ``extra`` float
    fields (and, for a shard of a sharded set, the send list)."""
    cls = FusedStepOps if cls is None else cls
    fbuf, ibuf = _pack_buffers(arr, meta.n_v, extra, n_recv, mirror)
    fields = {}
    for f in dataclasses.fields(cls):
        if f.name in ("fbuf", "ibuf"):
            continue
        a = np.ascontiguousarray(arr[f.name])
        if f.name in ("wall", "obc"):
            fields[f.name] = torch.as_tensor(a.astype(bool), device=device)
        elif f.name in ("vmapM", "vmapP", "send"):
            fields[f.name] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            fields[f.name] = torch.as_tensor(a, dtype=dtype, device=device)
    return cls(
        **fields,
        fbuf=torch.as_tensor(fbuf, device=device),
        ibuf=torch.as_tensor(ibuf, device=device))


def _np64(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t, dtype=np.float64)


def _operator_arrays(ctx: DGContext2D, phys: SWPhysics, forcing_bu,
                     forcing_bv, tidal) -> tuple[dict, dict]:
    """The operator set as float64 numpy arrays keyed by field name, and the
    keyword arguments of its ``FusedStepMeta``. Shared by the dense set
    (``build_fused_step_ops``) and the blocked set
    (``ops/sw2d_blocked.py::build_blocked_step_ops``)."""
    K, n_p = ctx.k_elem, ctx.n_p
    n_fp, n_faces = ctx.n_fp, ctx.n_faces
    n_v, n_t = K * n_p, K * n_faces * n_fp

    vmapM = ctx.vmapM.reshape(-1).cpu().numpy()
    vmapP = ctx.vmapP.reshape(-1).cpu().numpy()

    def flags(tag):
        out = np.zeros(n_t, dtype=bool)
        idx = ctx.bc_maps.idx[tag].cpu().numpy()
        msk = ctx.bc_maps.mask[tag].cpu().numpy()
        out[idx[msk]] = True
        return out

    if forcing_bu is None:
        forcing_bu = np.zeros((1, K, n_p))
        forcing_bv = np.zeros((1, K, n_p))
    forcing_bu, forcing_bv = _np64(forcing_bu), _np64(forcing_bv)
    n_ctrl = forcing_bu.shape[0]

    wb = phys.H is not None and phys.well_balanced
    has_bathy = phys.Hx is not None
    arr = {
        "Dr": _np64(ctx.Dr), "Ds": _np64(ctx.Ds), "lift": _np64(ctx.lift),
        "filt": _np64(ctx.filter),
        "rx": _np64(ctx.rx).reshape(-1), "sx": _np64(ctx.sx).reshape(-1),
        "ry": _np64(ctx.ry).reshape(-1), "sy": _np64(ctx.sy).reshape(-1),
        "nx": _np64(ctx.nx).reshape(-1), "ny": _np64(ctx.ny).reshape(-1),
        "fscale": _np64(ctx.fscale).reshape(-1),
        "wall": flags(BC_WALL),
        "obc": flags(BC_OUT) if tidal is not None else np.zeros(n_t, bool),
        "HMt": np.zeros(n_t), "HPt": np.zeros(n_t),
        "Hx": np.zeros(n_v), "Hy": np.zeros(n_v),
        "BU": forcing_bu.reshape(n_ctrl, -1),
        "BV": forcing_bv.reshape(n_ctrl, -1),
        "vmapM": vmapM, "vmapP": vmapP,
    }
    if has_bathy:
        arr["Hx"] = _np64(phys.Hx).reshape(-1)
        arr["Hy"] = _np64(phys.Hy).reshape(-1)
    if phys.H is not None:  # read by the star depths (wb) and by wet/dry
        Hflat = _np64(phys.H).reshape(-1)
        arr["HMt"], arr["HPt"] = Hflat[vmapM], Hflat[vmapP]

    meta_kw = dict(
        k_elem=K, n_p=n_p, n_faces=n_faces, n_fp=n_fp, n_v=n_v, n_t=n_t,
        n_ctrl=n_ctrl, g=float(phys.g), cd=float(phys.cd),
        f_cor=float(phys.f_cor), wb=wb, has_bathy=has_bathy,
        tidal=tuple(float(v) for v in tidal) if tidal is not None else None,
    )
    return arr, meta_kw


def build_fused_step_ops(
    ctx: DGContext2D,
    phys: SWPhysics,
    forcing_bu: np.ndarray | None = None,  # (n_ctrl, K, Np) hu injector
    forcing_bv: np.ndarray | None = None,
    dtype: torch.dtype = torch.float32,
    tidal: tuple | None = None,  # (h0, amp, omega, ramp_tau) BC_OUT forcing
    device="cuda",
) -> tuple[FusedStepOps, FusedStepMeta]:
    """Freeze the operator set. Host-side, runs once at setup. Coastal
    physics (bathymetry/WB/drag/Coriolis from ``phys``, tidal BC_OUT forcing
    from ``tidal``) is switched on in the kernels when present."""
    arr, meta_kw = _operator_arrays(ctx, phys, forcing_bu, forcing_bv, tidal)
    meta = FusedStepMeta(**meta_kw)
    return _ops_from_arrays(arr, meta, dtype, device), meta


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic, in tensor code)
# ---------------------------------------------------------------------------

def _safe_norm(u, v):
    r2 = u * u + v * v
    pos = r2 > 0.0
    r = torch.sqrt(torch.where(pos, r2, torch.ones_like(r2)))
    return torch.where(pos, r, torch.zeros_like(r))


def _desingularized_velocity(h, hu, hv, h_floor: float):
    """Velocities that go to zero, not to infinity, as the depth goes to the
    floor (Kurganov-Petrova style); equal to hu/h, hv/h above 4 h_floor."""
    eps2 = (4.0 * h_floor) ** 2
    inv = 2.0 * h / (h * h + torch.clamp_min(h * h, eps2))
    return hu * inv, hv * inv


def _tidal_depth(meta: FusedStepMeta, t: float) -> float:
    h0, amp, omega, ramp_tau = meta.tidal
    ramp = min(t / ramp_tau, 1.0) if ramp_tau > 0 else 1.0
    return h0 + amp * math.cos(omega * t) * ramp


class _TraceVals(NamedTuple):
    hM: torch.Tensor
    hP: torch.Tensor
    huM: torch.Tensor
    hvM: torch.Tensor
    huP: torch.Tensor
    hvP: torch.Tensor
    uM: torch.Tensor
    vM: torch.Tensor
    uP: torch.Tensor
    vP: torch.Tensor
    hMs: torch.Tensor  # star depths (== hM, hP without well-balancing)
    hPs: torch.Tensor
    passM: torch.Tensor | None  # max(0, x) passed its argument
    passP: torch.Tensor | None
    spdM: torch.Tensor
    spdP: torch.Tensor


def _plus_source(h, hu, hv, rb):
    """What the '+' gather reads: the state, followed for one shard of a
    sharded set by its (B, L_r, 3) receive buffer."""
    if rb is None:
        return h, hu, hv
    return tuple(torch.cat([f, rb[..., c]], dim=1)
                 for c, f in enumerate((h, hu, hv)))


def _trace_values(o: FusedStepOps, m: FusedStepMeta, h, hu, hv, t, rb=None):
    """Everything a trace node needs from the (B, nV) state (and ``rb``, the
    receive buffer of a shard: see ``_plus_source``)."""
    hx, hux, hvx = _plus_source(h, hu, hv, rb)
    hM, hP = h[:, o.vmapM], hx[:, o.vmapP]
    huM, hvM = hu[:, o.vmapM], hv[:, o.vmapM]
    huP, hvP = hux[:, o.vmapP], hvx[:, o.vmapP]
    un2 = 2.0 * (huM * o.nx + hvM * o.ny)
    huP = torch.where(o.wall, huM - un2 * o.nx, huP)
    hvP = torch.where(o.wall, hvM - un2 * o.ny, hvP)
    if m.tidal is not None:
        hP = hP + o.obc.to(hP.dtype) * (_tidal_depth(m, t) - hP)
    if m.wetdry:
        # minmod surface reconstruction of the columns, desingularized
        # velocities (ops/sw2d_wetdry.py::sw2d_rhs_wetdry on flat arrays)
        hMs, hPs = surface_reconstruction(hM - o.HMt, hM, hP - o.HPt, hP,
                                          m.h_floor)
        uM, vM = _desingularized_velocity(hM, huM, hvM, m.h_floor)
        uP, vP = _desingularized_velocity(hP, huP, hvP, m.h_floor)
        spdM = _safe_norm(uM, vM) + torch.sqrt(m.g * hMs)
        spdP = _safe_norm(uP, vP) + torch.sqrt(m.g * hPs)
        return _TraceVals(hM, hP, huM, hvM, huP, hvP, uM, vM, uP, vP, hMs,
                          hPs, None, None, spdM, spdP)
    uM, vM = huM / hM, hvM / hM
    uP, vP = huP / hP, hvP / hP
    if m.wb:
        bstar = torch.maximum(-o.HMt, -o.HPt)
        aM, aP = hM - o.HMt - bstar, hP - o.HPt - bstar
        passM, passP = aM > 0.0, aP > 0.0
        hMs, hPs = torch.clamp_min(aM, 0.0), torch.clamp_min(aP, 0.0)
    else:
        passM = passP = None
        hMs, hPs = hM, hP
    spdM = _safe_norm(uM, vM) + torch.sqrt(m.g * hMs)
    spdP = _safe_norm(uP, vP) + torch.sqrt(m.g * hPs)
    return _TraceVals(hM, hP, huM, hvM, huP, hvP, uM, vM, uP, vP, hMs, hPs,
                      passM, passP, spdM, spdP)


def _face_max(m: FusedStepMeta, spd):
    B = spd.shape[0]
    s = spd.reshape(B, -1, m.n_fp)
    return torch.amax(s, dim=-1, keepdim=True).expand(s.shape).reshape(B, -1)


def _elem(m: FusedStepMeta, f):
    return f.reshape(f.shape[0], m.k_elem, -1)


def _rhs_plain(o: FusedStepOps, m: FusedStepMeta, h, hu, hv, t, ctrl,
               rb=None):
    """One RHS on (B, nV) values; same arithmetic as the JAX kernels' _rhs.
    ``rb``: the receive buffer of one shard of a sharded set, or None."""
    g = m.g
    tv = _trace_values(o, m, h, hu, hv, t, rb)
    nx, ny = o.nx, o.ny
    if m.wb or m.wetdry:
        def flux_uv(hh, uu, vv):
            pr = 0.5 * g * hh * hh
            return (hh * uu, hh * uu * uu + pr, hh * uu * vv,
                    hh * vv, hh * uu * vv, hh * vv * vv + pr)

        F1M, F2M, F3M, G1M, G2M, G3M = flux_uv(tv.hMs, tv.uM, tv.vM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux_uv(tv.hPs, tv.uP, tv.vP)
        dq1, dq2, dq3 = tv.hMs - tv.hPs, F1M - F1P, G1M - G1P
        corr = (tv.hM - tv.hMs) * (tv.uM * nx + tv.vM * ny)
    else:
        def flux_c(hh, hhu, hhv):
            inv_h = 1.0 / hh
            p = 0.5 * g * hh * hh
            F2 = hhu * hhu * inv_h + p
            G2 = hhu * hhv * inv_h
            G3 = hhv * hhv * inv_h + p
            return hhu, F2, G2, hhv, G2, G3

        F1M, F2M, F3M, G1M, G2M, G3M = flux_c(tv.hM, tv.huM, tv.hvM)
        F1P, F2P, F3P, G1P, G2P, G3P = flux_c(tv.hP, tv.huP, tv.hvP)
        dq1, dq2, dq3 = tv.hM - tv.hP, tv.huM - tv.huP, tv.hvM - tv.hvP
        corr = None

    lam = _face_max(m, torch.maximum(tv.spdM, tv.spdP))
    d1 = 0.5 * ((F1M - F1P) * nx + (G1M - G1P) * ny - lam * dq1)
    d2 = 0.5 * ((F2M - F2P) * nx + (G2M - G2P) * ny - lam * dq2)
    d3 = 0.5 * ((F3M - F3P) * nx + (G3M - G3P) * ny - lam * dq3)
    if corr is not None:
        d1 = d1 + corr
        d2 = d2 + corr * tv.uM
        d3 = d3 + corr * tv.vM

    p = 0.5 * g * h * h
    if m.wetdry:
        u, v = _desingularized_velocity(h, hu, hv, m.h_floor)
        F2, G2, G3 = h * u * u + p, h * u * v, h * v * v + p
    else:
        inv_h = 1.0 / h
        u, v = hu * inv_h, hv * inv_h
        F2 = hu * hu * inv_h + p
        G2 = hu * hv * inv_h
        G3 = hv * hv * inv_h + p

    check_matmul_precision(h)
    rx, sx, ry, sy = (_elem(m, a[None]) for a in (o.rx, o.sx, o.ry, o.sy))

    def div(F, G):
        F, G = _elem(m, F), _elem(m, G)
        return (rx * (F @ o.Dr.T) + sx * (F @ o.Ds.T)
                + ry * (G @ o.Dr.T) + sy * (G @ o.Ds.T))

    def surf(d):
        return _elem(m, o.fscale * d) @ o.lift.T

    B = h.shape[0]
    rhs1 = (surf(d1) - div(hu, hv)).reshape(B, -1)
    rhs2 = (surf(d2) - div(F2, G2)).reshape(B, -1)
    rhs3 = (surf(d3) - div(G2, G3)).reshape(B, -1)

    if m.has_bathy:
        if m.wetdry:  # no bed-slope forcing in dry cells
            wet = (h > 5.0 * m.h_floor).to(h.dtype)
            rhs2 = rhs2 + g * h * o.Hx * wet
            rhs3 = rhs3 + g * h * o.Hy * wet
        else:
            rhs2 = rhs2 + g * h * o.Hx
            rhs3 = rhs3 + g * h * o.Hy
    if m.cd != 0.0:
        nrm = _safe_norm(u, v)
        rhs2 = rhs2 - m.cd * nrm * u
        rhs3 = rhs3 - m.cd * nrm * v
    if m.f_cor != 0.0:
        rhs2 = rhs2 + m.f_cor * hv
        rhs3 = rhs3 - m.f_cor * hu
    if ctrl is not None:
        rhs2 = rhs2 + ctrl @ o.BU
        rhs3 = rhs3 + ctrl @ o.BV
    return rhs1, rhs2, rhs3


def _filter(o, m, r):
    return (_elem(m, r) @ o.filt.T).reshape(r.shape)


def _eval_rhs_plain(o, m, h, hu, hv, t, ctrl, use_filter, rb=None):
    r = _rhs_plain(o, m, h, hu, hv, t, ctrl, rb)
    return tuple(_filter(o, m, a) for a in r) if use_filter else r


def _step_values(o, m, h, hu, hv, t, ctrl, dt, use_filter):
    k1 = _eval_rhs_plain(o, m, h, hu, hv, t, ctrl, use_filter)
    h1 = h + 0.5 * dt * k1[0]
    hu1 = hu + 0.5 * dt * k1[1]
    hv1 = hv + 0.5 * dt * k1[2]
    k2 = _eval_rhs_plain(o, m, h1, hu1, hv1, t + 0.5 * dt, ctrl, use_filter)
    return h + dt * k2[0], hu + dt * k2[1], hv + dt * k2[2]


def sw2d_step_plain(ops: FusedStepOps, meta: FusedStepMeta, h, hu, hv, ctrl,
                    dt: float, use_filter: bool = True, t0: float = 0.0):
    """Plain version of ``sw2d_step_fused``: one SSP-RK2 step on (B, nV)
    states with controls (B, n_ctrl)."""
    return _step_values(ops, meta, h, hu, hv, float(t0), ctrl, dt, use_filter)


def sw2d_rollout_plain(ops: FusedStepOps, meta: FusedStepMeta, h, hu, hv,
                       ctrls, dt: float, spc: int, use_filter: bool = True,
                       t0: float = 0.0):
    """Plain version of ``sw2d_rollout_fused``: returns the step-start
    trajectory (B, n_steps+1, nV) per field."""
    n_steps = ctrls.shape[1] * spc
    th, thu, thv = [h], [hu], [hv]
    for t in range(n_steps):
        h, hu, hv = _step_values(ops, meta, h, hu, hv, t0 + t * dt,
                                 ctrls[:, t // spc], dt, use_filter)
        th.append(h)
        thu.append(hu)
        thv.append(hv)
    return (torch.stack(th, dim=1), torch.stack(thu, dim=1),
            torch.stack(thv, dim=1))


def _rhs_vjp_plain(o: FusedStepOps, m: FusedStepMeta, h, hu, hv, t,
                   w1, w2, w3, rb=None):
    """Hand-derived VJP of the unfiltered, unforced RHS w.r.t. (h, hu, hv)
    and, given the receive buffer ``rb`` of a shard, w.r.t. ``rb`` as a
    fourth cotangent (B, L_r, 3).

    Recomputes the forward internals from the state, then runs the chain
    rule in reverse. The kernel does the same, node by node.
    """
    g = m.g
    B = h.shape[0]
    nx, ny = o.nx, o.ny
    tv = _trace_values(o, m, h, hu, hv, t, rb)
    if m.wb:
        dq1 = tv.hMs - tv.hPs
        dq2 = tv.hMs * tv.uM - tv.hPs * tv.uP
        dq3 = tv.hMs * tv.vM - tv.hPs * tv.vP
    else:
        dq1, dq2, dq3 = tv.hM - tv.hP, tv.huM - tv.huP, tv.hvM - tv.hvP
    spd = torch.maximum(tv.spdM, tv.spdP)
    lam = _face_max(m, spd)

    # ---- volume part: rhs_i = lift(fscale*dflux_i) - div(F_i, G_i) ----
    check_matmul_precision(h)
    rx, sx, ry, sy = (_elem(m, a[None]) for a in (o.rx, o.sx, o.ry, o.sy))
    W = [_elem(m, w) for w in (w1, w2, w3)]
    Fb = [-((rx * w) @ o.Dr + (sx * w) @ o.Ds).reshape(B, -1) for w in W]
    Gb = [-((ry * w) @ o.Dr + (sy * w) @ o.Ds).reshape(B, -1) for w in W]
    dfb = [o.fscale * (w @ o.lift).reshape(B, -1) for w in W]

    # volume flux adjoint: F1=hu, F2=hu^2/h+p, F3=G2=hu*hv/h, G1=hv,
    # G3=hv^2/h+p, p=g/2 h^2
    inv = 1.0 / h
    u, v = hu * inv, hv * inv
    w23 = Fb[2] + Gb[1]
    hub = Fb[0] + 2.0 * u * Fb[1] + v * w23
    hvb = Gb[0] + 2.0 * v * Gb[2] + u * w23
    hb = (g * h - u * u) * Fb[1] + (g * h - v * v) * Gb[2] - u * v * w23

    # sources
    if m.has_bathy:
        hb = hb + g * (o.Hx * w2 + o.Hy * w3)
    if m.cd != 0.0:
        nrm = _safe_norm(u, v)
        pos = nrm > 0.0
        inn = 1.0 / torch.where(pos, nrm, torch.ones_like(nrm))
        a2, a3 = -m.cd * w2, -m.cd * w3
        ub = a2 * (nrm + u * u * inn) + a3 * (u * v * inn)
        vb = a2 * (u * v * inn) + a3 * (nrm + v * v * inn)
        zero = torch.zeros_like(ub)
        ub, vb = torch.where(pos, ub, zero), torch.where(pos, vb, zero)
        hub = hub + ub * inv
        hvb = hvb + vb * inv
        hb = hb - (ub * u + vb * v) * inv
    if m.f_cor != 0.0:
        hvb = hvb + m.f_cor * w2
        hub = hub - m.f_cor * w3

    # ---- face part ----
    d1, d2, d3 = dfb
    # dflux_i = 0.5*(dF_i*nx + dG_i*ny - lam*dq_i) [+ corr*(1, uM, vM)]
    lamb = -0.5 * (dq1 * d1 + dq2 * d2 + dq3 * d3)
    q1, q2, q3 = -0.5 * lam * d1, -0.5 * lam * d2, -0.5 * lam * d3
    # cotangents of the '-' side fluxes (dq2 = F1M-F1P, dq3 = G1M-G1P ride
    # on F1, G1); the '+' side gets the negatives
    Fb1, Gb1 = 0.5 * nx * d1 + q2, 0.5 * ny * d1 + q3
    Fb2, Gb3 = 0.5 * nx * d2, 0.5 * ny * d3
    t23 = 0.5 * nx * d3 + 0.5 * ny * d2

    # lam = face max of max(spdM, spdP): the face-summed cotangent is split
    # evenly over the nodes that attain the maximum; an M/P tie is halved
    is_max = (spd == lam).to(spd.dtype).reshape(B, -1, m.n_fp)
    cnt = is_max.sum(dim=-1, keepdim=True)
    lsum = lamb.reshape(B, -1, m.n_fp).sum(dim=-1, keepdim=True)
    sb = (lsum * is_max / cnt).reshape(B, -1)
    wM = torch.where(tv.spdM > tv.spdP, 1.0,
                     torch.where(tv.spdM == tv.spdP, 0.5, 0.0)).to(spd.dtype)
    spdMb, spdPb = sb * wM, sb * (1.0 - wM)

    hMsb, hPsb = q1, -q1
    zero = torch.zeros_like(q1)
    uMb, vMb, hMb = zero, zero, zero
    if m.wb:
        unM = tv.uM * nx + tv.vM * ny
        corr = (tv.hM - tv.hMs) * unM
        corr_b = d1 + tv.uM * d2 + tv.vM * d3
        tb = corr_b * (tv.hM - tv.hMs)
        uMb = corr * d2 + tb * nx
        vMb = corr * d3 + tb * ny
        hMb = corr_b * unM
        hMsb = hMsb - corr_b * unM

    def flux_uv_vjp(hs, uu, vv):
        hsb = (uu * Fb1 + vv * Gb1 + (uu * uu + g * hs) * Fb2
               + (vv * vv + g * hs) * Gb3 + uu * vv * t23)
        ub = hs * (Fb1 + 2.0 * uu * Fb2 + vv * t23)
        vb = hs * (Gb1 + 2.0 * vv * Gb3 + uu * t23)
        return hsb, ub, vb

    a, b, c = flux_uv_vjp(tv.hMs, tv.uM, tv.vM)
    hMsb, uMb, vMb = hMsb + a, uMb + b, vMb + c
    a, b, c = flux_uv_vjp(tv.hPs, tv.uP, tv.vP)
    hPsb, uPb, vPb = hPsb - a, -b, -c

    def speed_vjp(sbar, uu, vv, hs):
        nrm = _safe_norm(uu, vv)
        pos = nrm > 0.0
        inn = torch.where(pos, 1.0 / torch.where(pos, nrm, torch.ones_like(nrm)),
                          torch.zeros_like(nrm))
        wet = hs > 0.0
        dh = torch.where(
            wet, 0.5 * torch.sqrt(g / torch.where(wet, hs, torch.ones_like(hs))),
            torch.zeros_like(hs))
        return sbar * uu * inn, sbar * vv * inn, sbar * dh

    a, b, c = speed_vjp(spdMb, tv.uM, tv.vM, tv.hMs)
    uMb, vMb, hMsb = uMb + a, vMb + b, hMsb + c
    a, b, c = speed_vjp(spdPb, tv.uP, tv.vP, tv.hPs)
    uPb, vPb, hPsb = uPb + a, vPb + b, hPsb + c

    if m.wb:
        hMb = hMb + torch.where(tv.passM, hMsb, zero)
        hPb = torch.where(tv.passP, hPsb, zero)
    else:
        hMb, hPb = hMb + hMsb, hPsb
    # u = hu / h
    huMb, hvMb = uMb / tv.hM, vMb / tv.hM
    hMb = hMb - (uMb * tv.uM + vMb * tv.vM) / tv.hM
    huPb, hvPb = uPb / tv.hP, vPb / tv.hP
    hPb = hPb - (uPb * tv.uP + vPb * tv.vP) / tv.hP
    if m.tidal is not None:  # a prescribed depth does not see the state
        hPb = torch.where(o.obc, zero, hPb)
    # wall reflection: the '+' momentum is a map of the '-' momentum
    unb = -2.0 * (nx * huPb + ny * hvPb)
    huMb = huMb + torch.where(o.wall, huPb + nx * unb, zero)
    hvMb = hvMb + torch.where(o.wall, hvPb + ny * unb, zero)
    huPb = torch.where(o.wall, zero, huPb)
    hvPb = torch.where(o.wall, zero, hvPb)

    # back through the gathers ('+' into the receive slots too, given rb)
    n_v = h.shape[1]
    if rb is not None:
        hb, hub, hvb = (torch.cat([f, f.new_zeros(B, rb.shape[1])], dim=1)
                        for f in (hb, hub, hvb))
    hb = hb.index_add(1, o.vmapM, hMb).index_add(1, o.vmapP, hPb)
    hub = hub.index_add(1, o.vmapM, huMb).index_add(1, o.vmapP, huPb)
    hvb = hvb.index_add(1, o.vmapM, hvMb).index_add(1, o.vmapP, hvPb)
    if rb is None:
        return hb, hub, hvb
    rbb = torch.stack([f[:, n_v:] for f in (hb, hub, hvb)], dim=-1)
    return hb[:, :n_v], hub[:, :n_v], hvb[:, :n_v], rbb


def _eval_rhs_vjp_plain(o, m, h, hu, hv, t, w1, w2, w3, use_filter,
                        rb=None):
    """VJP of the filtered, control-forced RHS: state cotangents and the
    control cotangent (B, n_ctrl); given the receive buffer ``rb`` of a
    shard, its cotangent (B, L_r, 3) follows."""
    if use_filter:
        w1, w2, w3 = ((_elem(m, w) @ o.filt).reshape(w.shape)
                      for w in (w1, w2, w3))
    cb = w2 @ o.BU.T + w3 @ o.BV.T
    hb, hub, hvb, *rbb = _rhs_vjp_plain(o, m, h, hu, hv, t, w1, w2, w3, rb)
    return (hb, hub, hvb, cb, *rbb)


def sw2d_rollout_bwd_plain(ops: FusedStepOps, meta: FusedStepMeta,
                           traj_h, traj_hu, traj_hv, tb_h, tb_hu, tb_hv,
                           ctrls, dt: float, spc: int,
                           use_filter: bool = True, t0: float = 0.0):
    """Plain version of ``sw2d_rollout_bwd_fused``: the reverse sweep of the
    SSP-RK2 rollout with the hand-derived RHS adjoint (no autograd).

    For each step t (T-1 .. 0) the stored step-start state is reloaded, the
    first RK stage is recomputed, and the adjoint state lambda is propagated:
      s_{t+1} = s_t + dt*R(s_t + dt/2*R(s_t))  gives
      a      = VJP_R(s_half)[dt*lambda]
      lambda = lambda + a + VJP_R(s_t)[(dt/2)*a].
    Returns the cotangents of (h0, hu0, hv0, ctrls).
    """
    o, m = ops, meta
    n_steps = traj_h.shape[1] - 1
    lh, lhu, lhv = (torch.zeros_like(traj_h[:, 0]) for _ in range(3))
    cb = torch.zeros_like(ctrls)
    for t in range(n_steps - 1, -1, -1):
        j = t // spc
        ctrl = ctrls[:, j]
        tt = t0 + t * dt
        lh, lhu, lhv = (lh + tb_h[:, t + 1], lhu + tb_hu[:, t + 1],
                        lhv + tb_hv[:, t + 1])
        h, hu, hv = traj_h[:, t], traj_hu[:, t], traj_hv[:, t]
        k1, k2, k3 = _eval_rhs_plain(o, m, h, hu, hv, tt, ctrl, use_filter)
        hh, hhu, hhv = h + 0.5 * dt * k1, hu + 0.5 * dt * k2, hv + 0.5 * dt * k3
        ah, ahu, ahv, cba = _eval_rhs_vjp_plain(
            o, m, hh, hhu, hhv, tt + 0.5 * dt, dt * lh, dt * lhu, dt * lhv,
            use_filter)
        bh, bhu, bhv, cbb = _eval_rhs_vjp_plain(
            o, m, h, hu, hv, tt, 0.5 * dt * ah, 0.5 * dt * ahu,
            0.5 * dt * ahv, use_filter)
        lh, lhu, lhv = lh + ah + bh, lhu + ahu + bhu, lhv + ahv + bhv
        cb[:, j] = cb[:, j] + cba + cbb
    return lh + tb_h[:, 0], lhu + tb_hu[:, 0], lhv + tb_hv[:, 0], cb


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class _SwDesc(ctypes.Structure):
    """Mirror of ``struct SwDesc`` in the kernels' source."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "K", "Np", "Nfaces", "Nfp", "n_ctrl", "wb", "has_bathy", "has_tidal",
        "has_sponge", "wetdry", "blocked")
    ] + [(n, ctypes.c_float) for n in (
        "g", "cd", "fcor", "tide_h0", "tide_amp", "tide_omega", "tide_tau",
        "h_floor")] + [(n, ctypes.c_int) for n in ("n_recv", "n_send")]


def _desc(meta: FusedStepMeta, blocked: bool = False, n_recv: int = 0,
          n_send: int = 0) -> _SwDesc:
    """``blocked``: the packed float buffer carries the blocked set's extra
    fields (still-water depth and sponge coefficient) after ``BV``.
    ``n_recv``/``n_send``: the halo slots of one shard of a sharded set."""
    h0, amp, omega, tau = meta.tidal if meta.tidal is not None else (0.0,) * 4
    return _SwDesc(meta.k_elem, meta.n_p, meta.n_faces, meta.n_fp,
                   meta.n_ctrl, int(meta.wb), int(meta.has_bathy),
                   int(meta.tidal is not None), int(meta.has_sponge),
                   int(meta.wetdry), int(blocked), meta.g, meta.cd,
                   meta.f_cor, h0, amp, omega, tau, meta.h_floor, n_recv,
                   n_send)


def _lib():
    """The compiled kernels with their argument types set (built at first
    use; needs nvcc and a CUDA device)."""
    from ._build import load

    lib = load("sw2d_dense")
    if getattr(lib, "_sw2d_typed", False):
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    D = ctypes.POINTER(_SwDesc)
    lib.sw2d_smem_bytes.argtypes = [D, I, I]
    lib.sw2d_smem_bytes.restype = ctypes.c_longlong
    lib.sw2d_dense_tile.argtypes = [D, I, I]
    lib.sw2d_dense_tile.restype = I
    lib.sw2d_dense_last_tile.argtypes = []
    lib.sw2d_dense_last_tile.restype = I
    lib.sw2d_step.argtypes = [D, P, P] + [P] * 7 + [I, F, F, I, P]
    lib.sw2d_rollout.argtypes = [D, P, P] + [P] * 7 + [I, I, I, F, F, I, P]
    lib.sw2d_rollout_bwd.argtypes = (
        [D, P, P] + [P] * 11 + [I, I, I, F, F, I, P])
    for fn in (lib.sw2d_step, lib.sw2d_rollout, lib.sw2d_rollout_bwd):
        fn.restype = I
    lib._sw2d_typed = True
    return lib


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, ref: torch.Tensor):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != ref.device:
        raise ValueError(f"{name}: on {t.device}, expected {ref.device}")
    if t.dtype != ref.dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {ref.dtype}")
    if t.is_cuda and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


# which kernel, as the launcher numbers them
_STEP, _ROLLOUT, _BWD = 0, 1, 2


def _check_kernel_inputs(ops: FusedStepOps, meta: FusedStepMeta,
                         ref: torch.Tensor, which: int):
    """What the kernels do not take raises here (no fallback)."""
    if ref.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels are float32, got {ref.dtype}")
    if ops.fbuf.device != ref.device or ops.ibuf.device != ref.device:
        raise ValueError("operator set and state lie on different devices")
    if meta.wetdry or meta.has_sponge:
        raise ValueError("the dense kernels have no wet/dry branch and no "
                         "sponge; use the blocked kernels")
    lib = _lib()
    desc = _desc(meta)
    tile = lib.sw2d_dense_tile(ctypes.byref(desc), ref.shape[0], which)
    if tile < 0:
        raise RuntimeError(f"CUDA error {-tile} while sizing the launch")
    if tile == 0:
        raise ValueError(
            f"K={meta.k_elem}, Np={meta.n_p}: one scenario's mesh does not "
            "fit one block of the dense kernels (a thread per element); use "
            "the blocked kernels")
    return lib, desc


def _launch_check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


_count_lock = threading.Lock()


def count_launches(wrapper, n: int = 1) -> None:
    """Adds ``n`` to a wrapper's launch counter (``wrapper.launches``) under
    a lock: the ranks of a ring in one process launch from threads of their
    own (and autograd's device thread), and a count must not lose one."""
    with _count_lock:
        wrapper.launches += n


def _launch_stream(t: torch.Tensor):
    """The stream a launch goes to: the current one of a CUDA tensor's
    device; none for the CPU (a build of the kernels' source for the host,
    in the tests)."""
    return torch.cuda.current_stream(t.device).cuda_stream if t.is_cuda \
        else None


def last_tile() -> int:
    """Scenarios a block of the last dense kernel launch took."""
    return int(_lib().sw2d_dense_last_tile())


def _run_step(ops, meta, h, hu, hv, ctrl, dt, use_filter, t0):
    """The step kernel's launch (the shapes checked by the caller)."""
    lib, desc = _check_kernel_inputs(ops, meta, h, _STEP)
    oh, ohu, ohv = (torch.empty_like(h) for _ in range(3))
    err = lib.sw2d_step(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        h.data_ptr(), hu.data_ptr(), hv.data_ptr(), ctrl.data_ptr(),
        oh.data_ptr(), ohu.data_ptr(), ohv.data_ptr(), h.shape[0], float(dt),
        float(t0), int(use_filter), _launch_stream(h))
    _launch_check(err, "sw2d_step_fused")
    return oh, ohu, ohv


def _run_rollout(ops, meta, h, hu, hv, ctrls, dt, spc, use_filter, t0):
    """The rollout kernel's launch (the shapes checked by the caller)."""
    lib, desc = _check_kernel_inputs(ops, meta, h, _ROLLOUT)
    B, n_cs = h.shape[0], ctrls.shape[1]
    shape = (B, n_cs * spc + 1, meta.n_v)
    th, thu, thv = (torch.empty(shape, dtype=h.dtype, device=h.device)
                    for _ in range(3))
    err = lib.sw2d_rollout(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        h.data_ptr(), hu.data_ptr(), hv.data_ptr(), ctrls.data_ptr(),
        th.data_ptr(), thu.data_ptr(), thv.data_ptr(), B, n_cs, int(spc),
        float(dt), float(t0), int(use_filter), _launch_stream(h))
    _launch_check(err, "sw2d_rollout_fused")
    return th, thu, thv


def _run_rollout_bwd(ops, meta, traj, tb, ctrls, dt, spc, use_filter, t0):
    """The adjoint kernel's launch (the shapes checked by the caller)."""
    traj_h = traj[0]
    lib, desc = _check_kernel_inputs(ops, meta, traj_h, _BWD)
    B = traj_h.shape[0]
    xb = [torch.empty((B, meta.n_v), dtype=traj_h.dtype, device=traj_h.device)
          for _ in range(3)]
    cb = torch.empty_like(ctrls)
    err = lib.sw2d_rollout_bwd(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        *(t.data_ptr() for t in traj), *(t.data_ptr() for t in tb),
        ctrls.data_ptr(), *(x.data_ptr() for x in xb), cb.data_ptr(), B,
        ctrls.shape[1], int(spc), float(dt), float(t0), int(use_filter),
        _launch_stream(traj_h))
    _launch_check(err, "sw2d_rollout_bwd_fused")
    return xb[0], xb[1], xb[2], cb


def sw2d_step_fused(ops: FusedStepOps, meta: FusedStepMeta, h, hu, hv, ctrl,
                    dt: float, use_filter: bool = True, t0: float = 0.0):
    """One fused SSP-RK2 shallow-water step on (B, nV) states with controls
    (B, n_ctrl).

    Replaces the TPU kernel ``_step_kernel`` / ``sw2d_step_pallas`` of
    ``blitzdg_tpu/ops/sw2d_pallas.py``. On the card it is bound by
    operations, not bytes: a step reads and writes 3*nV floats per scenario
    and spends some hundred float32 operations per node on them. One thread
    per (element, scenario), a tile of scenarios a block, neighbours met in
    shared memory (design: the kernels' source).
    """
    B = h.shape[0]
    for name, t in (("h", h), ("hu", hu), ("hv", hv)):
        _check_tensor(name, t, (B, meta.n_v), h)
    _check_tensor("ctrl", ctrl, (B, meta.n_ctrl), h)
    if h.device.type == "cpu":
        return sw2d_step_plain(ops, meta, h, hu, hv, ctrl, dt, use_filter, t0)
    out = _run_step(ops, meta, h, hu, hv, ctrl, dt, use_filter, t0)
    sw2d_step_fused.launches += 1
    return out


sw2d_step_fused.launches = 0


def sw2d_rollout_fused(ops: FusedStepOps, meta: FusedStepMeta, h, hu, hv,
                       ctrls, dt: float, spc: int, use_filter: bool = True,
                       t0: float = 0.0):
    """Fused SSP-RK2 rollout over n_ctrl_steps*spc steps in one launch; the
    control of step t is ``ctrls[:, t // spc]``. Returns the step-start
    trajectory (B, n_steps+1, nV) per field; ``[:, -1]`` is the final state.

    Replaces the TPU kernel ``_rollout_kernel`` / ``sw2d_rollout_pallas`` of
    ``blitzdg_tpu/ops/sw2d_pallas.py``. Device memory must take the whole
    trajectory (3*(n_steps+1)*nV floats per scenario), but the arithmetic of
    2*n_steps RHS evaluations outweighs it: the kernel is bound by
    operations. Each thread keeps its element's state in registers across
    all steps; only the step-start states are stored.
    """
    B = h.shape[0]
    for name, t in (("h", h), ("hu", hu), ("hv", hv)):
        _check_tensor(name, t, (B, meta.n_v), h)
    if ctrls.dim() != 3:
        raise ValueError("ctrls: expected (B, n_ctrl_steps, n_ctrl)")
    n_cs = ctrls.shape[1]
    _check_tensor("ctrls", ctrls, (B, n_cs, meta.n_ctrl), h)
    if h.device.type == "cpu":
        return sw2d_rollout_plain(ops, meta, h, hu, hv, ctrls, dt, spc,
                                  use_filter, t0)
    out = _run_rollout(ops, meta, h, hu, hv, ctrls, dt, spc, use_filter, t0)
    sw2d_rollout_fused.launches += 1
    return out


sw2d_rollout_fused.launches = 0


def sw2d_rollout_bwd_fused(ops: FusedStepOps, meta: FusedStepMeta,
                           traj_h, traj_hu, traj_hv, tb_h, tb_hu, tb_hv,
                           ctrls, dt: float, spc: int,
                           use_filter: bool = True, t0: float = 0.0):
    """Adjoint of ``sw2d_rollout_fused`` in one launch: takes the stored
    trajectory and its cotangents, returns the cotangents of
    (h0, hu0, hv0, ctrls).

    Replaces the TPU kernel ``_rollout_bwd_kernel`` /
    ``sw2d_rollout_bwd_pallas`` of ``blitzdg_tpu/ops/sw2d_pallas.py``, whose
    coastal adjoint comes from ``jax.vjp`` traced in the kernel; here it is
    derived by hand (see ``sw2d_rollout_bwd_plain``). It must read the
    trajectory and its cotangent once (6*(n_steps+1)*nV floats per
    scenario) and does about three RHS evaluations' worth of arithmetic per
    step: bound by operations. Per step each thread reloads its element of
    s_t, recomputes stage 1 and applies the RHS adjoint twice, lambda held
    in registers; the control cotangent is summed per thread and reduced
    once per control interval.
    """
    B, n1, _ = traj_h.shape
    n_cs = ctrls.shape[1]
    if n_cs * spc + 1 != n1:
        raise ValueError(f"trajectory of {n1} states does not match "
                         f"{n_cs} control steps x {spc}")
    for name, t in (("traj_h", traj_h), ("traj_hu", traj_hu),
                    ("traj_hv", traj_hv), ("tb_h", tb_h), ("tb_hu", tb_hu),
                    ("tb_hv", tb_hv)):
        _check_tensor(name, t, (B, n1, meta.n_v), traj_h)
    _check_tensor("ctrls", ctrls, (B, n_cs, meta.n_ctrl), traj_h)
    if traj_h.device.type == "cpu":
        return sw2d_rollout_bwd_plain(ops, meta, traj_h, traj_hu, traj_hv,
                                      tb_h, tb_hu, tb_hv, ctrls, dt, spc,
                                      use_filter, t0)
    out = _run_rollout_bwd(ops, meta, (traj_h, traj_hu, traj_hv),
                           (tb_h, tb_hu, tb_hv), ctrls, dt, spc, use_filter,
                           t0)
    sw2d_rollout_bwd_fused.launches += 1
    return out


sw2d_rollout_bwd_fused.launches = 0


def make_rollout(ops: FusedStepOps, meta: FusedStepMeta, dt: float, spc: int,
                 use_filter: bool = True, t0: float = 0.0,
                 forward=None, backward=None):
    """Differentiable fused rollout: returns ``rollout(h, hu, hv, ctrls) ->
    (traj_h, traj_hu, traj_hv)``, a ``torch.autograd.Function`` whose forward
    is ``sw2d_rollout_fused`` and whose backward is ``sw2d_rollout_bwd_fused``
    (the kernels on CUDA tensors, their plain versions on CPU tensors).

    ``forward``/``backward`` replace the two wrappers, e.g. by the plain
    versions to run those on the card for a comparison.
    """
    forward = sw2d_rollout_fused if forward is None else forward
    backward = sw2d_rollout_bwd_fused if backward is None else backward

    class _Rollout(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, hu, hv, ctrls):
            traj = forward(ops, meta, h, hu, hv, ctrls, dt, spc, use_filter,
                           t0)
            ctx.save_for_backward(*traj, ctrls)
            return traj

        @staticmethod
        def backward(ctx, tb_h, tb_hu, tb_hv):
            th, thu, thv, ctrls = ctx.saved_tensors
            return backward(
                ops, meta, th, thu, thv, tb_h.contiguous(),
                tb_hu.contiguous(), tb_hv.contiguous(), ctrls, dt, spc,
                use_filter, t0)

    return _Rollout.apply
