"""Element-blocked CUDA kernels: the LARGE-mesh shallow-water path, with
their plain PyTorch versions and the differentiable rollout built on them.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_blocked.py``
(``sw2d_step_blocked``, ``sw2d_rollout_blocked``,
``sw2d_rollout_bwd_blocked``, ``make_rollout_blocked``,
``build_blocked_step_ops``, ``matmul_flops_per_step``, and the element-sharded
path's stage kernels ``sw2d_stage_blocked`` (lean-I/O mode only) and
``sw2d_stage_bwd_blocked_v2`` and its one-launch step
``sw2d_step_rdma_blocked``, over a ``ShardOps`` set, which
``parallel/blocked_shard.py`` builds and drives). The dense kernels
(``sw2d_fused.py``) hold one scenario's whole mesh in one block, a
thread an element, which ends at a few hundred elements. Here the mesh is
split over blocks and neighbours are read from global memory
(``csrc/sw2d_blocked.cu``): every kernel takes a few lanes of a warp an
element, on one RK stage (``qstage``) and its adjoint (``qvjp``); the
forward rollout (and the step: a rollout of one step) and the rollout's
adjoint are one persistent cooperative launch each, grid-wide barriers
separating the RK stages.

Physics: everything ``sw2d_fused.py`` covers (wall reflection, tidal BC_OUT
depth at the stage time, well-balanced star fluxes over bathymetry, bed
slope, drag, Coriolis, linear control forcing) plus sponge relaxation after
each step and, forward only, wetting/drying (minmod surface reconstruction
of the traces, positivity limiter and momentum taper after every stage).

What is ported is the contract, not the TPU layout:
 - no packing: states are ``(B, K*Np)``, trajectories
   ``(B, n_steps+1, K*Np)``, controls ``(B, n_ctrl_steps, n_ctrl)``;
 - no roll/one-hot trace modes: '+' traces are index gathers through
   ``vmapP`` for any element numbering (``parallel.rcm_order`` helps
   locality, nothing depends on it);
 - no filter folding and no split-precision products: plain float32 FMAs;
 - the operator set EXTENDS the dense one (``BlockedOps`` is
   ``FusedStepOps`` plus still-water depth and sponge coefficient,
   ``BlockedMeta`` is ``FusedStepMeta``), and the RHS and its hand-derived
   adjoint are the ones of ``sw2d_fused.py``: this module adds the step
   structure (limiter, sponge) around them;
 - sponge without bathymetry relaxes the momenta only (as
   ``ops.sw2d.sponge_relax`` does in both packages);
 - ``make_rollout_blocked`` raises for a wet/dry operator set: the limiter
   has no adjoint here (the TPU kernel's backward omits the limiter's
   pullback, so there it is not the adjoint of its forward).

Every wrapper takes the plain version only for tensors that lie on the CPU.
For CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..context import DGContext2D
from .limiters import positivity_preserving_limiter
from .sw2d import SWPhysics
from .sw2d_fused import (FusedStepMeta, FusedStepOps, _SwDesc, _check_tensor,
                         _desc, _eval_rhs_plain, _eval_rhs_vjp_plain,
                         _launch_check, _launch_stream, _np64,
                         _operator_arrays, _ops_from_arrays, count_launches)

# Kernel launches on the device per call of a wrapper: one each (the
# stages, where there are several, separated by grid barriers inside it).
DEVICE_LAUNCHES_PER_CALL = 1

# The blocked path's switches (has_sponge, wetdry, h_floor) are fields of
# the one meta type that both operator sets share.
BlockedMeta = FusedStepMeta


@dataclass(frozen=True)
class BlockedOps(FusedStepOps):
    """The dense operator set plus what the blocked step adds. ``fbuf``
    carries ``H`` and ``SPNG`` after ``BV``."""

    H: torch.Tensor  # (nV,) still-water depth (zeros on a flat bottom)
    SPNG: torch.Tensor  # (nV,) sponge coefficient (zeros without sponge)


@dataclass(frozen=True)
class ShardOps(BlockedOps):
    """The operator sets of the shards of an element-sharded mesh, each
    field stacked on a leading shard axis (``parallel/blocked_shard.py``
    builds them). Each shard's set covers its own K_loc elements: ``vmapP``
    points at local nodes for interior faces and at ``K_loc*Np + j`` for a
    cut face, j being the receive slot that carries the '+' value; ``send``
    names the local node of each send slot (-1: an empty slot, sent as 0).
    Receive and send buffers have the same number of slots."""

    send: torch.Tensor  # (S, L) int64


def shard_view(ops: ShardOps, s: int) -> ShardOps:
    """Shard ``s``'s operator set (every field without the shard axis)."""
    return dataclasses.replace(ops, **{
        f.name: getattr(ops, f.name)[s] for f in dataclasses.fields(ops)})


def matmul_flops_per_step(meta: BlockedMeta, use_filter: bool = True) -> float:
    """Floating-point operations of the per-element operator products of one
    SSP-RK2 step and one scenario, for reporting: 2 RHS evaluations, each
    with Dr and Ds on the 5 distinct flux fields, the lift on 3 jumps and
    the filter on 3 fields. (The traces are gathers here, not products.)"""
    K, n_p, n_tr = meta.k_elem, meta.n_p, meta.n_faces * meta.n_fp
    per_rhs = (2 * 2 * n_p * n_p * K * 5    # Dr, Ds on 5 flux fields
               + 2 * n_p * n_tr * K * 3)    # lift
    if use_filter:
        per_rhs += 2 * n_p * n_p * K * 3
    return 2.0 * per_rhs


def build_blocked_step_ops(
    ctx: DGContext2D,
    phys: SWPhysics,
    forcing_bu: np.ndarray | None = None,  # (n_ctrl, K, Np) hu injector
    forcing_bv: np.ndarray | None = None,
    dtype: torch.dtype = torch.float32,
    tidal: tuple | None = None,  # (h0, amp, omega, ramp_tau) BC_OUT forcing
    wetdry: bool = False,
    h_floor: float = 1e-3,
    device="cuda",
) -> tuple[BlockedOps, BlockedMeta]:
    """Freeze the blocked operator set (host-side, once at setup)."""
    has_bathy = phys.H is not None
    if wetdry and not has_bathy:
        raise ValueError("wetdry needs bathymetry (phys.H)")
    arr, meta_kw = _operator_arrays(ctx, phys, forcing_bu, forcing_bv, tidal)
    n_v = meta_kw["n_v"]
    arr["H"] = _np64(phys.H).reshape(-1) if has_bathy else np.zeros(n_v)
    has_sponge = phys.sponge is not None
    arr["SPNG"] = (_np64(phys.sponge).reshape(-1) if has_sponge
                   else np.zeros(n_v))
    meta_kw.update(has_bathy=has_bathy, has_sponge=has_sponge,
                   wetdry=bool(wetdry), h_floor=float(h_floor))
    meta = BlockedMeta(**meta_kw)
    return _ops_from_arrays(arr, meta, dtype, device, cls=BlockedOps,
                            extra=("H", "SPNG"), mirror=True), meta


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the kernels' arithmetic, in tensor code)
# ---------------------------------------------------------------------------

def _limit_plain(m: BlockedMeta, h, hu, hv):
    """Per-stage positivity limiter + near-dry momentum taper, per element."""
    B = h.shape[0]
    e = lambda f: f.reshape(B, m.k_elem, m.n_p)
    h, hu, hv = positivity_preserving_limiter(e(h), e(hu), e(hv), m.h_floor)
    taper = torch.clamp((h - m.h_floor) / (4.0 * m.h_floor), 0.0, 1.0)
    return (h.reshape(B, -1), (hu * taper).reshape(B, -1),
            (hv * taper).reshape(B, -1))


def _sponge_factor(o: BlockedOps, dt: float):
    return 1.0 / (1.0 + dt * o.SPNG)


def _step_values(o, m, h, hu, hv, t, ctrl, dt, use_filter):
    """One SSP-RK2 step (stage times t and t + dt/2), the limiter after each
    stage when wet/dry, the sponge after the step."""
    k1 = _eval_rhs_plain(o, m, h, hu, hv, t, ctrl, use_filter)
    s1 = (h + 0.5 * dt * k1[0], hu + 0.5 * dt * k1[1], hv + 0.5 * dt * k1[2])
    if m.wetdry:
        s1 = _limit_plain(m, *s1)
    k2 = _eval_rhs_plain(o, m, *s1, t + 0.5 * dt, ctrl, use_filter)
    h, hu, hv = h + dt * k2[0], hu + dt * k2[1], hv + dt * k2[2]
    if m.wetdry:
        h, hu, hv = _limit_plain(m, h, hu, hv)
    if m.has_sponge:  # relax toward rest: h = H, no flow
        fac = _sponge_factor(o, dt)
        if m.has_bathy:
            h = o.H + (h - o.H) * fac
        hu, hv = hu * fac, hv * fac
    return h, hu, hv


def sw2d_step_blocked_plain(ops: BlockedOps, meta: BlockedMeta, h, hu, hv,
                            ctrl, dt: float, t0: float = 0.0,
                            use_filter: bool = True):
    """Plain version of ``sw2d_step_blocked``."""
    return _step_values(ops, meta, h, hu, hv, float(t0), ctrl, dt, use_filter)


def _n_steps(ctrls, spc: int, n_steps) -> int:
    if ctrls is not None:
        return ctrls.shape[1] * spc
    if n_steps is None:
        raise ValueError("n_steps is required when ctrls is None")
    return int(n_steps)


def sw2d_rollout_blocked_plain(ops: BlockedOps, meta: BlockedMeta, h, hu, hv,
                               ctrls, dt: float, spc: int = 1, n_steps=None,
                               t0: float = 0.0, use_filter: bool = True,
                               store_traj: bool = False):
    """Plain version of ``sw2d_rollout_blocked``."""
    n_steps = _n_steps(ctrls, spc, n_steps)
    th, thu, thv = [h], [hu], [hv]
    for t in range(n_steps):
        ctrl = None if ctrls is None else ctrls[:, t // spc]
        h, hu, hv = _step_values(ops, meta, h, hu, hv, t0 + t * dt, ctrl, dt,
                                 use_filter)
        if store_traj:
            th.append(h)
            thu.append(hu)
            thv.append(hv)
    if not store_traj:
        return h, hu, hv
    return (torch.stack(th, dim=1), torch.stack(thu, dim=1),
            torch.stack(thv, dim=1), h, hu, hv)


def _refuse_wetdry_adjoint(meta: BlockedMeta):
    if meta.wetdry:
        raise NotImplementedError(
            "the blocked rollout has no adjoint for a wet/dry operator set: "
            "the positivity limiter is not differentiated")


def sw2d_rollout_bwd_blocked_plain(ops: BlockedOps, meta: BlockedMeta,
                                   traj_h, traj_hu, traj_hv, tb_h, tb_hu,
                                   tb_hv, ctrls, dt: float, spc: int,
                                   t0: float = 0.0, use_filter: bool = True):
    """Plain version of ``sw2d_rollout_bwd_blocked``: the reverse sweep with
    the hand-derived RHS adjoint of ``sw2d_fused.py`` (no autograd).

    For each step t (T-1 .. 0), with lambda the adjoint of the stored
    s_{t+1} (which is the state AFTER the sponge):
      W      = (lambda + tbar_{t+1}) * sponge factor
      a      = VJP_R(s_half)[dt * W],  s_half = s_t + dt/2 R(s_t) recomputed
      lambda = W + a + VJP_R(s_t)[(dt/2) * a].
    Returns the cotangents of (h0, hu0, hv0, ctrls).
    """
    _refuse_wetdry_adjoint(meta)
    o, m = ops, meta
    n_steps = traj_h.shape[1] - 1
    lh, lhu, lhv = (torch.zeros_like(traj_h[:, 0]) for _ in range(3))
    cb = torch.zeros_like(ctrls)
    fac = _sponge_factor(o, dt) if m.has_sponge else None
    for t in range(n_steps - 1, -1, -1):
        j = t // spc
        ctrl = ctrls[:, j]
        tt = t0 + t * dt
        lh, lhu, lhv = (lh + tb_h[:, t + 1], lhu + tb_hu[:, t + 1],
                        lhv + tb_hv[:, t + 1])
        if fac is not None:
            if m.has_bathy:
                lh = lh * fac
            lhu, lhv = lhu * fac, lhv * fac
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
# One RK stage of an element-sharded set, plain versions
# ---------------------------------------------------------------------------

def _refuse_wetdry_stage_adjoint(meta: BlockedMeta):
    if meta.wetdry:
        raise NotImplementedError(
            "the sharded stage has no adjoint for a wet/dry operator set: "
            "the positivity limiter is not differentiated")


def _send_plain(o: ShardOps, h, hu, hv):
    """(B, L, 3) send buffer of one shard's (B, nV) state."""
    idx = o.send.clamp_min(0)
    keep = (o.send >= 0).to(h.dtype)
    return torch.stack([f[:, idx] * keep for f in (h, hu, hv)], dim=-1)


def _send_plain_vjp(o: ShardOps, lsb, n_v: int):
    """Cotangents of the (B, nV) fields of ``_send_plain``."""
    keep = o.send >= 0
    idx = o.send[keep]
    return tuple(lsb.new_zeros(lsb.shape[0], n_v).index_add(
        1, idx, lsb[:, keep, c]) for c in range(3))


def sw2d_stage_blocked_plain(ops: ShardOps, meta: BlockedMeta, base, cur, rb,
                             c_dt: float, t: float = 0.0, ctrl=None,
                             use_filter: bool = True,
                             apply_sponge: bool = False):
    """Plain version of ``sw2d_stage_blocked``."""
    c = None if ctrl is None else ctrl.reshape(1, -1)
    outs = []
    for s in range(ops.fbuf.shape[0]):
        o = shard_view(ops, s)
        r = _eval_rhs_plain(o, meta, *(f[s] for f in cur), float(t), c,
                            use_filter, rb=rb[s])
        out = tuple(b[s] + c_dt * ri for b, ri in zip(base, r))
        if meta.wetdry:
            out = _limit_plain(meta, *out)
        if apply_sponge and meta.has_sponge:  # relax toward rest
            fac = _sponge_factor(o, c_dt)
            h = o.H + (out[0] - o.H) * fac if meta.has_bathy else out[0]
            out = (h, out[1] * fac, out[2] * fac)
        outs.append((*out, _send_plain(o, *out)))
    return tuple(torch.stack([o_[i] for o_ in outs]) for i in range(4))


def sw2d_stage_bwd_blocked_v2_plain(ops: ShardOps, meta: BlockedMeta, cur,
                                    rb, lam_out, lam_sb, c_dt: float,
                                    t: float = 0.0, ctrl=None,
                                    use_filter: bool = True,
                                    apply_sponge: bool = False,
                                    lam_sb_add=None):
    """Plain version of ``sw2d_stage_bwd_blocked_v2``: the hand adjoint of
    ``sw2d_stage_blocked_plain`` (no autograd). ``lam_sb_add``: a second
    part of the send buffer's cotangent, added to ``lam_sb`` first."""
    _refuse_wetdry_stage_adjoint(meta)
    if lam_sb_add is not None:
        lam_sb = lam_sb + lam_sb_add
    n_v = cur[0].shape[2]
    outs = []
    for s in range(ops.fbuf.shape[0]):
        o = shard_view(ops, s)
        lo = [l[s] + g for l, g in
              zip(lam_out, _send_plain_vjp(o, lam_sb[s], n_v))]
        if apply_sponge and meta.has_sponge:
            fac = _sponge_factor(o, c_dt)
            lo = [lo[0] * fac if meta.has_bathy else lo[0],
                  lo[1] * fac, lo[2] * fac]
        hb, hub, hvb, cb, rbb = _eval_rhs_vjp_plain(
            o, meta, *(f[s] for f in cur), float(t), *(c_dt * l for l in lo),
            use_filter, rb=rb[s])
        outs.append((*lo, hb, hub, hvb, rbb, cb))
    res = [torch.stack([o_[i] for o_ in outs]) for i in range(8)]
    if ctrl is None:
        res[7] = None
    return tuple(res)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    """The compiled kernels with their argument types set (built at first
    use; needs nvcc and a CUDA device)."""
    from ._build import load

    lib = load("sw2d_blocked")
    if getattr(lib, "_sw2d_typed", False):
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    D = ctypes.POINTER(_SwDesc)
    lib.sw2d_blocked_last_grid.argtypes = []
    lib.sw2d_blocked_last_grid.restype = I
    lib.sw2d_blocked_barrier_probe.argtypes = [I, I, I, P]
    lib.sw2d_blocked_barrier_probe.restype = I
    Dbl = ctypes.c_double
    lib.sw2d_blocked_rollout.argtypes = (
        [D, P, P] + [P] * 11 + [I, I, I, I, Dbl, Dbl, I, P, P])
    lib.sw2d_blocked_rollout_bwd.argtypes = (
        [D, P, P] + [P] * 12 + [I, I, I, Dbl, Dbl, I, P, P])
    L = ctypes.c_longlong
    lib.sw2d_shard_plan.argtypes = [D, I, I, I, L, L, P]
    lib.sw2d_stage.argtypes = ([D, P, P, L, L, I, I] + [P] * 12
                               + [F, F, I, I, P, P])
    lib.sw2d_stage_bwd.argtypes = ([D, P, P, L, L, I, I] + [P] * 18
                                   + [F, F, I, I, P, P])
    lib.sw2d_step_rdma.argtypes = ([D, P, P, L, L, I, I] + [P] * 12
                                   + [F, F, F, I, I, P, P])
    lib.sw2d_step_rdma_peer.argtypes = ([D, P, P, L, L, I] + [P] * 12
                                        + [F, F, F, I, I, P, P])
    lib.sw2d_step_rdma_peer_load.argtypes = [D]
    U = ctypes.c_ulonglong
    lib.sw2d_stage_peer.argtypes = ([D, P, P, L, L, I] + [P] * 14
                                    + [U, U, U, F, F, I, I, P, P])
    lib.sw2d_stage_bwd_peer.argtypes = ([D, P, P, L, L, I] + [P] * 20
                                        + [U, U, U, F, F, I, I, P, P])
    lib.sw2d_stage_peer_load.argtypes = [D, I]
    for fn in (lib.sw2d_blocked_rollout,
               lib.sw2d_blocked_rollout_bwd, lib.sw2d_shard_plan,
               lib.sw2d_stage, lib.sw2d_stage_bwd, lib.sw2d_step_rdma,
               lib.sw2d_step_rdma_peer, lib.sw2d_step_rdma_peer_load,
               lib.sw2d_stage_peer, lib.sw2d_stage_bwd_peer,
               lib.sw2d_stage_peer_load):
        fn.restype = I
    lib._sw2d_typed = True
    return lib


def _check_kernel_inputs(ops: BlockedOps, meta: BlockedMeta,
                         ref: torch.Tensor):
    """What the kernels do not take raises here (no fallback)."""
    if ref.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels are float32, got {ref.dtype}")
    if not isinstance(ops, BlockedOps):
        raise TypeError("the blocked kernels need a BlockedOps operator set")
    if ops.fbuf.device != ref.device or ops.ibuf.device != ref.device:
        raise ValueError("operator set and state lie on different devices")
    lib = _lib()
    n_halo = ops.send.shape[-1] if isinstance(ops, ShardOps) else 0
    return lib, _desc(meta, blocked=True, n_recv=n_halo, n_send=n_halo)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# The q kernels' launch plans by shape (descriptor, S, B, kernel, row
# lengths of the packed buffers): made once a shape (block size, grid and
# shared memory from the occupancy the device reports), so that a launch
# issues nothing but the launch and can be captured into a CUDA graph.
# The kernels, as the launcher numbers them: the sharded stage (B7), the
# one-launch step (B9), the sharded stage's adjoint (B8), the blocked
# rollout's adjoint (B6), the blocked rollout (B5; B4 a rollout of one step),
# the one-launch step's peer mode (B9 across ranks), the stage's and its
# adjoint's peer modes (B7 and B8 across ranks).
(_STAGE, _RDMA, _STAGE_BWD, _ROLLOUT_BWD, _ROLLOUT, _RDMA_PEER, _STAGE_PEER,
 _STAGE_BWD_PEER) = range(8)
_plans: dict = {}
# The room of the kernels' run-time-size arrays (QMAX_NP in the source):
# triangles up to N=6, quadrilaterals up to N=4.
SHARD_MAX_NP = 28
_KERNEL_NAMES = {_STAGE: "the sharded stage (B7)",
                 _RDMA: "the one-launch sharded step (B9)",
                 _STAGE_BWD: "the sharded stage's adjoint (B8)",
                 _ROLLOUT_BWD: "the blocked rollout's adjoint (B6)",
                 _ROLLOUT: "the blocked rollout (B5, B4)",
                 _RDMA_PEER: "the one-launch sharded step across ranks (B9)",
                 _STAGE_PEER: "the sharded stage across ranks (B7)",
                 _STAGE_BWD_PEER: "the sharded stage's adjoint across ranks "
                                  "(B8)"}


def _shard_plan(lib, desc, ops: BlockedOps, B: int, which: int):
    """The plan of kernel ``which`` over ``ops``'s shards (one shard for a
    ``BlockedOps`` set) at ``B`` scenarios. Every kernel takes triangles up
    to N=6 and quadrilaterals up to N=4; above, it raises, naming itself."""
    if desc.Nfaces == 4 and desc.Np > SHARD_MAX_NP:
        raise ValueError(
            f"{_KERNEL_NAMES[which]} takes quadrilaterals of order N <= 4 (at "
            f"most {SHARD_MAX_NP} nodes an element); this set has "
            f"{desc.Np} nodes")
    if desc.Nfaces not in (3, 4) or desc.Np > SHARD_MAX_NP:
        raise ValueError(
            f"{_KERNEL_NAMES[which]} takes triangles of order N <= 6 (at "
            f"most {SHARD_MAX_NP} nodes an element); this set has "
            f"{desc.Np} nodes, {desc.Nfaces} faces")
    if isinstance(ops, ShardOps):
        S, fs, is_ = ops.send.shape[0], ops.fbuf.shape[1], ops.ibuf.shape[1]
    else:
        S, fs, is_ = 1, ops.fbuf.shape[0], ops.ibuf.shape[0]
    key = (bytes(desc), S, B, which, fs, is_)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_int * 4)()
        _launch_check(lib.sw2d_shard_plan(ctypes.byref(desc), S, B, which,
                                          fs, is_, plan), "sw2d_shard_plan")
        _plans[key] = plan
    return plan


def _plan_dict(plan) -> dict:
    return dict(zip(("threads", "grid", "smem_bytes", "lanes_per_element"),
                    plan))


def shard_plan(ops: ShardOps, meta: BlockedMeta, batch: int,
               step: bool = False, adjoint: bool = False,
               peer: bool = False) -> dict:
    """The launch plan of the sharded stage kernel (with ``step``, of the
    one-launch step kernel; with ``adjoint``, of the stage's adjoint; with
    ``peer`` too, of the kernel's peer mode) over ``ops``'s shards at
    ``batch`` scenarios: threads a block, blocks, bytes of shared memory a
    block, lanes an element (needs the card)."""
    lib, desc = _check_kernel_inputs(ops, meta, ops.fbuf)
    which = ((_RDMA_PEER if peer else _RDMA) if step
             else (_STAGE_BWD_PEER if peer else _STAGE_BWD) if adjoint
             else _STAGE_PEER if peer else _STAGE)
    return _plan_dict(_shard_plan(lib, desc, ops, batch, which))


def rollout_plan(ops: BlockedOps, meta: BlockedMeta, batch: int) -> dict:
    """The launch plan of the kernel of ``sw2d_rollout_blocked`` and
    ``sw2d_step_blocked`` at ``batch`` scenarios, as ``shard_plan`` gives it
    (needs the card)."""
    lib, desc = _check_kernel_inputs(ops, meta, ops.fbuf)
    return _plan_dict(_shard_plan(lib, desc, ops, batch, _ROLLOUT))


def rollout_bwd_plan(ops: BlockedOps, meta: BlockedMeta, batch: int) -> dict:
    """The launch plan of ``sw2d_rollout_bwd_blocked``'s kernel at ``batch``
    scenarios, as ``shard_plan`` gives it (needs the card)."""
    lib, desc = _check_kernel_inputs(ops, meta, ops.fbuf)
    return _plan_dict(_shard_plan(lib, desc, ops, batch, _ROLLOUT_BWD))


def last_grid() -> int:
    """Thread blocks of the last kernel launch of this module."""
    return int(_lib().sw2d_blocked_last_grid())


def barrier_probe(n_barriers: int, grid: int, threads: int, device) -> None:
    """Launch ``grid`` co-resident blocks of ``threads`` threads that pass
    ``n_barriers`` grid barriers and do nothing else: timed by a caller, it
    gives the cost of one barrier of the kernels above (a measuring aid, not
    part of any solver path)."""
    err = _lib().sw2d_blocked_barrier_probe(
        int(n_barriers), int(grid), int(threads),
        torch.cuda.current_stream(device).cuda_stream)
    _launch_check(err, "barrier_probe")


def _check_state(meta, h, hu, hv):
    B = h.shape[0]
    for name, t in (("h", h), ("hu", hu), ("hv", hv)):
        _check_tensor(name, t, (B, meta.n_v), h)
    return B


def sw2d_step_blocked(ops: BlockedOps, meta: BlockedMeta, h, hu, hv, ctrl,
                      dt: float, t0: float = 0.0, use_filter: bool = True):
    """One SSP-RK2 shallow-water step on a large mesh: (B, nV) states,
    controls (B, n_ctrl) or None.

    Replaces the TPU kernel ``_step_kernel`` / ``sw2d_step_blocked`` of
    ``blitzdg_tpu/ops/sw2d_blocked.py``. Bound by operations (6 nV floats of
    traffic against some hundred operations per node). The kernel of
    ``sw2d_rollout_blocked``, launched for one step: step t of a rollout
    from ``t0`` is this step from ``t0 + t * dt``, bit for bit. Takes
    triangles up to N=6 and quadrilaterals up to N=4, and raises above.
    """
    B = _check_state(meta, h, hu, hv)
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (B, meta.n_ctrl), h)
    if h.device.type == "cpu":
        return sw2d_step_blocked_plain(ops, meta, h, hu, hv, ctrl, dt, t0,
                                       use_filter)
    _, final = _run_rollout(ops, meta, (h, hu, hv), ctrl, 1, dt, 1, 1, t0,
                            use_filter, False)
    sw2d_step_blocked.launches += 1
    return final


sw2d_step_blocked.launches = 0


def sw2d_rollout_blocked(ops: BlockedOps, meta: BlockedMeta, h, hu, hv, ctrls,
                         dt: float, spc: int = 1, n_steps: int | None = None,
                         t0: float = 0.0, use_filter: bool = True,
                         store_traj: bool = False):
    """SSP-RK2 rollout on a large mesh in one launch. ``ctrls`` is
    (B, n_ctrl_steps, n_ctrl), the control of step t being
    ``ctrls[:, t // spc]``, or None with ``n_steps`` given. Returns the final
    state triple; with ``store_traj`` the step-start trajectory
    (B, n_steps+1, nV) per field first, then the final state (views of its
    last row).

    Replaces the TPU kernel ``_rollout_kernel`` / ``sw2d_rollout_blocked``
    of ``blitzdg_tpu/ops/sw2d_blocked.py``. Bound by operations: 2 n_steps
    RHS evaluations against one state in, one out (plus the trajectory when
    stored). One cooperative launch on the sharded kernels' stage
    (``qstage``: four lanes of a warp an element at N=3, eight at N=6, one
    at other orders), two grid barriers a step, the block size planned once
    a shape (``rollout_plan``); design: see the source of the kernels,
    measurements: PERF.md. Takes triangles up to N=6 and quadrilaterals
    (four faces) up to N=4, eight lanes an element at N=4 (its
    compile-time instance), one at other orders, and raises above.
    """
    B = _check_state(meta, h, hu, hv)
    if ctrls is not None:
        if ctrls.dim() != 3:
            raise ValueError("ctrls: expected (B, n_ctrl_steps, n_ctrl)")
        _check_tensor("ctrls", ctrls, (B, ctrls.shape[1], meta.n_ctrl), h)
    n_steps = _n_steps(ctrls, spc, n_steps)
    if n_steps < 1 or spc < 1:
        raise ValueError("the rollout needs at least one step")
    if h.device.type == "cpu":
        return sw2d_rollout_blocked_plain(ops, meta, h, hu, hv, ctrls, dt,
                                          spc, n_steps, t0, use_filter,
                                          store_traj)
    traj, final = _run_rollout(
        ops, meta, (h, hu, hv), ctrls,
        0 if ctrls is None else ctrls.shape[1], dt, spc, n_steps, t0,
        use_filter, store_traj)
    sw2d_rollout_blocked.launches += 1
    if store_traj:
        return (*traj, *(f[:, -1] for f in traj))
    return final


sw2d_rollout_blocked.launches = 0


def _run_rollout(ops: BlockedOps, meta: BlockedMeta, state, ctrls, n_cs, dt,
                 spc, n_steps, t0, use_filter, store_traj):
    """The forward kernel's launch (the shapes checked by the caller):
    ``n_steps`` steps from ``state``, ``ctrls`` (B, n_cs, n_ctrl) or None
    (one step: (B, n_ctrl)). Returns the trajectory triple and the final
    triple, the one not asked for as Nones."""
    h = state[0]
    lib, desc = _check_kernel_inputs(ops, meta, h)
    B = h.shape[0]
    plan = _shard_plan(lib, desc, ops, B, _ROLLOUT)
    new = lambda *shape: torch.empty(shape, dtype=h.dtype, device=h.device)
    s1 = new(3, B, meta.n_v)
    if store_traj:
        traj = tuple(new(B, n_steps + 1, meta.n_v) for _ in range(3))
        final = (None,) * 3
    else:
        traj, final = (None,) * 3, tuple(new(B, meta.n_v) for _ in range(3))
    err = lib.sw2d_blocked_rollout(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        *(f.data_ptr() for f in state), _ptr(ctrls),
        *(_ptr(f) for f in final), *(_ptr(f) for f in traj), s1.data_ptr(),
        B, n_steps, n_cs, int(spc), float(dt), float(t0), int(use_filter),
        plan, _launch_stream(h))
    _launch_check(err, "sw2d_rollout_blocked")
    return traj, final


def sw2d_rollout_bwd_blocked(ops: BlockedOps, meta: BlockedMeta,
                             traj_h, traj_hu, traj_hv, tb_h, tb_hu, tb_hv,
                             ctrls, dt: float, spc: int, t0: float = 0.0,
                             use_filter: bool = True):
    """Adjoint of ``sw2d_rollout_blocked`` in one launch: takes the stored
    trajectory and its cotangents, returns the cotangents of
    (h0, hu0, hv0, ctrls).

    Replaces the TPU kernel ``_rollout_bwd_kernel`` /
    ``sw2d_rollout_bwd_blocked`` of ``blitzdg_tpu/ops/sw2d_blocked.py``,
    whose pullback comes from ``jax.vjp`` traced in the kernel; here it is
    the hand-derived adjoint of ``sw2d_fused.py``. Bound by operations (one
    RHS recompute and two adjoint applications per step against one read of
    trajectory and cotangent). One cooperative launch, the block size
    planned once a shape (``rollout_bwd_plan``), two grid barriers a step:
    the recompute runs on the sharded stage's code (``qstage``, four lanes
    an element at N=3) and both products on its adjoint (``qvjp``), each
    lane completing its own nodes (the neighbours' side of each face
    recomputed, no scatter); sums are taken in a fixed order, no atomics.
    Takes triangles up to N=6 and quadrilaterals (four faces) up to N=4:
    at N=4 the blocked rollout's compile-time instance, eight lanes an
    element (the recompute gives its bits), ``qvjp``'s faces five nodes on
    eight lanes, three masked; one lane at other orders; raises above.
    """
    _refuse_wetdry_adjoint(meta)
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
        return sw2d_rollout_bwd_blocked_plain(
            ops, meta, traj_h, traj_hu, traj_hv, tb_h, tb_hu, tb_hv, ctrls,
            dt, spc, t0, use_filter)
    out = _run_rollout_bwd(ops, meta, (traj_h, traj_hu, traj_hv),
                           (tb_h, tb_hu, tb_hv), ctrls, dt, spc, t0,
                           use_filter)
    sw2d_rollout_bwd_blocked.launches += 1
    return out


def _run_rollout_bwd(ops: BlockedOps, meta: BlockedMeta, traj, tb, ctrls, dt,
                     spc, t0, use_filter):
    """The rollout adjoint kernel's launch (the shapes checked by the
    caller)."""
    lib, desc = _check_kernel_inputs(ops, meta, traj[0])
    B, n_cs = ctrls.shape[:2]
    plan = _shard_plan(lib, desc, ops, B, _ROLLOUT_BWD)
    new = lambda *shape: torch.empty(shape, dtype=traj[0].dtype,
                                     device=traj[0].device)
    xb = [new(B, meta.n_v) for _ in range(3)]
    cb = torch.empty_like(ctrls)
    # s_half, W and a, (3, B, nV) each; the elements' control shares; the
    # tidal depths of the stage times
    work = new(9 * B * meta.n_v + B * n_cs * meta.k_elem * meta.n_ctrl
               + 2 * n_cs * spc)
    err = lib.sw2d_blocked_rollout_bwd(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        *(f.data_ptr() for f in traj), *(f.data_ptr() for f in tb),
        ctrls.data_ptr(), *(f.data_ptr() for f in xb), cb.data_ptr(),
        work.data_ptr(), B, n_cs, int(spc), float(dt), float(t0),
        int(use_filter), plan, _launch_stream(traj[0]))
    _launch_check(err, "sw2d_rollout_bwd_blocked")
    return xb[0], xb[1], xb[2], cb


sw2d_rollout_bwd_blocked.launches = 0


def make_rollout_blocked(ops: BlockedOps, meta: BlockedMeta, dt: float,
                         spc: int, t0: float = 0.0, use_filter: bool = True,
                         forward=None, backward=None):
    """Differentiable blocked rollout: returns ``rollout(h, hu, hv, ctrls)
    -> (traj_h, traj_hu, traj_hv)`` of step-start states (B, n_steps+1, nV),
    a ``torch.autograd.Function`` whose forward is ``sw2d_rollout_blocked``
    with the trajectory stored and whose backward is
    ``sw2d_rollout_bwd_blocked`` (the kernels on CUDA tensors, their plain
    versions on CPU tensors). The large-mesh twin of
    ``sw2d_fused.make_rollout``.

    ``forward``/``backward`` replace the two wrappers, e.g. by the plain
    versions to run those on the card for a comparison.
    """
    _refuse_wetdry_adjoint(meta)
    forward = sw2d_rollout_blocked if forward is None else forward
    backward = sw2d_rollout_bwd_blocked if backward is None else backward

    class _Rollout(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, hu, hv, ctrls):
            traj = forward(ops, meta, h, hu, hv, ctrls, dt, spc, t0=t0,
                           use_filter=use_filter, store_traj=True)[:3]
            ctx.save_for_backward(*traj, ctrls)
            return tuple(traj)

        @staticmethod
        def backward(ctx, tb_h, tb_hu, tb_hv):
            th, thu, thv, ctrls = ctx.saved_tensors
            return backward(
                ops, meta, th, thu, thv, tb_h.contiguous(),
                tb_hu.contiguous(), tb_hv.contiguous(), ctrls, dt, spc, t0,
                use_filter)

    return _Rollout.apply


def _check_stage(ops: ShardOps, meta: BlockedMeta, fields: dict, rb):
    """Shapes of the stage's (S, B, nV) fields and (S, B, L, 3) buffers."""
    if not isinstance(ops, ShardOps):
        raise TypeError("the stage kernels need a ShardOps operator set")
    S, L = ops.send.shape
    ref = rb
    B = rb.shape[1]
    _check_tensor("rb", rb, (S, B, L, 3), ref)
    for name, t in fields.items():
        shape = (S, B, L, 3) if name == "lam_sb" else (S, B, meta.n_v)
        _check_tensor(name, t, shape, ref)
    return S, B, L


def sw2d_stage_blocked(ops: ShardOps, meta: BlockedMeta, base, cur, rb,
                       c_dt: float, t: float = 0.0, ctrl=None,
                       use_filter: bool = True, apply_sponge: bool = False,
                       ring=None):
    """One RK stage on every shard of an element-sharded set:
    ``out = base + c_dt * R(cur)``, the cut faces' '+' values read from the
    receive buffer, then the positivity limiter (wet/dry) and, with
    ``apply_sponge`` (the last stage of a step), the sponge; and the send
    buffer of ``out`` for the next exchange. ``base``, ``cur``: 3-tuples of
    (S, B, nV); ``rb``: (S, B, L, 3); ``t``: the stage time; ``ctrl``:
    (n_ctrl,), one control vector for every scenario and shard, or None.
    Returns (h, hu, hv, sb) with sb (S, B, L, 3).

    Replaces the TPU kernel ``_stage_kernel`` / ``sw2d_stage_blocked``
    (lean-I/O mode) of ``blitzdg_tpu/ops/sw2d_blocked.py``. Bound by
    bytes: six state reads and three writes against one RHS per node, whose
    operations take less time on the card than the bytes' transfer. One
    ordinary launch covers every shard, four lanes an element at N=3,
    eight at N=6, one at other orders, the block size planned once a shape
    (``shard_plan``); design: see the source of the kernels. Takes triangles
    up to N=6 and quadrilaterals (four faces) up to N=4, eight lanes an
    element at N=4 (its compile-time instance), one at other orders, and
    raises above.

    ``ring``: this rank's ``parallel.StageRing`` (one shard a rank):
    ``sw2d_stage_blocked_peer``, the ring's exchange of the send buffer
    folded into the launch; ``rb`` may then be None (the ring's slots), and
    the receive buffer read comes back as a fifth entry.
    """
    if ring is not None:
        return sw2d_stage_blocked_peer(ops, meta, base, cur, rb, ring, c_dt,
                                       t, ctrl, use_filter, apply_sponge)
    _check_stage(ops, meta, {"base_h": base[0], "base_hu": base[1],
                             "base_hv": base[2], "h": cur[0], "hu": cur[1],
                             "hv": cur[2]}, rb)
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (meta.n_ctrl,), rb)
    if rb.device.type == "cpu":
        return sw2d_stage_blocked_plain(ops, meta, base, cur, rb, c_dt, t,
                                        ctrl, use_filter, apply_sponge)
    out = _run_stage(ops, meta, base, cur, rb, c_dt, t, ctrl, use_filter,
                     apply_sponge)
    count_launches(sw2d_stage_blocked)
    return out


sw2d_stage_blocked.launches = 0


def _run_stage(ops: ShardOps, meta: BlockedMeta, base, cur, rb, c_dt, t,
               ctrl, use_filter, apply_sponge):
    """The stage kernel's launch (the shapes checked by the caller)."""
    lib, desc = _check_kernel_inputs(ops, meta, rb)
    S, B = rb.shape[:2]
    plan = _shard_plan(lib, desc, ops, B, _STAGE)
    out = [torch.empty_like(cur[0]) for _ in range(3)]
    sb = torch.empty_like(rb)
    err = lib.sw2d_stage(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        ops.fbuf.shape[1], ops.ibuf.shape[1], S, B,
        *(f.data_ptr() for f in base), *(f.data_ptr() for f in cur),
        rb.data_ptr(), _ptr(ctrl), *(f.data_ptr() for f in out),
        sb.data_ptr(), float(c_dt), float(t), int(use_filter),
        int(apply_sponge and meta.has_sponge), plan, _launch_stream(rb))
    _launch_check(err, "sw2d_stage_blocked")
    return (*out, sb)


def sw2d_stage_bwd_blocked_v2(ops: ShardOps, meta: BlockedMeta, cur, rb,
                              lam_out, lam_sb, c_dt: float, t: float = 0.0,
                              ctrl=None, use_filter: bool = True,
                              apply_sponge: bool = False, ring=None,
                              send: bool = True, lam_sb_add=None):
    """Adjoint of ``sw2d_stage_blocked``: from the cotangents of
    (out, sb) to those of (base, cur, rb) and, given ``ctrl``, the control
    cotangent of each shard and scenario (S, B, n_ctrl); None without.
    Returns (base_h, base_hu, base_hv, cur_h, cur_hu, cur_hv, rb, ctrl)
    cotangents.

    Replaces the TPU kernel ``_stage_bwd_kernel_v2`` /
    ``sw2d_stage_bwd_blocked_v2`` of ``blitzdg_tpu/ops/sw2d_blocked.py``,
    whose RHS pullback is ``jax.vjp`` traced in the kernel; here it is the
    hand adjoint of ``sw2d_fused.py`` with the receive buffer as a further
    gather source. Bound by bytes (the states and cotangents read and
    written outweigh one RHS adjoint per node). One ordinary launch on the
    stage's adjoint (``qvjp``: four lanes an element at N=3, sixteen at
    small batches, where an element's chain sets the time; each lane
    completing its own nodes, the neighbours' side of each face recomputed,
    no scatter and no grid barrier), the block size planned once a shape
    (``shard_plan(..., adjoint=True)``), the control sums' scratch made
    once a shape; no atomics on data, the same bits on a rerun. Takes
    triangles up to N=6 and quadrilaterals (four faces) up to N=4: at N=4
    eight lanes an element, ``qvjp``'s faces five nodes on eight lanes,
    three masked; one lane at other orders; raises above.

    ``ring``: this rank's ``parallel.StageRing`` (one shard a rank):
    ``sw2d_stage_bwd_blocked_peer``, the reverse of the ring's exchange
    folded into the launch (``lam_sb`` None: the ring's reverse slots;
    ``send``: the receive buffer's cotangent back to its senders;
    ``lam_sb_add``: a second part of the send buffer's cotangent, added in
    the launch). Without a ring ``lam_sb_add`` is the plain version's only:
    the stacked kernel takes one send-buffer cotangent.
    """
    if ring is not None:
        return sw2d_stage_bwd_blocked_peer(ops, meta, cur, rb, lam_out,
                                           lam_sb, ring, c_dt, t, ctrl,
                                           use_filter, apply_sponge, send,
                                           lam_sb_add)
    _refuse_wetdry_stage_adjoint(meta)
    S, B, L = _check_stage(ops, meta, {
        "h": cur[0], "hu": cur[1], "hv": cur[2], "lam_h": lam_out[0],
        "lam_hu": lam_out[1], "lam_hv": lam_out[2], "lam_sb": lam_sb}, rb)
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (meta.n_ctrl,), rb)
    if rb.device.type == "cpu":
        return sw2d_stage_bwd_blocked_v2_plain(ops, meta, cur, rb, lam_out,
                                               lam_sb, c_dt, t, ctrl,
                                               use_filter, apply_sponge,
                                               lam_sb_add)
    if lam_sb_add is not None:
        raise ValueError("lam_sb_add: the stacked stage adjoint takes one "
                         "send-buffer cotangent (the peer mode, ring=, takes "
                         "two)")
    out = _run_stage_bwd(ops, meta, cur, rb, lam_out, lam_sb, c_dt, t, ctrl,
                         use_filter, apply_sponge)
    count_launches(sw2d_stage_bwd_blocked_v2)
    return out


# The stage adjoint's scratch by stream and plan (device, stream, S, B, K,
# n_ctrl, items a block): the blocks' sums of their items' control shares
# and the counters of the blocks done with each shard and scenario (0
# between launches), made once, which every launch on the stream reuses
# (launches on two streams run at once, as the ranks of a ring in one
# process do, and each needs its own; on the host build of the kernels,
# in the tests, each thread); a CUDA graph that captures a launch reads
# them (this dictionary keeps them).
_stage_bwd_scratch: dict = {}


def _run_stage_bwd(ops: ShardOps, meta: BlockedMeta, cur, rb, lam_out,
                   lam_sb, c_dt, t, ctrl, use_filter, apply_sponge,
                   peer=None):
    """The stage adjoint kernel's launch (the shapes checked by the
    caller); with ``peer`` = (ring, e_in, e_out, e_skip, lam_sb_add), its
    peer mode's."""
    lib, desc = _check_kernel_inputs(ops, meta, rb)
    S, B = rb.shape[:2]
    plan = _shard_plan(lib, desc, ops, B,
                       _STAGE_BWD if peer is None else _STAGE_BWD_PEER)
    new = lambda: torch.empty_like(cur[0])
    bb, cb = [new() for _ in range(3)], [new() for _ in range(3)]
    rbb = torch.empty_like(rb)
    ctl = cpart = done = None
    if ctrl is not None:
        ctl = rb.new_empty((S, B, meta.n_ctrl))
        ipb = plan[0] // plan[3]
        stream = (torch.cuda.current_stream(rb.device).cuda_stream
                  if rb.is_cuda else threading.get_ident())
        key = (rb.device, stream, S, B, meta.k_elem, meta.n_ctrl, ipb)
        if key not in _stage_bwd_scratch:
            segments = -(-meta.k_elem // ipb) + 1
            _stage_bwd_scratch[key] = (
                rb.new_empty(S * B * segments * meta.n_ctrl),
                torch.zeros(S * B, dtype=torch.int32, device=rb.device))
        cpart, done = _stage_bwd_scratch[key]
    head = (ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
            ops.fbuf.shape[1], ops.ibuf.shape[1])
    lsb = (lam_sb.data_ptr() if lam_sb is not None
           else peer[0]._slots(True, peer[1]))
    lsb2 = () if peer is None else (_ptr(peer[4]),)
    mid = (*(f.data_ptr() for f in cur), rb.data_ptr(),
           *(f.data_ptr() for f in lam_out), lsb, *lsb2,
           *(f.data_ptr() for f in bb), *(f.data_ptr() for f in cb),
           rbb.data_ptr(), _ptr(ctl), _ptr(cpart), _ptr(done))
    tail = (float(c_dt), float(t), int(use_filter),
            int(apply_sponge and meta.has_sponge), plan, _launch_stream(rb))
    if peer is None:
        err = lib.sw2d_stage_bwd(*head, S, B, *mid, *tail)
        _launch_check(err, "sw2d_stage_bwd_blocked_v2")
    else:
        ring, e_in, e_out, e_skip, _ = peer
        err = lib.sw2d_stage_bwd_peer(*head, B, *mid, ring.table.data_ptr(),
                                      e_in, e_out, e_skip, *tail)
        _launch_check(err, "sw2d_stage_bwd_blocked_peer")
    return (*bb, *cb, rbb, ctl)


sw2d_stage_bwd_blocked_v2.launches = 0


# ---------------------------------------------------------------------------
# The stage and its adjoint one shard a rank, the stage ring's exchange and
# its reverse folded into their launches
# ---------------------------------------------------------------------------

def _stacked_reverse(buf, ex):
    """The reverse of a stacked ring exchange ``ex`` (each chunk back to the
    shard it came from); zeros without ring offsets."""
    if ex.src_rev is None:
        return torch.zeros_like(buf)
    return torch.gather(buf, 0, ex.src_rev[:, None, :, None].expand(buf.shape))


def sw2d_stage_blocked_peer_plain(ops: ShardOps, meta: BlockedMeta, base,
                                  cur, rb, ex, c_dt: float, t: float = 0.0,
                                  ctrl=None, use_filter: bool = True,
                                  apply_sponge: bool = False):
    """Plain version of ``sw2d_stage_blocked_peer`` over every rank's shard
    stacked (``ops`` the stacked set, ``ex`` its stacked
    ``parallel.RingExchange``): the stage, then the stacked exchange of its
    send buffer. Returns (h, hu, hv, sb, the receive buffer of each rank's
    next folded launch)."""
    *out, sb = sw2d_stage_blocked_plain(ops, meta, base, cur, rb, c_dt, t,
                                        ctrl, use_filter, apply_sponge)
    return (*out, sb, ex(sb))


def sw2d_stage_bwd_blocked_peer_plain(ops: ShardOps, meta: BlockedMeta, cur,
                                      rb, lam_out, lam_sb, ex, c_dt: float,
                                      t: float = 0.0, ctrl=None,
                                      use_filter: bool = True,
                                      apply_sponge: bool = False,
                                      lam_sb_add=None):
    """Plain version of ``sw2d_stage_bwd_blocked_peer`` over every rank's
    shard stacked: the stage adjoint (``lam_sb_add`` added to ``lam_sb``
    first), then the stacked reverse exchange of the receive buffer's
    cotangent. Returns the eight cotangents of
    ``sw2d_stage_bwd_blocked_v2_plain`` and the send-buffer cotangent that
    each rank's next folded adjoint launch reads."""
    g = sw2d_stage_bwd_blocked_v2_plain(ops, meta, cur, rb, lam_out, lam_sb,
                                        c_dt, t, ctrl, use_filter,
                                        apply_sponge, lam_sb_add)
    return (*g, _stacked_reverse(g[6], ex))


def _check_peer(ops: ShardOps, meta: BlockedMeta, ring, fields: dict,
                bufs: dict):
    """One shard a rank over ``ring``: shapes, device and type of the
    (1, B, nV) fields and the (1, B, L, 3) buffers (None: the ring's
    slots), B and L the ring's. Returns the reference tensor."""
    if not isinstance(ops, ShardOps) or ops.send.shape[0] != 1:
        raise ValueError("across ranks the stage holds one shard a rank")
    L = ops.send.shape[1]
    if ring.n_slots != L:
        raise ValueError(f"the ring's slots hold {ring.n_slots} a scenario; "
                         f"this set sends {L}")
    ref = fields["h"]
    if ref.device != ring.device:
        raise ValueError(f"a state on {ref.device} for a ring on "
                         f"{ring.device}: the launch runs on the ring's")
    for name, t in fields.items():
        _check_tensor(name, t, (1, ring.batch, meta.n_v), ref)
    for name, t in bufs.items():
        if t is not None:
            _check_tensor(name, t, (1, ring.batch, L, 3), ref)
    return ref


def load_stage_peer(ops: ShardOps, meta: BlockedMeta, batch: int) -> None:
    """Makes the plans of the stage's and its adjoint's peer modes for
    ``ops`` at ``batch`` scenarios and loads their instances into the
    context, so that no first launch of a folded stage waits on CUDA's lazy
    loading, which waits for the running kernels (a peer's spinning ring
    kernel among them). Made once a set, where a step over a ring is built
    (``parallel.make_sharded_blocked_step_diff``)."""
    lib, desc = _check_kernel_inputs(ops, meta, ops.fbuf)
    _shard_plan(lib, desc, ops, batch, _STAGE_PEER)
    plan = _shard_plan(lib, desc, ops, batch, _STAGE_BWD_PEER)
    _launch_check(lib.sw2d_stage_peer_load(ctypes.byref(desc), plan[3]),
                  "sw2d_stage_blocked_peer")


def sw2d_stage_blocked_peer(ops: ShardOps, meta: BlockedMeta, base, cur, rb,
                            ring, c_dt: float, t: float = 0.0, ctrl=None,
                            use_filter: bool = True,
                            apply_sponge: bool = False):
    """The sharded stage one shard a rank over this rank's
    ``parallel.StageRing`` ``ring``, the ring's exchange folded into the
    launch: the receive buffer ``rb`` (1, B, L, 3), or None: this rank's
    forward slots, where the peers' last launches over the ring (folded
    ones) stored their send buffers; the stage as
    ``sw2d_stage_blocked`` computes it; its send buffer also stored into
    the receiving ranks' forward slots, which their next folded launch
    reads. Returns (h, hu, hv, sb, rb): ``rb`` the receive buffer read
    (with None a new tensor torch owns, copied from the slots, which
    autograd keeps for the adjoint). Every rank makes the same calls in the
    same order (the ring counts the epochs); a launch on the rank's own
    thread first meets the others' (``meet=`` of the ring).

    One launch (``ops/csrc/sw2d_blocked.cu``, ``sw2d_stage_peer_kernel``):
    it waits for the peers' chunks of the epoch it reads and for the
    receivers' slots of the epoch it sends, both released by the peers'
    launches of the round before (two slot sets by the epoch's parity), so
    that no launch waits for a peer's launch of its own round. B7's items
    and stage, so its bits are B7's followed by the exchange
    (``peer_stage_exchange``). At the sharded MPC's shapes (K_loc = 512,
    B = 1, N=3: ``shard_plan(..., peer=True)``: 64 blocks of 32 threads)
    S = 4 or 8 ranks' grids take a small part of the card's block slots,
    room for every rank's launch beside its peers'. The launch goes to the
    ring's device, the card (a ring over host memory runs a host build of
    the kernels, in the tests); a failed launch raises. Its plain version
    is ``sw2d_stage_blocked_peer_plain``, the stacked stage followed by the
    stacked exchange. Replaces the TPU stage kernel with the XLA
    ``ppermute`` after it (``blitzdg_tpu/parallel/blocked_shard.py``,
    ``make_sharded_blocked_step_diff``)."""
    ref = _check_peer(ops, meta, ring,
                      {"h": cur[0], "hu": cur[1], "hv": cur[2],
                       "base_h": base[0], "base_hu": base[1],
                       "base_hv": base[2]}, {"rb": rb})
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (meta.n_ctrl,), ref)
    lib, desc = _check_kernel_inputs(ops, meta, ref)
    B = ring.batch
    plan = _shard_plan(lib, desc, ops, B, _STAGE_PEER)
    out = [torch.empty_like(cur[0]) for _ in range(3)]
    sb = ref.new_empty((1, B, ring.n_slots, 3))
    rbo = torch.empty_like(sb) if rb is None else rb
    ring._guard()
    e_in, e_out, e_skip = ring._fold("forward", rb is None, True)
    err = lib.sw2d_stage_peer(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        ops.fbuf.shape[1], ops.ibuf.shape[1], B,
        *(f.data_ptr() for f in base), *(f.data_ptr() for f in cur),
        ring._slots(False, e_in) if rb is None else rb.data_ptr(),
        _ptr(ctrl), *(f.data_ptr() for f in out), sb.data_ptr(),
        rbo.data_ptr(), ring.table.data_ptr(), e_in, e_out, e_skip,
        float(c_dt),
        float(t), int(use_filter), int(apply_sponge and meta.has_sponge),
        plan, _launch_stream(ref))
    _launch_check(err, "sw2d_stage_blocked_peer")
    count_launches(sw2d_stage_blocked_peer)
    return (*out, sb, rbo)


sw2d_stage_blocked_peer.launches = 0


def sw2d_stage_bwd_blocked_peer(ops: ShardOps, meta: BlockedMeta, cur, rb,
                                lam_out, lam_sb, ring, c_dt: float,
                                t: float = 0.0, ctrl=None,
                                use_filter: bool = True,
                                apply_sponge: bool = False,
                                send: bool = True, lam_sb_add=None):
    """The adjoint of ``sw2d_stage_blocked_peer`` one shard a rank, the
    reverse of the ring's exchange folded into the launch: ``lam_sb``, the
    cotangent of the send buffer (1, B, L, 3), or None: this rank's reverse
    slots, where the adjoint launches of the stage that read the send
    buffer (at the ranks it went to) stored it; ``lam_sb_add`` (1, B, L,
    3), or None: a second part, added to it in the launch (autograd's,
    where a cost also takes the send buffer); with ``send`` the receive
    buffer's cotangent also stored into the reverse slots of the ranks that
    sent it (the stage read its receive buffer from the ring's slots), which
    the adjoint launch of their stage before reads (without, the stage's
    receive buffer came from the standalone exchange, whose backward takes
    the cotangent). Returns the eight cotangents of
    ``sw2d_stage_bwd_blocked_v2`` (the receive buffer's as computed here).
    A launch on the rank's own thread meets the others' first (autograd's
    device thread does not meet).

    One launch (``sw2d_stage_bwd_peer_kernel``): B8's items and ``qvjp``
    (B8's bits, and its lanes for the shape: sixteen an element at the
    sharded MPC's batch of one, 256 blocks of 32 threads a rank at K_loc =
    512), then each block's cut-face cotangents stored into the senders'
    slots; it waits only on flags that the peers' adjoint launches of the
    round before release. Its plain version is
    ``sw2d_stage_bwd_blocked_peer_plain``: B8's plain version followed by
    the stacked reverse exchange. Replaces the TPU stage adjoint kernel
    with the transpose of the XLA ``ppermute``."""
    _refuse_wetdry_stage_adjoint(meta)
    ref = _check_peer(ops, meta, ring,
                      {"h": cur[0], "hu": cur[1], "hv": cur[2],
                       "lam_h": lam_out[0], "lam_hu": lam_out[1],
                       "lam_hv": lam_out[2]},
                      {"rb": rb, "lam_sb": lam_sb, "lam_sb_add": lam_sb_add})
    if rb is None:
        raise ValueError("rb: the stage's receive buffer is needed")
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (meta.n_ctrl,), ref)
    ring._guard()
    e_in, e_out, e_skip = ring._fold("reverse", lam_sb is None, send)
    out = _run_stage_bwd(ops, meta, cur, rb, lam_out, lam_sb, c_dt, t, ctrl,
                         use_filter, apply_sponge,
                         peer=(ring, e_in, e_out, e_skip, lam_sb_add))
    count_launches(sw2d_stage_bwd_blocked_peer)
    return out


sw2d_stage_bwd_blocked_peer.launches = 0


# ---------------------------------------------------------------------------
# One whole SSP-RK2 step of an element-sharded set in one launch
# ---------------------------------------------------------------------------

def _refuse_wetdry_rdma(meta: BlockedMeta):
    if meta.wetdry:
        raise NotImplementedError(
            "the one-launch sharded step does not limit its stages: build "
            "the set with wetdry=False, or use the fused sharded step")


def sw2d_step_rdma_blocked_plain(ops: ShardOps, meta: BlockedMeta, state, rb,
                                 dt: float, ex, t: float = 0.0, ctrl=None,
                                 use_filter: bool = True):
    """Plain version of ``sw2d_step_rdma_blocked``: the plain stage twice,
    the ring exchange ``ex`` of the stage-1 send buffer between them."""
    _refuse_wetdry_rdma(meta)
    *s1, sb1 = sw2d_stage_blocked_plain(ops, meta, state, state, rb,
                                        0.5 * dt, t, ctrl, use_filter)
    return sw2d_stage_blocked_plain(ops, meta, state, tuple(s1), ex(sb1), dt,
                                    t + 0.5 * dt, ctrl, use_filter,
                                    apply_sponge=True)


class RdmaLaunch:
    """``sw2d_step_rdma_blocked`` over one sharded set and its ring exchange
    ``ex``, with what every launch shares made once: the descriptor, the
    argument list's constant head, the launch plan of each batch size, and
    the scratch of the last batch size (the stage-1 triple and, stacked,
    the stage-2 receive buffer), which every launch on the stream reuses.
    Call it as ``launch(state, rb, dt, t, ctrl, use_filter)``. After the
    first call at a batch size a call issues nothing but the launch (no
    device query, no synchronisation), so a CUDA graph can capture it.

    ``ex`` is one of:
     - the set's stacked ``parallel.RingExchange`` (every shard here): one
       launch covers every shard, the shard that receives each send slot
       being the ring's reverse source table ``ex.src_rev``;
     - a ``parallel.PeerRing`` (one shard a rank, CUDA tensors): the
       launch runs this rank's shard, stores the stage-1 halo into the
       peers' stage-2 slots and its send slots into their step-boundary
       slots (the next step's exchange), and meets them through flags in
       their memory; ``rb`` must be the ring's step-boundary slots, as
       ``ex(sbuf)`` returns them. Making it loads the peer mode's kernel
       for the set (``PeerRing`` loads the exchange's), so that no first
       launch of a ring step waits on CUDA's lazy loading;
     - a ``parallel.RingExchange`` over a process group (one shard a rank):
       CPU tensors only, the plain version with the group's exchange.
    """

    def __init__(self, ops: ShardOps, meta: BlockedMeta, ex):
        _refuse_wetdry_rdma(meta)
        if not isinstance(ops, ShardOps):
            raise TypeError("the stage kernels need a ShardOps operator set")
        S, L = ops.send.shape
        # a parallel.PeerRing (duck-typed: parallel imports this module)
        self.peer = getattr(ex, "table", None) is not None
        if self.peer or ex.group is not None:
            if S != 1 or (ex.plan.offs and
                          len(ex.plan.offs) * ex.chunk != L):
                raise ValueError("across ranks the one-launch step holds "
                                 "one shard a rank, of its ring's plan")
        elif ex.plan.n_shards != S or (
                ex.plan.offs and tuple(ex.src_rev.shape) != (S, L)):
            raise ValueError("the one-launch step needs the stacked ring "
                             "exchange of its own set")
        ring_dev = (ex.device if self.peer else
                    None if ex.src_rev is None else ex.src_rev.device)
        if ring_dev is not None and ring_dev != ops.fbuf.device:
            raise ValueError("ring exchange and operator set lie on "
                             "different devices")
        self.ops, self.meta, self.ex = ops, meta, ex
        self.device, self._scratch, self._head = ops.fbuf.device, None, None
        if self.peer:
            lib, desc = _check_kernel_inputs(ops, meta, ops.fbuf)
            _launch_check(lib.sw2d_step_rdma_peer_load(ctypes.byref(desc)),
                          "sw2d_step_rdma_blocked")

    def _scratch_for(self, rb: torch.Tensor):
        if self._scratch is None or self._scratch[1].shape != rb.shape:
            S, B = rb.shape[:2]
            self._scratch = (rb.new_empty((3, S, B, self.meta.n_v)),
                             torch.empty_like(rb))
        return self._scratch

    def __call__(self, state, rb, dt: float, t: float = 0.0, ctrl=None,
                 use_filter: bool = True):
        ops, meta = self.ops, self.meta
        _check_stage(ops, meta, {"h": state[0], "hu": state[1],
                                 "hv": state[2]}, rb)
        if ctrl is not None:
            _check_tensor("ctrl", ctrl, (meta.n_ctrl,), rb)
        if rb.device != self.device:
            raise ValueError("operator set and state lie on different devices")
        if rb.device.type == "cpu":
            return sw2d_step_rdma_blocked_plain(ops, meta, state, rb, dt,
                                                self.ex, t, ctrl, use_filter)
        if not self.peer and self.ex.group is not None:
            raise ValueError(
                "a process group's ring exchange serves CPU tensors (the "
                "plain version); on the card the one-launch step across "
                "ranks takes a parallel.PeerRing")
        out = self._launch(state, rb, dt, t, ctrl, use_filter)
        sw2d_step_rdma_blocked.launches += 1
        return out

    def _launch(self, state, rb, dt, t, ctrl, use_filter):
        """The kernel's launch (the shapes checked by the caller)."""
        ops, meta = self.ops, self.meta
        if self._head is None:
            lib, desc = _check_kernel_inputs(ops, meta, ops.fbuf)
            self._head = (lib, desc, (
                ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
                ops.fbuf.shape[1], ops.ibuf.shape[1]))
        if rb.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels are float32, got {rb.dtype}")
        lib, desc, head = self._head
        S, B = rb.shape[:2]
        out = [torch.empty_like(state[0]) for _ in range(3)]
        sb = torch.empty_like(rb)
        tail = (*(f.data_ptr() for f in out), sb.data_ptr(), float(dt),
                float(t), float(t + 0.5 * dt), int(use_filter),
                int(meta.has_sponge))
        if self.peer:
            ex = self.ex
            if rb.data_ptr() != ex.rbb.data_ptr():
                raise ValueError("across ranks the step reads the ring's "
                                 "step-boundary slots: pass ring(sbuf)")
            plan = _shard_plan(lib, desc, ops, B, _RDMA_PEER)
            s1 = self._scratch_for(rb)[0]
            err = lib.sw2d_step_rdma_peer(
                *head, B, *(f.data_ptr() for f in state), rb.data_ptr(),
                _ptr(ctrl), ex.table.data_ptr(), s1.data_ptr(),
                ex.rb2.data_ptr(), *tail, plan, _launch_stream(rb))
            _launch_check(err, "sw2d_step_rdma_blocked")
            ex.carried = sb  # (in the peers' step-boundary slots now)
            return (*out, sb)
        else:
            plan = _shard_plan(lib, desc, ops, B, _RDMA)
            s1, rb2 = self._scratch_for(rb)
            err = lib.sw2d_step_rdma(
                *head, S, B, *(f.data_ptr() for f in state), rb.data_ptr(),
                _ptr(ctrl), _ptr(self.ex.src_rev), s1.data_ptr(),
                rb2.data_ptr(), *tail, plan, _launch_stream(rb))
        _launch_check(err, "sw2d_step_rdma_blocked")
        return (*out, sb)


def sw2d_step_rdma_blocked(ops: ShardOps, meta: BlockedMeta, state, rb,
                           dt: float, ex, t: float = 0.0, ctrl=None,
                           use_filter: bool = True):
    """One whole SSP-RK2 step on every shard of an element-sharded set:
    stage 1 from ``state`` (a triple of (S, B, nV)) and the step-boundary
    receive buffer ``rb`` (S, B, L, 3), the ring exchange ``ex`` of the
    stage-1 halo (the set's stacked ``parallel.RingExchange``, or one shard
    a rank: a ``parallel.PeerRing`` on the card, a process group's
    ``RingExchange`` on the CPU; see ``RdmaLaunch``), stage 2 with the
    sponge. ``t``: the step's start time; ``ctrl``: (n_ctrl,) shared by
    every scenario and shard, or None. Returns (h, hu, hv, sb), sb
    (S, B, L, 3) the send buffer of the output. A caller that steps
    repeatedly makes one ``RdmaLaunch`` and calls it, as
    ``parallel.make_sharded_blocked_step_rdma`` does.

    Replaces the TPU kernel ``_step_kernel_rdma`` / ``sw2d_step_rdma_blocked``
    of ``blitzdg_tpu/ops/sw2d_blocked.py``, which runs one shard per chip at
    B = 1 and moves the inter-stage halo by remote DMA after a READY
    handshake. Here, with the stacked ``ex``, one cooperative launch covers
    every shard and scenario, the halo is stored into the receiving shard's
    slots in global memory and a grid barrier stands for the handshake;
    with a ``parallel.PeerRing`` (one shard a rank, ``state`` (1, B, nV))
    the launch runs this rank's shard, stores both halos (the inter-stage
    one and the next step's step-boundary one) into the receiving ranks'
    memory (CUDA IPC) and meets them through one READY and one ARRIVED flag
    a ring offset for each in their memory. Bound by operations (two
    RHS evaluations per node against one state in and one out). Takes
    triangles up to N=6 and quadrilaterals (four faces) up to N=4, eight
    lanes an element at N=4 in both modes (its compile-time instance, the
    stage kernel's), one at other orders; raises above and for a wet/dry
    set.
    """
    return RdmaLaunch(ops, meta, ex)(state, rb, dt, t, ctrl, use_filter)


sw2d_step_rdma_blocked.launches = 0
