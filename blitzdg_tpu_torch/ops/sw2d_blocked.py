"""Element-blocked CUDA kernels: the LARGE-mesh shallow-water path, with
their plain PyTorch versions and the differentiable rollout built on them.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_blocked.py``
(``sw2d_step_blocked``, ``sw2d_rollout_blocked``,
``sw2d_rollout_bwd_blocked``, ``make_rollout_blocked``,
``build_blocked_step_ops``, ``matmul_flops_per_step``). The dense kernels
(``sw2d_fused.py``) hold one scenario's whole mesh in one block's shared
memory, which ends near K = 200 elements. Here the mesh is split over blocks
(work unit: scenario x chunk of elements), neighbours are read from global
memory, and grid-wide barriers separate the RK stages inside one persistent
cooperative launch (``csrc/sw2d_blocked.cu``).

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
from dataclasses import dataclass

import numpy as np
import torch

from ..context import DGContext2D
from .limiters import positivity_preserving_limiter
from .sw2d import SWPhysics
from .sw2d_fused import (MAX_SMEM_BYTES, FusedStepMeta, FusedStepOps, _SwDesc,
                         _check_tensor, _desc, _eval_rhs_plain,
                         _eval_rhs_vjp_plain, _launch_check, _np64,
                         _operator_arrays, _ops_from_arrays)

# Threads of one block. The kernels loop over nodes with this stride, so any
# multiple of 32 is valid.
THREADS = 256
# Kernel launches on the device per call of a wrapper: one persistent
# cooperative launch each, the stages separated by grid barriers inside it.
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
                            extra=("H", "SPNG")), meta


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
# Kernel wrappers
# ---------------------------------------------------------------------------

def chunk_elems(meta: BlockedMeta) -> int:
    """Elements per work unit: as many as give every thread of a block at
    most one trace node per pass."""
    return max(1, min(meta.k_elem, THREADS // (meta.n_faces * meta.n_fp)))


def _lib():
    """The compiled kernels with their argument types set (built at first
    use; needs nvcc and a CUDA device)."""
    from ._build import load

    lib = load("sw2d_blocked")
    if getattr(lib, "_sw2d_typed", False):
        return lib
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    D = ctypes.POINTER(_SwDesc)
    lib.sw2d_blocked_smem_bytes.argtypes = [D, I]
    lib.sw2d_blocked_smem_bytes.restype = ctypes.c_longlong
    lib.sw2d_blocked_bwd_work_floats.argtypes = [D, I, I, I]
    lib.sw2d_blocked_bwd_work_floats.restype = ctypes.c_longlong
    lib.sw2d_blocked_last_grid.argtypes = []
    lib.sw2d_blocked_last_grid.restype = I
    lib.sw2d_blocked_barrier_probe.argtypes = [I, I, I, P]
    lib.sw2d_blocked_barrier_probe.restype = I
    lib.sw2d_blocked_step.argtypes = [D, P, P] + [P] * 8 + [I, F, F, I, I, I, P]
    lib.sw2d_blocked_rollout.argtypes = (
        [D, P, P] + [P] * 11 + [I, I, I, I, F, F, I, I, I, P])
    lib.sw2d_blocked_rollout_bwd.argtypes = (
        [D, P, P] + [P] * 12 + [I, I, I, F, F, I, I, I, P])
    for fn in (lib.sw2d_blocked_step, lib.sw2d_blocked_rollout,
               lib.sw2d_blocked_rollout_bwd):
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
    desc = _desc(meta, blocked=True)
    E = chunk_elems(meta)
    need = lib.sw2d_blocked_smem_bytes(ctypes.byref(desc), E)
    while need > MAX_SMEM_BYTES and E > 1:  # high orders: smaller chunks
        E = max(1, E // 2)
        need = lib.sw2d_blocked_smem_bytes(ctypes.byref(desc), E)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"Np={meta.n_p} needs {need} bytes of shared memory per block "
            f"even with one element per block; a block can have "
            f"{MAX_SMEM_BYTES}")
    return lib, desc, E


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def last_grid() -> int:
    """Thread blocks of the last kernel launch of this module."""
    return int(_lib().sw2d_blocked_last_grid())


def barrier_probe(n_barriers: int, grid: int, device) -> None:
    """Launch ``grid`` co-resident blocks that pass ``n_barriers`` grid
    barriers and do nothing else: timed by a caller, it gives the cost of
    one barrier of the kernels above (a measuring aid, not part of any
    solver path)."""
    err = _lib().sw2d_blocked_barrier_probe(
        int(n_barriers), int(grid), THREADS,
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
    traffic against some hundred operations per node). The mesh is split
    over thread blocks and the two stages are separated by a grid barrier
    inside one cooperative launch; design: see the source of the kernels.
    """
    B = _check_state(meta, h, hu, hv)
    if ctrl is not None:
        _check_tensor("ctrl", ctrl, (B, meta.n_ctrl), h)
    if h.device.type == "cpu":
        return sw2d_step_blocked_plain(ops, meta, h, hu, hv, ctrl, dt, t0,
                                       use_filter)
    lib, desc, E = _check_kernel_inputs(ops, meta, h)
    oh, ohu, ohv = (torch.empty_like(h) for _ in range(3))
    s1 = torch.empty((3, B, meta.n_v), dtype=h.dtype, device=h.device)
    err = lib.sw2d_blocked_step(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        h.data_ptr(), hu.data_ptr(), hv.data_ptr(), _ptr(ctrl),
        oh.data_ptr(), ohu.data_ptr(), ohv.data_ptr(), s1.data_ptr(), B,
        float(dt), float(t0), int(use_filter), E, THREADS, _stream(h))
    _launch_check(err, "sw2d_step_blocked")
    sw2d_step_blocked.launches += 1
    return oh, ohu, ohv


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
    stored). The state stays in the L2 cache across steps and each stage
    ends in a grid barrier; at B = 8 gather latency, not arithmetic, sets
    the time (measurements: PERF.md).
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
    lib, desc, E = _check_kernel_inputs(ops, meta, h)
    new = lambda *shape: torch.empty(shape, dtype=h.dtype, device=h.device)
    s1 = new(3, B, meta.n_v)
    if store_traj:
        traj = [new(B, n_steps + 1, meta.n_v) for _ in range(3)]
        final = [None] * 3
    else:
        traj = [None] * 3
        final = [new(B, meta.n_v) for _ in range(3)]
    err = lib.sw2d_blocked_rollout(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        h.data_ptr(), hu.data_ptr(), hv.data_ptr(), _ptr(ctrls),
        *(_ptr(f) for f in final), *(_ptr(f) for f in traj), s1.data_ptr(),
        B, n_steps, 0 if ctrls is None else ctrls.shape[1], int(spc),
        float(dt), float(t0), int(use_filter), E, THREADS, _stream(h))
    _launch_check(err, "sw2d_rollout_blocked")
    sw2d_rollout_blocked.launches += 1
    if store_traj:
        return (*traj, *(f[:, -1] for f in traj))
    return tuple(final)


sw2d_rollout_blocked.launches = 0


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
    trajectory and cotangent). The transposed '+' gather crosses blocks, so
    each adjoint application runs in two phases around a grid barrier (three
    barriers per step); sums are taken in a fixed order, no atomics.
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
    lib, desc, E = _check_kernel_inputs(ops, meta, traj_h)
    new = lambda *shape: torch.empty(shape, dtype=traj_h.dtype,
                                     device=traj_h.device)
    xb = [new(B, meta.n_v) for _ in range(3)]
    cb = torch.empty_like(ctrls)
    work = new(lib.sw2d_blocked_bwd_work_floats(ctypes.byref(desc), B, n_cs, E))
    err = lib.sw2d_blocked_rollout_bwd(
        ctypes.byref(desc), ops.fbuf.data_ptr(), ops.ibuf.data_ptr(),
        traj_h.data_ptr(), traj_hu.data_ptr(), traj_hv.data_ptr(),
        tb_h.data_ptr(), tb_hu.data_ptr(), tb_hv.data_ptr(), ctrls.data_ptr(),
        xb[0].data_ptr(), xb[1].data_ptr(), xb[2].data_ptr(), cb.data_ptr(),
        work.data_ptr(), B, n_cs, int(spc), float(dt), float(t0),
        int(use_filter), E, THREADS, _stream(traj_h))
    _launch_check(err, "sw2d_rollout_bwd_blocked")
    sw2d_rollout_bwd_blocked.launches += 1
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
