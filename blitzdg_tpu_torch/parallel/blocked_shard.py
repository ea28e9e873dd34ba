"""The element-sharded blocked path: per-shard operator sets, the stage
kernels and the ring exchange between the RK stages.

Counterpart of the JAX package's ``blitzdg_tpu/parallel/blocked_shard.py``
(``ShardedBlocked``, ``build_sharded_blocked``, ``initial_send_buffer``,
``make_sharded_blocked_step_fused``, ``make_sharded_blocked_step_diff``,
``make_sharded_blocked_step_rdma``).
The mesh is partitioned into S contiguous element blocks
(``parallel.partition_mesh``). Each shard runs the same stage kernel as the
others (``ops.sw2d_blocked.sw2d_stage_blocked``, full coastal physics); only
the cut faces' '+' values cross shards. Per SSP-RK2 stage (each stage's RHS
needs the traces of its own input):

  1. the previous stage kernel emitted a compact (S, B, L, 3) send buffer;
  2. ``parallel.halo.ring_exchange`` turns it into the receive buffer;
  3. one stage kernel consumes the receive buffer and computes
     ``out = base + c dt R(cur)`` and the next send buffer.

What is ported is the contract, not the TPU layout: no (p, NP, M) packing
(states are (S, B, K_loc*Np)), no kron operators, combos, EXTM/SGEM/SL/RG/RL
one-hot tables or filter folding. Each shard's ``ShardOps`` covers its
K_loc elements; a cut face's ``vmapP`` points at the receive slot that
carries its '+' value, in the JAX package's slot layout (slot j =
offset * chunk + send slot * Nfp + node, the node reversed on flipped
faces), and the send list pads unused slots with face row 0 as the JAX
package does, so send buffers compare equal. The '+' bathymetry at a cut face
is the remote element's, taken from the global trace at set-up: nothing
coastal crosses shards at run time.

Controls follow the JAX package: one vector (n_ctrl,) per step, shared by
every scenario and shard. The differentiable step sums its control
cotangent over scenarios and the shards held here; one shard a rank, the
caller sums it over the ranks (``sum_over_ranks_grad``, once for a whole
control sequence), as JAX's transpose of the replicated controls does. The
JAX backward reshapes its per-scenario (B, n_ctrl) cotangent to (n_ctrl,),
which holds for B = 1 only (ROADMAP C21).

One shard a rank, the fused and the differentiable step exchange through
the process group (``batch_isend_irecv`` on CPU tensors) or, on the card,
through this rank's ``parallel.StageRing`` (``ring=``): each stage is one
launch of the stage kernel's peer mode, which reads its receive buffer
from the ring's slots and stores its send buffer into the peers' (the
exchange folded into the launch), and in the backward one launch of the
adjoint's peer mode, the reverse folded in likewise; only a rollout's
first exchange (its constant start's send buffer) is a launch of the
ring's exchange kernel (a ring over host memory runs a host build of the
same kernels, in the tests). The sums over ranks of the control cotangent go
through the ring's sum kernel. ``sum_over_ranks_grad`` and
``total_over_ranks`` are the two sums with their transposes, for a cost
that each rank computes in part (``mpc.sharded_box``).

``make_sharded_blocked_step_rdma`` is the same step in one launch: one
exchange of the carried send buffer, then one kernel that runs both stages
and moves the inter-stage halo inside itself
(``ops.sw2d_blocked.sw2d_step_rdma_blocked``). Stacked, all shards are on
one card and the halo is stored into the receiving shard's slots in global
memory. With a process group (one shard a rank) on the card, the transport
is a ``parallel.PeerRing``: the step launch stores both halos into the
peers' memory (CUDA IPC: the inter-stage one and the next step's
step-boundary one; the ring's first step has the initial send buffer
delivered by an exchange launch), and per-offset flags there stand for the
TPU kernel's READY handshake; on the CPU it is the plain version over the
group's ``RingExchange``.

Not ported: ``make_sharded_blocked_step`` (superseded) and
``initial_packed_traces``; ``pack_local``/``unpack_local`` have no
counterpart (``split_shards``/``join_shards`` reshape flat fields).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..context import DGContext2D
from ..ops.sw2d import SWPhysics
from ..ops.sw2d_blocked import (BlockedMeta, RdmaLaunch, ShardOps,
                                _refuse_wetdry_rdma, _send_plain,
                                load_stage_peer, shard_view,
                                sw2d_stage_blocked, sw2d_stage_bwd_blocked_v2)
from ..ops.sw2d_fused import _np64, _operator_arrays, _ops_from_arrays
from .halo import HaloPlan, RingExchange, build_halo_plan, sum_over_ranks

_VOLUME = ("rx", "sx", "ry", "sy", "Hx", "Hy", "H", "SPNG")
_TRACE = ("nx", "ny", "fscale", "wall", "obc", "HMt", "HPt")


class ShardedBlocked(NamedTuple):
    ops: ShardOps  # the shards held here, stacked on the leading axis
    meta: BlockedMeta  # one shard's (k_elem = k_loc)
    plan: HaloPlan
    n_shards: int
    k_loc: int
    shards: tuple  # global ids of the shards held here


def build_sharded_blocked(
    ctx: DGContext2D,
    phys: SWPhysics,
    n_shards: int,
    dtype: torch.dtype = torch.float32,
    tidal: tuple | None = None,  # (h0, amp, omega, ramp_tau) BC_OUT forcing
    wetdry: bool = False,
    h_floor: float = 1e-3,
    forcing_bu: np.ndarray | None = None,  # (n_ctrl, K, Np) hu injector
    forcing_bv: np.ndarray | None = None,
    device="cuda",
    shards=None,
) -> ShardedBlocked:
    """Freeze the per-shard operator sets and the halo plan (host side).

    ``ctx`` must be built on a partitioned mesh (contiguous blocks, K
    divisible by ``n_shards``: ``partition_mesh``, ``pad_context``).
    ``shards``: the global ids of the shards to hold (default: all, for the
    stacked transport; one rank's id for the process-group transport)."""
    K, n_p, n_fp, nf = ctx.k_elem, ctx.n_p, ctx.n_fp, ctx.n_faces
    if K % n_shards:
        raise ValueError(f"K={K} is not divisible by {n_shards} shards")
    if wetdry and phys.H is None:
        raise ValueError("wetdry needs bathymetry (phys.H)")
    shards = tuple(range(n_shards)) if shards is None else tuple(shards)
    k_loc = K // n_shards
    nvl, ntl, f_loc = k_loc * n_p, k_loc * nf * n_fp, k_loc * nf

    arr, meta_kw = _operator_arrays(ctx, phys, forcing_bu, forcing_bv, tidal)
    n_v = meta_kw["n_v"]
    arr["H"] = _np64(phys.H).reshape(-1) if phys.H is not None else np.zeros(n_v)
    arr["SPNG"] = (_np64(phys.sponge).reshape(-1) if phys.sponge is not None
                   else np.zeros(n_v))
    meta_kw.update(k_elem=k_loc, n_v=nvl, n_t=ntl, has_sponge=phys.sponge
                   is not None, wetdry=bool(wetdry), h_floor=float(h_floor))
    meta = BlockedMeta(**meta_kw)

    plan = build_halo_plan(ctx, n_shards)
    ms = plan.max_send
    chunk = ms * n_fp
    L = max(len(plan.offs) * chunk, 1)
    fmask = ctx.fmask.cpu().numpy().reshape(nf, n_fp)
    sets = []
    for s in shards:
        vs, ts = slice(s * nvl, (s + 1) * nvl), slice(s * ntl, (s + 1) * ntl)
        a = {k: arr[k] for k in ("Dr", "Ds", "lift", "filt")}
        a.update({k: arr[k][vs] for k in _VOLUME})
        a.update({k: arr[k][ts] for k in _TRACE})
        a["BU"], a["BV"] = arr["BU"][:, vs], arr["BV"][:, vs]
        a["vmapM"] = arr["vmapM"][ts] - s * nvl
        vp = arr["vmapP"][ts] - s * nvl
        jn = np.arange(n_fp)
        for r in np.flatnonzero(plan.psrc[s] >= f_loc):  # cut faces
            di, slot = divmod(int(plan.psrc[s, r]) - f_loc, ms)
            src = n_fp - 1 - jn if plan.pflip[s, r] else jn
            vp[r * n_fp + jn] = nvl + di * chunk + slot * n_fp + src
        if vp.min() < 0 or vp.max() >= nvl + L:
            raise ValueError("a '+' trace of the shard reads outside it and "
                             "its receive slots")
        a["vmapP"] = vp
        send = -np.ones(L, dtype=np.int64)
        for di in range(len(plan.offs)):
            for slot in range(ms):
                kl, f = divmod(int(plan.send_idx[s, di, slot]), nf)
                j0 = di * chunk + slot * n_fp
                send[j0:j0 + n_fp] = kl * n_p + fmask[f]
        a["send"] = send
        sets.append(_ops_from_arrays(a, meta, dtype, device, cls=ShardOps,
                                     extra=("H", "SPNG"), n_recv=L,
                                     mirror=True))
    ops = ShardOps(**{f.name: torch.stack([getattr(o, f.name) for o in sets])
                      for f in dataclasses.fields(ShardOps)})
    return ShardedBlocked(ops=ops, meta=meta, plan=plan, n_shards=n_shards,
                          k_loc=k_loc, shards=shards)


def split_shards(f: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(B, K*Np) field of the partitioned mesh -> (S, B, K_loc*Np)."""
    B = f.shape[0]
    return f.reshape(B, n_shards, -1).transpose(0, 1).contiguous()


def join_shards(f: torch.Tensor) -> torch.Tensor:
    """(S, B, K_loc*Np) -> (B, K*Np)."""
    return f.transpose(0, 1).reshape(f.shape[1], -1)


def initial_send_buffer(sb: ShardedBlocked, state) -> torch.Tensor:
    """(S_here, B, L, 3) send buffer of a (S_here, B, nV) state triple: it
    seeds the steps' carry (later buffers come from the stage kernel)."""
    return torch.stack([
        _send_plain(shard_view(sb.ops, i), *(f[i] for f in state))
        for i in range(len(sb.shards))])


def _exchange(sb: ShardedBlocked, group, ring=None) -> RingExchange:
    if group is None and ring is None and len(sb.shards) != sb.n_shards:
        raise ValueError("the stacked transport needs every shard; this set "
                         f"holds {len(sb.shards)} of {sb.n_shards}")
    if (group is not None or ring is not None) and len(sb.shards) != 1:
        raise ValueError("the process-group transport holds one shard a rank")
    if ring is not None and (
            (ring.plan.n_shards, ring.plan.offs, ring.chunk, ring.rank)
            != (sb.n_shards, sb.plan.offs, sb.plan.max_send * sb.meta.n_fp,
                sb.shards[0])):
        raise ValueError(f"the ring (rank {ring.rank}) is not one of this "
                         f"set's plan and shard {sb.shards}")
    return RingExchange(sb.plan, sb.meta.n_fp, group, device=sb.ops.fbuf.device,
                        ring=ring)


class _Carried:
    """A folded step's record of the send buffer that its last stage launch
    stored into the peers' forward slots (a weak reference), the ring's
    forward epoch just after that launch, and the stage's ``_Sent``."""

    __slots__ = ("sbuf", "epoch", "mark")

    def __init__(self):
        self.sbuf, self.epoch, self.mark = None, -1, None

    def holds(self, ring, sbuf: torch.Tensor) -> bool:
        """Whether the ring's forward slots hold ``sbuf``'s exchange: it is
        the send buffer of this step's last folded launch, and no launch
        over the ring has exchanged forward since."""
        return (self.sbuf is not None and self.sbuf() is sbuf
                and ring.epochs["forward"] == self.epoch)

    def note(self, ring, sbuf: torch.Tensor, mark=None):
        self.sbuf = weakref.ref(sbuf)
        self.epoch, self.mark = ring.epochs["forward"], mark


def make_sharded_blocked_step_fused(sb: ShardedBlocked, dt: float,
                                    use_filter: bool = True, group=None,
                                    ring=None):
    """The sharded SSP-RK2 step. Returns ``step(carry, t=0.0, ctrl=None) ->
    carry`` with carry = (state, send buffer): state a triple of (S_here, B,
    nV), send buffer (S_here, B, L, 3); seed it with
    ``initial_send_buffer``. ``ctrl``: (n_ctrl,) or None. ``group``: None for
    the stacked transport, or the process group (one shard a rank, CPU
    tensors); ``ring``: this rank's ``parallel.StageRing`` (one shard a
    rank), each stage one launch of the stage's peer mode
    (``ops.sw2d_blocked.sw2d_stage_blocked_peer``) that reads its receive
    buffer from the ring's slots, the exchange of the rollout's first send
    buffer (one that this step's last folded stage did not return) one
    launch of the ring's exchange kernel. ``step.exchange`` is the step's
    ``RingExchange``."""
    ops, meta = sb.ops, sb.meta
    ex = _exchange(sb, group, ring)
    if ring is not None:
        load_stage_peer(ops, meta, ring.batch)
        carried = _Carried()

        def stage(base, cur, sbuf, c_dt, t, ctrl, sponge):
            rb = None if carried.holds(ring, sbuf) else ex(sbuf)
            *out, sbo, _ = sw2d_stage_blocked(ops, meta, base, cur, rb, c_dt,
                                              t, ctrl, use_filter, sponge,
                                              ring=ring)
            carried.note(ring, sbo)
            return tuple(out), sbo

        def folded(carry, t: float = 0.0, ctrl=None):
            state, sbuf = carry
            s1, sb1 = stage(state, state, sbuf, 0.5 * dt, t, ctrl, False)
            return stage(state, s1, sb1, dt, t + 0.5 * dt, ctrl, True)

        folded.exchange = ex
        return folded

    def step(carry, t: float = 0.0, ctrl=None):
        state, sbuf = carry
        *s1, sb1 = sw2d_stage_blocked(ops, meta, state, state, ex(sbuf),
                                      0.5 * dt, t, ctrl, use_filter)
        *s2, sb2 = sw2d_stage_blocked(ops, meta, state, tuple(s1), ex(sb1),
                                      dt, t + 0.5 * dt, ctrl, use_filter,
                                      apply_sponge=True)
        return tuple(s2), sb2

    step.exchange = ex
    return step


def make_sharded_blocked_step_rdma(sb: ShardedBlocked, dt: float,
                                   use_filter: bool = True, group=None):
    """The sharded SSP-RK2 step in one kernel launch: the same carry and
    arguments as ``make_sharded_blocked_step_fused``, and the same values;
    the step-boundary exchange, then ``sw2d_step_rdma_blocked`` (through
    one ``RdmaLaunch``), which exchanges the inter-stage halo inside the
    launch. Forward only.

    With ``group`` on the card (one shard a rank, ``sb`` built with
    ``shards=(rank,)``), the first step makes a ``parallel.PeerRing`` sized
    by its carry's scenarios (a collective set-up: every rank steps), has
    ``peer_ring_exchange`` deliver the carried send buffer into the peers'
    step-boundary slots and launches the step's peer mode, which stores its
    own send buffer into them for the next step: every later step is one
    launch, and its carry must be the one the step before returned (the
    ring refuses another send buffer). Every later carry has the same
    scenarios. The ring is ``step.ring`` (None before the first step);
    every rank calls ``step.ring.close()`` when done. On the CPU, with
    ``group``, the step is the plain version over the group's
    ``RingExchange``.

    Raises for a wet/dry set, as the JAX wrapper does (the kernel does not
    limit its stages)."""
    _refuse_wetdry_rdma(sb.meta)
    ex = _exchange(sb, group)
    launch = None
    if group is not None and sb.ops.fbuf.is_cuda:
        import torch.distributed as dist

        if sb.shards != (dist.get_rank(group),):
            raise ValueError(f"rank {dist.get_rank(group)} of the group "
                             f"holds shard {sb.shards}: one shard a rank, "
                             "its own")
    else:
        launch = RdmaLaunch(sb.ops, sb.meta, ex)

    def step(carry, t: float = 0.0, ctrl=None):
        nonlocal ex, launch
        state, sbuf = carry
        if launch is None:
            from .peer import PeerRing

            ex = step.ring = PeerRing(sb.plan, sb.meta.n_fp, sbuf.shape[1],
                                      group, device=sb.ops.fbuf.device)
            launch = RdmaLaunch(sb.ops, sb.meta, ex)
        *s2, sb2 = launch(state, ex(sbuf), dt, t, ctrl, use_filter)
        return tuple(s2), sb2

    step.ring = None
    return step


class _SumOverRanks(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the ranks of
    an exchange's transport (the shared control's cotangent)."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return sum_over_ranks(grad.contiguous(), ctx.ex), None


class _TotalOverRanks(torch.autograd.Function):
    """The sum over the ranks forward (every rank holds the same bits); the
    backward passes the cotangent on unchanged: each rank's part enters the
    total once."""

    @staticmethod
    def forward(ctx, x, ex):
        return sum_over_ranks(x.contiguous(), ex)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks_grad(x: torch.Tensor, ex: RingExchange) -> torch.Tensor:
    """``x`` itself, whose cotangent is summed over ``ex``'s ranks in the
    backward (rank order; the same bits on every rank): the shared
    controls, replicated on every rank, each of which differentiates its own
    part of a cost. Stacked: ``x``."""
    if ex.group is None and ex.ring is None:
        return x
    return _SumOverRanks.apply(x, ex)


def total_over_ranks(x: torch.Tensor, ex: RingExchange) -> torch.Tensor:
    """The sum over ``ex``'s ranks of each rank's ``x`` (rank order; the
    same bits on every rank), whose backward gives each rank's part the
    total's cotangent: the ``psum`` of a cost. Stacked: ``x``."""
    if ex.group is None and ex.ring is None:
        return x
    return _TotalOverRanks.apply(x, ex)


class _Sent:
    """A folded stage's send buffer: the ring's reverse epoch at which the
    backward of the stage that read it from the ring's slots stored its
    cotangent into the senders' reverse slots, and the backward (autograd's
    graph task) that did, which this stage's backward then reads (``take``:
    None where no such backward has run since this stage's last backward,
    or where it ran in another backward, one that autograd restricted to a
    part of the rollout: ``torch.autograd.grad(..., inputs=)``)."""

    __slots__ = ("epoch", "task")

    def __init__(self):
        self.epoch = self.task = None

    def put(self, epoch: int):
        self.epoch, self.task = epoch, torch._C._current_graph_task_id()

    def take(self):
        e, self.epoch = self.epoch, None
        return e if self.task == torch._C._current_graph_task_id() else None


def _folded_diff_stages(ops, meta, ring, dt, use_filter, ex):
    """The differentiable step over ``ring`` with the ring's exchange and
    its reverse folded into the stage launches (see
    ``make_sharded_blocked_step_diff``)."""

    def make_stage(c_dt: float, apply_sponge: bool):
        class _PeerStage(torch.autograd.Function):
            @staticmethod
            def forward(ctx, bh, bhu, bhv, ch, chu, chv, link, rb, t, ctrl,
                        src, mark):
                # link: the previous stage's send buffer (autograd's order
                # only) where rb is None, the ring's slots; src its _Sent
                ctx.set_materialize_grads(False)
                *out, sbo, rbr = sw2d_stage_blocked(
                    ops, meta, (bh, bhu, bhv), (ch, chu, chv), rb, c_dt, t,
                    ctrl, use_filter, apply_sponge, ring=ring)
                ctx.save_for_backward(ch, chu, chv, rbr, ctrl)
                ctx.t, ctx.read, ctx.src, ctx.mark = t, rb is None, src, mark
                return (*out, sbo)

            @staticmethod
            def backward(ctx, lh, lhu, lhv, lsb):
                ch, chu, chv, rb, ctrl = ctx.saved_tensors
                lam = tuple(torch.zeros_like(ch) if g is None
                            else g.contiguous() for g in (lh, lhu, lhv))
                lsb = None if lsb is None else lsb.contiguous()
                e = ctx.mark.take()
                if e is not None:  # (from the ring's reverse slots)
                    if e != ring.epochs["reverse"]:
                        raise RuntimeError(
                            "another backward over this ring ran between "
                            "two stages' backwards of one rollout: one "
                            "rollout's backward at a time over a ring "
                            "(ROADMAP C35)")
                    # autograd's part, where a cost also takes the send
                    # buffer, is added in the launch (the ppermute
                    # transpose's sum)
                    lam_sb, add = None, lsb
                else:
                    lam_sb = torch.zeros_like(rb) if lsb is None else lsb
                    add = None
                # the receive buffer's cotangent to its senders where it
                # came from the ring's slots and the stage before has a
                # backward (which then reads it)
                send = ctx.read and ctx.needs_input_grad[6]
                g = sw2d_stage_bwd_blocked_v2(
                    ops, meta, (ch, chu, chv), rb, lam, lam_sb, c_dt, ctx.t,
                    ctrl, use_filter, apply_sponge, ring=ring, send=send,
                    lam_sb_add=add)
                if send:
                    ctx.src.put(ring.epochs["reverse"])
                lctl = None if g[7] is None else g[7].sum(dim=(0, 1))
                return (*g[:6], None, None if ctx.read else g[6], None,
                        lctl, None, None)

        return _PeerStage.apply

    stage1, stage2 = make_stage(0.5 * dt, False), make_stage(dt, True)
    carried = _Carried()

    def run(fn, base, cur, sbuf, t, ctrl):
        if carried.holds(ring, sbuf):
            link, rb, src = sbuf, None, carried.mark
        else:  # a rollout's start: the standalone exchange
            ring._pace()
            link, rb, src = None, ex(sbuf), None
        mark = _Sent()
        *out, sbo = fn(*base, *cur, link, rb, t, ctrl, src, mark)
        carried.note(ring, sbo, mark)
        return tuple(out), sbo

    def step(carry, t: float = 0.0, ctrl=None):
        state, sbuf = carry
        s1, sb1 = run(stage1, state, state, sbuf, t, ctrl)
        return run(stage2, state, s1, sb1, t + 0.5 * dt, ctrl)

    return step


def make_sharded_blocked_step_diff(sb: ShardedBlocked, dt: float,
                                   use_filter: bool = True, group=None,
                                   ring=None):
    """The differentiable sharded step: same carry and arguments as
    ``make_sharded_blocked_step_fused``; each stage is a
    ``torch.autograd.Function`` whose forward is ``sw2d_stage_blocked`` and
    whose backward is ``sw2d_stage_bwd_blocked_v2``, and the exchange's
    backward is the reverse exchange, so a rollout of steps is
    differentiable in its initial state and its controls. The control
    cotangent is summed over scenarios and the shards held here; one shard
    a rank (``group`` or ``ring``), each rank differentiates its own part
    of the cost, and the caller passes its controls through
    ``sum_over_ranks_grad`` (once for a whole control sequence: one sum an
    evaluation) to sum their cotangent over the ranks. Raises for a wet/dry
    set: the limiter has no adjoint.

    With a ``StageRing``, each stage Function takes the previous stage's
    send buffer only to carry autograd's order: its forward is one launch
    of the stage's peer mode, which reads the receive buffer from the
    ring's slots and stores its own send buffer into the peers', and its
    backward one launch of the adjoint's peer mode, which stores the
    receive buffer's cotangent into the senders' reverse slots where the
    stage before has a backward, and returns no cotangent for that input:
    the cotangent travels through the ring. A stage's backward reads its
    send buffer's cotangent from its reverse slots where the backward of
    the stage that read that buffer ran in the same backward (the cost
    depends on the later stages), adding autograd's part where a cost also
    takes the buffer (as the ``ppermute`` transpose adds both), and
    otherwise takes autograd's (zeros without), so a cost of any states and
    send buffers of a rollout has its gradient, also in a backward that
    autograd restricts to a part of the rollout (``inputs=``; the epochs
    that no backward reads are skipped: ``StageRing._fold``). A
    rollout's first exchange (a send buffer that this step's last stage did
    not return: the constant start's) is one launch of the ring's exchange
    kernel, whose backward is its reverse,
    and the rank's host first waits for its stream there when its ring is
    one of ranks that share this process (``StageRing.over_regions``): a
    rank then runs at most one rollout and its backward ahead of its
    stream, which keeps autograd's one device thread, shared by the ranks,
    from blocking in a launch behind a ring kernel that waits for it
    (ROADMAP C34)."""
    if sb.meta.wetdry:
        raise NotImplementedError(
            "make_sharded_blocked_step_diff does not differentiate the "
            "wet/dry positivity limiter; build with wetdry=False (or use "
            "the non-differentiable step for wet/dry rollouts)")
    ops, meta = sb.ops, sb.meta
    ex = _exchange(sb, group, ring)
    if ring is not None:
        load_stage_peer(ops, meta, ring.batch)
        step = _folded_diff_stages(ops, meta, ring, dt, use_filter, ex)
        step.exchange = ex
        return step

    def make_stage(c_dt: float, apply_sponge: bool):
        class _Stage(torch.autograd.Function):
            @staticmethod
            def forward(ctx, bh, bhu, bhv, ch, chu, chv, rb, t, ctrl):
                ctx.save_for_backward(ch, chu, chv, rb, ctrl)
                ctx.t = t
                return tuple(sw2d_stage_blocked(
                    ops, meta, (bh, bhu, bhv), (ch, chu, chv), rb, c_dt, t,
                    ctrl, use_filter, apply_sponge))

            @staticmethod
            def backward(ctx, lh, lhu, lhv, lsb):
                ch, chu, chv, rb, ctrl = ctx.saved_tensors
                g = sw2d_stage_bwd_blocked_v2(
                    ops, meta, (ch, chu, chv), rb,
                    (lh.contiguous(), lhu.contiguous(), lhv.contiguous()),
                    lsb.contiguous(), c_dt, ctx.t, ctrl, use_filter,
                    apply_sponge)
                lctl = None if g[7] is None else g[7].sum(dim=(0, 1))
                return (*g[:7], None, lctl)

        return _Stage.apply

    stage1, stage2 = make_stage(0.5 * dt, False), make_stage(dt, True)

    def step(carry, t: float = 0.0, ctrl=None):
        state, sbuf = carry
        *s1, sb1 = stage1(*state, *state, ex(sbuf), t, ctrl)
        *s2, sb2 = stage2(*state, *s1, ex(sb1), t + 0.5 * dt, ctrl)
        return tuple(s2), sb2

    step.exchange = ex
    return step
