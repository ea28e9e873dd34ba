"""The halo plan of an element-sharded mesh, the ring exchange, and the
element-sharded plain-tensor path (RHS, Laplacian, time step, curved RHS).

Counterpart of the JAX package's ``blitzdg_tpu/parallel/halo.py``:
``HaloPlan``, ``build_halo_plan``, ``build_gauss_halo_plan``,
``_plan_from_struct`` and ``halo_tables`` (host numpy, the same arrays entry
for entry), ``halo_comm_model``, ``halo_face_rows``, ``halo_traces``,
``_localize_bc``, ``halo_sw2d_rhs``, ``halo_poisson2d_op``,
``halo_sw2d_timestep`` and ``halo_sw2d_curved_rhs``. ``ring_exchange`` (with
``RingExchange``, its tables) moves the blocked path's send buffers.
``_ppermute`` is the call site of every exchange by ring offset but the
blocked path's stacked buffers, which ``ring_exchange`` moves in one static
gather over every offset (``_StackedExchange``), one launch where a roll an
offset would be one each, and the rings' exchanges, one kernel launch for
every offset.

Each shard owns a contiguous block of K / S elements. The only data another
shard needs is the '-' trace of the faces on the cut. The plan lists, per
shard and per ring offset d, the local faces that the shard at offset d
needs; at run time each offset moves one fixed-size buffer from shard s to
shard (s + d) mod S. The blocked path's buffers are ``(S_here, B, L, 3)``:
the shards held here, the scenarios, ``L = n_off * chunk`` slots (chunk d
holds the values for offset ``offs[d]``) and the three fields.

Four transports, all differentiable (the backward is the same exchange in
the reverse direction):

 - stacked: all S shards on one device, on a shard axis. The receive
   buffer of offset d of shard s is the send buffer of shard
   (s - offs[d]) mod S: a roll over the shard axis, or, for the blocked
   path's buffers, one static index gather over every offset. It is what a
   ring permutation over a mesh axis does when the whole mesh is one card.
 - process group: one shard per rank of a ``torch.distributed`` group; one
   ``batch_isend_irecv`` round per ring offset. CPU tensors (gloo).
 - stage ring (the blocked path's buffers on the card, one shard a rank):
   a ``parallel.StageRing``, device memory that the ranks map into each
   other, one exchange kernel launch forward and one in the backward
   (``peer_stage_exchange``, ``peer_stage_exchange_reverse``).
 - halo ring (the plain-tensor path's face rows on the card, one shard a
   rank): a ``parallel.HaloRing`` (of which the stage ring is a kind), the
   per-offset gathers stacked into one send buffer, one exchange kernel
   launch for every offset forward and one in the backward
   (``peer_halo_exchange``, ``peer_halo_exchange_reverse``).

``sum_over_ranks`` sums a tensor over the ranks, the same bits on every
rank: the parts added in rank order, gathered over the process group (CPU
tensors) or by the ring's sum kernel (``peer_rank_sum``). Across ranks on
the card every exchange and reduction takes a ring (``ring=``): a process
group with CUDA tensors and no ring raises (NCCL refuses two ranks on one
card, and nothing falls back to the CPU).

With no offsets (S = 1) the receive buffer is zeros.

The plain-tensor path takes the place of the JAX functions that run inside
``shard_map`` over the element axis. Where ``shard_map`` consumed the shard
axis, the port keeps it: per-element fields are ``(S_here, K_loc, ...)``
(``parallel.shard_context`` makes the context's), the tables
``(S_here, ...)`` (``halo_tables``), face rows ``(n_fields, S_here, F_loc,
w)``; ``S_here`` is S on the stacked transport (``group=None``) and 1 on a
process group (``group=``, in the place of ``axis_name``) or a halo ring
(``ring=``). The shard index (``lax.axis_index``) is the position on the
shard axis, or the rank; the maximum over shards (``lax.pmax``) a max over
that axis, an ``all_reduce`` with ``MAX``, or the ring's ``peer_rank_max``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..context import (BC_DIRICHLET, BC_NEUMAN, BC_OUT, BC_WALL, DGContext2D,
                       face_trace_structure)
from ..ops.sw2d import (SWPhysics, SWState, _lf_flux_jumps, _safe_norm,
                        _volume_and_sources)


class HaloPlan(NamedTuple):
    """Static halo tables; arrays lead with the shard axis."""

    # (n_shards, n_off or 1, max_send): local face rows to send to the shard
    # at ring offset offs[d]; padded with row 0 (sent, never read)
    send_idx: np.ndarray
    # (n_shards, F_loc): row of [local faces | recv_0 | recv_1 | ...] that
    # feeds each local face's '+' trace
    psrc: np.ndarray
    # (n_shards, F_loc): the '+' face runs in reverse node order
    pflip: np.ndarray
    offs: tuple  # ring offsets with traffic, ascending
    n_shards: int
    max_send: int


def build_halo_plan(ctx: DGContext2D, n_shards: int) -> HaloPlan:
    """Send lists and '+'-source tables from the context's face structure.
    K must be divisible by ``n_shards`` (``partition_mesh`` or
    ``pad_context`` make it so)."""
    K, nf, n_fp = ctx.k_elem, ctx.n_faces, ctx.n_fp
    if K % n_shards:
        raise ValueError(f"K={K} is not divisible by {n_shards} shards")
    fts = face_trace_structure(ctx.mapP.cpu().numpy(), n_fp)
    if fts is None:
        raise ValueError("mapP has no face-granular structure "
                         "(non-conforming mesh?); the halo exchange "
                         "requires conforming faces")
    face_nbr, face_flip = fts
    return _plan_from_struct(face_nbr, face_flip, n_shards,
                             (K // n_shards) * nf)


def build_gauss_halo_plan(gauss, n_shards: int) -> HaloPlan:
    """The halo plan of the curved path's Gauss-face traces: the
    construction of ``build_halo_plan`` over ``gauss.mapP``'s face structure
    (NG-wide face rows, the '+' side in reverse order), so that
    ``halo_sw2d_curved_rhs`` exchanges only the Gauss traces of the cut."""
    K, ntr = gauss.mapP.shape
    nf = ntr // gauss.n_gauss
    if K % n_shards:
        raise ValueError(f"K={K} is not divisible by {n_shards} shards")
    fts = face_trace_structure(gauss.mapP.cpu().numpy(), gauss.n_gauss)
    if fts is None:
        raise ValueError("gauss.mapP has no face-granular structure")
    face_nbr, face_flip = fts
    return _plan_from_struct(face_nbr, face_flip, n_shards,
                             (K // n_shards) * nf)


def _plan_from_struct(face_nbr, face_flip, n_shards: int,
                      f_loc: int) -> HaloPlan:
    owner = face_nbr // f_loc
    # send[d][t]: local row -> slot, in first-seen order, for shard t
    # sending to shard (t + d) mod n_shards
    send: dict[int, list[dict]] = {}
    psrc = np.zeros((n_shards, f_loc), np.int64)
    remote_ref: list[list[tuple]] = [[] for _ in range(n_shards)]
    for s in range(n_shards):
        base = s * f_loc
        for i in range(f_loc):
            nbr = int(face_nbr[base + i])
            t = int(owner[base + i])
            if t == s:
                psrc[s, i] = nbr - t * f_loc
            else:
                d = (s - t) % n_shards
                slots = send.setdefault(d, [dict() for _ in range(n_shards)])
                row = nbr - t * f_loc
                slot = slots[t].setdefault(row, len(slots[t]))
                remote_ref[s].append((i, d, slot))

    offs = tuple(sorted(send.keys()))
    max_send = max((len(send[d][t]) for d in offs for t in range(n_shards)),
                   default=1)
    max_send = max(max_send, 1)
    send_idx = np.zeros((n_shards, max(len(offs), 1), max_send), np.int32)
    for di, d in enumerate(offs):
        for t in range(n_shards):
            for row, slot in send[d][t].items():
                send_idx[t, di, slot] = row
    for s in range(n_shards):
        for i, d, slot in remote_ref[s]:
            psrc[s, i] = f_loc + offs.index(d) * max_send + slot
    pflip = np.asarray(face_flip).reshape(n_shards, f_loc)
    return HaloPlan(send_idx=send_idx, psrc=psrc.astype(np.int32),
                    pflip=pflip, offs=offs, n_shards=n_shards,
                    max_send=max_send)


def halo_tables(plan: HaloPlan, device="cuda", rank: int | None = None):
    """The per-shard tables as tensors: (send_idx, psrc, pflip), every
    shard's rows (the stacked transport) or, with ``rank``, that shard's
    row alone (leading axis 1: one rank of a process group)."""
    rows = slice(None) if rank is None else slice(rank, rank + 1)
    return tuple(torch.as_tensor(a[rows], device=device)
                 for a in (plan.send_idx, plan.psrc, plan.pflip))


def halo_comm_model(plan: HaloPlan, width: int, n_fields: int, *,
                    link_gbps: float, latency_us: float,
                    itemsize: int = 4) -> dict:
    """Bytes of one exchange and a projection of its time on a link whose
    bandwidth (GB/s) and latency (µs a collective) the caller gives.

    bytes/shard/exchange = n_fields * width * itemsize * n_off * max_send:
    every active ring offset ships its padded (max_send, width) face
    buffer. time = latency_us per offset + bytes / bandwidth."""
    per_off_rows = int(plan.max_send)
    n_off = max(len(plan.offs), 1)
    bytes_per_exchange = n_fields * per_off_rows * width * itemsize * n_off
    t_us = n_off * latency_us + bytes_per_exchange / (link_gbps * 1e3)
    return {
        "halo_rows_per_offset": per_off_rows,
        "ring_offsets": list(plan.offs),
        "bytes_per_shard_per_exchange": bytes_per_exchange,
        "link_gbps_assumed": link_gbps,
        "collective_latency_us_assumed": latency_us,
        "projected_exchange_us": round(t_us, 3),
    }


def _stacked_source(plan: HaloPlan, chunk: int, sign: int) -> np.ndarray:
    """(S, L): the shard whose slot j a stacked shard s receives, for the
    exchange (sign +1) or its reverse (sign -1)."""
    S = plan.n_shards
    d = np.repeat(np.asarray(plan.offs, dtype=np.int64), chunk)
    return (np.arange(S)[:, None] - sign * d[None, :]) % S


def _stacked(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    index = src[:, None, :, None].expand(buf.shape)
    return torch.gather(buf, 0, index)


def _p2p(x: torch.Tensor, shift: int, n_shards: int, group) -> torch.Tensor:
    """This rank's ``x`` to rank + shift of ``group``; what rank - shift
    sent (one ``batch_isend_irecv`` round)."""
    import torch.distributed as dist

    rank = dist.get_rank(group)
    peer = lambda r: dist.get_global_rank(group, r % n_shards)
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peer(rank + shift), group),
           dist.P2POp(dist.irecv, recv, peer(rank - shift), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _GroupShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, n_shards, group):
        ctx.shift, ctx.n_shards, ctx.group = shift, n_shards, group
        return _p2p(x, shift, n_shards, group)

    @staticmethod
    def backward(ctx, grad):
        return _p2p(grad, -ctx.shift, ctx.n_shards, ctx.group), None, None, None


def _ppermute(x: torch.Tensor, shift: int, n_shards: int, group=None,
              dim: int = 0) -> torch.Tensor:
    """An exchange by one ring offset (every one but the stacked blocked
    buffers', which ``ring_exchange`` gathers at once): shard s's ``x``
    goes to shard (s + shift) mod S, and each shard gets what shard
    (s - shift) mod S sent. Stacked (``group`` None): ``x`` holds every
    shard on axis ``dim``, and the exchange is a roll over it. Process
    group: ``x`` is this rank's, and the exchange one send/receive round.
    Differentiable: the backward is the exchange by -shift."""
    if group is None:
        return torch.roll(x, shift, dim)
    return _GroupShift.apply(x, shift, n_shards, group)


class _StackedExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, src, src_rev):
        ctx.src_rev = src_rev
        return _stacked(buf, src)

    @staticmethod
    def backward(ctx, grad):
        return _stacked(grad.contiguous(), ctx.src_rev), None, None


class _RingStageExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, ring):
        from .peer import peer_stage_exchange

        ctx.ring = ring
        return peer_stage_exchange(ring, buf)

    @staticmethod
    def backward(ctx, grad):
        from .peer import peer_stage_exchange_reverse

        return peer_stage_exchange_reverse(ctx.ring, grad.contiguous()), None


class _RingHaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, ring):
        from .peer import peer_halo_exchange

        ctx.ring = ring
        return peer_halo_exchange(ring, buf)

    @staticmethod
    def backward(ctx, grad):
        from .peer import peer_halo_exchange_reverse

        return peer_halo_exchange_reverse(ctx.ring, grad.contiguous()), None


class RingExchange:
    """The exchange of one plan, its static tables made once: call it with
    a send buffer ``(S_here, B, L, 3)`` to get the receive buffer.
    ``group``: None for the stacked transport (``S_here = S``), or the
    ``torch.distributed`` process group of the S ranks (``S_here = 1``).
    ``ring``: a ``parallel.StageRing`` of this rank (``S_here = 1``, CUDA
    tensors): the stage-ring transport. The process group's point-to-point
    transport serves CPU tensors; across ranks on the card the exchange
    takes a ring, and a buffer on the card without one raises."""

    def __init__(self, plan: HaloPlan, n_fp: int, group=None, device="cuda",
                 ring=None):
        self.plan, self.group, self.ring = plan, group, ring
        self.chunk = plan.max_send * n_fp
        self.src = self.src_rev = None
        if plan.offs and group is None and ring is None:
            self.src = torch.as_tensor(_stacked_source(plan, self.chunk, 1),
                                       device=device)
            self.src_rev = torch.as_tensor(
                _stacked_source(plan, self.chunk, -1), device=device)

    def __call__(self, sbuf: torch.Tensor) -> torch.Tensor:
        return ring_exchange(sbuf, self)

    def ring_for(self, t: torch.Tensor):
        """The stage ring that serves ``t``, or None (the stacked transport,
        or the process group's on CPU tensors)."""
        return _ring_for(t, self.group, self.ring)


def _ring_for(t: torch.Tensor, group, ring):
    """The ring (``ring=``) that serves ``t``, or None: the stacked
    transport, or the process group's on CPU tensors. A process group with
    a tensor on the card and no ring raises."""
    if ring is None:
        if group is not None and t.is_cuda:
            raise ValueError(
                "across ranks on the card the exchange takes this rank's "
                "ring (ring=: a parallel.HaloRing or StageRing); the process "
                "group's transport serves CPU tensors")
        return None
    if t.device != ring.device:
        raise ValueError(
            f"a tensor on {t.device} for a ring on {ring.device}: the ring "
            "runs on the card; on CPU tensors the process group is the "
            "transport")
    return ring


def ring_exchange(sbuf: torch.Tensor, ex: RingExchange) -> torch.Tensor:
    """The receive buffer of ``sbuf`` under ``ex``'s plan and transport: the
    stacked transport gathers every offset's chunk at once through the
    static tables; a process group moves each offset's chunk through
    ``_ppermute``; a stage ring launches its exchange kernel (its backward:
    the reverse exchange kernel)."""
    plan = ex.plan
    ring = ex.ring_for(sbuf)
    if ring is not None:
        return _RingStageExchange.apply(sbuf, ring)
    if not plan.offs:
        return torch.zeros_like(sbuf)
    if ex.group is None:
        return _StackedExchange.apply(sbuf, ex.src, ex.src_rev)
    c = ex.chunk
    return torch.cat([
        _ppermute(sbuf[:, :, di * c:(di + 1) * c], d, plan.n_shards, ex.group)
        for di, d in enumerate(plan.offs)], dim=2)


def sum_over_ranks(x: torch.Tensor, ex: RingExchange) -> torch.Tensor:
    """``x`` summed over the ranks of ``ex``'s transport, the parts added in
    rank order 0, 1, ..., S-1, so that every rank holds the same bits: the
    stage ring's sum kernel (``peer_rank_sum``), or over the process group
    an ``all_gather`` and the sum here (CPU tensors; the plain version of
    the kernel). The stacked transport has one process: ``x`` itself. Not
    differentiable (``parallel.blocked_shard`` pairs it with its
    transpose)."""
    ring = ex.ring_for(x)
    if ring is not None:
        from .peer import peer_rank_sum

        return peer_rank_sum(ring, x.contiguous())
    if ex.group is None:
        return x
    import torch.distributed as dist

    from .peer import rank_order_sum

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(ex.group))]
    dist.all_gather(parts, x.contiguous(), group=ex.group)
    return rank_order_sum(parts)


# ---------------------------------------------------------------------------
# The element-sharded plain-tensor path
# ---------------------------------------------------------------------------

def halo_face_rows(rows: torch.Tensor, tables, plan: HaloPlan, group=None,
                   halo_dtype=None, ring=None) -> torch.Tensor:
    """'+' face rows from the local '-' face rows ``rows`` (n_fields,
    S_here, F_loc, w): one exchange per active ring offset, then each local
    face's source row, reversed where the face is flipped. Any width: w is
    Nfp for nodal traces, NG for Gauss traces. ``tables``: ``halo_tables``
    rows of the shards held here.

    ``ring``: this rank's ``parallel.HaloRing`` (one shard a rank on the
    card, ``S_here = 1``): the offsets' gathers go into one offset-major
    send buffer (n_off, n_fields, max_send, w), moved by one exchange
    launch, whose backward is the reverse launch.

    ``halo_dtype`` (e.g. ``torch.bfloat16``) casts the shipped buffer
    alone; local faces keep their precision. The '+' trace is only the
    flux's stabilising input, so a bfloat16 halo trades about 1e-3 relative
    face-flux noise for half the bytes: opt-in."""
    send_idx, psrc, pflip = tables
    nF, Sh, _, w = rows.shape
    ring = _ring_for(rows, group, ring)
    parts = [rows]
    if ring is not None and plan.offs:
        if Sh != 1:
            raise ValueError(f"a ring's rank holds one shard, not {Sh}")
        idx = send_idx[0, :len(plan.offs)].long()
        buf = rows[:, 0][:, idx].transpose(0, 1).contiguous()
        if halo_dtype is not None:
            buf = buf.to(halo_dtype)
        recv = _RingHaloExchange.apply(buf, ring).to(rows.dtype)
        parts.append(recv.transpose(0, 1).reshape(nF, 1, -1, w))
    else:
        for di, d in enumerate(plan.offs):
            idx = send_idx[:, di].long()
            buf = torch.gather(rows, 2, idx[None, :, :, None].expand(
                nF, Sh, idx.shape[1], w))
            if halo_dtype is not None:
                buf = buf.to(halo_dtype)
            parts.append(_ppermute(buf, d, plan.n_shards, group, dim=1)
                         .to(rows.dtype))
    comb = torch.cat(parts, dim=2)
    src = psrc.long()
    out = torch.gather(comb, 2, src[None, :, :, None].expand(
        nF, Sh, src.shape[1], w))
    return torch.where(pflip[None, :, :, None], out.flip(-1), out)


def halo_traces(fields, ctx: DGContext2D, tables, plan: HaloPlan, group=None,
                halo_dtype=None, ring=None):
    """'-' and '+' traces of a tuple of (S_here, K_loc, Np) fields, the cut
    faces' '+' side exchanged (``halo_face_rows``, over ``group`` or
    ``ring``). Returns two (n_fields, S_here, F_loc*Nfp) stacks."""
    n_fp = ctx.n_fp
    fm = ctx.fmask.reshape(-1)
    fMf = torch.stack([f[..., fm] for f in fields])
    nF, Sh = fMf.shape[:2]
    fMf = fMf.reshape(nF, Sh, -1, n_fp)
    fP = halo_face_rows(fMf, tables, plan, group, halo_dtype, ring)
    return fMf.reshape(nF, Sh, -1), fP.reshape(nF, Sh, -1)


def _shard_ids(n_here: int, group, device, ring=None) -> torch.Tensor:
    """(S_here, 1) ids of the shards held here: the positions on the
    stacked shard axis, this rank of ``ring``, or this rank of ``group``."""
    if ring is not None:
        return torch.full((1, 1), ring.rank, device=device)
    if group is None:
        return torch.arange(n_here, device=device)[:, None]
    import torch.distributed as dist

    return torch.full((1, 1), dist.get_rank(group), device=device)


def _localize_bc(g_idx, g_mask, my, local_size: int):
    """GLOBAL trace indices (replicated) localized to the shards ``my``
    (S_here, 1): (idx, safe, mine), each (S_here, n). An entry another
    shard owns gets the out-of-range index ``local_size`` (``_set_drop``
    drops it) and the safe index 0 for reads."""
    mine = g_mask & (torch.div(g_idx, local_size, rounding_mode="floor")
                     == my)
    idx = torch.where(mine, g_idx % local_size, local_size)
    safe = torch.where(mine, idx, 0)
    return idx, safe, mine


def _set_drop(a: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``a`` (S_here, n) with ``vals`` written at ``idx`` in each shard's
    row; an index n is dropped (it lands in a column of the shard's own
    that is cut off, never in another shard's row)."""
    ext = torch.cat([a, a.new_zeros(a.shape[0], 1)], dim=1)
    vals = torch.as_tensor(vals, dtype=a.dtype, device=a.device)
    return ext.scatter(1, idx, vals.expand(idx.shape))[:, :-1]


def halo_sw2d_rhs(ctx: DGContext2D, state: SWState, t, phys: SWPhysics,
                  tables, plan: HaloPlan, group=None, tidal_forcing=None,
                  halo_dtype=None, ring=None) -> SWState:
    """The shallow-water RHS of ``ops.sw2d.sw2d_rhs`` on an element-sharded
    mesh, the cut faces' '+' traces exchanged (the halo, not the domain):
    wall reflection, BC_OUT tidal forcing, hydrostatic-reconstruction
    well-balancing over bathymetry (whose trace joins the exchange), the
    bed-slope, drag and Coriolis sources.

    ``ctx``: the shards' context blocks (``shard_context``); ``state`` and
    ``phys.H/Hx/Hy`` (S_here, K_loc, Np); ``tables``: ``halo_tables`` rows;
    ``group``: None (stacked) or the process group; ``ring``: this rank's
    ``parallel.HaloRing`` (one shard a rank on the card). ``halo_dtype``:
    see ``halo_face_rows``. Differentiable by ``torch.autograd``."""
    h, hu, hv = state
    Sh, K_loc = h.shape[:2]
    ring = _ring_for(h, group, ring)
    my = _shard_ids(Sh, group, h.device, ring)
    wb = phys.H is not None and phys.well_balanced
    fields = (h, hu, hv) + ((phys.H,) if wb else ())
    fM, fP = halo_traces(fields, ctx, tables, plan, group, halo_dtype, ring)
    hM, huM, hvM = fM[0], fM[1], fM[2]
    hP, huP, hvP = fP[0], fP[1], fP[2]
    HMt, HPt = (fM[3], fP[3]) if wb else (None, None)

    nxf, nyf = ctx.nx.reshape(Sh, -1), ctx.ny.reshape(Sh, -1)
    local_size = K_loc * ctx.n_faces * ctx.n_fp

    # wall: reflect the normal momentum
    wall, safe, _ = _localize_bc(ctx.bc_maps.idx[BC_WALL],
                                 ctx.bc_maps.mask[BC_WALL], my, local_size)
    at = lambda a: torch.gather(a, 1, safe)
    un2 = 2.0 * (at(huM) * at(nxf) + at(hvM) * at(nyf))
    huP = _set_drop(huP, wall, at(huM) - un2 * at(nxf))
    hvP = _set_drop(hvP, wall, at(hvM) - un2 * at(nyf))

    # open boundary: the prescribed total depth on BC_OUT nodes
    if tidal_forcing is not None:
        ob, _, _ = _localize_bc(ctx.bc_maps.idx[BC_OUT],
                                ctx.bc_maps.mask[BC_OUT], my, local_size)
        hP = _set_drop(hP, ob, tidal_forcing(t))

    d1, d2, d3 = _lf_flux_jumps(phys.g, ctx.n_fp, nxf, nyf, hM, hP, huM, huP,
                                hvM, hvP, HMt, HPt)
    return _volume_and_sources(ctx, phys, h, hu, hv, d1, d2, d3)


def halo_poisson2d_op(ctx: DGContext2D, u: torch.Tensor, tau, tables,
                      plan: HaloPlan, group=None,
                      dirichlet_tags=(BC_WALL, BC_DIRICHLET),
                      neumann_tags=(BC_NEUMAN,),
                      symmetrize: bool = False, ring=None) -> torch.Tensor:
    """The IP Laplacian of ``ops.poisson.poisson2d_op`` on an
    element-sharded mesh, its two trace exchanges (u, then the gradient
    pair) through the halo: u (S_here, K_loc, Np) -> (S_here, K_loc, Np).
    With ``solvers.cg``/``gmres`` it gives an element-sharded elliptic
    solve: on the stacked transport the flattened (S*K_loc*Np,) vector goes
    to the solver with ``group=None``; on a process group each rank's
    block goes with ``group=``, which sums the dots over the ranks; on the
    card one shard a rank, with this rank's ``parallel.HaloRing``
    (``ring=``, here and in the solver).

    ``tau`` is the GLOBAL penalty constant ((N+1)^2 max Fscale over the
    whole mesh), computed once at set-up, so that the sharded operator
    equals the unsharded one."""
    Sh, K_loc = u.shape[:2]
    n_tr = ctx.n_faces * ctx.n_fp
    ring = _ring_for(u, group, ring)
    my = _shard_ids(Sh, group, u.device, ring)
    local_size = K_loc * n_tr
    loc = lambda tag: _localize_bc(ctx.bc_maps.idx[tag],
                                   ctx.bc_maps.mask[tag], my, local_size)

    ux, uy = ctx.grad(u)
    (uM,), (uP,) = halo_traces((u,), ctx, tables, plan, group, ring=ring)
    nxf, nyf = ctx.nx.reshape(Sh, -1), ctx.ny.reshape(Sh, -1)

    # Dirichlet: uP = -uM (a zero trace)
    for tag in dirichlet_tags:
        idx, safe, _ = loc(tag)
        uP = _set_drop(uP, idx, -torch.gather(uM, 1, safe))

    du = uM - uP
    du_mat = du.reshape(Sh, K_loc, n_tr)
    # the auxiliary gradient with the central flux: q = grad u - Lift(n du/2)
    qx = ux - ((ctx.fscale * ctx.nx * du_mat * 0.5) @ ctx.lift.T)
    qy = uy - ((ctx.fscale * ctx.ny * du_mat * 0.5) @ ctx.lift.T)

    (uxM, uyM), (uxP, uyP) = halo_traces((ux, uy), ctx, tables, plan, group,
                                         ring=ring)
    fm = ctx.fmask.reshape(-1)
    qxM = qx[..., fm].reshape(Sh, -1)
    qyM = qy[..., fm].reshape(Sh, -1)

    # Neumann: mirror the gradient so that its normal component cancels
    for tag in neumann_tags:
        idx, safe, _ = loc(tag)
        at = lambda a: torch.gather(a, 1, safe)
        un = at(uxM) * at(nxf) + at(uyM) * at(nyf)
        uxP = _set_drop(uxP, idx, at(uxM) - 2.0 * at(nxf) * un)
        uyP = _set_drop(uyP, idx, at(uyM) - 2.0 * at(nyf) * un)

    dqx = qxM - 0.5 * (uxM + uxP)
    dqy = qyM - 0.5 * (uyM + uyP)
    surf = (ctx.nx * dqx.reshape(Sh, K_loc, n_tr)
            + ctx.ny * dqy.reshape(Sh, K_loc, n_tr) + tau * du_mat)
    qxr, qxs = qx @ ctx.Dr.T, qx @ ctx.Ds.T
    qyr, qys = qy @ ctx.Dr.T, qy @ ctx.Ds.T
    lap = (ctx.rx * qxr + ctx.sx * qxs + ctx.ry * qyr + ctx.sy * qys
           - (ctx.fscale * surf) @ ctx.lift.T)
    if symmetrize:
        M = ctx.Vinv.T @ ctx.Vinv
        lap = ctx.J * (lap @ M.T)
    return lap


def halo_sw2d_timestep(ctx: DGContext2D, state: SWState, g: float,
                       cfl: float, group=None, ring=None):
    """The adaptive dt of ``ops.sw2d.sw2d_timestep`` on an element-sharded
    mesh: the largest face wavespeed of the shards held here (the '-' trace,
    no exchange), then the maximum over the ranks (not differentiated): of
    ``ring`` by its ``peer_rank_max`` (the card), or of ``group`` by an
    ``all_reduce`` with ``MAX`` (CPU tensors)."""
    h, hu, hv = state
    ring = _ring_for(h, group, ring)
    spd = _safe_norm(hu / h, hv / h) + torch.sqrt(g * h)
    spdM = spd[..., ctx.fmask.reshape(-1)]
    fsc = torch.max(torch.abs(ctx.fscale) * spdM)
    if ring is not None:
        from .peer import peer_rank_max

        fsc = peer_rank_max(ring, fsc.detach().reshape(1)).reshape(())
    elif group is not None:
        import torch.distributed as dist

        fsc = fsc.detach().clone()
        dist.all_reduce(fsc, op=dist.ReduceOp.MAX, group=group)
    return cfl / ((ctx.n_order + 1) ** 2 * 0.5 * fsc)


def halo_sw2d_curved_rhs(ctx: DGContext2D, cub, gauss, state, t,
                         phys: SWPhysics, tables, plan: HaloPlan, group=None,
                         tidal_forcing=None, zx=None, zy=None, ring=None):
    """The curved weak-form RHS of ``ops.sw2d_curved.sw2d_curved_rhs``
    (four fields, the tracer too; no wet/dry) on an element-sharded mesh:
    the cubature volume integrals and the element mass inverses are the
    shards' own; only the Gauss-face '+' trace crosses the cut, through the
    halo of the Gauss plan (``build_gauss_halo_plan``). ``cub``/``gauss``:
    the shards' blocks (``shard_context``); the Gauss context's boundary
    lists stay global and are localized here. ``group`` / ``ring``: as
    ``halo_sw2d_rhs``'s."""
    from ..ops.sw2d_curved import SWStateTracer, _fluxes

    h, hu, hv, hN = state
    Sh, K_loc = h.shape[:2]
    g = phys.g
    ring = _ring_for(h, group, ring)
    my = _shard_ids(Sh, group, h.device, ring)

    # volume: interpolate to the cubature nodes, weak derivatives (local)
    at_cub = lambda f: f @ cub.V.T
    (F1, F2, F3, F4), (G1, G2, G3, G4) = _fluxes(
        at_cub(h), at_cub(hu), at_cub(hv), at_cub(hN), g)

    def weak_div(F, G):
        tr = cub.W * (cub.rx * F + cub.ry * G)
        ts = cub.W * (cub.sx * F + cub.sy * G)
        return tr @ cub.Dr + ts @ cub.Ds

    MMRHS = [weak_div(F1, G1), weak_div(F2, G2), weak_div(F3, G3),
             weak_div(F4, G4)]

    # surface: the Gauss traces, the '+' side through the halo
    NG = gauss.n_gauss
    ntr = gauss.nx.shape[-1]
    nf = ntr // NG
    gM = torch.stack([(f @ gauss.interp.T).reshape(Sh, K_loc * nf, NG)
                      for f in (h, hu, hv, hN)])
    gP = halo_face_rows(gM, tables, plan, group, ring=ring)
    hM, huM, hvM, hNM = gM.reshape(4, Sh, -1)
    hP, huP, hvP, hNP = gP.reshape(4, Sh, -1)

    nxf, nyf = gauss.nx.reshape(Sh, -1), gauss.ny.reshape(Sh, -1)
    local_size = K_loc * ntr
    wall, safe, _ = _localize_bc(gauss.bc_idx[BC_WALL],
                                 gauss.bc_mask[BC_WALL], my, local_size)
    at = lambda a: torch.gather(a, 1, safe)
    un2 = 2.0 * (at(huM) * at(nxf) + at(hvM) * at(nyf))
    huP = _set_drop(huP, wall, at(huM) - un2 * at(nxf))
    hvP = _set_drop(hvP, wall, at(hvM) - un2 * at(nyf))
    if tidal_forcing is not None:
        ob, _, _ = _localize_bc(gauss.bc_idx[BC_OUT], gauss.bc_mask[BC_OUT],
                                my, local_size)
        hP = _set_drop(hP, ob, tidal_forcing(t))

    (F1M, F2M, F3M, F4M), (G1M, G2M, G3M, G4M) = _fluxes(hM, huM, hvM, hNM, g)
    (F1P, F2P, F3P, F4P), (G1P, G2P, G3P, G4P) = _fluxes(hP, huP, hvP, hNP, g)
    spdM = _safe_norm(huM / hM, hvM / hM) + torch.sqrt(g * hM)
    spdP = _safe_norm(huP / hP, hvP / hP) + torch.sqrt(g * hP)
    spd = torch.maximum(spdM, spdP).reshape(Sh, K_loc * nf, NG)
    lam = torch.amax(spd, dim=-1, keepdim=True).expand(spd.shape).reshape(
        Sh, -1)

    shape = (Sh, K_loc, ntr)
    fl = [(0.5 * ((FM + FP) * nxf + (GM + GP) * nyf
                  + lam * (qM - qP))).reshape(shape)
          for FM, FP, GM, GP, qM, qP in (
              (F1M, F1P, G1M, G1P, hM, hP),
              (F2M, F2P, G2M, G2P, huM, huP),
              (F3M, F3P, G3M, G3P, hvM, hvP),
              (F4M, F4P, G4M, G4P, hNM, hNP))]
    MMRHS = [m - (gauss.W * f) @ gauss.interp for m, f in zip(MMRHS, fl)]
    inv = lambda mm: torch.einsum("skij,skj->ski", cub.MMinv, mm)
    RHS1, RHS2, RHS3, RHS4 = (inv(m) for m in MMRHS)

    u, v = hu / h, hv / h
    cd_norm = phys.cd * _safe_norm(u, v)
    RHS2 = RHS2 + phys.f_cor * hv - cd_norm * u
    RHS3 = RHS3 - phys.f_cor * hu - cd_norm * v
    if zx is not None:
        RHS2 = RHS2 - g * h * zx
        RHS3 = RHS3 - g * h * zy
    return SWStateTracer(h=RHS1, hu=RHS2, hv=RHS3, hN=RHS4)
