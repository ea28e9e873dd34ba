"""The halo plan of an element-sharded mesh and the ring exchange.

Counterpart of the JAX package's ``blitzdg_tpu/parallel/halo.py``:
``HaloPlan``, ``build_halo_plan``, ``_plan_from_struct`` and ``halo_tables``
(host numpy, the same arrays entry for entry), and ``ring_exchange`` in the
place of ``_ppermute``, the one call site of every exchange.

Each shard owns a contiguous block of K / S elements. The only data another
shard needs is the '-' trace of the faces on the cut. The plan lists, per
shard and per ring offset d, the local faces that the shard at offset d
needs; at run time each offset moves one fixed-size chunk of a send buffer
from shard s to shard (s + d) mod S. Buffers are ``(S_here, B, L, 3)``: the
shards held here, the scenarios, ``L = n_off * chunk`` slots (chunk d holds
the values for offset ``offs[d]``) and the three fields.

Two transports, both differentiable (the backward is the same exchange in
the reverse direction):

 - stacked: all S shards on one device, on the leading axis. The receive
   chunk d of shard s is the send chunk d of shard (s - offs[d]) mod S: one
   static index gather. It is what a ring permutation over a mesh axis does
   when the whole mesh is one card.
 - process group: one shard per rank of a ``torch.distributed`` group; one
   ``batch_isend_irecv`` round per ring offset.

With no offsets (S = 1) the receive buffer is zeros.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..context import DGContext2D, face_trace_structure


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


def halo_tables(plan: HaloPlan, device="cuda"):
    """The per-shard tables as tensors: (send_idx, psrc, pflip)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in (plan.send_idx, plan.psrc, plan.pflip))


def _stacked_source(plan: HaloPlan, chunk: int, sign: int) -> np.ndarray:
    """(S, L): the shard whose slot j a stacked shard s receives, for the
    exchange (sign +1) or its reverse (sign -1)."""
    S = plan.n_shards
    d = np.repeat(np.asarray(plan.offs, dtype=np.int64), chunk)
    return (np.arange(S)[:, None] - sign * d[None, :]) % S


def _stacked(buf: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    index = src[:, None, :, None].expand(buf.shape)
    return torch.gather(buf, 0, index)


def _process_group(buf: torch.Tensor, plan: HaloPlan, chunk: int, sign: int,
                   group) -> torch.Tensor:
    import torch.distributed as dist

    S = plan.n_shards
    rank = dist.get_rank(group)
    peer = lambda r: dist.get_global_rank(group, r % S)
    out = torch.empty_like(buf)
    for di, d in enumerate(plan.offs):
        part = slice(di * chunk, (di + 1) * chunk)
        send = buf[:, :, part].contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, peer(rank + sign * d), group),
               dist.P2POp(dist.irecv, recv, peer(rank - sign * d), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out[:, :, part] = recv
    return out


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, plan, chunk, group, src, src_rev):
        ctx.plan, ctx.chunk, ctx.group, ctx.src_rev = plan, chunk, group, src_rev
        if group is None:
            return _stacked(buf, src)
        return _process_group(buf, plan, chunk, +1, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        if ctx.group is None:
            back = _stacked(grad, ctx.src_rev)
        else:
            back = _process_group(grad, ctx.plan, ctx.chunk, -1, ctx.group)
        return back, None, None, None, None, None


class RingExchange:
    """The exchange of one plan, its static tables made once: call it with
    a send buffer ``(S_here, B, L, 3)`` to get the receive buffer.
    ``group``: None for the stacked transport (``S_here = S``), or the
    ``torch.distributed`` process group of the S ranks (``S_here = 1``)."""

    def __init__(self, plan: HaloPlan, n_fp: int, group=None, device="cuda"):
        self.plan, self.group = plan, group
        self.chunk = plan.max_send * n_fp
        self.src = self.src_rev = None
        if plan.offs and group is None:
            self.src = torch.as_tensor(_stacked_source(plan, self.chunk, 1),
                                       device=device)
            self.src_rev = torch.as_tensor(
                _stacked_source(plan, self.chunk, -1), device=device)

    def __call__(self, sbuf: torch.Tensor) -> torch.Tensor:
        return ring_exchange(sbuf, self)


def ring_exchange(sbuf: torch.Tensor, ex: RingExchange) -> torch.Tensor:
    """The receive buffer of ``sbuf`` under ``ex``'s plan and transport: the
    one call site of every halo exchange of the sharded path."""
    if not ex.plan.offs:
        return torch.zeros_like(sbuf)
    return _RingExchange.apply(sbuf, ex.plan, ex.chunk, ex.group, ex.src,
                               ex.src_rev)
