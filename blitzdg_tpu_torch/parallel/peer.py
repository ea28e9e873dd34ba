"""Transports across ranks over device memory that the ranks map into each
other (CUDA IPC): ``PeerRing``, the one-launch step's (B9's), ``HaloRing``,
the element-sharded plain-tensor path's, and ``StageRing`` (a halo ring
whose slots hold the blocked buffers), the differentiable sharded step's
and the MPC's across ranks.

``PeerRing``: one region of device memory a rank that its ring peers store
into, and ``peer_ring_exchange``, the step-boundary exchange over it (a
launch for the ring's first step only: every later step's exchange is the
step launch's own).

Counterpart of what the JAX package's one-launch sharded step
(``blitzdg_tpu/ops/sw2d_blocked.py``, ``_step_kernel_rdma``, driven by
``parallel/blocked_shard.py::make_sharded_blocked_step_rdma``) has on each
chip: its ``comm_buf`` (the stage-2 receive slots), its barrier semaphore
(READY) and its remote copies, and the XLA ``ppermute`` of the carried send
buffer between steps. One shard a rank: each rank allocates one region
(``ops/csrc/peer.cu``: ``cudaMalloc``, zeroed) that holds

 - the stage-2 receive slots, (B, L, 3) floats, which the peers' step
   launches store their stage-1 halo into;
 - the step-boundary receive slots, (B, L, 3) floats, which the peers'
   step launches store their send slots into (and, before the first step,
   their ``peer_ring_exchange`` the initial send buffer);
 - the flags: the epoch (the last step launched here), then one READY and
   one ARRIVED word a ring offset for each of the two uses (the layout and
   the protocol: ``ops/csrc/peer_flags.cuh``). The TPU kernel waits on one
   count of READY signals, which is right only while every rank's offsets
   are symmetric; one flag an offset needs no such rule.

``StageRing``: the counterpart of the XLA collectives of the JAX package's
sharded MPC across chips (``examples/mpc_sharded.py`` over
``make_sharded_blocked_step_diff``): the ``ppermute`` of a stage's send
buffer between the RK stages, its transpose in the backward sweep, and the
``psum`` of the cost with the sum over chips of the shared controls'
cotangent. A region a rank holds two slot sets by the epoch's parity for
each use (forward and reverse receive slots, (B, L, 3) floats each) and a
sum slot a rank, with their GO and ARRIVED flags; ``peer_stage_exchange``,
``peer_stage_exchange_reverse`` and ``peer_rank_sum`` launch its kernels
(``ops/csrc/peer.cu``), which copy what arrives into memory torch owns, so
that autograd may keep a receive buffer: a later exchange into the same
slots changes nothing it kept. The sharded steps fold the exchange into
the stage's launch and its reverse into the adjoint's
(``ops.sw2d_blocked.sw2d_stage_blocked_peer``,
``sw2d_stage_bwd_blocked_peer``, over the same slots and flags): the
standalone exchange moves only a rollout's first send buffer.

``HaloRing``: the counterpart of the collectives of the JAX package's
element-sharded plain-tensor path inside ``shard_map``
(``blitzdg_tpu/parallel/halo.py``, ``blitzdg_tpu/solvers/krylov.py``): the
``lax.ppermute`` a ring offset of ``halo_face_rows`` and its transpose, the
``lax.pmax`` of ``halo_sw2d_timestep`` and the ``psum`` of the Krylov
dots. The same region layout and kernels as the stage ring's, its slots
sized in bytes (``halo_slot_bytes``): ``peer_halo_exchange`` moves a
face-row buffer of any width and type (float32, float64, bfloat16), every
ring offset in one launch, ``peer_halo_exchange_reverse`` its transpose,
``peer_rank_max`` and ``peer_rank_sum`` reduce float32 or float64 tensors
over the ranks in rank order, the same bits on every rank.

A region's CUDA IPC handle is all-gathered over the process group, and each
rank opens the regions it stores into once (a ``PeerRing``'s ring peers, a
``HaloRing``'s every rank, for the reductions): on one card that maps the same
memory into another process, on a node with several cards a peer card's
memory over NVLink. The group carries nothing else: the handles and the
barriers of set-up and ``close``. gloo will do, and on one card it must be
gloo, since NCCL refuses two ranks on one card. Nothing falls back to
``torch.distributed`` point-to-point or ``all_reduce``: a ring on a CPU
device, or over a group whose size is not the plan's shard count, raises.
On CPU tensors the sharded steps take the process group's ``RingExchange``
instead (``parallel.make_sharded_blocked_step_rdma``,
``make_sharded_blocked_step_fused``, ``make_sharded_blocked_step_diff``).

Flags are 64-bit epochs that only grow, so nothing is ever reset; every
wait is bounded (``timeout_s``) and traps past its bound, so a lost peer is
an error (the CUDA context is lost with it) and never a hang.

Ranks that share a process (``over_regions``) share its interpreter and
autograd's one device thread; the stage and halo rings guard them
(ROADMAP C34): ``meet=``, a meeting of the ranks' threads before each ring
launch; the differentiable step's pacing of each rollout (``_pace``); and
``warm_ranks``, each rank's program run alone first, so that no launch of
it loads a module while a peer's ring kernel spins.
"""
from __future__ import annotations

import ctypes
import threading
import weakref

import torch

from ..ops import _build
from ..ops.sw2d_fused import count_launches
from .halo import HaloPlan

# Byte alignment of the parts of a region.
_ALIGN = 256


def _lib():
    """The compiled transport (``ops/csrc/peer.cu``) with its argument types
    set (built at first use; needs nvcc and a CUDA device)."""
    lib = _build.load("peer")
    if getattr(lib, "_peer_typed", False):
        return lib
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.peer_handle_bytes.argtypes = []
    lib.peer_error_string.argtypes = [I]
    lib.peer_error_string.restype = ctypes.c_char_p
    lib.peer_alloc.argtypes = [I, ctypes.c_size_t, ctypes.POINTER(P)]
    lib.peer_free.argtypes = [P]
    lib.peer_export.argtypes = [P, ctypes.c_char_p]
    lib.peer_open.argtypes = [I, ctypes.c_char_p, ctypes.POINTER(P)]
    lib.peer_close.argtypes = [P]
    lib.peer_ring_exchange.argtypes = [P, P, I, I, I, P]
    lib.peer_stage_exchange.argtypes = [P, I, P, P, I, I, I, I, I,
                                        ctypes.c_ulonglong, I, P]
    lib.peer_rank_reduce.argtypes = [P, I, I, P, P, I, ctypes.c_ulonglong,
                                     I, P]
    lib.peer_load.argtypes = []
    for fn in (lib.peer_handle_bytes, lib.peer_alloc, lib.peer_free,
               lib.peer_export, lib.peer_open, lib.peer_close,
               lib.peer_ring_exchange, lib.peer_stage_exchange,
               lib.peer_rank_reduce, lib.peer_load):
        fn.restype = I
    lib._peer_typed = True
    return lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.peer_error_string(err).decode()})")


def _round(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def region_layout(batch: int, n_slots: int, n_off: int) -> dict:
    """Byte offsets in one rank's region (``ops/csrc/peer_flags.cuh``): the
    stage-2 receive slots at 0, the step-boundary slots at ``rbb``, the
    ``n_flags`` flag words at ``flags`` and after them the step launch's
    count of its blocks; ``bytes`` in all."""
    slots = _round(batch * n_slots * 3 * 4)
    n_flags = 1 + 4 * n_off
    return {"rbb": slots, "flags": 2 * slots, "n_flags": n_flags,
            "bytes": 2 * slots + _round(8 * (n_flags + 1))}


def _map_regions(ring, plan: HaloPlan, group, device, nbytes: int, peers,
                 setup):
    """A ring's set-up across processes: this rank's region of ``nbytes``
    (zeroed) on ``device``, its IPC handle all-gathered over ``group``, the
    regions of ``peers(rank, S)`` opened here, then ``setup(rank, bases,
    device)`` with every mapped region's address by rank, and a barrier.
    Sets ``ring.group``, ``_lib``, ``_own`` and ``_opened``; on a failure
    unmaps and frees what it made."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            "a ring maps device memory and needs a CUDA device; on the CPU "
            "the process group's RingExchange is the transport")
    if group is None:
        raise ValueError("a ring needs the process group of its ranks (gloo "
                         "will do)")
    S = plan.n_shards
    if dist.get_world_size(group) != S:
        raise ValueError(f"the group has {dist.get_world_size(group)} "
                         f"ranks; the plan has {S} shards, one a rank")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank(group)
    lib = _lib()
    own = ctypes.c_void_p()
    _check(lib, lib.peer_alloc(dev.index, nbytes, ctypes.byref(own)),
           "peer_alloc")
    opened = {}
    try:
        handle = ctypes.create_string_buffer(lib.peer_handle_bytes())
        _check(lib, lib.peer_export(own, handle), "peer_export")
        handles = [None] * S
        dist.all_gather_object(handles, handle.raw, group=group)
        for p in sorted(set(peers(rank, S)) - {rank}):
            ptr = ctypes.c_void_p()
            _check(lib, lib.peer_open(dev.index, handles[p],
                                      ctypes.byref(ptr)),
                   f"peer_open of rank {p}'s region")
            opened[p] = ptr.value
        bases = dict(opened)
        bases[rank] = own.value
        setup(rank, bases, dev)
    except BaseException:
        for ptr in opened.values():
            lib.peer_close(ptr)
        lib.peer_free(own)
        raise
    ring.group, ring._lib = group, lib
    ring._own, ring._opened = own.value, opened
    dist.barrier(group)


def _unmap_regions(ring):
    """Every rank: wait for this rank's launches, meet the others, unmap
    the peers' regions, meet again, free this rank's region (nothing for a
    ring over regions of one process)."""
    if ring._own is None:
        return
    import torch.distributed as dist

    torch.cuda.synchronize(ring.device)
    dist.barrier(ring.group)
    for ptr in ring._opened.values():
        _check(ring._lib, ring._lib.peer_close(ptr), "peer_close")
    ring._opened = {}
    dist.barrier(ring.group)
    _check(ring._lib, ring._lib.peer_free(ring._own), "peer_free")
    ring._own = None


class _Raw:
    """Device memory that torch does not own, as ``__cuda_array_interface__``
    (``torch.as_tensor`` makes a view of it without a copy)."""

    def __init__(self, ptr: int, shape: tuple, typestr: str):
        self.__cuda_array_interface__ = {
            "shape": shape, "typestr": typestr, "data": (ptr, False),
            "version": 3, "strides": None}


def _view(ptr: int, shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor over memory at ``ptr`` that it does not own (host memory on
    a CPU device: a build of the kernels for the host, in the tests)."""
    n = 1
    for s in shape:
        n *= s
    if device.type == "cpu":
        size = n * torch.empty((), dtype=dtype).element_size()
        buf = (ctypes.c_char * size).from_address(ptr)
        return torch.frombuffer(buf, dtype=dtype).view(shape)
    typestr = {torch.float32: "<f4", torch.int64: "<i8"}[dtype]
    return torch.as_tensor(_Raw(ptr, shape, typestr), device=device)


class PeerRing:
    """This rank's region and its ring peers' regions mapped here, for one
    shard a rank of a sharded set with halo plan ``plan`` (``n_fp`` nodes a
    face, ``batch`` scenarios): the transport of
    ``make_sharded_blocked_step_rdma`` across ranks.

    ``group``: the process group of the ``plan.n_shards`` ranks (rank r
    holds shard r; gloo will do); ``device``: this rank's CUDA device;
    ``timeout_s``: the bound of every wait on a peer's flag, after which
    the waiting kernel traps.

    ``ring(sbuf)`` is ``peer_ring_exchange``: the step-boundary exchange of
    this rank's send buffer (1, B, L, 3); it returns this rank's
    step-boundary slots ``rbb`` (1, B, L, 3), the ``rb`` of the one-launch
    step that follows (``ops.sw2d_blocked.RdmaLaunch`` with this ring),
    which waits for the peers' chunks before it reads them. Only the first
    call launches (the initial send buffer); each step then stores its own
    send buffer into the peers' slots, so a later call takes only the
    buffer the last step returned and launches nothing. Each exchange is
    followed by one step; nothing else should read ``rbb``. ``rb2`` are the
    stage-2 receive slots, ``table`` the offset-indexed table of the ring's
    regions in device memory, ``flags`` this rank's flag words,
    ``carried`` the send buffer last delivered (None before the first
    call). Both constructors load the exchange kernel into the context, as
    ``RdmaLaunch`` does the step's: no first launch of a ring step waits on
    CUDA's lazy loading, which waits for the running kernels (any other
    kernel that a caller launches between the steps of ranks that share a
    process must be loaded before the ring runs, for example by one launch
    of it, or by ``CUDA_MODULE_LOADING=EAGER``).

    ``close()`` (or leaving a ``with`` block): a group barrier, the peers'
    regions closed, a second barrier, this rank's region freed. Every rank
    must call it; a view of the region is invalid after it."""

    def __init__(self, plan: HaloPlan, n_fp: int, batch: int, group,
                 device="cuda", timeout_s: float = 10.0):
        lay = region_layout(batch, _n_slots(plan, n_fp), len(plan.offs))
        peers = lambda rank, S: {(rank + s * d) % S for d in plan.offs
                                 for s in (1, -1)}
        _map_regions(self, plan, group, device, lay["bytes"], peers,
                     lambda rank, bases, dev: self._setup(
                         plan, n_fp, batch, rank, bases, dev, timeout_s))

    @classmethod
    def over_regions(cls, plan: HaloPlan, n_fp: int, batch: int, rank: int,
                     bases: dict, device,
                     timeout_s: float = 10.0) -> "PeerRing":
        """Rank ``rank``'s ring over regions of this process (``bases``:
        address of each rank's region, laid out as ``region_layout`` says,
        zeroed; on a CPU device, host memory for a build of the kernels for
        the host): the S ranks of a ring in one process, each launch on its
        own stream. Their step launches must then be resident on the card
        together (a wait that outlasts its bound traps), and every kernel
        that the caller launches between their steps must be loaded before
        they run (the ring's own are: see the class). The caller owns the
        regions and their lifetime; ``close`` does nothing here."""
        ring = cls.__new__(cls)
        ring._setup(plan, n_fp, batch, rank, bases, torch.device(device),
                    timeout_s)
        ring.group, ring._lib, ring._own, ring._opened = None, None, None, {}
        return ring

    def _setup(self, plan, n_fp, batch, rank, bases, device, timeout_s):
        S, offs = plan.n_shards, plan.offs
        self.plan, self.n_fp, self.batch, self.rank = plan, n_fp, batch, rank
        self.device = device
        self.chunk = plan.max_send * n_fp
        self.n_slots = _n_slots(plan, n_fp)
        lay = region_layout(batch, self.n_slots, len(offs))
        own = bases[rank]
        words = [own, lay["rbb"], lay["flags"], int(timeout_s * 1e9),
                 len(offs), self.chunk, 0, 0]
        words += [bases[(rank + d) % S] for d in offs]
        words += [bases[(rank - d) % S] for d in offs]
        self.table = torch.tensor(words, dtype=torch.int64, device=device)
        shape = (1, batch, self.n_slots, 3)
        self.rb2 = _view(own, shape, torch.float32, device)
        self.rbb = _view(own + lay["rbb"], shape, torch.float32, device)
        self.flags = _view(own + lay["flags"], (lay["n_flags"],),
                           torch.int64, device)
        # GOB: the receiving ranks' step-boundary slots are free for the
        # first exchange (epoch 1); every later release is a peer's
        self.flags[3::4] = 1
        self.carried = None
        lib = _lib()
        _check(lib, lib.peer_load(), "peer_load")
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def __call__(self, sbuf: torch.Tensor) -> torch.Tensor:
        return peer_ring_exchange(self, sbuf)

    def _exchange(self, sbuf: torch.Tensor):
        """The exchange kernel's launch (the shape checked by the caller)."""
        from ..ops.sw2d_fused import _launch_stream

        lib = self._lib or _lib()
        err = lib.peer_ring_exchange(
            self.table.data_ptr(), sbuf.data_ptr(), len(self.plan.offs),
            self.batch, self.n_slots, _launch_stream(sbuf))
        _check(lib, err, "peer_ring_exchange")

    def _deliver(self, sbuf: torch.Tensor):
        """The initial send buffer into the peers' step-boundary slots."""
        if self.plan.offs:
            self._exchange(sbuf)
        self.carried = sbuf

    def close(self):
        """Every rank: wait for this rank's launches, meet the others,
        unmap the peers' regions, meet again, free this rank's region."""
        _unmap_regions(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _n_slots(plan: HaloPlan, n_fp: int) -> int:
    """Slots L of a send or receive buffer (``build_sharded_blocked``'s)."""
    return max(len(plan.offs) * plan.max_send * n_fp, 1)


def peer_ring_exchange(ring: PeerRing, sbuf: torch.Tensor) -> torch.Tensor:
    """The step-boundary exchange across ranks: chunk i of this rank's send
    buffer ``sbuf`` (1, B, L, 3), every scenario, into the step-boundary
    slots of the rank that ring offset i sends to, and its ARRIVED flag
    there. Returns this rank's own step-boundary slots ``ring.rbb``, which
    the peers fill: only the one-launch step that follows reads them, after
    its wait for the peers' ARRIVED flags.

    At the ring's first call (its initial send buffer) this launches the
    exchange kernel (``ops/csrc/peer.cu``, one block an offset), which
    waits until each receiving rank has released its slots. After that a
    step launch stores its own send slots into the peers' step-boundary
    slots (its stage 2), so ``ring(sbuf)`` launches nothing: ``sbuf`` must
    be the buffer that the ring's last step returned (or, before the first
    step, the one delivered), and any other raises. The values are those of
    an exchange of ``sbuf`` as long as it is not changed in place between
    its step and the next.

    Replaces the XLA ``ppermute`` of the carried send buffer before the TPU
    one-launch step (``blitzdg_tpu/parallel/blocked_shard.py``,
    ``make_sharded_blocked_step_rdma``); its plain version is the process
    group's ``parallel.RingExchange`` on CPU tensors. A ring lives on the
    card, so a send buffer elsewhere raises."""
    shape = (1, ring.batch, ring.n_slots, 3)
    if tuple(sbuf.shape) != shape:
        raise ValueError(f"sbuf: shape {tuple(sbuf.shape)}, expected {shape}")
    last = ring.carried
    if last is not None:
        if (sbuf.device != last.device or sbuf.data_ptr() != last.data_ptr()
                or sbuf.stride() != last.stride()):
            raise ValueError(
                "the ring's steps deliver their own send buffers: ring(sbuf) "
                "takes the buffer its last step returned (the carry), not "
                "another one")
        return ring.rbb
    if sbuf.device.type != "cuda":
        raise ValueError("the ring exchange runs on the card; on CPU tensors "
                         "the process group's RingExchange is the transport")
    if sbuf.device != ring.device or sbuf.dtype != torch.float32:
        raise ValueError(f"sbuf: {sbuf.dtype} on {sbuf.device}; the ring "
                         f"exchanges float32 on {ring.device}")
    if not sbuf.is_contiguous():
        raise ValueError("sbuf: the kernel needs a contiguous tensor")
    ring._deliver(sbuf)
    if ring.plan.offs:
        peer_ring_exchange.launches += 1
    return ring.rbb


peer_ring_exchange.launches = 0


# ---------------------------------------------------------------------------
# The halo ring and the stage ring: exchanges of any buffer and reductions
# over ranks, one shard a rank
# ---------------------------------------------------------------------------

# bytes of one rank's reduction slot: a longer vector is reduced in pieces
SUM_BYTES = 1024
# threads of a block of the rings' exchange and reduction kernels
THREADS = 256
# what each use moves
_EXCHANGE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
_REDUCE_DTYPES = {torch.float32: 0, torch.float64: 1}
_SUM, _MAX = 0, 1


def ring_region_layout(slot_bytes: int, n_off: int, n_ranks: int) -> dict:
    """Byte offsets in one rank's halo- or stage-ring region
    (``ops/csrc/peer_flags.cuh``): the forward receive slots at 0, two sets
    of ``cap`` bytes (``slot_bytes`` rounded up) by the epoch's parity, the
    reverse ones at ``rev``, the reduction slots (one of ``SUM_BYTES`` a
    rank) at ``sum``, the ``n_flags`` flag words at ``flags``, the two
    words that count a folded launch's blocks at ``count``; ``bytes`` in
    all."""
    slots = _round(slot_bytes)
    sums = _round(n_ranks * SUM_BYTES)
    n_flags = 4 * n_off + 2 * n_ranks
    flags = 4 * slots + sums
    count = flags + _round(8 * n_flags)
    return {"cap": slots, "rev": 2 * slots, "sum": 4 * slots,
            "flags": flags, "count": count, "n_flags": n_flags,
            "bytes": count + _round(16)}


def _stage_bytes(plan: HaloPlan, n_fp: int, batch: int) -> int:
    """Bytes of the blocked path's send buffer (B, L, 3) floats."""
    return batch * _n_slots(plan, n_fp) * 3 * 4


def stage_region_layout(batch: int, n_slots: int, n_off: int,
                        n_ranks: int) -> dict:
    """``ring_region_layout`` of a stage ring: slots of the blocked path's
    (B, L, 3) floats."""
    return ring_region_layout(batch * n_slots * 3 * 4, n_off, n_ranks)


def _chunk_words(per: int, itemsize: int) -> int:
    """4-byte words of a chunk of ``per`` values of ``itemsize`` bytes."""
    return -(-per * itemsize // 4)


def halo_slot_bytes(plan: HaloPlan, width: int, n_fields: int,
                    dtype: torch.dtype) -> int:
    """Bytes of the largest face-row send buffer of ``plan`` that a halo
    ring is to carry: ``n_fields`` fields of rows ``width`` wide (Nfp for
    nodal traces, NG for Gauss traces) in ``dtype``, every ring offset's
    ``max_send`` rows, each offset's chunk padded to whole words."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per = n_fields * plan.max_send * width
    return max(len(plan.offs), 1) * _chunk_words(per, itemsize) * 4


class HaloRing:
    """This rank's ring region and every rank's region mapped here, for one
    shard a rank of an element-sharded set with halo plan ``plan``: the
    transport of the element-sharded plain-tensor path across ranks on the
    card (``parallel.halo_sw2d_rhs`` and the other halo functions, and
    ``solvers.cg`` / ``gmres``, with ``ring=``).

    ``slot_bytes``: the capacity of each of the two exchange slot sets, at
    least the largest buffer an exchange moves (``halo_slot_bytes``);
    ``group``: the process group of the ``plan.n_shards`` ranks (rank r
    holds shard r; gloo will do); ``device``: this rank's CUDA device;
    ``timeout_s``: the bound of every wait on a peer's flag, after which the
    waiting kernel traps.

    ``peer_halo_exchange(ring, buf)``: the receive buffer of this rank's
    face-row send buffer ``buf`` (n_off, ...), every ring offset in one
    launch, a new tensor; ``peer_halo_exchange_reverse(ring, g)``: its
    transpose; ``peer_rank_sum(ring, x)`` and ``peer_rank_max(ring, x)``:
    the sum and the maximum of a float32 or float64 tensor over the ranks,
    combined in rank order, the same bits on every rank (``SUM_BYTES`` a
    launch). Every rank must make the same calls of each in the same order
    (the epochs are counted here, a use each: ``forward``, ``reverse``, and
    ``sum`` for the sums and the maxima, which share their slots). Both
    constructors load the ring's kernels into the context; any other kernel
    that a caller launches between the calls of ranks that share a process
    must be loaded before the ring runs (see ``PeerRing``). ``table`` is the
    ring's table in device memory, ``flags`` this rank's flag words.

    ``close()`` (or leaving a ``with`` block): as ``PeerRing.close``; every
    rank must call it."""

    def __init__(self, plan: HaloPlan, slot_bytes: int, group,
                 device="cuda", timeout_s: float = 10.0):
        lay = ring_region_layout(slot_bytes, len(plan.offs), plan.n_shards)
        _map_regions(self, plan, group, device, lay["bytes"],
                     lambda rank, S: range(S),
                     lambda rank, bases, dev: self._setup(
                         plan, slot_bytes, rank, bases, dev, timeout_s))

    @classmethod
    def over_regions(cls, plan: HaloPlan, slot_bytes: int, rank: int,
                     bases: dict, device, timeout_s: float = 10.0,
                     meet: threading.Barrier | None = None) -> "HaloRing":
        """Rank ``rank``'s ring over regions of this process (``bases``:
        the address of every rank's region, laid out as
        ``ring_region_layout`` says, zeroed; on a CPU device, host memory
        for a build of the kernels for the host): the S ranks of a ring in
        one process, each on its own stream. The caller owns the regions;
        ``close`` does nothing here.

        Ranks on host threads of their own share the process's interpreter
        and autograd's one device thread, and a ring kernel that spins at
        its flags for a peer whose host is held before its launch (by a
        first launch that loads a module, or a ``cudaFree``: calls that wait
        for the running kernels) traps at the ring's bound (ROADMAP C34).
        So give every rank's ring the same ``meet``, a
        ``threading.Barrier`` of the S threads: each launch of a kernel
        that waits on a peer's flag (the exchanges, the reductions, the
        folded stage launches of ``ops.sw2d_blocked``), made on the rank's
        own thread, waits there first, so that no ring kernel is on the
        card before every rank's host has issued its work up to its own
        launch of that kernel. A rank's own thread is the one that last
        launched one of its ring's kernels outside autograd's backward (or
        that called ``bind()``); launches in a backward on another thread
        do not meet: autograd's device thread runs every rank's backward.
        A launch that leaves the rings of one region set on several threads
        without a ``meet`` common to them all raises, naming ``meet=``; one
        thread that launches every rank's kernels onto S streams needs no
        meeting (and must not be given one: its lone wait at the meeting
        raises after six times the ring's bound, as does a rank's wait for
        a peer thread that stopped). Before the ranks run together,
        ``warm_ranks`` runs each rank's program alone, so that no launch of
        it loads a module."""
        ring = cls.__new__(cls)
        ring._setup(plan, slot_bytes, rank, bases, torch.device(device),
                    timeout_s)
        ring.group, ring._lib, ring._own, ring._opened = None, None, None, {}
        ring._meet = meet
        ring._set = _RegionSet.of(bases, rank)
        return ring

    def bind(self):
        """Names the calling thread this rank's own: its launches of the
        ring's kernels meet the other ranks' (``meet``). Raises where the
        rings of this region set are then bound to several threads without
        a meeting of them all. A launch outside autograd's backward binds
        its thread likewise."""
        thread = threading.get_ident()
        if self._set is not None:
            self._set.bind(self.rank, thread, self._meet)
        self._thread = thread

    def _guard(self):
        """Before a launch of a kernel that waits on a peer's flag, over
        regions of this process: a launch outside autograd's backward from
        another thread than this rank's binds that thread (``bind``: it may
        raise); on this rank's own thread, the meeting of the ranks'
        threads, bounded by six times the ring's bound."""
        if self._set is None:
            return
        thread = threading.get_ident()
        if thread != self._thread:
            if torch._C._current_graph_task_id() != -1:
                return  # (a backward on autograd's thread: no meeting)
            self.bind()
        if self._meet is None:
            return
        try:
            self._meet.wait(6 * self._timeout_s)
        except threading.BrokenBarrierError:
            raise RuntimeError(
                f"rank {self.rank}: the ranks' threads did not all reach "
                f"this ring launch within {6 * self._timeout_s:g} s at "
                "their meeting (meet=): a rank's thread stopped, or one "
                "thread launches every rank's kernels, which needs no "
                "meet= (ROADMAP C34)") from None

    def _pace(self):
        """A rollout's start on a ring of ranks that share this process: the
        host waits for this rank's stream (``paces`` counts it), so that it
        runs at most one rollout and its backward ahead of its stream. The
        ranks share autograd's one device thread, which launches every
        rank's backward; a rank whose host ran a launch queue ahead blocks
        that thread in a launch while the ring kernel at the head of its
        stream waits for a peer's backward launch, which only that thread
        can make: a deadlock, which traps at the ring's bound (C34). Ranks
        in processes of their own (a process group) need none."""
        if self._set is None:
            return
        self.paces += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _setup(self, plan, slot_bytes, rank, bases, device, timeout_s):
        S, offs = plan.n_shards, plan.offs
        self.plan, self.rank, self.device = plan, rank, device
        lay = ring_region_layout(slot_bytes, len(offs), S)
        self.slot_bytes = lay["cap"]
        self._base, self._rev = bases[rank], lay["rev"]
        words = [bases[rank], int(timeout_s * 1e9), len(offs),
                 self.slot_bytes // 4, S, rank, SUM_BYTES, lay["flags"],
                 lay["rev"], lay["sum"], lay["count"]]
        words += [0] * (16 - len(words))
        words += [bases[(rank + d) % S] for d in offs]
        words += [bases[(rank - d) % S] for d in offs]
        words += [bases[p] for p in range(S)]
        self.table = torch.tensor(words, dtype=torch.int64, device=device)
        self.flags = _view(bases[rank] + lay["flags"], (lay["n_flags"],),
                           torch.int64, device)
        # the GO flags: every slot is free for the first epoch of its use
        n_off = len(offs)
        self.flags[0:4 * n_off:4] = 1
        self.flags[2:4 * n_off:4] = 1
        self.flags[4 * n_off + 1::2] = 1
        self.epochs = {"forward": 0, "reverse": 0, "sum": 0}
        self.threads = THREADS
        self._meet, self._set, self._thread = None, None, None
        self._timeout_s = timeout_s
        self.paces = 0
        lib = _lib()
        _check(lib, lib.peer_load(), "peer_load")
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _launch_exchange(self, src: torch.Tensor, out: torch.Tensor,
                         rows: int, row: int, cw: int, slot_cw: int,
                         rev: bool):
        """The exchange kernel's launch, forward or reverse: chunk i (``cw``
        words) of each of ``rows`` rows of ``row`` words of ``src`` to the
        rank at ring offset +-i, what arrived here into ``out``; in the
        slots chunk i lies at i x ``slot_cw`` words (the shapes checked by
        the caller). A call must not need more than the slots hold."""
        from ..ops.sw2d_fused import _launch_stream

        n_off = len(self.plan.offs)
        if cw > slot_cw or rows * n_off * slot_cw * 4 > self.slot_bytes:
            raise ValueError(
                f"chunks of {cw * 4} bytes a ring offset for a ring whose "
                f"slots hold {self.slot_bytes} over {n_off} ring offsets: "
                "make the ring for the largest buffer it carries "
                "(halo_slot_bytes)")
        use = "reverse" if rev else "forward"
        self._guard()
        self.epochs[use] += 1
        lib = self._lib or _lib()
        err = lib.peer_stage_exchange(
            self.table.data_ptr(), int(rev), src.data_ptr(), out.data_ptr(),
            n_off, rows, row, cw, slot_cw, self.epochs[use], self.threads,
            _launch_stream(src))
        _check(lib, err, "peer_stage_exchange")

    def _reduce(self, x: torch.Tensor, op: int) -> torch.Tensor:
        """The reduction kernel's launches (sum, or max) over a flat float32
        or float64 vector, ``SUM_BYTES`` a launch: a new vector."""
        from ..ops.sw2d_fused import _launch_stream

        out = torch.empty_like(x)
        lib = self._lib or _lib()
        step = SUM_BYTES // x.element_size()
        for j in range(0, x.numel(), step):
            n = min(step, x.numel() - j)
            self._guard()
            self.epochs["sum"] += 1
            err = lib.peer_rank_reduce(
                self.table.data_ptr(), op, _REDUCE_DTYPES[x.dtype],
                x[j:].data_ptr(), out[j:].data_ptr(), n, self.epochs["sum"],
                self.threads, _launch_stream(x))
            _check(lib, err, "peer_rank_max" if op == _MAX
                   else "peer_rank_sum")
        return out

    def close(self):
        """Every rank: wait for this rank's launches, meet the others,
        unmap the peers' regions, meet again, free this rank's region."""
        _unmap_regions(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StageRing(HaloRing):
    """A ring (``HaloRing``) whose slots hold the blocked path's buffers,
    for one shard a rank of a sharded set with halo plan ``plan`` (``n_fp``
    nodes a face, ``batch`` scenarios): the transport of
    ``make_sharded_blocked_step_fused`` / ``_diff`` and of the sharded MPC
    across ranks on the card (``parallel.RingExchange`` with ``ring=``).

    ``peer_stage_exchange(ring, sbuf)``: the receive buffer (1, B, L, 3) of
    this rank's send buffer ``sbuf`` (1, B, L, 3), a new tensor;
    ``peer_stage_exchange_reverse(ring, g)``: its transpose (each chunk
    back to the rank it came from); ``peer_rank_sum(ring, x)``: as the
    halo ring's. The rest as ``HaloRing``."""

    def __init__(self, plan: HaloPlan, n_fp: int, batch: int, group,
                 device="cuda", timeout_s: float = 10.0):
        super().__init__(plan, _stage_bytes(plan, n_fp, batch), group,
                         device, timeout_s)
        self._shape(plan, n_fp, batch)

    @classmethod
    def over_regions(cls, plan: HaloPlan, n_fp: int, batch: int, rank: int,
                     bases: dict, device, timeout_s: float = 10.0,
                     meet: threading.Barrier | None = None) -> "StageRing":
        """Rank ``rank``'s ring over regions of this process, laid out as
        ``stage_region_layout`` says (see ``HaloRing.over_regions``, and
        ``meet=`` there)."""
        ring = super().over_regions(plan, _stage_bytes(plan, n_fp, batch),
                                    rank, bases, device, timeout_s, meet)
        ring._shape(plan, n_fp, batch)
        return ring

    def _shape(self, plan, n_fp, batch):
        self.n_fp, self.batch = n_fp, batch
        self.chunk = plan.max_send * n_fp
        self.n_slots = _n_slots(plan, n_fp)
        # by use, the last epoch up to which this rank has released the
        # senders' GO flags (read, or skipped: _fold)
        self._freed = {"forward": 0, "reverse": 0}

    def _slots(self, rev: bool, e: int) -> int:
        """The address of this rank's slot set of epoch ``e`` of a use
        (``peer_flags.cuh``, ``sr_slots``)."""
        return self._base + (self._rev if rev else 0) + (e & 1) * \
            self.slot_bytes

    def _fold(self, use: str, read: bool, send: bool) -> tuple:
        """The epochs of a folded launch over ``use`` ("forward": the
        stage's peer mode, "reverse": its adjoint's): the one it reads from
        its slots (0: none, its buffer given), the one it sends (0: none),
        and the one up to which it first releases the senders' GO flags (0:
        none): the epochs that this rank has neither read nor released and
        that no launch will read. A folded launch reads only the latest
        epoch of its use (what the launch before it sent; the backward
        refuses another order, ``parallel.blocked_shard``), so every earlier
        epoch is such, and the latest too once a launch that does not read
        it sends. A backward that autograd restricts to a part of a rollout
        (``torch.autograd.grad(..., inputs=)``) leaves them: its last launch
        sends an epoch that no launch reads, and a sender's wait for the
        read of the epoch two before its own would never end (ROADMAP
        C35). Every rank makes the same calls, so every rank releases the
        same."""
        e = self.epochs[use]
        if read and e == 0:
            raise ValueError(
                "no exchange has reached the ring's slots yet: a rollout's "
                "first stage takes its receive buffer" if use == "forward"
                else "no reverse exchange has reached the ring's slots yet: "
                "the last stage's adjoint takes its send buffer's cotangent")
        dead = e if send and not read else e - 1
        skip = dead if dead > self._freed[use] else 0
        self._freed[use] = max(self._freed[use], dead, e if read else 0)
        if send:
            self.epochs[use] += 1
        return e if read else 0, self.epochs[use] if send else 0, skip

    def _exchange(self, src: torch.Tensor, rev: bool) -> torch.Tensor:
        """The exchange kernel's launch over a (1, B, L, 3) buffer, forward
        or reverse: a new receive buffer."""
        out = torch.empty_like(src)
        self._launch_exchange(src, out, self.batch, 3 * self.n_slots,
                              3 * self.chunk, 3 * self.chunk, rev)
        # (it reads the epoch it sent and frees every slot set before)
        use = "reverse" if rev else "forward"
        self._freed[use] = self.epochs[use]
        return out


class _RegionSet:
    """The rings of one set of regions of this process (``over_regions``):
    the thread and the meeting each rank's ring is bound to."""

    _sets: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
    _lock = threading.Lock()

    def __init__(self):
        self.ranks = set()  # the ranks that have a ring in the set
        self.bound = {}  # rank -> (thread, meet)

    @classmethod
    def of(cls, bases: dict, rank: int) -> "_RegionSet":
        """The set over the regions ``bases``; a new one where rank ``rank``
        already has a ring in it (a later set over the same addresses)."""
        key = tuple(sorted(bases.items()))
        with cls._lock:
            rs = cls._sets.get(key)
            if rs is None or rank in rs.ranks:
                rs = cls._sets[key] = cls()
            rs.ranks.add(rank)
            return rs

    def bind(self, rank: int, thread: int, meet):
        with self._lock:
            bound = {**self.bound, rank: (thread, meet)}
            threads = {t for t, _ in bound.values()}
            meets = {id(m) for _, m in bound.values()}
            if len(threads) > 1 and (meet is None or len(meets) > 1):
                raise ValueError(
                    "the ranks of a ring in one process run on several host "
                    "threads: give every rank's ring the same meet= (a "
                    "threading.Barrier of the threads), or launch every "
                    "rank's kernels from one thread (ROADMAP C34)")
            self.bound = bound


def warm_ranks(rings, streams, warm) -> None:
    """The warm-up of the S ranks of a ring that share this process:
    ``warm(r, ring)`` for each rank r in turn, alone on its stream
    ``streams[r]``, over ``rings``, a region set of its own (not the one
    the ranks then run on) whose flags are set past any epoch just before
    each rank's turn, so that no wait holds a launch (the values are not
    used). Every kernel that the rank's program launches is then loaded and
    each stream's caching allocator holds its blocks before the ranks run
    together: a kernel's first launch loads its module (CUDA's lazy
    loading), which waits for the running kernels, a peer's spinning ring
    kernel among them (C34)."""
    for r, ring in enumerate(rings):
        cuda = ring.device.type == "cuda"
        ring.flags[:] = 1 << 60
        if cuda:
            torch.cuda.synchronize(ring.device)
            with torch.cuda.stream(streams[r]):
                warm(r, ring)
            torch.cuda.synchronize(ring.device)
        else:
            warm(r, ring)


def _check_ring_tensor(ring: HaloRing, name: str, t: torch.Tensor,
                       dtypes=(torch.float32,)):
    if t.device != ring.device or t.dtype not in dtypes:
        names = ", ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name}: {t.dtype} on {t.device}; the ring moves "
                         f"{names} on {ring.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def _stage_exchange(ring: StageRing, buf: torch.Tensor, rev: bool):
    shape = (1, ring.batch, ring.n_slots, 3)
    if tuple(buf.shape) != shape:
        raise ValueError(f"buffer: shape {tuple(buf.shape)}, expected {shape}")
    _check_ring_tensor(ring, "buffer", buf)
    if not ring.plan.offs:
        return torch.zeros_like(buf), False
    return ring._exchange(buf, rev), True


def peer_stage_exchange(ring: StageRing, sbuf: torch.Tensor) -> torch.Tensor:
    """The exchange between the RK stages across ranks: chunk i of this
    rank's send buffer ``sbuf`` (1, B, L, 3), every scenario, into the
    forward slots of the rank that ring offset i sends to; returns this
    rank's receive buffer (1, B, L, 3), what its peers sent, copied out of
    its slots into a new tensor (zeros without ring offsets). One launch
    (``ops/csrc/peer.cu``, a send block and a receive block an offset, one
    system fence on each block's path), which waits until each
    receiving rank has read the epoch before the last (two slot sets by
    the epoch's parity) and until each chunk here has arrived. On the card
    the sharded steps launch it for a rollout's first send buffer only:
    every later exchange is folded into the stage's launch
    (``ops.sw2d_blocked.sw2d_stage_blocked_peer``).

    Replaces the XLA ``ppermute`` between the stages of the JAX package's
    differentiable sharded step (``blitzdg_tpu/parallel/blocked_shard.py``,
    ``make_sharded_blocked_step_diff``); its plain version is the stacked
    gather (``parallel.halo._stacked`` over every rank's buffer), or the
    process group's ``RingExchange`` on CPU tensors."""
    out, launched = _stage_exchange(ring, sbuf, False)
    if launched:
        count_launches(peer_stage_exchange)
    return out


peer_stage_exchange.launches = 0


def peer_stage_exchange_reverse(ring: StageRing,
                                g: torch.Tensor) -> torch.Tensor:
    """The transpose of ``peer_stage_exchange``: the cotangent ``g`` (1, B,
    L, 3) of a receive buffer back to the ranks its chunks came from (chunk
    i to the rank at ring offset -i), over the ring's reverse slots; returns
    this rank's send-buffer cotangent (1, B, L, 3), a new tensor. One
    launch of the same kernel. Replaces the transpose of the XLA
    ``ppermute`` in the JAX package's backward sweep; the sharded steps on
    the card launch it only for a rollout's first send buffer where that
    needs its cotangent (the adjoint's launches carry every other reverse:
    ``ops.sw2d_blocked.sw2d_stage_bwd_blocked_peer``)."""
    out, launched = _stage_exchange(ring, g, True)
    if launched:
        count_launches(peer_stage_exchange_reverse)
    return out


peer_stage_exchange_reverse.launches = 0


def _halo_exchange(ring: HaloRing, buf: torch.Tensor, rev: bool,
                   counter) -> torch.Tensor:
    n_off = len(ring.plan.offs)
    if buf.dim() < 1 or buf.shape[0] != n_off or n_off == 0:
        raise ValueError(f"buffer: shape {tuple(buf.shape)}; the ring's plan "
                         f"has {n_off} ring offsets, one chunk each")
    _check_ring_tensor(ring, "buffer", buf, _EXCHANGE_DTYPES)
    flat = buf.reshape(n_off, -1)
    per, item = flat.shape[1], buf.element_size()
    cw = _chunk_words(per, item)
    if cw * 4 != per * item:  # (bfloat16: padded to whole words)
        flat = torch.nn.functional.pad(flat, (0, cw * 4 // item - per))
    out = torch.empty_like(flat)
    ring._launch_exchange(flat, out, 1, n_off * cw, cw,
                          ring.slot_bytes // 4 // n_off, rev)
    count_launches(counter)
    return out[:, :per].reshape(buf.shape)


def peer_halo_exchange(ring: HaloRing, buf: torch.Tensor) -> torch.Tensor:
    """The face-row exchange across ranks: chunk i of this rank's send
    buffer ``buf`` (n_off, ...), float32, float64 or bfloat16, laid out
    offset-major (chunk i the face rows for ring offset ``plan.offs[i]``),
    into the forward slots of the rank at ring offset +i; returns this
    rank's receive buffer of the same shape and type (chunk i what the rank
    at offset -i sent), a new tensor. One launch for every offset
    (``ops/csrc/peer.cu``, the stage exchange's kernel, a send block and a
    receive block an offset, each chunk padded to whole 4-byte words); a
    buffer larger than the ring's slots raises.

    Replaces the ``lax.ppermute`` a ring offset of the JAX package's
    ``halo_face_rows`` (``blitzdg_tpu/parallel/halo.py``); its plain
    version is the stacked roll of each offset's rows over the shard axis
    (``parallel.halo._ppermute`` with no group), or the process group's
    point-to-point rounds on CPU tensors."""
    return _halo_exchange(ring, buf, False, peer_halo_exchange)


peer_halo_exchange.launches = 0


def peer_halo_exchange_reverse(ring: HaloRing,
                               g: torch.Tensor) -> torch.Tensor:
    """The transpose of ``peer_halo_exchange``: the cotangent ``g`` of a
    receive buffer, chunk i back to the rank at ring offset -i that sent it,
    over the ring's reverse slots; returns this rank's send-buffer
    cotangent, a new tensor. One launch of the same kernel. Replaces the
    transpose of ``halo_face_rows``'s ``ppermute`` in the JAX package's
    backward; its plain version is the stacked roll by -d."""
    return _halo_exchange(ring, g, True, peer_halo_exchange_reverse)


peer_halo_exchange_reverse.launches = 0


def _rank_reduce(ring: HaloRing, x: torch.Tensor, op: int,
                 counter) -> torch.Tensor:
    _check_ring_tensor(ring, "x", x, tuple(_REDUCE_DTYPES))
    if x.numel() == 0:
        return x.clone()
    out = ring._reduce(x.reshape(-1), op).view(x.shape)
    count_launches(counter, -(-x.numel() * x.element_size() // SUM_BYTES))
    return out


def peer_rank_sum(ring: HaloRing, x: torch.Tensor) -> torch.Tensor:
    """The sum over the ring's ranks of each rank's float32 or float64
    tensor ``x`` (any shape, the same on every rank): each rank's ``x`` into
    its slot at every rank, then at each rank the parts added in rank order
    0, 1, ..., S-1, so that every rank holds the same bits. One launch a
    ``SUM_BYTES``. Replaces the XLA ``psum`` of the JAX package's sharded
    MPC (``examples/mpc_sharded.py``), the sum over chips of the shared
    controls' cotangent, and the ``psum`` of the Krylov loops' dots
    (``blitzdg_tpu/solvers/krylov.py``, ``_reducers``); its plain version
    is ``rank_order_sum``."""
    return _rank_reduce(ring, x, _SUM, peer_rank_sum)


peer_rank_sum.launches = 0


def peer_rank_max(ring: HaloRing, x: torch.Tensor) -> torch.Tensor:
    """The maximum over the ring's ranks of each rank's float32 or float64
    tensor ``x``, entry by entry, the parts combined in rank order, the
    same bits on every rank; a NaN on any rank is the result on every rank
    (the first in rank order), as XLA's ``pmax``. One launch a
    ``SUM_BYTES``, over the slots and epochs of the sums. Replaces the
    ``lax.pmax`` of the JAX package's ``halo_sw2d_timestep``
    (``blitzdg_tpu/parallel/halo.py``); its plain version is
    ``rank_order_max``."""
    return _rank_reduce(ring, x, _MAX, peer_rank_max)


peer_rank_max.launches = 0


def rank_order_sum(parts) -> torch.Tensor:
    """The plain version of the sum over ranks: ``parts[0] + parts[1] +
    ...`` in that order (a torch reduction may add in another)."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    return acc


def rank_order_max(parts) -> torch.Tensor:
    """The plain version of the maximum over ranks: the parts combined in
    rank order, a NaN kept where one comes (the first), else the larger
    (the earlier of two equal ones); equal in value to ``torch.amax`` over
    the stacked parts."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = torch.where(torch.isnan(acc) | ~(torch.isnan(p) | (p > acc)),
                          acc, p)
    return acc
