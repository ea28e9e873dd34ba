"""The element-sharded workloads: the sharded rollout and the sharded MPC.

The configurations the JAX package runs through its sharded path, rebuilt
for the port with nothing cut:

 - sharded rollout (``bench.py``, "sharded_blocked_step" rows, and
   ``examples/sharded_blocked_bench.py``): ``box_triangles(32, 32)``
   (K=2048, all walls), N=3, modal filter (cutoff 0.9 N, order 4), flat
   bottom, g=9.81, dt from the CFL number 0.7 at depth 11, h = 10 +
   exp(-10 (x^2+y^2)) at rest, 2048 steps at B=1 and B=8; S=1 shard (the
   bench row) or S=4 (``partition_mesh`` into 4 blocks of 512 elements,
   which gives a real halo); through the fused step (two stage launches
   a step) or the one-launch step (``make_sharded_blocked_step_rdma``), a
   step at a time from the host (``sharded_rollout``) or replayed from one
   CUDA graph (``capture_sharded_rollout``);
 - sharded MPC (``examples/mpc_sharded.py``): rest at depth 10, two
   Gaussian-bump momentum injectors, one control vector per step for 8
   steps, the target the terminal ``hu`` under the hidden controls
   (0.8, -0.4), the cost sum (hu_end - target)^2 + 1e-7 sum c^2, Adam 30
   iterations at learning rate 0.5, one scenario. Two sizes: the example's
   own (``EXAMPLE``: ``box_triangles(8, 8)``, N=1, filter 0.9 / order 1, 8
   shards, dt = 1e-3) and full width (``FULL``: the K=2048, N=3 box above
   with 4 shards and the CFL dt). Every shard stacked in one process, or,
   as the JAX example runs on its chips, one shard a rank (``rank=``): the
   same program on every rank, which builds its own shard, computes the
   target with the ranks' fused step, and runs Adam over its part of the
   cost, the parts summed over the ranks (the example's ``psum``) and the
   controls' cotangent with them, so that every rank holds the same
   controls. The ranks exchange through a process group (gloo, CPU
   tensors) or, on the card, a ``parallel.StageRing``: each stage one
   launch of the stage's peer mode with the exchange folded in, its
   backward one of the adjoint's with the reverse; ranks that share a
   process give their rings ``meet=`` (``StageRing.over_regions``), and
   the step paces each rollout.

Nothing here is random. Everything float32 unless ``dtype`` says otherwise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..context import DGContext2D
from ..mesh import box_triangles
from ..ops.sw2d import SWPhysics
from ..parallel.blocked_shard import (ShardedBlocked, build_sharded_blocked,
                                      initial_send_buffer,
                                      make_sharded_blocked_step_diff,
                                      make_sharded_blocked_step_fused,
                                      split_shards, sum_over_ranks_grad,
                                      total_over_ranks)
from ..parallel.partition import partition_mesh
from ..specgrid.triangle import build_triangle_context
from .coastal_box import cfl_dt
from .solver import MPCSolution, adam_minimize

CELLS = (32, 32)  # K = 2048 triangles
N_ORDER = 3
ROLLOUT_STEPS = 2048
ROLLOUT_BATCHES = (1, 8)
ROLLOUT_SHARDS = (1, 4)
H_REST = 10.0

MPC_STEPS = 8  # one control vector a step
MPC_ITERS = 30
MPC_LEARNING_RATE = 0.5
R_CONTROL = 1e-7
HIDDEN_CONTROL = (0.8, -0.4)
EXAMPLE = dict(cells=(8, 8), n_order=1, filter_order=1, n_shards=8, dt=1e-3)
FULL = dict(cells=CELLS, n_order=N_ORDER, filter_order=4, n_shards=4,
            dt=None)  # None: the CFL dt


def _context(cells, n_order: int, n_shards: int, filter_order: int, dtype,
             device):
    """The context on the mesh partitioned into ``n_shards`` blocks (the
    box's own order for one shard), and the CFL dt from a float64 host
    context, as the JAX benchmark takes it."""
    mesh = box_triangles(*cells)
    if n_shards > 1:
        mesh = partition_mesh(mesh, n_shards)[0]
    kw = dict(filter_cutoff=0.9 * n_order, filter_order=filter_order)
    ctx = build_triangle_context(n_order, mesh, dtype=dtype, device=device,
                                 **kw)
    host = build_triangle_context(n_order, mesh, dtype=torch.float64,
                                  device="cpu", **kw)
    return ctx, cfl_dt(host, 9.81, 11.0, cfl=0.7)


def injectors(ctx: DGContext2D) -> tuple[np.ndarray, np.ndarray]:
    """The two momentum injectors (a Gaussian bump at the origin on hu and
    on hv), (2, K, Np) each."""
    xs, ys = ctx.x.double().cpu().numpy(), ctx.y.double().cpu().numpy()
    bump = np.exp(-8.0 * (xs ** 2 + ys ** 2))
    return np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])


class ShardedRollout(NamedTuple):
    ctx: DGContext2D  # on the partitioned mesh
    sb: ShardedBlocked
    dt: float
    state: tuple  # (S, B, K_loc*Np) per field
    n_steps: int


def sharded_rollout_problem(n_shards: int, batch: int,
                            n_steps: int = ROLLOUT_STEPS,
                            n_order: int = N_ORDER, cells: tuple = CELLS,
                            dtype: torch.dtype = torch.float32,
                            device="cuda") -> ShardedRollout:
    """The sharded rollout rows: a Gaussian hump at rest on the flat box."""
    ctx, dt = _context(cells, n_order, n_shards, 4, dtype, device)
    sb = build_sharded_blocked(ctx, SWPhysics(g=9.81), n_shards, dtype=dtype,
                               device=device)
    h = (H_REST + torch.exp(-10.0 * (ctx.x ** 2 + ctx.y ** 2))).reshape(1, -1)
    h = split_shards(h.expand(batch, -1), n_shards)
    return ShardedRollout(ctx, sb, dt,
                          (h, torch.zeros_like(h), torch.zeros_like(h)),
                          n_steps)


def sharded_rollout(r: ShardedRollout, n_steps: int | None = None,
                    make_step: Callable = make_sharded_blocked_step_fused
                    ) -> tuple:
    """The state after ``n_steps`` (default ``r.n_steps``) sharded steps
    from ``r.state``: fused steps (two stage launches a step), or the steps
    that ``make_step`` builds (``make_sharded_blocked_step_rdma``: one launch
    a step, the same values)."""
    step = make_step(r.sb, r.dt)
    carry = (r.state, initial_send_buffer(r.sb, r.state))
    for i in range(r.n_steps if n_steps is None else n_steps):
        carry = step(carry, i * r.dt)
    return carry[0]


def capture_sharded_rollout(r: ShardedRollout, n_steps: int | None = None,
                            make_step: Callable =
                            make_sharded_blocked_step_fused) -> Callable:
    """``sharded_rollout`` recorded into one CUDA graph: every step's
    exchange gather and kernel launch(es) of ``n_steps`` (default
    ``r.n_steps``) steps of ``make_step``'s step, each step's time
    ``i * r.dt`` baked into its launch. Returns ``replay(state=None)``,
    which copies ``state`` (default ``r.state``) into the graph's static
    input, replays the graph and returns the end state: the graph's own
    tensors, overwritten by the next replay. The steps' outputs live in the
    graph's memory pool. The counterpart of the JAX package's jitted
    ``lax.scan`` over the steps: a step then costs what the card takes, not
    the host's calls.

    Needs the card: raises for a CPU problem, and a failure to capture or to
    replay raises too (nothing falls back to the per-step loop). Before the
    capture one step runs on a side stream, so that the kernels are built
    and their launch plans made outside the graph; the one-launch step's
    scratch is made there too, outside the graph's pool, and reused by
    every recorded launch. The graph reads the step's own tensors (the
    exchange's index tables, that scratch), so ``replay`` holds the step
    (``replay.step``) as long as the graph. The wrappers' launch counters
    count the launches the capture records; a replay adds nothing to
    them."""
    device = r.state[0].device
    if device.type != "cuda":
        raise RuntimeError(
            "capture_sharded_rollout records a CUDA graph, which needs the "
            f"card; this problem lies on {device} (use sharded_rollout)")
    n = r.n_steps if n_steps is None else n_steps
    step = make_step(r.sb, r.dt)
    static = tuple(f.clone() for f in r.state)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step((static, initial_send_buffer(r.sb, static)), 0.0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        carry = (static, initial_send_buffer(r.sb, static))
        for i in range(n):
            carry = step(carry, i * r.dt)
    end = carry[0]

    def replay(state=None):
        for dst, src in zip(static, r.state if state is None else state):
            dst.copy_(src)
        graph.replay()
        return end

    replay.step = step  # what the graph reads besides its pool and r
    return replay


class ShardedMPC(NamedTuple):
    ctx: DGContext2D  # on the partitioned mesh
    sb: ShardedBlocked
    dt: float
    n_steps: int
    step: Callable  # the differentiable sharded step
    state0: tuple  # (S_here, 1, K_loc*Np) rest start per field
    target: torch.Tensor  # (S_here, 1, K_loc*Np) terminal hu under the hidden controls
    hidden: torch.Tensor  # (n_steps, 2)
    # the stage ring that sharded_mpc_problem made over its group (one shard
    # a rank on the card): every rank closes it when done
    ring: object = None


def _run(sb: ShardedBlocked, step, state0, cs, dt: float):
    carry = (state0, initial_send_buffer(sb, state0))
    for i in range(cs.shape[0]):
        carry = step(carry, i * dt, cs[i])
    return carry[0]


def sharded_mpc_problem(size: dict = EXAMPLE, n_steps: int = MPC_STEPS,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        rank: int | None = None, group=None, ring=None
                        ) -> ShardedMPC:
    """The sharded MPC at ``EXAMPLE`` or ``FULL`` size: every shard stacked
    here (``rank`` None), or shard ``rank`` alone, one shard a rank of the
    ``size["n_shards"]`` ranks, exchanging through ``ring`` (this rank's
    ``parallel.StageRing``, on the card) or ``group`` (the process group:
    on CPU tensors its point-to-point transport; on the card a
    ``StageRing`` over it is made here, a collective, and returned as
    ``ring``, which every rank closes when done). Every rank must make the
    same calls on its problem in the same order. Over a ring of ranks that
    share this process (``StageRing.over_regions``) the differentiable
    step waits for the rank's stream at each rollout's start
    (``make_sharded_blocked_step_diff``), so that no rank's host runs more
    than a cost evaluation and its gradient ahead of its stream (ROADMAP
    C34)."""
    ctx, dt_cfl = _context(size["cells"], size["n_order"], size["n_shards"],
                           size["filter_order"], dtype, device)
    dt = dt_cfl if size["dt"] is None else size["dt"]
    S = size["n_shards"]
    bu, bv = injectors(ctx)
    shards = None if rank is None else (rank,)
    if rank is None and (group is not None or ring is not None):
        raise ValueError("a process group or ring needs the rank's shard "
                         "(rank=)")
    sb = build_sharded_blocked(ctx, SWPhysics(g=9.81), S, dtype=dtype,
                               forcing_bu=bu, forcing_bv=bv, device=device,
                               shards=shards)
    made = None
    if rank is not None and ring is None and sb.ops.fbuf.is_cuda:
        from ..parallel.peer import StageRing

        ring = made = StageRing(sb.plan, sb.meta.n_fp, 1, group, device=device)
    h0 = torch.full((len(sb.shards), 1, sb.meta.n_v), H_REST, dtype=dtype,
                    device=device)
    state0 = (h0, torch.zeros_like(h0), torch.zeros_like(h0))
    hidden = torch.tensor([HIDDEN_CONTROL] * n_steps, dtype=dtype,
                          device=device)
    fused = make_sharded_blocked_step_fused(sb, dt, group=group, ring=ring)
    with torch.no_grad():
        target = _run(sb, fused, state0, hidden, dt)[1].contiguous()
    step = make_sharded_blocked_step_diff(sb, dt, group=group, ring=ring)
    return ShardedMPC(ctx, sb, dt, n_steps, step, state0, target, hidden,
                      made)


def sharded_mpc_cost(mp: ShardedMPC, cs: torch.Tensor) -> torch.Tensor:
    """sum (hu_end - target)^2 + R_CONTROL sum cs^2 over the controls
    ``cs`` (n_steps, 2), differentiable in ``cs``. One shard a rank, each
    rank's part of the first term is summed over the ranks (rank order: the
    same bits on every rank), the control term is counted once, and the
    controls' cotangent through the rollout is summed over the ranks, once
    for the whole sequence."""
    ex = mp.step.exchange
    hu_end = _run(mp.sb, mp.step, mp.state0, sum_over_ranks_grad(cs, ex),
                  mp.dt)[1]
    misfit = total_over_ranks(((hu_end - mp.target) ** 2).sum(), ex)
    return misfit + R_CONTROL * (cs ** 2).sum()


def solve_sharded_mpc(mp: ShardedMPC, iters: int = MPC_ITERS,
                      learning_rate: float = MPC_LEARNING_RATE,
                      init_controls: torch.Tensor | None = None
                      ) -> MPCSolution:
    """Adam from zero controls (the JAX example's loop); one shard a rank,
    every rank runs it and holds the same controls."""
    if init_controls is None:
        init_controls = torch.zeros_like(mp.hidden)
    cs, cost, hist = adam_minimize(lambda c: sharded_mpc_cost(mp, c),
                                   init_controls, iters, learning_rate)
    return MPCSolution(controls=cs, cost=cost, cost_history=hist)
