#!/usr/bin/env python3
"""Time the blocked forward kernels on one NVIDIA GPU at the shapes their
paths run, for an A/B of two trees of this repository in one call.

    python3 tools/forward_times.py [label] [--quads]

run from the root of a tree (its own package is imported). Prints one JSON
line per shape, then one with the card's name and power limit. Shapes, on
the blocked box (``mpc/blocked_box.py``: K=2048, flat bottom, walls):

 - ``sw2d_step_blocked`` (B4) at N=3, B=8, two controls (the plant
   advance's step);
 - ``sw2d_rollout_blocked`` (B5) at N=3, B=8, 4 x 2 steps with the
   trajectory stored (the MPC's rollout), and at N=6, 2 x 2 steps;
 - ``sw2d_rollout_blocked`` over 2048 steps without controls or trajectory
   at N=3 and N=6, B=8 (``blocked_rollout_problem``): us a step;
 - on quadrilaterals, ``chip_smoke.py``'s ``quads_coastal_K144_N4`` case
   (``box_quads(12, 12)``, K=144, N=4, B=8, its east side open: bathymetry,
   drag, Coriolis, tidal depth from t0 = 1, sponge, two injectors):
   ``sw2d_step_blocked`` (B4) and ``sw2d_rollout_blocked`` (B5) over 2 x 2
   steps with the trajectory stored; and its sharded case
   (``quads_sharded_coastal_K144_N4_S4_B8``: the same mesh partitioned into
   4 shards of 36 elements, the same physics, one control vector):
   ``sw2d_stage_blocked`` (B7), stage 1 (dt/2, no sponge) and stage 2 (dt,
   the sponge, the stage-1 output and its exchanged send buffer), and
   ``sw2d_step_rdma_blocked`` (B9, stacked: both stages and the exchange
   in one launch) from the same inputs (``--quads``: these five alone).

Inputs are made from fixed seeds, as ``chip_smoke.py`` makes its timed
cases. Two times a shape: ``ms``, CUDA events around one call of the
wrapper, the 50 MB L2 cache flushed before each (256 MB written), median of
9 after one warm-up (5 for the 2048-step rollouts), as ``chip_smoke.py``
times; and ``device_ms``, the mean duration of the forward kernel over 10
calls under ``torch.profiler`` (L2 warm, the kernel alone; 2 calls of the
2048-step rollouts). Uses only entry points that the trees before and
after the forward kernels' redesign share.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))


def time_ms(fn, flush, reps: int) -> float:
    fn()
    out = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, calls: int, kernel: str = "sw2d_blocked_rollout") -> float:
    """The mean device time a call of the kernels whose name holds
    ``kernel`` (the blocked rollout's, B4's too, by default)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if kernel in e.key and "bwd" not in e.key]
    return sum(e.device_time_total for e in ev) / calls / 1e3


TIDE = (12.0, 0.5, 2.0, 10.0)


def _quad_coastal(dev, g, shards: int = 1):
    """``chip_smoke.py --only quads``'s coastal quad problem: ``box_quads(12,
    12)`` at N=4, its east side open (partitioned into ``shards`` where more
    than one), bathymetry, drag, Coriolis and the sponge; the context, the
    physics, the two injectors and a perturbed state of 8 scenarios,
    (8, nV) per field, drawn from ``g``."""
    from blitzdg_tpu_torch.context import BC_OUT
    from blitzdg_tpu_torch.mesh import box_quads
    from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
    from blitzdg_tpu_torch.mpc.sharded_box import injectors
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.parallel import partition_mesh
    from blitzdg_tpu_torch.specgrid.quad import build_quad_context
    from blitzdg_tpu_torch.utils import build_sponge_coefficient

    N, B = 4, 8
    mesh = box_quads(12, 12)
    retag_east_open(mesh)
    if shards > 1:
        mesh = partition_mesh(mesh, shards)[0]
    cc = build_quad_context(N, mesh, dtype=torch.float32, device=dev,
                            filter_cutoff=0.9 * N, filter_order=4)
    H = 10.0 + 2.0 * cc.x + torch.sin(2.0 * cc.y)
    open_nodes = (cc.bc_table[:, :, None].expand(-1, -1, cc.n_fp)
                  .reshape(cc.k_elem, -1) == BC_OUT).cpu().numpy()
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=2.0 * torch.ones_like(H),
                     Hy=2.0 * torch.cos(2.0 * cc.y),
                     sponge=build_sponge_coefficient(cc, open_nodes,
                                                     width=0.3, strength=0.5))
    Hf = H.reshape(1, -1)
    h = (Hf + 0.1 * torch.exp(-8.0 * (cc.x ** 2 + cc.y ** 2)).reshape(1, -1)
         + 0.01 * g(B, Hf.shape[1])).contiguous()
    hu = (0.05 * h + 0.01 * g(*h.shape)).contiguous()
    hv = (-0.05 * h + 0.01 * g(*h.shape)).contiguous()
    return cc, phys, injectors(cc), (h, hu, hv)


def quad_case(dev, g):
    """The quad coastal case of ``chip_smoke.py --only quads`` (its
    ``quads_coastal_K144_N4``): operator set, dt, a perturbed state of 8
    scenarios and controls of 2 control steps, drawn from ``g``."""
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB

    cc, phys, (bu, bv), state = _quad_coastal(dev, g)
    ops, meta = TB.build_blocked_step_ops(cc, phys, bu, bv, tidal=TIDE,
                                          device=dev)
    return (ops, meta, cfl_dt(cc, 9.81, 13.5), state,
            g(state[0].shape[0], 2, meta.n_ctrl))


def quad_shard_case(dev, g):
    """The sharded quad case of ``chip_smoke.py --only quads`` (its
    ``quads_sharded_coastal_K144_N4_S4_B8``): ``quad_case``'s problem on
    its mesh partitioned into 4 shards, one control vector; the sharded
    set, dt, the stage time t = 1, the state (S, B, K_loc Np) per field,
    the receive buffer of its send buffer, the control and the exchange."""
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    S = 4
    sc, phys, (bu, bv), state = _quad_coastal(dev, g, S)
    sb = BS.build_sharded_blocked(sc, phys, S, tidal=TIDE, forcing_bu=bu,
                                  forcing_bv=bv, device=dev)
    st = tuple(BS.split_shards(f, S) for f in state)
    ex = RingExchange(sb.plan, sb.meta.n_fp, device=dev)
    rb = ex(BS.initial_send_buffer(sb, st))
    return sb, cfl_dt(sc, 9.81, 13.5), 1.0, st, rb, g(sb.meta.n_ctrl), ex


def quads(say, dev, g) -> None:
    """B4 and B5 on the quad coastal case (``quad_case``), B7's two
    stages and B9 on its sharded case (``quad_shard_case``)."""
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB

    ops, meta, dt, (h, hu, hv), ctrls = quad_case(dev, g)
    B = h.shape[0]
    c0 = ctrls[:, 0].contiguous()
    shape = f"quads_K{meta.k_elem}_N4_B{B}"
    plan = TB.rollout_plan(ops, meta, B)
    say("sw2d_step_blocked", shape, lambda: TB.sw2d_step_blocked(
        ops, meta, h, hu, hv, c0, dt, 1.0), plan=plan)
    say("sw2d_rollout_blocked", f"{shape}_2x2",
        lambda: TB.sw2d_rollout_blocked(ops, meta, h, hu, hv, ctrls, dt, 2,
                                        t0=1.0, store_traj=True), plan=plan)
    sb, dt, t, st, rb, ctrl, ex = quad_shard_case(dev, g)
    ops, meta = sb.ops, sb.meta
    S = sb.n_shards
    shape = f"quads_sharded_K{S * meta.k_elem}_N4_S{S}_B{B}"
    plan = TB.shard_plan(ops, meta, B)
    *s1, sb1 = TB.sw2d_stage_blocked(ops, meta, st, st, rb, 0.5 * dt, t, ctrl)
    cur, rb2 = tuple(f.contiguous() for f in s1), ex(sb1)
    say("sw2d_stage_blocked", f"{shape}_stage1",
        lambda: TB.sw2d_stage_blocked(ops, meta, st, st, rb, 0.5 * dt, t,
                                      ctrl),
        plan=plan, kernel_name="sw2d_stage_kernel")
    say("sw2d_stage_blocked", f"{shape}_stage2",
        lambda: TB.sw2d_stage_blocked(ops, meta, st, cur, rb2, dt,
                                      t + 0.5 * dt, ctrl, True, True),
        plan=plan, kernel_name="sw2d_stage_kernel")
    launch = TB.RdmaLaunch(ops, meta, ex)
    say("sw2d_step_rdma_blocked", f"{shape}_step",
        lambda: launch(st, rb, dt, t, ctrl),
        plan=TB.shard_plan(ops, meta, B, step=True),
        kernel_name="sw2d_step_rdma_kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("forward_times: no CUDA device", file=sys.stderr)
        return 1
    from blitzdg_tpu_torch.mpc import blocked_box as bbx
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB

    args = sys.argv[1:]
    label = next((a for a in args if not a.startswith("--")),
                 str(Path.cwd()))
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    scratch = torch.empty(64 * 1024 * 1024, dtype=f32, device=dev)
    flush = scratch.zero_
    rng = np.random.default_rng(0)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=f32,
                                       device=dev)

    def say(kernel, shape, run, reps=9, calls=10, plan=None,
            kernel_name="sw2d_blocked_rollout", **more):
        ms = time_ms(run, flush, reps)
        print(json.dumps({"tree": label, "kernel": kernel, "shape": shape,
                          "ms": ms,
                          "device_ms": device_ms(run, calls, kernel_name),
                          **({"plan": plan} if plan else {}),
                          **{k: f(ms) for k, f in more.items()}}),
              flush=True)

    n_cs, spc, B = bbx.HORIZON, bbx.STEPS_PER_CONTROL, bbx.BATCH
    for n_order, horizon in (() if "--quads" in args else ((3, n_cs),
                                                            (6, 2))):
        box = bbx.blocked_box_problem(n_order=n_order, horizon=horizon,
                                      device=dev)
        ops, meta, dt = box.bm.ops, box.bm.meta, box.prob.dt
        x = box.prob.ctx.x.reshape(1, -1)
        h = (bbx.H_REST + 0.1 * torch.exp(-((x - x.mean()) / x.std()) ** 2)
             + 0.01 * g(B, x.shape[1])).contiguous()
        hu = (0.05 * h + 0.01 * g(*h.shape)).contiguous()
        hv = (-0.05 * h + 0.01 * g(*h.shape)).contiguous()
        ctrls = g(B, horizon, meta.n_ctrl)
        shape = f"K{meta.k_elem}_N{n_order}_B{B}"
        if n_order == 3:
            c0 = ctrls[:, 0].contiguous()
            say("sw2d_step_blocked", shape, lambda: TB.sw2d_step_blocked(
                ops, meta, h, hu, hv, c0, dt))
        say("sw2d_rollout_blocked", f"{shape}_{horizon}x{spc}",
            lambda: TB.sw2d_rollout_blocked(ops, meta, h, hu, hv, ctrls, dt,
                                            spc, store_traj=True))
        del box, ops
    quads(say, dev, g)
    for n_order in (() if "--quads" in args else (3, 6)):
        r = bbx.blocked_rollout_problem(n_order=n_order, device=dev)
        say("sw2d_rollout_blocked",
            f"K{r.meta.k_elem}_N{n_order}_B{B}_{r.n_steps}_steps",
            lambda: TB.sw2d_rollout_blocked(r.ops, r.meta, *r.states, None,
                                            r.dt, n_steps=r.n_steps),
            reps=5, calls=2,
            us_per_step=lambda ms: ms * 1e3 / r.n_steps)
        del r
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": label, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
