#!/usr/bin/env python3
"""Time the two blocked adjoint kernels on one NVIDIA GPU at the shapes
their paths run, for an A/B of two trees of this repository in one call.

    python3 tools/adjoint_times.py [label] [--kernel NAME] [--sass] [--quads]

run from the root of a tree (its own package is imported). Prints one JSON
line per shape, then one with the card's name and power limit.
``--kernel NAME`` times only the shapes of the wrapper whose name holds
NAME (``rollout_bwd``: B6 alone). ``--sass`` first prints, for each
instantiation of the two adjoint kernels in the tree's built library, its
registers and stack frame (from ptxas's report in the build log) and its
count of SASS instructions (``cuobjdump -sass``). Shapes:

 - ``sw2d_stage_bwd_blocked_v2`` (B8) on the second stage of a step of the
   sharded box (``mpc/sharded_box.py``): K=2048, N=3, S=4 at B=8 and B=1
   (the full-width MPC's), K=128, N=1, S=8, B=1 (the example's), and
   K=2048, N=6, S=4, B=8 (the run-time-size instance, one lane an
   element), two controls, random cotangents;
 - ``sw2d_rollout_bwd_blocked`` (B6) on the blocked box
   (``mpc/blocked_box.py``): K=2048, N=3 (the compile-time instance) and
   N=6 (the run-time-size instance, one lane an element), B=8, 4 x 2
   steps, random cotangents of the kernel's own trajectory;
 - with ``--quads`` (alone): B6 on ``chip_smoke.py``'s quad coastal case
   (``quads_coastal_K144_N4``: ``box_quads(12, 12)``, K=144, N=4, B=8, its
   east side open: bathymetry, drag, Coriolis, tidal depth from t0 = 1,
   sponge, two injectors), 2 x 2 steps, random cotangents of the forward
   kernel's own trajectory (``tools/forward_times.py``'s ``quad_case``,
   which its ``--quads`` times B4 and B5 on): the shape of the quad Adam
   solve's adjoint; and B8 on the second stage of a step of that case's
   sharded form (``forward_times.py``'s ``quad_shard_case``: the mesh in 4
   shards of 36 elements, B=8, one control vector, random cotangents):
   the shape of the quad path's differentiable sharded steps.

Inputs are made from fixed seeds, as ``chip_smoke.py`` makes its timed
cases. Two times a shape: ``ms``, CUDA events around one call of the
wrapper, the 50 MB L2 cache flushed before each (256 MB written), median of
9 after one warm-up (as ``chip_smoke.py`` times; where the wrapper's host
work outlasts the flush, the events include the rest of it), and
``device_ms``, the mean duration of the adjoint kernel over 10 calls under
``torch.profiler`` (L2 warm, the kernel alone). Uses only entry points
that the trees before and after the adjoints' redesign share.
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

REPS = 9
ADJOINTS = ("sw2d_blocked_rollout_bwd_kernel", "sw2d_stage_bwd_kernel")


def sass_report(label: str) -> None:
    """Registers, stack frame and SASS instruction count of each adjoint
    kernel instantiation in this tree's library."""
    import re

    from blitzdg_tpu_torch.ops import _build

    lib = _build.build_all()["sw2d_blocked"]
    log = lib.with_suffix(".log").read_text()
    props = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s+(\d+) bytes "
                         r"stack frame.*?\n.*?Used (\d+) registers", log):
        props[m.group(1)] = (int(m.group(3)), int(m.group(2)))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    for fn in sorted(counts):
        if any(a in fn for a in ADJOINTS):
            regs, stack = props.get(fn, (None, None))
            print(json.dumps({"tree": label, "function": fn,
                              "registers": regs, "stack_bytes": stack,
                              "sass_instructions": counts[fn]}), flush=True)


def time_ms(fn, flush) -> float:
    fn()
    out = []
    for _ in range(REPS):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "bwd" in e.key]
    return sum(e.device_time_total for e in ev) / 10 / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("adjoint_times: no CUDA device", file=sys.stderr)
        return 1
    from blitzdg_tpu_torch.mpc import blocked_box as bbx
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    args = sys.argv[1:]
    only = None
    if "--kernel" in args:
        i = args.index("--kernel")
        only = args[i + 1]
        del args[i:i + 2]
    sass = "--sass" in args
    on_quads = "--quads" in args
    args = [a for a in args if a not in ("--sass", "--quads")]
    label = args[0] if args else str(Path.cwd())
    if sass:
        sass_report(label)
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    scratch = torch.empty(64 * 1024 * 1024, dtype=f32, device=dev)
    flush = scratch.zero_
    rng = np.random.default_rng(0)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=f32,
                                       device=dev)

    def state(ctx, B, S):
        x = ctx.x.reshape(1, -1)
        bump = torch.exp(-((x - x.mean()) / x.std()) ** 2)
        h = sbx.H_REST + 0.1 * bump + 0.01 * g(B, x.shape[1])
        hu, hv = 0.05 * h + 0.01 * g(*h.shape), -0.05 * h + 0.01 * g(*h.shape)
        return tuple(BS.split_shards(f.contiguous(), S) for f in (h, hu, hv))

    if on_quads:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from forward_times import quad_case

        ops, meta, dt, st, ctrls = quad_case(dev, g)
        spc, B = 2, st[0].shape[0]
        traj = TB.sw2d_rollout_blocked(ops, meta, *st, ctrls, dt, spc,
                                       t0=1.0, store_traj=True)[:3]
        traj = tuple(f.contiguous() for f in traj)
        tb = tuple(g(*traj[0].shape) for _ in range(3))
        run = lambda: TB.sw2d_rollout_bwd_blocked(ops, meta, *traj, *tb,
                                                  ctrls, dt, spc, t0=1.0)
        ms = time_ms(run, flush)
        print(json.dumps({"tree": label, "kernel": "sw2d_rollout_bwd_blocked",
                          "shape": f"quads_K{meta.k_elem}_N4_B{B}_2x{spc}",
                          "ms": ms, "device_ms": device_ms(run),
                          "grid_blocks": TB.last_grid(),
                          "plan": TB.rollout_bwd_plan(ops, meta, B)}),
              flush=True)
        from forward_times import quad_shard_case

        sb, dt, t, st, rb, ctrl, ex = quad_shard_case(dev, g)
        S, meta = sb.n_shards, sb.meta
        *s1, sb1 = TB.sw2d_stage_blocked(sb.ops, meta, st, st, rb, 0.5 * dt,
                                         t, ctrl)
        cur, rb2 = tuple(f.contiguous() for f in s1), ex(sb1)
        lam = tuple(g(S, B, meta.n_v) for _ in range(3))
        lsb = g(*rb2.shape)
        run = lambda: TB.sw2d_stage_bwd_blocked_v2(
            sb.ops, meta, cur, rb2, lam, lsb, dt, t + 0.5 * dt, ctrl, True,
            True)
        ms = time_ms(run, flush)
        print(json.dumps({"tree": label, "kernel": "sw2d_stage_bwd_blocked_v2",
                          "shape": f"quads_sharded_K{S * meta.k_elem}_N4_"
                                   f"S{S}_B{B}",
                          "ms": ms, "device_ms": device_ms(run),
                          "grid_blocks": TB.last_grid(),
                          "plan": TB.shard_plan(sb.ops, meta, B,
                                                adjoint=True)}), flush=True)
    stage_shapes = () if on_quads else (
        ("K2048_N3_S4_B8", sbx.FULL, 8),
        ("K2048_N3_S4_B1", sbx.FULL, 1),
        ("example_K128_N1_S8_B1", sbx.EXAMPLE, 1),
        ("K2048_N6_S4_B8", {**sbx.FULL, "n_order": 6}, 8))
    for name, cfg, B in stage_shapes:
        if only and only not in "sw2d_stage_bwd_blocked_v2":
            continue
        prob = sbx.sharded_mpc_problem(cfg, device=dev)
        sb, dt = prob.sb, prob.dt
        S, meta = sb.n_shards, sb.meta
        st = state(prob.ctx, B, S)
        ctrl = g(meta.n_ctrl)
        ex = RingExchange(sb.plan, meta.n_fp, device=dev)
        rb = ex(BS.initial_send_buffer(sb, st))
        *s1, sb1 = TB.sw2d_stage_blocked(sb.ops, meta, st, st, rb, 0.5 * dt,
                                         0.0, ctrl)
        cur, rb2 = tuple(f.contiguous() for f in s1), ex(sb1)
        lam = tuple(g(S, B, meta.n_v) for _ in range(3))
        lsb = g(*rb2.shape)
        run = lambda: TB.sw2d_stage_bwd_blocked_v2(
            sb.ops, meta, cur, rb2, lam, lsb, dt, 0.5 * dt, ctrl)
        ms = time_ms(run, flush)
        print(json.dumps({"tree": label, "kernel": "sw2d_stage_bwd_blocked_v2",
                          "shape": name, "ms": ms,
                          "device_ms": device_ms(run),
                          "grid_blocks": TB.last_grid()}), flush=True)
        del prob, sb

    for n_order in () if on_quads else (3, 6):
        if only and only not in "sw2d_rollout_bwd_blocked":
            continue
        box = bbx.blocked_box_problem(n_order=n_order, device=dev)
        ops, meta, dt = box.bm.ops, box.bm.meta, box.prob.dt
        n_cs, spc, B = bbx.HORIZON, bbx.STEPS_PER_CONTROL, bbx.BATCH
        x = box.prob.ctx.x.reshape(1, -1)
        h = bbx.H_REST + 0.1 * torch.exp(-((x - x.mean()) / x.std()) ** 2) \
            + 0.01 * g(B, x.shape[1])
        hu = 0.05 * h + 0.01 * g(*h.shape)
        hv = -0.05 * h + 0.01 * g(*h.shape)
        ctrls = g(B, n_cs, meta.n_ctrl)
        traj = TB.sw2d_rollout_blocked(ops, meta, h.contiguous(),
                                       hu.contiguous(), hv.contiguous(),
                                       ctrls, dt, spc, store_traj=True)[:3]
        traj = tuple(f.contiguous() for f in traj)
        tb = tuple(g(*traj[0].shape) for _ in range(3))
        run = lambda: TB.sw2d_rollout_bwd_blocked(ops, meta, *traj, *tb,
                                                  ctrls, dt, spc)
        ms = time_ms(run, flush)
        print(json.dumps({"tree": label, "kernel": "sw2d_rollout_bwd_blocked",
                          "shape": f"K{meta.k_elem}_N{n_order}_B{B}_"
                                   f"{n_cs}x{spc}",
                          "ms": ms, "device_ms": device_ms(run),
                          "grid_blocks": TB.last_grid()}), flush=True)
        del box, traj, tb
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": label, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
