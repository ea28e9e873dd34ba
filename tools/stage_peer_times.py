#!/usr/bin/env python3
"""Time the stage's and its adjoint's peer modes (B7 peer and B8 peer: the
stage ring's exchange and its reverse folded into B7's and B8's launches,
one shard a rank) on one NVIDIA GPU at the full-width sharded MPC's shapes,
beside B7 and B8 launched alone on the same inputs and the stage ring's own
kernels, for an A/B of trees of this repository in one call.

    python3 tools/stage_peer_times.py [label]

run from the root of a tree (its own package is imported); to compare
trees, run it from each tree's root in one call (a tree with a part of the
fold deleted among them: a copy in a gitignored directory of the repo).
Prints one JSON line per kernel, then one with the card's name and power
limit.

The shapes: ``mpc/sharded_box.py``'s FULL (K=2048 in S=4 shards, N=3, B=1,
two controls), rank 0's shard (K_loc=512), the second stage of a step (dt,
the sponge), from a perturbed rest state, as ``chip_smoke.py``'s
``stage_peer_kernels`` takes them. The four ranks' regions are made in this
process (``StageRing.over_regions``); rank 0 launches alone, its flags set
past any epoch (no wait holds a launch) and its forward and reverse slots
(both sets) filled with the stacked exchange's receive buffer and a random
send-buffer cotangent, which its launches read. Kernels:

 - ``B7_peer``: ``sw2d_stage_blocked_peer`` reading its receive buffer from
   the slots; ``B7``: ``sw2d_stage_blocked``'s kernel on the same inputs,
   the receive buffer given (``_run_stage``);
 - ``B8_peer``: ``sw2d_stage_bwd_blocked_peer`` reading its send buffer's
   cotangent from the reverse slots and sending its receive buffer's;
   ``B8``: the stacked adjoint's kernel on the same inputs
   (``_run_stage_bwd``);
 - ``exchange``: the ring's standalone exchange kernel
   (``peer_stage_exchange``) of one (1, B, L, 3) buffer; ``sum``: its sum
   over ranks of 16 floats (``peer_rank_sum``).

Four numbers a kernel: ``ms``, CUDA events around one call of the wrapper,
the 50 MB L2 cache flushed four times before each (256 MB written each
time: about 0.4 ms of work on the card, during which the host enqueues the
call), median of 9 after one warm-up, as ``chip_smoke.py``'s ``time_ms``
times; ``device_ms``, the mean duration of the kernel over 20 calls under
``torch.profiler`` (L2 warm, the calls back to back; the mean over the
launches it recorded); ``device_cold_ms``,
the same with the L2 flushed before each call; ``host_ms``, the median
host time of one call of the wrapper (its enqueue: the Python, the checks
and the launch, with no wait for the card). Uses only entry points that
the trees before and after the peer modes' redesign share.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))

REPS = 9
CALLS = 20
# the kernels' names in the profiler's records
NAMES = {"B7_peer": "sw2d_stage_peer_kernel", "B7": "sw2d_stage_kernel",
         "B8_peer": "sw2d_stage_bwd_peer_kernel",
         "B8": "sw2d_stage_bwd_kernel", "exchange": "peer_stage_exchange",
         "sum": "peer_rank_reduce"}


def time_ms(fn, flush) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        for _ in range(4):
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, kernel: str, flush=None, calls: int = CALLS) -> float:
    """The mean device time of a launch of the kernel whose name holds
    ``kernel`` (over the launches the profiler recorded); with ``flush``,
    the L2 flushed before each call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if kernel in e.key]
    return (sum(e.device_time_total for e in ev)
            / max(sum(e.count for e in ev), 1) / 1e3)


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_peer_times: no CUDA device", file=sys.stderr)
        return 1
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import peer as PR
    from blitzdg_tpu_torch.parallel.blocked_shard import initial_send_buffer
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    label = next((a for a in sys.argv[1:] if not a.startswith("--")),
                 str(Path.cwd()))
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    scratch = torch.empty(64 * 1024 * 1024, dtype=f32, device=dev)
    flush = scratch.zero_
    rng = np.random.default_rng(0)
    g = lambda *shape, scale=1.0: scale * torch.as_tensor(
        rng.standard_normal(shape), dtype=f32, device=dev)

    mp = sbx.sharded_mpc_problem(sbx.FULL, device=dev)
    sb, meta, dt = mp.sb, mp.sb.meta, mp.dt
    plan, S, L = sb.plan, sb.n_shards, sb.ops.send.shape[1]
    state = (10.0 + g(S, 1, meta.n_v, scale=0.01),
             g(S, 1, meta.n_v, scale=0.01), g(S, 1, meta.n_v, scale=0.01))
    ctrl = g(meta.n_ctrl, scale=0.3)
    ops0 = dataclasses.replace(sb.ops, **{
        f.name: getattr(sb.ops, f.name)[:1]
        for f in dataclasses.fields(sb.ops)})
    rb = RingExchange(plan, meta.n_fp, device=dev)(
        initial_send_buffer(sb, state))
    row0 = lambda t: t[:1].contiguous()
    base0 = tuple(row0(f) for f in state)
    cur0 = tuple((f[:1] + g(1, 1, meta.n_v, scale=0.001)).contiguous()
                 for f in state)
    rb0, lsb0 = row0(rb), g(1, 1, L, 3)
    lam = tuple(g(1, 1, meta.n_v) for _ in range(3))
    c_dt, t, sponge = dt, 0.5 * dt, True

    lib = PR._lib()
    lay = PR.stage_region_layout(1, L, len(plan.offs), S)
    bases = {}
    for r in range(S):
        p = ctypes.c_void_p()
        PR._check(lib, lib.peer_alloc(0, lay["bytes"], ctypes.byref(p)),
                  "peer_alloc")
        bases[r] = p.value
    ring = PR.StageRing.over_regions(plan, meta.n_fp, 1, 0, bases, dev)
    ring.flags[:] = 1 << 60
    for rev, buf in ((False, rb0), (True, lsb0)):
        for e in (0, 1):
            PR._view(ring._slots(rev, e), tuple(buf.shape), f32,
                     dev).copy_(buf)
    ring.epochs["forward"] = ring.epochs["reverse"] = 1
    torch.cuda.synchronize()
    x16 = g(16)
    calls = {
        "B7_peer": lambda: TB.sw2d_stage_blocked_peer(
            ops0, meta, base0, cur0, None, ring, c_dt, t, ctrl, True,
            sponge),
        "B7": lambda: TB._run_stage(ops0, meta, base0, cur0, rb0, c_dt, t,
                                    ctrl, True, sponge),
        "B8_peer": lambda: TB.sw2d_stage_bwd_blocked_peer(
            ops0, meta, cur0, rb0, lam, None, ring, c_dt, t, ctrl, True,
            sponge),
        "B8": lambda: TB._run_stage_bwd(ops0, meta, cur0, rb0, lam, lsb0,
                                        c_dt, t, ctrl, True, sponge),
        "exchange": lambda: PR.peer_stage_exchange(ring, rb0),
        "sum": lambda: PR.peer_rank_sum(ring, x16)}
    try:
        for name, fn in calls.items():
            print(json.dumps({
                "tree": label, "kernel": name,
                "shape": "FULL_rank0_K512_N3_B1",
                "ms": time_ms(fn, flush),
                "device_ms": device_ms(fn, NAMES[name]),
                "device_cold_ms": device_ms(fn, NAMES[name], flush, REPS),
                "host_ms": host_ms(fn)}), flush=True)
    finally:
        torch.cuda.synchronize()
        for p in bases.values():
            lib.peer_free(p)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": label, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
