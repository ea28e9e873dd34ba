#!/usr/bin/env python3
"""Time the one-launch sharded step (B9) on one NVIDIA GPU: its stacked
mode at ``chip_smoke.py``'s ``rdma_K2048_N3_S4`` shape, for an A/B of two
trees of this repository in one call, and, in a tree that has it, its peer
mode with the S ranks of a ring in one process.

    python3 tools/peer_times.py [label] [--sass] [--in-process] [--quads]

run from the root of a tree (its own package is imported). Prints one JSON
line per measurement, then one with the card's name and power limit.

 - stacked: ``sw2d_step_rdma_blocked`` over the stacked ring exchange at
   K=2048, N=3, S=4, B=8, two controls (``mpc/sharded_box.py``'s full
   width, a perturbed state from a fixed seed): ``ms``, CUDA events around
   one call, the 50 MB L2 flushed before each (four times 256 MB written,
   as ``chip_smoke.py``'s ``time_ms``), median of 9 after one warm-up; and
   ``device_ms``, the mean duration of the step kernel over 10 calls under
   ``torch.profiler`` (L2 warm, the kernel alone);
 - ``--sass``: for each instantiation of the step kernel in the tree's
   library (stacked and, where present, peer mode), its count of SASS
   instructions and a hash of their text (``cuobjdump -sass``): the same
   hash, the same machine code;
 - ``--in-process``: the coastal set of ``chip_smoke.py --only peer``
   (K=2048, N=3, B=8, S=4) with the four ranks' ``PeerRing``s over four
   regions of this process (``chip_smoke.py``'s ``run_peer_in_process``:
   each launch on its own stream; the four step launches, 256 blocks of 64
   threads each, are resident together and meet only through their flags):
   64 steps (after 64 untimed), host clock around them (synchronised), us
   a step (the host's launches included: a step kernel a rank a step, and
   where a tree's ring exchanges before every step, an exchange kernel
   too), each rank's end state against its shard of the stacked rollout
   (bit for bit), the stacked rollout's us a step by the same clock, and
   the exchange kernel's launches a rank a step (``peer_ring_exchange``'s
   counter over the run). The only run in which the ranks' kernels run at
   the same time: processes without MPS time-slice the card. Then rank
   0's step alone and its exchange kernel alone (its flags set past any
   epoch, the others idle), each timed as above: a step of a tree costs
   its step plus its exchanges a step;
 - ``--quads`` (in the place of the stacked step): rank 0's peer step
   alone on ``chip_smoke.py --only quads``'s sharded quad set (K=144 in
   S=4 shards, N=4, B=8, coastal; ``tools/forward_times.py``'s
   ``quad_shard_case``), its four rings in this process, its flags set
   past any epoch, timed as above (the stacked step on that set:
   ``tools/forward_times.py --quads``).
"""
from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))

REPS = 9
STEPS = 64


def sass_report(label: str) -> None:
    from blitzdg_tpu_torch.ops import _build

    lib = _build.build_all()["sw2d_blocked"]
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    code, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            code[fn] = []
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            code[fn].append(line.split("*/", 1)[1].split(";")[0].strip())
    for fn in sorted(code):
        if "sw2d_step_rdma" in fn:
            text = "\n".join(code[fn]).encode()
            print(json.dumps({"tree": label, "function": fn,
                              "sass_instructions": len(code[fn]),
                              "sass_sha1": hashlib.sha1(text).hexdigest()}),
                  flush=True)


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


def device_ms(fn, name: str) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if name in e.key]
    return sum(e.device_time_total for e in ev) / 10 / 1e3


def stacked(label: str, dev, flush) -> None:
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    rng = np.random.default_rng(0)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)
    prob = sbx.sharded_mpc_problem(sbx.FULL, device=dev)
    sb, dt, B = prob.sb, prob.dt, 8
    S, meta = sb.n_shards, sb.meta
    x = prob.ctx.x.reshape(1, -1)
    h = sbx.H_REST + 0.1 * torch.exp(-((x - x.mean()) / x.std()) ** 2) \
        + 0.01 * g(B, x.shape[1])
    st = tuple(BS.split_shards(f.contiguous(), S) for f in
               (h, 0.05 * h + 0.01 * g(*h.shape),
                -0.05 * h + 0.01 * g(*h.shape)))
    ctrl = g(meta.n_ctrl)
    ex = RingExchange(sb.plan, meta.n_fp, device=dev)
    rb = ex(BS.initial_send_buffer(sb, st))
    launch = TB.RdmaLaunch(sb.ops, meta, ex)
    run = lambda: launch(st, rb, dt, 0.0, ctrl)
    print(json.dumps({"tree": label, "kernel": "sw2d_step_rdma_blocked",
                      "shape": "K2048_N3_S4_B8", "ms": time_ms(run, flush),
                      "device_ms": device_ms(run, "sw2d_step_rdma_kernel"),
                      "grid_blocks": TB.last_grid()}), flush=True)


def in_process(label: str, dev) -> None:
    """The four ranks of the coastal ring in this process, concurrently."""
    import time
    import types

    import chip_smoke as C
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel import peer as PR

    S, B = 4, 8
    cc, sb, H, dt = C.peer_problem(S, dev)
    rng = np.random.default_rng(1)
    on_card = lambda a: a.to(dev, torch.float32)
    xy = types.SimpleNamespace(x=on_card(cc.x), y=on_card(cc.y))
    h, hu, hv, _ = C.perturbed_blocked(xy, on_card(H).reshape(1, -1), B, 1,
                                       2, rng, dev)
    state = tuple(BS.split_shards(f, S) for f in (h, hu, hv))
    cs = torch.as_tensor(0.3 * rng.standard_normal((STEPS, 2)),
                         dtype=torch.float32, device=dev)
    sbuf0 = BS.initial_send_buffer(sb, state)

    def timed_loop(step_fn):
        step_fn()  # plans, scratch and first launches outside the clock
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out = step_fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - w0) * 1e6 / STEPS

    rstep = BS.make_sharded_blocked_step_rdma(sb, dt)

    def stacked_loop():
        carry, t = (state, sbuf0), 1.0
        for k in range(STEPS):
            carry = rstep(carry, t, cs[k])
            t += dt
        return carry

    want, stacked_us = timed_loop(stacked_loop)
    want = (*want[0], want[1])
    n_ex = PR.peer_ring_exchange.launches
    ends, peer_us, rings, launches, free = C.run_peer_in_process(
        sb, state, cs, dt, 1.0, dev, STEPS)
    ring0, launch0 = rings[0], launches[0]
    # (an untimed run and a timed one, S ranks each)
    ex_per_step = (PR.peer_ring_exchange.launches - n_ex) / (2 * S * STEPS)
    try:
        bits = [all(torch.equal(a, b[r:r + 1]) for a, b in
                    zip(ends[r], want)) for r in range(S)]
        # rank 0's step alone: its flags past any epoch, so that no wait
        # holds it (the others idle), as chip_smoke.py times it
        ring0.flags[1:] = 1 << 60
        st0 = tuple(f[:1] for f in state)
        alone = lambda: launch0(st0, ring0.rbb, dt, 1.0, cs[0])
        scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                              device=dev)
        alone_ms = time_ms(alone, scratch.zero_)
        alone_device_ms = device_ms(alone, "sw2d_step_rdma_peer_kernel")
        sb0 = ends[0][3]
        exchange = lambda: ring0._exchange(sb0)
        exchange_ms = time_ms(exchange, scratch.zero_)
        exchange_device_ms = device_ms(exchange, "peer_ring_exchange_kernel")
        del scratch
        print(json.dumps({"tree": label, "in_process": "S4_B8_K2048_N3",
                          "steps": STEPS, "peer_us_per_step": peer_us,
                          "stacked_us_per_step": stacked_us,
                          "bit_equal_to_stacked": bits,
                          "exchange_launches_per_rank_step": ex_per_step,
                          "rank0_alone_ms": alone_ms,
                          "rank0_alone_device_ms": alone_device_ms,
                          "rank0_exchange_alone_ms": exchange_ms,
                          "rank0_exchange_alone_device_ms":
                              exchange_device_ms,
                          "peer_plan": TB.shard_plan(launch0.ops, sb.meta,
                                                     B, step=True,
                                                     peer=True)}),
              flush=True)
    finally:
        free()


def quads(label: str, dev, flush) -> None:
    """A rank's peer step alone on the quad path's sharded set
    (``forward_times.quad_shard_case``: K=144 in 4 shards of 36, N=4,
    B=8, coastal, tidal): the four ranks' ``PeerRing``s over four regions
    of this process (``chip_smoke.py``'s ``peer_ranks_in_process``), rank
    0's flags set past any epoch (the others idle), its step-boundary
    slots the ring exchange of the set's send buffer; timed as the
    stacked step."""
    import chip_smoke as C
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from forward_times import quad_shard_case

    rng = np.random.default_rng(0)
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)
    sb, dt, t, st, rb, ctrl, _ = quad_shard_case(dev, g)
    B = st[0].shape[1]
    rings, launches, _, free = C.peer_ranks_in_process(sb, B, dev)
    try:
        ring0, launch0 = rings[0], launches[0]
        ring0.flags[1:] = 1 << 60
        ring0.rbb.copy_(rb[:1])
        st0 = tuple(f[:1] for f in st)
        alone = lambda: launch0(st0, ring0.rbb, dt, t, ctrl)
        ms = time_ms(alone, flush)
        print(json.dumps({
            "tree": label, "kernel": "sw2d_step_rdma_blocked (peer)",
            "shape": f"quads_K{sb.n_shards * sb.meta.k_elem}_N4_S"
                     f"{sb.n_shards}_B{B}_rank0_alone", "ms": ms,
            "device_ms": device_ms(alone, "sw2d_step_rdma_peer_kernel"),
            "grid_blocks": TB.last_grid(),
            "peer_plan": TB.shard_plan(launch0.ops, sb.meta, B, step=True,
                                       peer=True)}), flush=True)
    finally:
        free()


def main() -> int:
    if not torch.cuda.is_available():
        print("peer_times: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    label = next((a for a in args if not a.startswith("--")),
                 str(Path.cwd()))
    dev = torch.device("cuda", 0)
    if "--sass" in args:
        sass_report(label)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    if "--quads" in args:
        quads(label, dev, scratch.zero_)
    else:
        stacked(label, dev, scratch.zero_)
    if "--in-process" in args:
        in_process(label, dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"tree": label, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
