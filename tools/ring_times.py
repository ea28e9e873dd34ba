#!/usr/bin/env python3
"""Time every ring kernel of ``ops/csrc/peer.cu`` (the rings' exchanges, the
reductions over ranks, the step-boundary exchange) on one NVIDIA GPU, rank
0 of each ring alone, for an A/B of trees of this repository in one call.

    python3 tools/ring_times.py [label]

run from the root of a tree (its own package is imported, and only its
``peer.cu`` is built); to compare trees, run it from each tree's root in one
call (a tree with a part of a kernel deleted among them: a copy in a
gitignored directory of the repo). Prints one JSON line per kernel, then
one with the card's name and power limit.

Each ring's regions are made in this process (``over_regions``); rank 0
launches alone, its flags set past any epoch (no wait holds a launch; the
step-boundary ring's epoch word excepted), so a time is the kernel's own:
its launch, its fences and flag stores, its bytes. Kernels and shapes:

 - ``stage_exchange``, ``stage_exchange_reverse``: the stage ring's
   standalone exchange and its reverse (``StageRing._exchange``) of one
   (1, 1, L, 3) float32 buffer at ``mpc/sharded_box.py``'s FULL (K=2048 in
   S=4, N=3: three ring offsets);
 - ``halo_exchange_<dtype>``, ``halo_exchange_reverse_<dtype>``:
   ``peer_halo_exchange`` and its reverse at ``chip_smoke.py``'s
   ``halo_ring_check`` shapes (the scaling study's S=4 plan on
   box_triangles(32, 32), N=3: (n_off, 3, max_send, Nfp), three fields) in
   float32, float64 and bfloat16;
 - ``sum_16xfloat32`` (the MPC's sum, on the stage ring),
   ``sum_1xfloat64`` (a Krylov dot's) and ``max_1xfloat32`` (the halo
   time step's), ``peer_rank_sum`` / ``peer_rank_max``;
 - ``ring_exchange``: ``PeerRing._exchange`` (``peer_ring_exchange``'s
   launch) of a (1, 8, L, 3) send buffer on FULL's plan at the peer
   path's batch (its set is the same box in the same four shards).

Four numbers a kernel: ``ms``, CUDA events around one call of the wrapper,
the 50 MB L2 flushed four times before each (about 0.4 ms of work during
which the host enqueues the call), median of 9 after one warm-up, as
``chip_smoke.py``'s ``time_ms``; ``device_ms``, the mean duration of the
kernel over 20 calls under ``torch.profiler`` (L2 warm, the calls back to
back), as ``tools/stage_peer_times.py`` takes it; ``graph_ms``, a launch
of a CUDA graph of 50 launches back to back (the gaps between them
included), as ``chip_smoke.py`` takes ``device_ms``; ``host_ms``, the
median host time of one call of the wrapper (its enqueue). Uses only
entry points that the trees before and after the rings' redesign share.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from stage_peer_times import REPS, device_ms, host_ms, time_ms  # noqa: E402

GRAPH_LAUNCHES = 50
# the kernels' names in the profiler's records
EXCHANGE, REDUCE = "peer_stage_exchange_kernel", "peer_rank_reduce_kernel"


def graph_ms(fn, n: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """The median time of one launch of a CUDA graph of ``n`` calls of
    ``fn`` back to back, replayed ``reps`` times, CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / n)
    return statistics.median(out)


def load_peer():
    """This tree's ``peer.cu`` built alone (the other sources are not
    needed here) and registered as ``_build.load("peer")``'s library."""
    from blitzdg_tpu_torch.ops import _build

    src = _build.CSRC / "peer.cu"
    target = _build._target(src)
    if not target.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent),
             "-Xptxas", "-v", "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for peer.cu:\n{res.stdout}"
                               f"{res.stderr}")
        _build._log_path(target).write_text(res.stdout + res.stderr)
        os.replace(tmp, target)
    _build._libs["peer"] = ctypes.CDLL(str(target))


def sets():
    """The plans, built on the host, and their Nfp: FULL's (the stage ring
    and the step-boundary ring) and the scaling study's S=4 (the halo
    ring)."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.parallel.blocked_shard import build_sharded_blocked
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    f = sbx.FULL
    ctx, _ = sbx._context(f["cells"], f["n_order"], f["n_shards"],
                          f["filter_order"], torch.float32, "cpu")
    sb = build_sharded_blocked(ctx, SWPhysics(g=9.81), f["n_shards"],
                               dtype=torch.float32, device="cpu")
    hctx = build_triangle_context(
        3, TP.partition_mesh(box_triangles(32, 32), 4)[0],
        dtype=torch.float32, device="cpu")
    return sb.plan, sb.meta.n_fp, TP.build_halo_plan(hctx, 4), hctx.n_fp


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_times: no CUDA device", file=sys.stderr)
        return 1
    from blitzdg_tpu_torch.parallel import peer as PR

    label = next((a for a in sys.argv[1:] if not a.startswith("--")),
                 str(Path.cwd()))
    load_peer()
    lib = PR._lib()
    dev = torch.device("cuda", 0)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    rng = np.random.default_rng(0)
    stage_plan, n_fp, halo_plan, halo_fp = sets()
    S = stage_plan.n_shards
    allocated = []

    def regions(nbytes: int) -> dict:
        bases = {}
        for r in range(S):
            p = ctypes.c_void_p()
            PR._check(lib, lib.peer_alloc(0, nbytes, ctypes.byref(p)),
                      "peer_alloc")
            bases[r] = p.value
            allocated.append(p.value)
        return bases

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    L = PR._n_slots(stage_plan, n_fp)
    lay = PR.stage_region_layout(1, L, len(stage_plan.offs), S)
    stage = PR.StageRing.over_regions(stage_plan, n_fp, 1, 0,
                                      regions(lay["bytes"]), dev)
    slot = PR.halo_slot_bytes(halo_plan, halo_fp, 3, f64)
    lay = PR.ring_region_layout(slot, len(halo_plan.offs), S)
    halo = PR.HaloRing.over_regions(halo_plan, slot, 0, regions(lay["bytes"]),
                                    dev)
    B = 8
    lay = PR.region_layout(B, L, len(stage_plan.offs))
    step = PR.PeerRing.over_regions(stage_plan, n_fp, B, 0,
                                    regions(lay["bytes"]), dev)
    for ring in (stage, halo):
        ring.flags[:] = 1 << 60
    step.flags[1:] = 1 << 60  # (word 0 is the epoch the launch reads)
    torch.cuda.synchronize()
    t = lambda *shape, dtype=f32: torch.as_tensor(
        rng.standard_normal(shape), device=dev).to(dtype)
    sbuf = t(1, 1, L, 3)
    hshape = (len(halo_plan.offs), 3, halo_plan.max_send, halo_fp)
    calls = {
        "stage_exchange": (lambda: stage._exchange(sbuf, False), EXCHANGE),
        "stage_exchange_reverse": (lambda: stage._exchange(sbuf, True),
                                   EXCHANGE)}
    for dt in (f32, f64, bf16):
        buf = t(*hshape, dtype=dt)
        name = str(dt).removeprefix("torch.")
        calls[f"halo_exchange_{name}"] = (
            lambda b=buf: PR.peer_halo_exchange(halo, b), EXCHANGE)
        calls[f"halo_exchange_reverse_{name}"] = (
            lambda b=buf: PR.peer_halo_exchange_reverse(halo, b), EXCHANGE)
    x16, x1d, x1f = t(16), t(1, dtype=f64), t(1)
    calls["sum_16xfloat32"] = (lambda: PR.peer_rank_sum(stage, x16), REDUCE)
    calls["sum_1xfloat64"] = (lambda: PR.peer_rank_sum(halo, x1d), REDUCE)
    calls["max_1xfloat32"] = (lambda: PR.peer_rank_max(halo, x1f), REDUCE)
    sb8 = t(1, B, L, 3)
    calls["ring_exchange"] = (lambda: step._exchange(sb8),
                              "peer_ring_exchange_kernel")
    try:
        for name, (fn, kernel) in calls.items():
            print(json.dumps({
                "tree": label, "kernel": name, "ms": time_ms(fn, flush),
                "device_ms": device_ms(fn, kernel), "graph_ms": graph_ms(fn),
                "host_ms": host_ms(fn), "reps": REPS}), flush=True)
    finally:
        torch.cuda.synchronize()
        for p in allocated:
            lib.peer_free(p)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": label, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
