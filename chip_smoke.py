#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

(``--only dense`` or ``--only blocked`` runs one path's phases alone, for
work on that path.) What it does, in order (any failure is an exception and
a non-zero exit):

 1. refuses to run without a CUDA device;
 2. builds the CUDA kernels of ``blitzdg_tpu_torch/ops/csrc`` with nvcc;
 3. DENSE path (small meshes, one block per scenario). Holds each kernel
    (``sw2d_step_fused``, ``sw2d_rollout_fused``, ``sw2d_rollout_bwd_fused``)
    against its plain PyTorch version on the card, at the headline shape
    (B=2048 scenarios, K=40 triangles, N=1, 32 SSP-RK2 steps, coastal
    physics, float32) and on a flat-bottom and an N=2 case (tolerances: see
    the constants below), and times kernel and plain version with CUDA
    events. Then drives the main path: the full headline coastal MPC solve
    (20 Adam iterations over the fused rollout and its adjoint) through
    ``solve_mpc_fused``, then one closed-loop plant advance with the first
    optimized control through ``advance_plant_fused``. Launch counters are
    zeroed just before and read just after. Cross-checks the solve against
    the same solve run through the plain versions on the card, for the
    first 32 scenarios (and, for information, profiles one more solve);
 4. BLOCKED path (large meshes, the mesh split over blocks):
    ``blocked_kernels`` holds ``sw2d_step_blocked``, ``sw2d_rollout_blocked``
    (with and without trajectory, with and without controls) and
    ``sw2d_rollout_bwd_blocked`` against their plain versions over 8 steps
    at K=2048, N=3, B=8 (perturbed and exact rest state), at N=6, on a
    coastal case (bathymetry, well-balancing, drag, Coriolis, tidal open
    boundary, sponge, t0=1), on a wet/dry beach (forward only) and on a
    shuffled, RCM-reordered mesh; ``blocked_rollout`` times the 2048-step
    rollout at N=3 and N=6 and one grid barrier; ``blocked_path`` drives
    ``solve_mpc_blocked`` (5 Adam iterations), ``solve_mpc_blocked_gn``
    (2 x 2) and ``advance_plant_blocked`` at the full configuration of
    ``mpc/blocked_box.py`` with the launch counters zeroed just before and
    read just after; ``blocked_cross_check`` repeats the Adam solve through
    the plain versions on the card;
 5. prints one JSON line per phase, the ``{"kernels": [...]}`` line, the
    card's name and power limit, and as the last line
    ``{"ok": true, "device": {...}}``.

Bounds: ``bound_ms`` is the larger of (bytes each input is read once and
each output written once) / 3.35 TB/s and (float32 operations of the
function, counted from the shapes by the formulas below) / 67 TFLOP/s, the
published peaks of one H100 SXM.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

FWD_ATOL = 2e-5  # float32 kernel vs plain version, absolute, states ~ 10
# The N=2 rollout is held to a wider bound: its single step differs from the
# plain version by 3.6e-6 (a few ulp of h = 12, which is 9.5e-7), and over
# 32 steps of the less dissipative N=2 scheme that grows to 5e-5.
FWD_ATOL_N2_ROLLOUT = 1e-4
# Adjoint kernel vs plain version, per scenario, relative to the largest
# entry of each cotangent. max(spdM, spdP) and the face maximum are kinks:
# where two speeds agree to the last bits, float32 rounding decides which
# side gets the cotangent, and kernel and plain version can decide
# differently. Both answers are valid subgradients. On the card that happens
# in a handful of 2048 scenarios (errors up to 1e-4 there), while the others
# agree to 2e-7. So: 99 % of the scenarios within BWD_RTOL_BULK, every
# scenario within BWD_RTOL_MAX; a wrong adjoint formula would show in all.
BWD_RTOL_BULK = 1e-5
BWD_RTOL_MAX = 1e-3
# At the exact rest start every scenario holds the same state and sits on
# the kinks (equal speeds on both sides of every face), so there is no bulk:
# every scenario is held to 1e-4 (seen: 2.1e-5).
BWD_RTOL_REST = 1e-4
COST_RATIO = (0.999, 1.001)  # final cost, kernels vs plain versions

# Blocked kernels, forward, states near 10. One step differs from the plain
# version by 3e-6 (3 ulp of h = 10); on the rough test state (node-wise
# noise 0.01) 8 steps of the N=3 scheme at CFL 0.7 grow that to 1.8e-5, so
# steps and rollouts are held to 5e-5; from the smooth rest start they agree
# to 1e-12. The N=6 operators have larger entries (a derivative row sums to
# 40 in absolute value against 12 at N=3): held to 1e-4.
BLK_FWD_ATOL = 5e-5
BLK_FWD_ATOL_N6 = 1e-4
# Blocked adjoint: B = 8 scenarios are too few for a quantile over
# scenarios, so the kinks (see BWD_RTOL_BULK) are counted per NODE: every
# entry of the four cotangents relative to the largest entry of its
# reference; 99 % of the entries within BWD_RTOL_BULK, all within
# BWD_RTOL_MAX, and all within BWD_RTOL_REST at the exact rest start.
ADAM_MIN_DECREASE = 10.0  # first cost / final cost, median over scenarios
# Final cost of the blocked Adam solve, kernels vs plain versions. The whole
# tracking error of that problem is some 30 ulp of h = 10 in float32, and
# all scenarios are the same, so rounding differences do not average out
# over the batch (seen: 0.99934 in every scenario): wider than COST_RATIO.
BLK_COST_RATIO = (0.995, 1.005)


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# Operation counts (float32 operations per scenario, from the shapes)
# ---------------------------------------------------------------------------

def rhs_flops(meta, n_wall: int, use_filter: bool = True) -> float:
    """One RHS evaluation: adds, multiplies, divisions, square roots and
    maxima of the formulas in ops/sw2d_fused.py::_rhs_plain, each counted
    as one operation; per-element products as 2 per multiply-add."""
    np_, ntr = meta.n_p, meta.n_faces * meta.n_fp
    if meta.wb:
        # velocities 4, star depths 7, correction 5, two flux_uv 26,
        # speeds 15, jumps 3, three dflux 24 + correction 5, fscale 3
        trace = 4 + 7 + 5 + 26 + 15 + 3 + 24 + 5 + 3
    else:
        # velocities 4, two conservative fluxes 24, speeds 15, jumps 3,
        # three dflux 24, fscale 3
        trace = 4 + 24 + 15 + 3 + 24 + 3
    trace += (meta.n_fp - 1) + (3 if meta.tidal is not None else 0)
    # volume flux 12, Dr/Ds on five fields 20 Np, metric combine 24,
    # lift 6 Ntr, filter 6 Np, stage axpy 6
    vol = 12 + 20 * np_ + 24 + 6 * ntr + 6 + 4 * meta.n_ctrl
    vol += 6 * np_ if use_filter else 0
    vol += (5 if meta.has_bathy else 0) + (12 if meta.cd else 0)
    vol += 4 if meta.f_cor else 0
    return trace * meta.n_t + 8 * n_wall + vol * meta.n_v


def vjp_flops(meta, n_wall: int, use_filter: bool = True) -> float:
    """One application of the RHS adjoint (_eval_rhs_vjp_plain), forward
    recompute of the trace values included."""
    np_ = meta.n_p
    # recompute 36, lift^T 6 Np + 3, speed cotangent 6 + face 3 Nfp + 9,
    # flux cotangents 15, two flux adjoints 64, two speed adjoints 32,
    # velocity adjoints 14, star/tidal 3, gather transpose 6
    trace = 36 + 6 * np_ + 3 + 6 + 3 * meta.n_fp + 9 + 15 + 64 + 32 + 14 + 3 + 6
    trace += 20 if meta.wb else 0
    # filter^T 6 Np + 3, control cotangent, div^T 18 Np, flux adjoint 25,
    # sources, lambda update 6
    vol = 3 + 4 * meta.n_ctrl + 18 * np_ + 25 + 6
    vol += 6 * np_ if use_filter else 0
    vol += (5 if meta.has_bathy else 0) + (30 if meta.cd else 0)
    vol += 4 if meta.f_cor else 0
    return trace * meta.n_t + 10 * n_wall + vol * meta.n_v


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Timing and comparison
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, flush) -> float:
    """Median time of ``fn()`` over ``reps`` runs, CUDA events, after one
    warm-up; ``flush()`` (not timed) runs before each to empty the L2. It
    runs four times: about 0.4 ms of work on the card during which the host
    gets ahead and enqueues ``fn``'s launch, so that the events bracket the
    kernel's time on the card and not the wrapper's time on the host (which
    is several times a short kernel's and spreads from call to call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        for _ in range(4):
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs(xs, ys) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


def scenario_rel(xs, ys):
    """Per scenario: the largest error over all cotangents, each relative to
    the largest entry of its reference over the whole batch."""
    B = xs[0].shape[0]
    return torch.stack([
        (x - y).abs().reshape(B, -1).amax(dim=1) / (y.abs().max() + 1e-30)
        for x, y in zip(xs, ys)]).amax(dim=0)


def check_case(F, name, ops, meta, h, hu, hv, ctrls, dt, spc, t0,
               timed: bool, flush, rng, rollout_atol: float = FWD_ATOL,
               bwd_rtol: tuple = (BWD_RTOL_BULK, BWD_RTOL_MAX)):
    """Compare the three kernels with their plain versions on one case.
    Returns the three per-kernel records (errors always, times if asked)."""
    B = h.shape[0]
    n_cs = ctrls.shape[1]
    n_steps = n_cs * spc
    n_wall = int(ops.wall.sum())
    out = {}

    # --- step ---
    c0 = ctrls[:, 0].contiguous()
    got = F.sw2d_step_fused(ops, meta, h, hu, hv, c0, dt, True, t0)
    ref = F.sw2d_step_plain(ops, meta, h, hu, hv, c0, dt, True, t0)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    rec = {"case": name, "kernel": "sw2d_step_fused", "max_abs_err": err,
           "tol": FWD_ATOL, "ok": err <= FWD_ATOL}
    if timed:
        rec["ms"] = time_ms(lambda: F.sw2d_step_fused(
            ops, meta, h, hu, hv, c0, dt, True, t0), 9, flush)
        rec["plain_ms"] = time_ms(lambda: F.sw2d_step_plain(
            ops, meta, h, hu, hv, c0, dt, True, t0), 3, flush)
        byts = 4.0 * (6 * B * meta.n_v + B * meta.n_ctrl)
        flops = B * 2 * rhs_flops(meta, n_wall)
        rec["bound_ms"], rec["bound_by"] = bound(byts, flops)
    out["sw2d_step_fused"] = rec

    # --- rollout ---
    got = F.sw2d_rollout_fused(ops, meta, h, hu, hv, ctrls, dt, spc, True, t0)
    ref = F.sw2d_rollout_plain(ops, meta, h, hu, hv, ctrls, dt, spc, True, t0)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    rec = {"case": name, "kernel": "sw2d_rollout_fused", "max_abs_err": err,
           "tol": rollout_atol, "ok": finite and err <= rollout_atol}
    if timed:
        rec["ms"] = time_ms(lambda: F.sw2d_rollout_fused(
            ops, meta, h, hu, hv, ctrls, dt, spc, True, t0), 9, flush)
        rec["plain_ms"] = time_ms(lambda: F.sw2d_rollout_plain(
            ops, meta, h, hu, hv, ctrls, dt, spc, True, t0), 2, flush)
        byts = 4.0 * (3 * B * meta.n_v + B * n_cs * meta.n_ctrl
                      + 3 * B * (n_steps + 1) * meta.n_v)
        flops = B * n_steps * 2 * rhs_flops(meta, n_wall)
        rec["bound_ms"], rec["bound_by"] = bound(byts, flops)
    out["sw2d_rollout_fused"] = rec

    # --- backward rollout, on the kernel's own trajectory ---
    traj = got
    tb = [torch.as_tensor(rng.standard_normal(tuple(traj[0].shape)),
                          dtype=torch.float32, device=h.device)
          for _ in range(3)]
    gk = F.sw2d_rollout_bwd_fused(ops, meta, *traj, *tb, ctrls, dt, spc,
                                  True, t0)
    gp = F.sw2d_rollout_bwd_plain(ops, meta, *traj, *tb, ctrls, dt, spc,
                                  True, t0)
    torch.cuda.synchronize()
    per = scenario_rel(gk, gp)  # (B,)
    p99, worst = float(torch.quantile(per, 0.99)), float(per.max())
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    rec = {"case": name, "kernel": "sw2d_rollout_bwd_fused",
           "max_abs_err": max_abs(gk, gp), "max_rel_err": worst,
           "p99_rel_err": p99,
           "scenarios_above_bulk_tol": int((per > BWD_RTOL_BULK).sum()),
           "tol": list(bwd_rtol),
           "ok": finite and p99 <= bwd_rtol[0] and worst <= bwd_rtol[1]}
    if timed:
        rec["ms"] = time_ms(lambda: F.sw2d_rollout_bwd_fused(
            ops, meta, *traj, *tb, ctrls, dt, spc, True, t0), 9, flush)
        rec["plain_ms"] = time_ms(lambda: F.sw2d_rollout_bwd_plain(
            ops, meta, *traj, *tb, ctrls, dt, spc, True, t0), 2, flush)
        byts = 4.0 * (6 * B * (n_steps + 1) * meta.n_v
                      + 2 * B * n_cs * meta.n_ctrl + 3 * B * meta.n_v)
        flops = B * n_steps * (rhs_flops(meta, n_wall)
                               + 2 * vjp_flops(meta, n_wall))
        rec["bound_ms"], rec["bound_by"] = bound(byts, flops)
    out["sw2d_rollout_bwd_fused"] = rec
    for r in out.values():
        say(r)
        if not r["ok"]:
            raise RuntimeError(f"kernel out of tolerance: {r}")
    return out


def perturbed_inputs(cb, B, n_cs, rng, device):
    """Generic states near the rest state: per scenario a smooth bump of
    random height and place on the surface, a random uniform current, a
    little node-wise noise on top; and random controls."""
    ctx = cb.prob.ctx
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
    col = lambda lo, hi: to(rng.uniform(lo, hi, (B, 1)))
    x, y = ctx.x.reshape(1, -1), ctx.y.reshape(1, -1)
    n_v = x.shape[1]
    bump = torch.exp(-10.0 * ((x - col(-0.5, 0.5)) ** 2
                              + (y - col(-0.5, 0.5)) ** 2))
    h = (cb.H_rest.reshape(1, -1) + col(0.05, 0.3) * bump
         + to(0.01 * rng.standard_normal((B, n_v))))
    hu = col(-0.1, 0.1) * h + to(0.01 * rng.standard_normal((B, n_v)))
    hv = col(-0.1, 0.1) * h + to(0.01 * rng.standard_normal((B, n_v)))
    ctrls = to(0.3 * rng.standard_normal((B, n_cs, 2)))
    return h.contiguous(), hu.contiguous(), hv.contiguous(), ctrls


def profile_solve(phase: str, card: str, run, solve_s: float) -> None:
    """Where one solve's time goes, for information: device time by kernel
    name under torch.profiler, and the idle share against the unprofiled
    host-clock time ``solve_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def self_device_us(ev):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, attr):
                return float(getattr(ev, attr))
        return 0.0

    # kernel rows only: a CPU-side operator row repeats its kernels' time
    rows = sorted(((self_device_us(ev), ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    say({"phase": phase, "card": card,
         "device_busy_ms": busy_ms if busy_ms > 0 else None,
         "solve_ms_unprofiled": solve_s * 1e3,
         "device_idle_share": (1.0 - busy_ms / (solve_s * 1e3)
                               if busy_ms > 0 else None),
         "device_kernel_launches": sum(r[2] for r in rows),
         "top_device_ms": [{"name": k[:60], "ms": us / 1e3, "calls": n}
                           for us, k, n in rows[:8] if us > 0]})


def dense_phases(dev, card: str, rng, flush) -> list:
    """The dense path (small meshes): kernels against plain versions, the
    headline solve, its profile and cross-check. Returns the kernel records
    of the ``kernels`` line."""
    from blitzdg_tpu_torch.mpc import (advance_plant_fused, build_fused_mpc,
                                       solve_mpc_fused)
    from blitzdg_tpu_torch.mpc import coastal_box as cbx
    from blitzdg_tpu_torch.ops import sw2d_fused as F
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState

    # ---- kernels against their plain versions ----
    cb = cbx.coastal_box_problem(device=dev)  # the headline shape
    prob = cb.prob
    fm = build_fused_mpc(prob, cb.forcing_bu, cb.forcing_bv, tidal=cb.tidal,
                         device=dev)
    n_cs, spc, dt = prob.horizon, prob.steps_per_control, prob.dt
    h, hu, hv, ctrls = perturbed_inputs(cb, cbx.BATCH, n_cs, rng, dev)
    head = check_case(F, "headline", fm.ops, fm.meta, h, hu, hv, ctrls,
                      dt, spc, 0.0, True, flush, rng)
    # the exact start of the main path: rest state, zero controls
    flat = lambda f: f.reshape(f.shape[0], -1).contiguous()
    check_case(F, "headline_rest", fm.ops, fm.meta,
               flat(cb.states.h), flat(cb.states.hu), flat(cb.states.hv),
               torch.zeros_like(ctrls), dt, spc, 0.0, False, flush, rng,
               bwd_rtol=(BWD_RTOL_REST, BWD_RTOL_REST))
    # flat bottom, wall-only, no coastal terms (same mesh)
    flat_ops, flat_meta = F.build_fused_step_ops(
        prob.ctx, SWPhysics(g=9.81), cb.forcing_bu, cb.forcing_bv, device=dev)
    hf = 10.0 + (h[:256] - cb.H_rest.reshape(1, -1))
    check_case(F, "flat_K40_N1", flat_ops, flat_meta, hf.contiguous(),
               hu[:256].contiguous(), hv[:256].contiguous(),
               ctrls[:256].contiguous(), dt, spc, 0.0, False, flush, rng)
    # N=2 (three nodes per face), K=18, coastal
    cb2 = cbx.coastal_box_problem(batch=256, n_order=2, cells=(3, 3),
                                  device=dev)
    fm2 = build_fused_mpc(cb2.prob, cb2.forcing_bu, cb2.forcing_bv,
                          tidal=cb2.tidal, device=dev)
    h2, hu2, hv2, c2 = perturbed_inputs(cb2, 256, n_cs, rng, dev)
    check_case(F, "coastal_K18_N2", fm2.ops, fm2.meta, h2, hu2, hv2,
               c2, cb2.prob.dt, spc, 1.0, False, flush, rng,
               rollout_atol=FWD_ATOL_N2_ROLLOUT)

    # ---- the main path ----
    wrappers = (F.sw2d_step_fused, F.sw2d_rollout_fused,
                F.sw2d_rollout_bwd_fused)
    solve = lambda fm_, cb_, iters: solve_mpc_fused(
        cb_.prob, fm_, cb_.states, cb_.targets, 2, iters=iters,
        learning_rate=cbx.LEARNING_RATE, H_rest=cb_.H_rest)
    solve(fm, cb, 2)  # warm-up (allocator, autograd)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    sol = solve(fm, cb, cbx.ITERS)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    plant = advance_plant_fused(prob, fm, cb.states, sol.controls[:, 0])
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}

    hist = sol.cost_history
    first, last = float(hist[0].mean()), float(sol.cost.mean())
    expect = {"sw2d_step_fused": spc, "sw2d_rollout_fused": cbx.ITERS + 1,
              "sw2d_rollout_bwd_fused": cbx.ITERS}
    # the plant after one control interval is the final rollout's state at
    # step spc: same arithmetic through the other kernel
    with torch.no_grad():
        th, thu, thv = fm.rollout(flat(cb.states.h), flat(cb.states.hu),
                                  flat(cb.states.hv), sol.controls.contiguous())
    plant_err = max_abs([flat(plant.h), flat(plant.hu), flat(plant.hv)],
                        [th[:, spc], thu[:, spc], thv[:, spc]])
    main_ok = (bool(torch.isfinite(hist).all())
               and bool(torch.isfinite(sol.cost).all())
               and bool(torch.isfinite(sol.controls).all())
               and tuple(sol.controls.shape) == (cbx.BATCH, n_cs, 2)
               and last < first and launches == expect
               and plant_err <= FWD_ATOL)
    say({"phase": "main_path", "ok": main_ok, "card": card,
         "batch": cbx.BATCH, "iters": cbx.ITERS, "n_steps": n_cs * spc,
         "mean_first_cost": first, "mean_final_cost": last,
         "launches": launches, "expected_launches": expect,
         "plant_vs_rollout_max_abs": plant_err, "seconds_per_solve": solve_s,
         "solves_per_second": cbx.BATCH / solve_s})
    if not main_ok:
        raise RuntimeError("main path failed its checks")

    profile_solve("profile", card, lambda: solve(fm, cb, cbx.ITERS), solve_s)

    # ---- the same solve through the plain versions, first 32 scenarios ----
    nb = 32
    cbs = cb._replace(states=SWState(*(f[:nb].contiguous() for f in cb.states)),
                      targets=cb.targets[:nb].contiguous())
    fm_plain = build_fused_mpc(prob, cb.forcing_bu, cb.forcing_bv,
                               tidal=cb.tidal, device=dev,
                               forward=F.sw2d_rollout_plain,
                               backward=F.sw2d_rollout_bwd_plain)
    before = {w.__name__: w.launches for w in wrappers}
    ref = solve(fm_plain, cbs, cbx.ITERS)
    torch.cuda.synchronize()
    if before != {w.__name__: w.launches for w in wrappers}:
        raise RuntimeError("the plain-version solve launched a kernel")
    ratio = sol.cost[:nb] / ref.cost
    rmin, rmax = float(ratio.min()), float(ratio.max())
    cross_ok = COST_RATIO[0] <= rmin and rmax <= COST_RATIO[1]
    say({"phase": "cross_check", "ok": cross_ok, "scenarios": nb,
         "cost_ratio_min": rmin, "cost_ratio_max": rmax,
         "tol": list(COST_RATIO)})
    if not cross_ok:
        raise RuntimeError("solve through the kernels disagrees with the "
                           "solve through the plain versions")

    # ---- the record ----
    src = "blitzdg_tpu_torch/ops/csrc/sw2d_dense.cu"
    replaces = {"sw2d_step_fused": "blitzdg_tpu/ops/sw2d_pallas.py:417",
                "sw2d_rollout_fused": "blitzdg_tpu/ops/sw2d_pallas.py:622",
                "sw2d_rollout_bwd_fused": "blitzdg_tpu/ops/sw2d_pallas.py:743"}
    kernels = []
    for name, rec in head.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "device_launches_per_call": 1})
    return kernels


# ---------------------------------------------------------------------------
# The blocked path
# ---------------------------------------------------------------------------

def entry_rel(xs, ys):
    """Every entry of every cotangent, relative to the largest entry of its
    reference: one flat tensor."""
    return torch.cat([((x - y).abs() / (y.abs().max() + 1e-30)).reshape(-1)
                      for x, y in zip(xs, ys)])


def check_blocked_case(TB, name, ops, meta, h, hu, hv, ctrls, dt, spc,
                       n_steps, t0, flush, rng, adjoint: bool = True,
                       timed: bool = False, fwd_atol: float = BLK_FWD_ATOL,
                       bwd_rtol: tuple = (BWD_RTOL_BULK, BWD_RTOL_MAX)):
    """Compare the three blocked kernels with their plain versions on one
    case: the step, the rollout with stored trajectory (and the controls, if
    any), the rollout without trajectory with and without controls, and the
    adjoint on the kernel's own trajectory. Returns the records by kernel
    (errors always, times and bounds if asked)."""
    B = h.shape[0]
    n_wall = int(ops.wall.sum())
    n_cs = 0 if ctrls is None else ctrls.shape[1]
    finite = lambda fs: all(bool(torch.isfinite(f).all()) for f in fs)
    out = {}

    def record(kernel, err, tol, ok, **more):
        rec = {"case": name, "kernel": kernel, "max_abs_err": err, "tol": tol,
               "ok": bool(ok), **more}
        out[kernel] = rec
        return rec

    # --- step ---
    c0 = None if ctrls is None else ctrls[:, 0].contiguous()
    step = lambda f: f(ops, meta, h, hu, hv, c0, dt, t0)
    got, ref = step(TB.sw2d_step_blocked), step(TB.sw2d_step_blocked_plain)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    rec = record("sw2d_step_blocked", err, fwd_atol,
                 finite(got) and err <= fwd_atol, grid_blocks=TB.last_grid())
    if timed:
        rec["ms"] = time_ms(lambda: step(TB.sw2d_step_blocked), 9, flush)
        rec["plain_ms"] = time_ms(lambda: step(TB.sw2d_step_blocked_plain),
                                  2, flush)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (6 * B * meta.n_v + B * meta.n_ctrl),
            B * 2 * rhs_flops(meta, n_wall))

    # --- rollout: stored trajectory; then no trajectory, with and without
    # the controls ---
    roll = lambda f, c, traj: f(ops, meta, h, hu, hv, c, dt, spc,
                                n_steps=None if c is not None else n_steps,
                                t0=t0, store_traj=traj)
    got = roll(TB.sw2d_rollout_blocked, ctrls, True)
    ref = roll(TB.sw2d_rollout_blocked_plain, ctrls, True)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    ok = finite(got) and err <= fwd_atol
    traj = tuple(f.contiguous() for f in got[:3])
    for c in ([ctrls, None] if ctrls is not None else [None]):
        g2 = roll(TB.sw2d_rollout_blocked, c, False)
        r2 = roll(TB.sw2d_rollout_blocked_plain, c, False)
        torch.cuda.synchronize()
        e2 = max_abs(g2, r2)
        err, ok = max(err, e2), ok and finite(g2) and e2 <= fwd_atol
    rec = record("sw2d_rollout_blocked", err, fwd_atol, ok, n_steps=n_steps)
    if timed:
        rec["ms"] = time_ms(
            lambda: roll(TB.sw2d_rollout_blocked, ctrls, True), 9, flush)
        rec["plain_ms"] = time_ms(
            lambda: roll(TB.sw2d_rollout_blocked_plain, ctrls, True), 2, flush)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (3 * B * meta.n_v + B * n_cs * meta.n_ctrl
                   + 3 * B * (n_steps + 1) * meta.n_v),
            B * n_steps * 2 * rhs_flops(meta, n_wall))

    # --- backward rollout, on the kernel's own trajectory ---
    if adjoint:
        tb = [torch.as_tensor(rng.standard_normal(tuple(traj[0].shape)),
                              dtype=torch.float32, device=h.device)
              for _ in range(3)]
        bwd = lambda f: f(ops, meta, *traj, *tb, ctrls, dt, spc, t0)
        gk = bwd(TB.sw2d_rollout_bwd_blocked)
        gp = bwd(TB.sw2d_rollout_bwd_blocked_plain)
        again = bwd(TB.sw2d_rollout_bwd_blocked)
        torch.cuda.synchronize()
        per = entry_rel(gk, gp)
        p99, worst = float(torch.quantile(per, 0.99)), float(per.max())
        same = all(torch.equal(a, b) for a, b in zip(gk, again))
        rec = record("sw2d_rollout_bwd_blocked", max_abs(gk, gp),
                     list(bwd_rtol),
                     finite(gk) and same and p99 <= bwd_rtol[0]
                     and worst <= bwd_rtol[1],
                     max_rel_err=worst, p99_rel_err=p99,
                     entries_above_bulk_tol=int((per > BWD_RTOL_BULK).sum()),
                     entries=per.numel(), same_bits_on_rerun=same)
        if timed:
            rec["ms"] = time_ms(lambda: bwd(TB.sw2d_rollout_bwd_blocked), 9,
                                flush)
            rec["plain_ms"] = time_ms(
                lambda: bwd(TB.sw2d_rollout_bwd_blocked_plain), 2, flush)
            rec["bound_ms"], rec["bound_by"] = bound(
                4.0 * (6 * B * (n_steps + 1) * meta.n_v
                       + 2 * B * n_cs * meta.n_ctrl + 3 * B * meta.n_v),
                B * n_steps * (rhs_flops(meta, n_wall)
                               + 2 * vjp_flops(meta, n_wall)))
    for r in out.values():
        say(r)
        if not r["ok"]:
            raise RuntimeError(f"kernel out of tolerance: {r}")
    return out


def perturbed_blocked(ctx, rest, B, n_cs, n_ctrl, rng, device,
                      ctrl_scale: float = 5.0):
    """Generic (B, nV) states near the rest depth ``rest`` ((nV,) tensor or
    number): per scenario a smooth bump of random height and place, a random
    uniform current, a little node-wise noise; and random controls."""
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                   device=device)
    col = lambda lo, hi: to(rng.uniform(lo, hi, (B, 1)))
    x, y = ctx.x.reshape(1, -1), ctx.y.reshape(1, -1)
    # bump centres in the middle half of the box, width scaled with the box
    cx = 0.5 * float(ctx.x.min() + ctx.x.max())
    cy = 0.5 * float(ctx.y.min() + ctx.y.max())
    half = 0.5 * float(ctx.x.max() - ctx.x.min())
    n_v = x.shape[1]
    bump = torch.exp(-10.0 / half ** 2
                     * ((x - cx - 0.5 * half * col(-1, 1)) ** 2
                        + (y - cy - 0.5 * half * col(-1, 1)) ** 2))
    h = rest + col(0.05, 0.3) * bump + to(0.01 * rng.standard_normal((B, n_v)))
    hu = col(-0.1, 0.1) * h + to(0.01 * rng.standard_normal((B, n_v)))
    hv = col(-0.1, 0.1) * h + to(0.01 * rng.standard_normal((B, n_v)))
    ctrls = to(ctrl_scale * rng.standard_normal((B, n_cs, n_ctrl)))
    return h.contiguous(), hu.contiguous(), hv.contiguous(), ctrls


def blocked_phases(dev, card: str, rng, flush) -> list:
    """The blocked path (large meshes): kernels against plain versions, the
    long rollouts, the MPC solves and their cross-check. Returns the kernel
    records of the ``kernels`` line."""
    from blitzdg_tpu_torch.context import BC_OUT
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mesh.gmsh import build_mesh
    from blitzdg_tpu_torch.mpc import (advance_plant_blocked,
                                       solve_mpc_blocked,
                                       solve_mpc_blocked_gn)
    from blitzdg_tpu_torch.mpc import blocked_box as bbx
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt, retag_east_open
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.parallel import rcm_order
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
    from blitzdg_tpu_torch.utils import build_sponge_coefficient

    f32 = torch.float32
    n_cs, spc = bbx.HORIZON, bbx.STEPS_PER_CONTROL
    n_steps = n_cs * spc
    t_set = time.perf_counter()
    box = bbx.blocked_box_problem(device=dev)  # the full configuration
    prob, bm = box.prob, box.bm
    ops, meta, dt = bm.ops, bm.meta, prob.dt
    flat = lambda f: f.reshape(f.shape[0], -1).contiguous()
    say({"phase": "blocked_setup", "seconds": time.perf_counter() - t_set,
         "k_elem": meta.k_elem, "n_p": meta.n_p, "dt": dt,
         "elements_per_block": TB.chunk_elems(meta)})

    # ---- kernels against their plain versions ----
    # the MPC shape: K=2048, N=3, B=8, 4 controls x 2 steps, flat bottom
    h, hu, hv, ctrls = perturbed_blocked(prob.ctx, bbx.H_REST, bbx.BATCH,
                                         n_cs, 2, rng, dev)
    cases = []

    def check(name, *a, **kw):
        cases.append(name)
        return check_blocked_case(TB, name, *a, **kw)

    head = check("blocked_K2048_N3", ops, meta, h, hu, hv, ctrls, dt, spc,
                 n_steps, 0.0, flush, rng, timed=True)
    # the exact start of the solves: rest state, zero controls
    check("blocked_K2048_N3_rest", ops, meta, flat(box.states.h),
          flat(box.states.hu), flat(box.states.hv), torch.zeros_like(ctrls),
          dt, spc, n_steps, 0.0, flush, rng,
          bwd_rtol=(BWD_RTOL_REST, BWD_RTOL_REST))
    # N=6 (28 nodes an element, 7 a face): 2 controls x 2 steps
    b6 = bbx.blocked_box_problem(n_order=6, horizon=2, device=dev)
    h6, hu6, hv6, c6 = perturbed_blocked(b6.prob.ctx, bbx.H_REST, bbx.BATCH,
                                         2, 2, rng, dev)
    check("blocked_K2048_N6", b6.bm.ops, b6.bm.meta, h6, hu6, hv6, c6,
          b6.prob.dt, spc, 2 * spc, 0.0, flush, rng, fwd_atol=BLK_FWD_ATOL_N6)
    del b6, h6, hu6, hv6, c6

    def context(mesh, n_order=2):
        return build_triangle_context(n_order, mesh, dtype=f32, device=dev,
                                      filter_cutoff=0.9 * n_order,
                                      filter_order=4)

    def injectors(ctx):
        xs, ys = ctx.x.double().cpu().numpy(), ctx.y.double().cpu().numpy()
        cx, cy = 0.5 * (xs.min() + xs.max()), 0.5 * (ys.min() + ys.max())
        bump = np.exp(-8.0 * ((xs - cx) ** 2 + (ys - cy) ** 2))
        return np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])

    # full coastal physics on a K=512, N=2 box: bathymetry with the
    # well-balanced star fluxes, drag, Coriolis, tidal depth on the open east
    # side, sponge toward it, stage times from t0 = 1
    mesh = box_triangles(16, 16)
    retag_east_open(mesh)
    cc = context(mesh)
    H = 10.0 + 2.0 * cc.x + torch.sin(2.0 * cc.y)
    open_nodes = (cc.bc_table[:, :, None].expand(-1, -1, cc.n_fp)
                  .reshape(cc.k_elem, -1) == BC_OUT).cpu().numpy()
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=2.0 * torch.ones_like(H), Hy=2.0 * torch.cos(2.0 * cc.y),
                     sponge=build_sponge_coefficient(cc, open_nodes, width=0.3,
                                                     strength=0.5))
    tidal = (12.0, 0.5, 2.0, 10.0)
    cops, cmeta = TB.build_blocked_step_ops(cc, phys, *injectors(cc),
                                            tidal=tidal, device=dev)
    if not (cmeta.wb and cmeta.has_bathy and cmeta.has_sponge
            and cmeta.cd and cmeta.f_cor and cmeta.tidal == tidal
            and int(cops.obc.sum()) > 0):
        raise RuntimeError("the coastal case does not switch every term on")
    hc, huc, hvc, c_c = perturbed_blocked(cc, H.reshape(1, -1), bbx.BATCH,
                                          n_cs, 2, rng, dev)
    check("blocked_coastal_K512_N2", cops, cmeta, hc, huc, hvc, c_c,
          cfl_dt(cc, 9.81, 13.5), spc, n_steps, 1.0, flush, rng)

    # wetting and drying, forward only: a sloping beach, dry beyond x = 2/3
    wc = context(box_triangles(16, 16, xlim=(0.0, 1.0), ylim=(0.0, 1.0)))
    Hb = 1.0 - 1.5 * wc.x
    h_floor = 1e-3
    wphys = SWPhysics(g=9.81, cd=1e-3, H=Hb, Hx=-1.5 * torch.ones_like(Hb),
                      Hy=torch.zeros_like(Hb), well_balanced=False)
    wops, wmeta = TB.build_blocked_step_ops(wc, wphys, wetdry=True,
                                            h_floor=h_floor, device=dev)
    scen = torch.arange(bbx.BATCH, dtype=f32, device=dev)[:, None]
    wave = 0.05 * torch.exp(-30.0 * ((wc.x - 0.45) ** 2
                                     + (wc.y - 0.5) ** 2)).reshape(1, -1)
    hw = torch.clamp_min(Hb.reshape(1, -1) + (1.0 + 0.2 * scen) * wave,
                         h_floor).contiguous()
    wet = (hw > 5.0 * h_floor).to(f32)
    noise = lambda: torch.as_tensor(rng.standard_normal(tuple(hw.shape)),
                                    dtype=f32, device=dev)
    huw = (wet * hw * (0.3 + 0.05 * noise())).contiguous()
    hvw = (wet * hw * 0.1 * noise()).contiguous()
    if not (bool((hw <= h_floor).any()) and bool((hw > 0.5).any())):
        raise RuntimeError("the beach has no dry or no wet region")
    check("blocked_wetdry_beach_K512_N2", wops, wmeta, hw, huw, hvw, None,
          cfl_dt(wc, 9.81, 1.1), 1, n_steps, 0.0, flush, rng, adjoint=False)

    # unstructured numbering: the elements of the box shuffled, then put in
    # reverse Cuthill-McKee order
    mesh = box_triangles(16, 16)
    perm = np.random.default_rng(3).permutation(mesh.num_elements)
    rmesh, _ = rcm_order(build_mesh(mesh.verts, mesh.etov[perm]))
    rc = context(rmesh)
    rops, rmeta = TB.build_blocked_step_ops(rc, SWPhysics(g=9.81),
                                            *injectors(rc), device=dev)
    hr, hur, hvr, c_r = perturbed_blocked(rc, bbx.H_REST, bbx.BATCH, n_cs, 2,
                                          rng, dev)
    check("blocked_rcm_shuffled_K512_N2", rops, rmeta, hr, hur, hvr, c_r,
          cfl_dt(rc, 9.81, 11.0), spc, n_steps, 0.0, flush, rng)

    say({"phase": "blocked_kernels", "ok": True, "cases": cases})

    # ---- the long forward rollouts ----
    for n_order in (3, 6):
        r = bbx.blocked_rollout_problem(n_order=n_order, device=dev)
        run = lambda: TB.sw2d_rollout_blocked(r.ops, r.meta, *r.states, None,
                                              r.dt, n_steps=r.n_steps)
        end = run()
        torch.cuda.synchronize()
        grid = TB.last_grid()
        ms = time_ms(run, 5, flush)
        B = r.states.h.shape[0]
        flops = TB.matmul_flops_per_step(r.meta) * B * r.n_steps
        ok = (all(bool(torch.isfinite(f).all()) for f in end)
              and 9.0 < float(end[0].min()) and float(end[0].max()) < 12.0)
        # what the barriers alone cost at this grid
        nb = 2 * r.n_steps
        t_many = time_ms(lambda: TB.barrier_probe(nb + 1, grid, dev), 5, flush)
        t_one = time_ms(lambda: TB.barrier_probe(1, grid, dev), 5, flush)
        say({"phase": "blocked_rollout", "ok": ok, "card": card,
             "n_order": n_order, "k_elem": r.meta.k_elem, "batch": B,
             "n_steps": r.n_steps, "dt": r.dt, "ms": ms,
             "us_per_step": ms * 1e3 / r.n_steps,
             "us_per_step_per_scenario": ms * 1e3 / r.n_steps / B,
             "matmul_flops_per_step": TB.matmul_flops_per_step(r.meta),
             "matmul_gflops_per_s": flops / (ms * 1e-3) / 1e9,
             "grid_blocks": grid, "work_units": B * -(-r.meta.k_elem //
                                                     TB.chunk_elems(r.meta)),
             "us_per_grid_barrier": (t_many - t_one) * 1e3 / nb,
             "barriers_share_of_step": (t_many - t_one) / ms,
             "h_min": float(end[0].min()), "h_max": float(end[0].max())})
        if not ok:
            raise RuntimeError("the long blocked rollout left its bounds")
        del r, end

    # ---- the main path: Adam solve, Gauss-Newton solve, plant advance ----
    wrappers = (TB.sw2d_step_blocked, TB.sw2d_rollout_blocked,
                TB.sw2d_rollout_bwd_blocked)
    adam = lambda b, iters: solve_mpc_blocked(
        b.prob, b.bm, b.states, b.targets, 2, iters=iters,
        learning_rate=bbx.LEARNING_RATE, H_rest=bbx.H_REST)
    gauss_newton = lambda b, fd_eps: solve_mpc_blocked_gn(
        b.prob, b.bm, b.states, b.targets, 2, gn_iters=bbx.GN_ITERS,
        cg_iters=bbx.CG_ITERS, fd_eps=fd_eps, H_rest=bbx.H_REST)
    # warm-up: allocator, autograd (its first gradient with given cotangents
    # imports a symbolic-shapes module, seconds on the host)
    adam(box, 1)
    gauss_newton(box, bbx.FD_EPS)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    sol = adam(box, bbx.ADAM_ITERS)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gn = gauss_newton(box, bbx.FD_EPS)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    gn_wide = gauss_newton(box, bbx.FD_EPS_FLOAT32)
    plant = advance_plant_blocked(prob, bm, box.states, sol.controls[:, 0])
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}

    # Adam: one rollout and one adjoint per iteration, one more of each for
    # the gradient norm. Gauss-Newton, per outer iteration: the linearization
    # (1 rollout), J^T r (1 adjoint), the curvature probe (1 rollout), per
    # CG step one difference rollout and one adjoint, the trial point
    # (1 rollout); one rollout and one adjoint at the end.
    gi, ci = bbx.GN_ITERS, bbx.CG_ITERS
    # Gauss-Newton runs twice (two difference steps).
    expect = {"sw2d_step_blocked": spc,
              "sw2d_rollout_blocked": bbx.ADAM_ITERS + 1
              + 2 * (gi * (3 + ci) + 1),
              "sw2d_rollout_bwd_blocked": bbx.ADAM_ITERS + 1
              + 2 * (gi * (1 + ci) + 1)}
    with torch.no_grad():
        th, thu, thv = bm.rollout(flat(box.states.h), flat(box.states.hu),
                                  flat(box.states.hv), sol.controls.contiguous())
    plant_err = max_abs([flat(plant.h), flat(plant.hu), flat(plant.hv)],
                        [th[:, spc], thu[:, spc], thv[:, spc]])
    decrease = float((sol.cost_history[0] / sol.cost).median())
    finite = lambda *ts: all(bool(torch.isfinite(t).all()) for t in ts)
    gn_first, gn_last = float(gn.cost_history[0].mean()), float(gn.cost.mean())
    gn_wide_first = float(gn_wide.cost_history[0].mean())
    gn_wide_last = float(gn_wide.cost.mean())
    path_ok = (finite(sol.cost_history, sol.cost, sol.controls, sol.grad_norm,
                      gn.cost_history, gn.cost, gn.controls, gn.grad_norm,
                      gn_wide.cost, gn_wide.controls, gn_wide.grad_norm)
               and tuple(sol.controls.shape) == (bbx.BATCH, n_cs, 2)
               and decrease > ADAM_MIN_DECREASE
               and bool((gn.cost <= gn.cost_history[0]).all())
               and gn_wide_last < gn_wide_first
               and launches == expect and plant_err <= BLK_FWD_ATOL)
    say({"phase": "blocked_path", "ok": path_ok, "card": card,
         "batch": bbx.BATCH, "k_elem": meta.k_elem, "n_order": bbx.N_ORDER,
         "n_steps": n_steps, "adam_iters": bbx.ADAM_ITERS,
         "adam_first_cost": float(sol.cost_history[0].median()),
         "adam_final_cost": float(sol.cost.median()),
         "adam_cost_decrease": decrease, "min_decrease": ADAM_MIN_DECREASE,
         "adam_grad_norm": float(sol.grad_norm.median()),
         "adam_seconds_per_solve": adam_s,
         "adam_scenario_solves_per_second": bbx.BATCH / adam_s,
         "gn_first_cost": gn_first, "gn_final_cost": gn_last,
         "gn_grad_norm": float(gn.grad_norm.median()),
         "gn_seconds_per_solve": gn_s, "gn_fd_eps": bbx.FD_EPS,
         "gn_wide_fd_eps": bbx.FD_EPS_FLOAT32,
         "gn_wide_first_cost": gn_wide_first,
         "gn_wide_final_cost": gn_wide_last,
         "gn_wide_final_cost_vs_adam": float((gn_wide.cost / sol.cost)
                                             .median()),
         "gn_wide_grad_norm": float(gn_wide.grad_norm.median()),
         "launches": launches, "expected_launches": expect,
         "plant_vs_rollout_max_abs": plant_err})
    if not path_ok:
        raise RuntimeError("blocked path failed its checks")

    profile_solve("blocked_profile", card,
                  lambda: adam(box, bbx.ADAM_ITERS), adam_s)

    # ---- the same Adam solve through the plain versions on the card ----
    # (the same problem: the kernel path's targets, not the plain path's own)
    box_plain = bbx.blocked_box_problem(
        device=dev, forward=TB.sw2d_rollout_blocked_plain,
        backward=TB.sw2d_rollout_bwd_blocked_plain)
    target_diff = float((box.targets - box_plain.targets).abs().max())
    box_plain = box_plain._replace(targets=box.targets)
    before = {w.__name__: w.launches for w in wrappers}
    ref = adam(box_plain, bbx.ADAM_ITERS)
    torch.cuda.synchronize()
    if before != {w.__name__: w.launches for w in wrappers}:
        raise RuntimeError("the plain-version solve launched a kernel")
    ratio = sol.cost / ref.cost
    rmin, rmax = float(ratio.min()), float(ratio.max())
    cross_ok = BLK_COST_RATIO[0] <= rmin and rmax <= BLK_COST_RATIO[1]
    say({"phase": "blocked_cross_check", "ok": cross_ok,
         "scenarios": bbx.BATCH, "cost_ratio_min": rmin,
         "cost_ratio_max": rmax, "tol": list(BLK_COST_RATIO),
         "own_targets_max_abs_diff": target_diff})
    if not cross_ok:
        raise RuntimeError("blocked solve through the kernels disagrees with "
                           "the solve through the plain versions")

    # ---- the record ----
    src = "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu"
    replaces = {
        "sw2d_step_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:1288",
        "sw2d_rollout_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:1352",
        "sw2d_rollout_bwd_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:1491"}
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             "device_launches_per_call": TB.DEVICE_LAUNCHES_PER_CALL}
            for name, rec in head.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("dense", "blocked"),
                    help="run one path's phases alone (default: both)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1

    from blitzdg_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the port needs full float32")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # ---- build ----
    t0 = time.perf_counter()
    _build.build_all()
    say({"phase": "build", "seconds": time.perf_counter() - t0,
         "ptxas": [ln for log in _build.last_build_log.values()
                   for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln][:16]})

    rng = np.random.default_rng(0)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = lambda: scratch.zero_()  # 256 MB written: empties the 50 MB L2

    kernels = []
    if args.only in (None, "dense"):
        kernels += dense_phases(dev, card, rng, flush)
    if args.only in (None, "blocked"):
        kernels += blocked_phases(dev, card, rng, flush)

    say({"phase": "total", "seconds": time.perf_counter() - t_start})
    say({"kernels": kernels})
    print(card, flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
