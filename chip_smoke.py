#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

(``--only dense``, ``--only blocked``, ``--only curved``, ``--only
sharded``, ``--only peer``, ``--only ranks``, ``--only elliptic``, ``--only
solver``, ``--only quads``, ``--only ins2d``, ``--only dg1d``, ``--only
halo``, ``--only compat`` or ``--only halo_ranks`` runs one path's phases
alone, for work on that path.) What it does, in order (any failure is an exception and a non-zero
exit):

 1. refuses to run without a CUDA device;
 2. builds the CUDA kernels of ``blitzdg_tpu_torch/ops/csrc`` with nvcc and
    prints what ptxas reports (registers, stack, spills) of the curved,
    dense and sharded kernels and their static SASS mix (a library built by
    an earlier run keeps its report beside it); it fails at the end of the
    run if any instantiation of a curved rollout kernel, a dense kernel,
    the blocked rollout (the step's kernel too) and its adjoint, the
    sharded stage, its adjoint and the one-launch step kernel, or the
    step's peer mode and the step-boundary exchange, or the stage ring's
    exchange and sum, or the halo ring's maximum and float64 sum (of the
    paths run) spills or has no report;
 3. DENSE path (small meshes, one thread per element and scenario). Holds
    each kernel (``sw2d_step_fused``, ``sw2d_rollout_fused``,
    ``sw2d_rollout_bwd_fused``) against its plain PyTorch version on the
    card, at the headline shape (B=2048 scenarios, K=40 triangles, N=1, 32
    SSP-RK2 steps, coastal physics, float32), from its exact rest start,
    and on a flat-bottom and an N=2 case (tolerances: see the constants
    below; the adjoint also gives the same bits on a rerun), and times
    kernel and plain version with CUDA events. Then drives the main path:
    the full headline coastal MPC solve (20 Adam iterations over the fused
    rollout and its adjoint) through
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
    shuffled, RCM-reordered mesh, each kernel the same bits on a rerun and
    the rollout's trajectory bit-equal to the step launched for each step
    in turn; ``blocked_rollout`` times the 2048-step rollout at N=3 and N=6
    and one grid barrier, with the launch plan; ``blocked_path`` drives
    ``solve_mpc_blocked`` (5 Adam iterations), ``solve_mpc_blocked_gn``
    (2 x 2) and ``advance_plant_blocked`` at the full configuration of
    ``mpc/blocked_box.py`` with the launch counters zeroed just before and
    read just after; ``blocked_cross_check`` repeats the Adam solve through
    the plain versions on the card;
 5. CURVED path (Gordon-Hall deformed disk, cubature volume and Gauss face
    integrals, four fields): ``curved_kernels`` holds
    ``sw2d_curved_step_blocked``, ``sw2d_curved_rollout_blocked`` and
    ``sw2d_curved_rollout_bwd_blocked`` against their plain versions over 8
    steps at N=3 on the large disk (K=1014, B=32; perturbed, and from the
    exact rest start with a cotangent on the depth alone), on the small disk
    (K=54, B=256, and B=5: a ragged scenario tile), at N=2 (K=96) and on a
    straight box in the 'affine' mass mode with drag, Coriolis and bed
    slope, each record with its grid and work units; ``curved_path`` drives
    ``solve_mpc_curved_blocked`` (5 Adam iterations) on both disks,
    ``solve_mpc_curved_blocked_gn`` (2 x 2) over a sweep of difference steps
    and ``advance_plant_curved_blocked`` at the full configurations of
    ``mpc/curved_disk.py``, counters zeroed just before and read just
    after; ``curved_cross_check`` solves the same problems through
    ``solve_mpc`` with ``rhs_fn = sw2d_curved_rhs`` (plain tensor code) and
    compares the final costs per scenario;
 6. SHARDED path (the mesh partitioned into element shards, all stacked on
    the card, the halo moved between the RK stages by the ring exchange):
    ``sharded_kernels`` holds ``sw2d_stage_blocked`` and
    ``sw2d_stage_bwd_blocked_v2`` against their plain versions at K=2048,
    N=3, S=4 shards, B=8, with controls, on a perturbed state (both stages
    of a step), on a coastal case (bathymetry, well-balancing, drag,
    Coriolis, tidal open boundary, sponge, t0=1), forward only on a wet/dry
    beach and at N=6 (the highest order they take), and at the two shapes
    of the main path: full width at B=1 and the example's size (K=128, N=1,
    S=8, B=1), where it times the adjoint too; it holds the one-launch step
    kernel
    ``sw2d_step_rdma_blocked`` against its plain version (reruns it for the
    same bits, and holds it bit-equal to two stage launches with the
    exchange between) at K=2048, N=3 with controls at S=4 and S=1, each at
    B=8 and B=1, at the example's size, on the coastal case and at N=6, and
    times in CUDA graphs the step, its two stage launches and the exchange
    gather between them;
    ``sharded_rollout`` runs the 2048-step rollout at S=1 and S=4, B=1 and
    B=8, with its device idle share, and holds the first 8 S=4 steps
    against the unsharded blocked rollout; ``sharded_rollout_rdma`` runs
    each of them again through the one-launch step (counters zeroed just
    before and read just after: one step kernel a step, no stage kernel),
    with its idle share, holds its end state against the fused rollout's
    after all 2048 steps and the first 8 S=4, B=8 steps against the fused
    rollout's; ``sharded_rollout_graph`` captures each rollout, through
    either step, into one CUDA graph (``capture_sharded_rollout``) and
    replays it: its end state bit-equal to the per-step loop's (the replays
    made after memory of the sizes of what the graph reads outside its pool
    was taken and filled with NaN), its time a step, the capture's time and
    the idle share of a profiled replay;
    ``sharded_path`` drives
    ``solve_sharded_mpc`` (30 Adam iterations) at the example's size and at
    full width (``mpc/sharded_box.py``), counters zeroed just before and
    read just after, and holds the full-width control gradient against the
    blocked path's; ``sharded_cross_check`` repeats the full-width solve
    through the plain versions on the card and reads the rounding floor
    (the cost through the plain versions at the hidden and at the final
    controls);
 7. PEER path (the one-launch step across ranks, one process a shard):
    ``peer_S4``, ``peer_S2`` and ``peer_S4_delayed_rank`` start S worker
    processes of this script (``--peer-worker``, each with its own
    timeout, always ended), each on the one card in a gloo group, holding
    one shard of the coastal K=2048, N=3 set at B=8 (as
    ``rdma_coastal_K2048_N3_S4``) and a ``PeerRing`` (its region mapped
    into its ring peers by CUDA IPC); each runs 64 steps of
    ``make_sharded_blocked_step_rdma(sb, dt, group=g)`` (the step's peer
    mode, which stores its send buffer into the peers' step-boundary slots
    itself, and before the first step the exchange ``peer_ring_exchange``
    of the initial send buffer; counters zeroed just before and read just
    after: 64 and 1 a rank, no stage kernel), rank 2 of the last case
    sleeping 0.5 s before every 8th step. Every rank's end state and send
    buffer must be bit-equal to its shard of the stacked one-launch rollout
    run here, its first step within BLK_FWD_ATOL of the plain version, its
    last step-boundary slots (its peers' last send buffers) bit-equal to
    the stacked gather and to the group's plain exchange (gloo, CPU
    copies); no worker may fail or trap. Records the card's compute mode
    and whether MPS runs (without it the processes time-slice the card:
    the wall time a step measures the slices), and, in ``peer_S4``, each
    rank's step kernel and exchange alone (the other ranks idle at a
    barrier, its flags set past any epoch), CUDA events, L2 flushed. Then
    ``peer_S4_in_process``: the four ranks in this process on four streams
    (``PeerRing.over_regions``), their kernels running at the same time,
    bit-equal to the stacked rollout, and their host-clocked us a step;
    ``peer_S4_fresh_process``: the same ranks' first PEER_FRESH_STEPS
    steps in a fresh process of this script (``--peer-fresh``, lazy module
    loading) that launches no kernel of the port before them, a rank held
    back at each step: the ring loads its own kernels, so none traps, and
    the end states are bit-equal to the stacked rollout's; and
    ``peer_S4_in_process_long``: the four ranks over 2048 steps (an eighth
    of the set's dt, a time where the state stays finite: 0.57 of the
    time at which the set's state stops being finite, in the JAX package's
    plain step as in the port's, ROADMAP C31), at every step one rank
    drawn from the seed held back on its stream, each rank's state, send
    buffer and stage-2 receive slots bit-equal to the stacked rollout's
    after every step;
 8. RANKS path (the sharded MPC one shard a rank, ``sharded_mpc_problem(
    rank=r)``: each rank builds its own shard, computes the target with the
    ranks' fused step and runs Adam over its part of the cost; the stages'
    exchanges, their reverses and the sums over ranks through a
    ``parallel.StageRing``, device memory the ranks map into each other):
    builds the stacked problems and solves at both sizes as references;
    ``stage_ring_kernels`` holds the ring's exchange, its reverse and its
    sum (``ops/csrc/peer.cu``) bit-equal to their plain versions (the
    stacked gather of every rank's buffer, the rank-order sum) at the main
    path's shapes, four ranks on four streams, and times each of rank 0's
    alone (its flags set past any epoch: events, and its device time, a
    launch of a CUDA graph of 50); ``stage_peer_kernels`` holds the
    stage's and its adjoint's peer modes (the exchange and its reverse
    folded into their launches) bit-equal to B7 and B8 launched on each
    rank's shard with the stacked exchange and its reverse between them,
    four ranks on four streams, and times rank 0's alone;
    ``sharded_mpc_S4_in_process``
    runs the 4 ranks of the full width on threads and streams of this
    process, and ``sharded_mpc_example_S8_in_process`` the example's 8
    (each rank first alone over a ring whose flags read past any epoch,
    ``parallel.peer.warm_ranks``, so that every kernel is loaded before
    the ranks meet; then the port's guard: the ranks' hosts meet before
    each launch of a ring kernel, ``meet=`` of the rings, and each rank's
    step waits for its stream at each rollout's start);
    ``sharded_mpc_S4_ranks`` starts 4 worker processes of this script
    (``--ranks-worker``, gloo group, CUDA IPC regions, each with its own
    timeout, all ended once one fails) at full width. Each rank: its
    problem, the gradient at zero controls, the 30-iteration solve
    (timed), counters zeroed just before and read just after; every rank's
    target bit-equal to its shard of the stacked target, its gradient
    within SHD_GRAD_RTOL of the stacked diff step's, its controls, cost
    history and final cost bit-equal to every other rank's, the final cost
    within COST_RATIO of the stacked solve's and below the first cost (the
    example: below SHD_EXAMPLE_RATIO of it), the launches exact; then a
    5-iteration solve profiled for the idle share (the union of the
    kernels' intervals against the host clock, with and without the
    ring's kernels, whose time is mostly waits at flags);
 9. ELLIPTIC path (no kernel of its own: plain tensor code): the JAX
    benchmark's Poisson configuration, N=2, float32, on
    ``box_triangles(23, 23)`` (K=1058; the benchmark's box.msh, K=1046, is
    not in the repository). ``elliptic_setup`` builds the context,
    assembles the SIP operator in float64 on the host, block-Jacobi from it
    and the two-level preconditioner; ``elliptic_gmres`` runs
    block-Jacobi GMRES(300) on the symmetrized matrix-free operator
    (restarts, relres, flag, Arnoldi steps and the modified Gram-Schmidt
    launch cost); ``elliptic_cg_batched`` 64 right-hand sides at once
    through block-Jacobi CG (per-RHS iterations, relres); and
    ``elliptic_cg_twolevel`` one right-hand side through the two-level CG
    beside block-Jacobi CG. Every solution is held to a float64 splu solve
    of the assembled operator; no flag may be inf/nan or diverged. For
    information it profiles 50 iterations of the batched CG (device events
    only: the idle share);
10. SOLVER path: ``solve_mpc_gn`` (Gauss-Newton, 2 outer x 8 CG
    iterations) and ``receding_horizon`` (2 cycles of 5 Adam iterations)
    at the headline shape (B=2048, K=40, N=1, 8 x 4 steps) over the plain
    composite (``MPCProblem.rhs_fn`` = ``sw2d_rhs`` with the tidal depth),
    counters zeroed just before and read just after (no kernel launches
    there). Each scenario's cost history must not rise; GN's final cost
    through ``mpc_cost_fused`` (B2) must equal the composite's per
    scenario within COST_RATIO; each receding-horizon cycle's plant state
    must equal ``advance_plant_fused`` (B1) from the cycle's control at
    t0 = 0 within FWD_ATOL. For information it profiles one Gauss-Newton CG
    step (a J v and a pullback at B=2048, device events only);
11. QUADS path (quadrilateral elements): ``quads_sw2d`` runs
    ``examples/sw2dquads.py``'s configuration (``box_quads(12, 12)``, K=144,
    N=4, filter 0.9 N of order 4, CFL 0.5, float32, 10 chunks of 100
    adaptive SSP-RK2 steps of ``sw2d_rhs``; mass drift below 1e-5, the
    first chunk against the port's CPU float64 run, idle share);
    ``quads_kernels`` holds B4, B5 and B6 (2 x 2 steps with controls) on
    the same mesh with coastal physics at B=8 against their plain
    versions, the same bits on a rerun and B4 step by step bit-equal to
    B5's rows, and B7, B8 and B9 on that mesh partitioned into 4 shards
    (B9 bit-equal to two B7 launches with the exchange between), each
    timed, and checks that every q kernel refuses a quad set at N=5 and
    that B4-B9 take eight lanes an element (their N=4 instance);
    ``quads_path`` drives the example's problem at B=8 through B5 (10
    launches of 100 steps) and B4 (10 launches), each scenario's mass
    drift below 1e-5, the first launch against the plain version in
    float64; a blocked Adam solve on the quad mesh (5 iterations, B5 and
    B6), whose final cost ``quads_cross_check`` holds to the same solve
    through the plain versions on the card within COST_RATIO; and 8
    sharded steps on the partitioned mesh through the fused (B7), the
    one-launch (B9) and the differentiable step (B7, B8), bit-equal to one
    another, against the unsharded blocked rollout and its adjoint's
    gradient; counters zeroed just before and read just after; for
    information the Adam solve's and the sharded steps' device time by
    kernel and idle share (``quads_adam_profile``,
    ``quads_sharded_profile``); ``peer_quads_S4_in_process``: B9's peer
    mode on the partitioned mesh, its four ranks in this process on four
    streams (as ``peer_S4_in_process``), 64 steps from the sharded state
    above, counters zeroed just before and read just after: every rank's
    end state, send buffer and step-boundary slots bit-equal to its shard
    of the stacked one-launch rollout, every state finite; then rank 0's
    step alone (its flags set past any epoch), timed; the N=4 instances of
    B4-B9 (B9 in both modes) and the run-time-size ones of B4-B9 must not
    spill;
12. INS2D path (plain tensor code): ``examples/ins2d.py`` at
    ``examples/ins2d.nml`` read by the port's ``read_namelist`` (K=36
    quads, N=2, dt 2e-3, 100 steps, float32): fields finite, max|u| <= 1,
    every projection lowering the L2 norm of div u, the kinetic energy
    against the port's CPU float64 run; CG iterations a step, ms a step,
    the idle share of 5 profiled steps;
13. DG1D path (plain tensor code): ``examples/advec1d.py`` (N=4, K=30,
    c=0.1, CFL 0.8, T=20) and ``examples/burgers1d.py`` (N=6, K=40, nu=0.1)
    through ``integrate(lserk4_step)`` in float32, max-norm errors against
    the exact solutions at the JAX tests' bounds, ms a step;
14. HALO path (``parallel/halo.py``, plain tensor code, every shard stacked
    on the card): ``halo_rhs_rollout`` holds ``halo_sw2d_rhs`` on
    ``box_triangles(32, 32)`` (K=2048, N=3) at S = 1, 2, 4 to ``sw2d_rhs``
    (a bfloat16 halo's gap reported) and runs
    ``examples/scaling_study.py --mode xla``'s 100 SSP-RK2 steps at dt
    1e-4, its µs a step and idle share, its end state against the
    unsharded rollout; ``halo_coastal_adaptive_dt`` a 10-step coastal
    rollout with ``halo_sw2d_timestep`` at S=4; ``halo_curved``
    ``halo_sw2d_curved_rhs`` on the large Gordon-Hall disk (K=1014, N=3)
    at S = 2, 6 against ``sw2d_curved_rhs``; ``halo_elliptic`` the CG of
    ``TestShardedElliptic`` on the elliptic configuration padded to S=4
    against the unsharded CG (iterations and solution);
15. COMPAT path (``compat.py``): the reference's advec1d numpy script
    through ``Nodes1DProvisioner`` and its poisson2d pattern through
    ``MeshManager``, ``TriangleNodesProvisioner`` (its context on the
    card) and ``Poisson2DSparseMatrix``, solved with scipy and held to
    sin(pi x) sin(pi y);
16. HALO RANKS path (``parallel/halo.py`` one shard a rank over a
    ``parallel.HaloRing``, device memory the ranks map into each other;
    the Krylov dots through its sum): ``halo_ring_kernels`` holds the
    face-row exchange, its reverse (float32, float64, bfloat16), the
    maximum (float32, float64) and the float64 sum (``ops/csrc/peer.cu``)
    bit-equal to their plain versions (the stacked roll of each offset's
    rows, the rank-order maximum and sum) at the scaling study's S=4
    shapes, four ranks on four streams, and times each of rank 0's alone
    (its flags set past any epoch: events, and its device time, a launch
    of a CUDA graph of 50); ``halo_rhs_S2_ranks_in_process`` and
    ``halo_rhs_S4_ranks_in_process`` run ``examples/scaling_study.py
    --mode xla``'s RHS and 100-step rollout (K=2048, N=3) with full and
    bfloat16 halos, the ranks on threads and streams of this process (each
    rank first alone over a ring whose flags read past any epoch, which
    loads every kernel the program launches; the hosts meet before each
    ring launch), at S=4 also the RHS gradient
    through the reverse exchange, with the idle share of a 20-step window
    with and without the ring's kernels; ``halo_rhs_S4_ranks`` the same in
    4 worker processes of this script (``--halo-worker``, gloo group, CUDA
    IPC regions), 20 steps; ``halo_coastal_adaptive_dt_ranks`` 10 coastal
    steps with ``halo_sw2d_timestep`` at S=4; ``halo_curved_ranks`` the
    large disk's curved RHS at S = 2, 6 ranks; ``halo_elliptic_ranks`` CG
    and GMRES on the float64 elliptic configuration padded to S=4. Each is
    held to the stacked transport run here (the gates: beside
    HALO_RANKS_SHARDS below), counters zeroed just before and read just
    after;
17. prints one JSON line per phase, the ``{"kernels": [...]}`` line, the
    card's name and power limit, and as the last line
    ``{"ok": true, "device": {...}}``.

Bounds: ``bound_ms`` is the larger of (bytes each input is read once and
each output written once) / 3.35 TB/s and (float32 operations of the
function, counted from the shapes by the formulas below) / 67 TFLOP/s, the
published peaks of one H100 SXM.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

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

# Curved kernels, forward, states near 1 (one ulp: 1.2e-7): held to 1e-5
# over 8 steps, the blocked path's 5e-5 at states near 10 scaled to the
# state; the adjoint is held per entry like the blocked one.
CRV_FWD_ATOL = 1e-5
# Final cost of a curved Adam solve, kernels vs ``solve_mpc`` over the plain
# curved RHS, per scenario (the JAX benchmark's own cross-check is this
# ratio's median against 0.999).
CRV_COST_RATIO = (0.999, 1.001)
# Difference steps of the curved Gauss-Newton solve that the path tries
# after the solver's default (``curved_disk.FD_EPS``).
CRV_FD_EPS_WIDER = (1e-2, 1e-1, 1.0)
# the kernels' units hold up to 4 scenarios: 5 leaves a ragged tile of one
CRV_RAGGED_BATCH = 5

# Sharded path: the stage kernels are held to the blocked tolerances
# (BLK_FWD_ATOL; the adjoint per entry, BWD_RTOL_BULK / BWD_RTOL_MAX). The
# S=4 rollout is held to the unsharded blocked rollout over its first
# SHD_CHECK_STEPS steps at BLK_FWD_ATOL. The example-size MPC must end below
# SHD_EXAMPLE_RATIO of its first cost (the JAX example's own assertion); the
# full-width control gradient must equal the blocked path's (whose kernels
# share the stage arithmetic) per entry within SHD_GRAD_RTOL of its largest
# entry.
SHD_CHECK_STEPS = 8
SHD_EXAMPLE_RATIO = 0.05
SHD_GRAD_RTOL = 1e-4
# Final cost of the full-width sharded Adam solve, kernels vs plain versions.
# Wider than COST_RATIO: the solve ends at 0.65 % of its first cost, near the
# float32 rounding of the state, which kernel and plain version round
# differently. ``sharded_cross_check`` reads it each run (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md, sharded path): at the hidden controls the plain
# versions miss the kernels' target by a cost of 0.0036 of the final cost
# (the rounding floor), at the kernels' final controls the two costs differ
# by a ratio of 1.0068, and the two solves end at a ratio of 1.0040. The
# bound is twice the larger deviation, 0.0068.
SHD_COST_RATIO = (0.986, 1.014)
# Steps of the profiled window of each sharded rollout (the idle share).
SHD_PROFILE_STEPS = 256

# Elliptic path: the JAX benchmark's Poisson configuration (box.msh, K=1046,
# N=2) on box_triangles(23, 23), K=1058 (box.msh is not in the repository):
# GMRES(300) and CG at tol 2e-4 (the float32 floor of this operator), 64
# right-hand sides for the batched CG, every solution within 5e-3 of a
# float64 splu solve of the assembled operator (the benchmark's own gate).
ELL_CELLS = 23
ELL_ORDER = 2
ELL_TOL = 2e-4
ELL_RESTART = 300
ELL_GMRES_MAXITER = 5
ELL_NB = 64
ELL_CG_MAXITER = 600
ELL_SPLU_ATOL = 5e-3
ELL_PROFILE_ITERS = 50
# MPC solvers over the plain composite at the headline shape: Gauss-Newton
# cut from the JAX default of 5 outer iterations to 2 (8 CG steps each, the
# default), receding horizon 2 cycles of 5 Adam iterations. The plant is
# held to the dense forward tolerance FWD_ATOL, GN's cost through the B2
# kernel to COST_RATIO.
GN_ITERS = 2
GN_CG_ITERS = 8
RH_CYCLES = 2
RH_ITERS = 5

# Quadrilaterals: examples/sw2dquads.py's configuration (box_quads(12, 12),
# K=144, N=4, filter cutoff 0.9 N of order 4, CFL 0.5, flat bottom, walls,
# a Gaussian bump) in float32, 10 chunks of 100 adaptive steps; its own
# gate, mass drift below 1e-5; its first chunk against the port's CPU
# float64 run at 1e-4 on h ~ 10 (float32 against float64 on the CPU:
# 1.1e-5 after 100 steps). B4/B5 on the same mesh with coastal physics at
# B=8, held to the plain versions at the blocked tolerance (BLK_FWD_ATOL:
# the forward takes a face's maximum, which has no tie rule); the path
# through them is the example's problem, B=8 bump heights, at the
# example's first time step (the kernels take a fixed step), 10 launches of
# 100 steps of B5 and 10 of B4, each scenario's mass drift below 1e-5, the
# first launch within 2e-4 of the plain version in float64 (100 float32
# steps of h ~ 11: the plain version in float32 drifts 8.1e-5 from float64
# there, the kernel compiled for the CPU behind the test shim 9.0e-5).
QD_CELLS = (12, 12)
QD_ORDER = 4
QD_CFL = 0.5
QD_CHUNKS, QD_CHUNK_STEPS = 10, 100
QD_MASS_DRIFT = 1e-5
QD_CPU_ATOL = 1e-4
QD_BATCH = 8
QD_STEPS = 10
QD_PATH_ATOL = 2e-4
# B6-B9 on quads: the sharded kernels on box_quads(12, 12) with the east
# side open, partitioned into QD_SHARDS, coastal physics, two controls, at
# the blocked and sharded tolerances. The quad Adam solve (B5, B6) is the
# blocked MPC of mpc/blocked_box.py on the example's quad mesh, its hidden
# controls QD_HIDDEN (scenario b scaled by 1 + b/10) and its learning rate
# QD_LR: blocked_box's 30 and 6 scaled by 100, which scales Adam's iterates
# by 100 and leaves its relative decrease as it is (the dynamics are linear
# in the controls at this size), so that the tracking error stands far
# above the float32 rounding of h ~ 10 (at 30 the error is some 30 ulp of
# h, and float32 and float64 plain solves end at cost ratios 0.9988-1.008
# on the CPU; at 3000 at 0.99999-1.00001). Its final cost is held to the
# same solve through the plain versions within COST_RATIO. The sharded
# steps drive QD_SHARD_STEPS steps: the fused and the one-launch rollouts
# bit for bit, against the unsharded blocked rollout on the same mesh at
# BLK_FWD_ATOL, and the differentiable steps' gradient of the end depth
# against the blocked rollout adjoint's within SHD_GRAD_RTOL.
QD_SHARDS = 4
QD_HIDDEN = 3000.0
QD_LR = 600.0
QD_ADAM_ITERS = 5
QD_SHARD_STEPS = 8
# ins2d: examples/ins2d.py at examples/ins2d.nml (N=2, filter 1.5 of order
# 4, T=0.2), box_quads(6, 6) (K=36), dt 2e-3: 100 steps in float32. The
# kinetic energy at the end against the port's CPU float64 run, relative
# 1e-3 (float32 against float64 on the CPU: 8.3e-6). Every projection must
# lower the mass-weighted L2 norm of div u (on the CPU it falls by a factor
# of at most 0.99992 a step in float64 and float32 alike); the pointwise
# maximum of div u stops falling after about 17 steps in float64 too (the
# SIP projection does not act on the strong divergence's interface part:
# ROADMAP C29), so it is reported, not gated.
INS_CELLS = (6, 6)
INS_DT = 2e-3
INS_KE_RTOL = 1e-3
INS_PROFILE_STEPS = 5
# The 1D solvers through integrate(lserk4_step), float32 (the examples'):
# max-norm errors against the exact solutions at the JAX tests' bounds
# (float32 on the CPU: 8.4e-5 and 4.8e-6).
ADV_ERR_BOUND = 5e-4
BRG_ERR_BOUND = 1e-5
# The element-sharded plain-tensor path (parallel/halo.py), stacked on the
# card, float32: examples/scaling_study.py's --mode xla configuration
# (box_triangles(32, 32), K=2048, N=3, flat bottom, walls, a Gaussian hump
# at rest, 100 SSP-RK2 steps at dt 1e-4) at S = 1, 2, 4 shards (runs of
# the blocks of one partition into 4). The halo
# RHS against sw2d_rhs on the unsharded context, every entry within
# HALO_RHS_RTOL of the largest (the two compute the same float32 arithmetic
# on the same traces, and on the CPU give the same bits at every S; the
# bound leaves room for a different order of a few sums on the card); a
# bfloat16 halo's gap is reported, not gated (on the CPU 5-7 % of the
# largest entry at S = 2, 4: h ~ 10 keeps 8 bits). The rollout's end state against the unsharded rollout within
# HALO_ROLL_ATOL on h ~ 10 (100 steps). A 10-step coastal rollout
# (well-balanced bathymetry, drag, Coriolis, tidal open east side) with the
# adaptive dt of halo_sw2d_timestep at S=4, as tests/test_parallel.py runs
# it, against the unsharded one: the times to HALO_ROLL_ATOL relative, the
# states to HALO_ROLL_ATOL. The curved halo RHS on the large Gordon-Hall
# disk (mpc/curved_disk.py, K=1014, N=3) at S = 2, 6 against
# sw2d_curved_rhs within HALO_RHS_RTOL. The sharded CG: TestShardedElliptic
# on the elliptic configuration (N=2, box_triangles(23, 23), K=1058,
# padded by pad_context to S=4) in float64 (the card runs float64 too; in
# float32 the dots' summation order moves the iteration count), tol 1e-10:
# the same iterations as the unsharded CG and the solution within
# HALO_CG_ATOL.
HALO_SHARDS = (1, 2, 4)
HALO_STEPS = 100
HALO_DT = 1e-4
HALO_RHS_RTOL = 1e-5
HALO_ROLL_ATOL = 1e-4
HALO_COASTAL_STEPS = 10
HALO_CURVED_SHARDS = (2, 6)
HALO_CG_TOL = 1e-10
HALO_CG_ATOL = 1e-9
# pyblitzdg-compatible API: the reference's advec1d numpy script through
# Nodes1DProvisioner (its error bound ADV_ERR_BOUND), and its poisson2d
# pattern (MeshManager, TriangleNodesProvisioner on the card,
# Poisson2DSparseMatrix, a scipy direct solve) on box_triangles(12, 12) at
# N=2, held to sin(pi x) sin(pi y) within CMP_POISSON_ERR (the
# discretization error: 1.8e-3 in the same float64 host solve on the CPU).
CMP_POISSON_ERR = 5e-3


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


def graph_us(fns, n: int = 100, reps: int = 5) -> float:
    """Median time in us of one round of ``fns`` (called in order) from a
    CUDA graph of ``n`` rounds replayed ``reps`` times, CUDA events: the
    launches back to back with their inputs warm in L2 and no host between
    them, as a captured rollout issues them (the gaps between launches
    included)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / n)
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
           "tol": rollout_atol, "tile": F.last_tile() if h.is_cuda else None,
           "ok": finite and err <= rollout_atol}
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
    again = F.sw2d_rollout_bwd_fused(ops, meta, *traj, *tb, ctrls, dt, spc,
                                     True, t0)
    gp = F.sw2d_rollout_bwd_plain(ops, meta, *traj, *tb, ctrls, dt, spc,
                                  True, t0)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(gk, again))
    per = scenario_rel(gk, gp)  # (B,)
    p99, worst = float(torch.quantile(per, 0.99)), float(per.max())
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    rec = {"case": name, "kernel": "sw2d_rollout_bwd_fused",
           "max_abs_err": max_abs(gk, gp), "max_rel_err": worst,
           "p99_rel_err": p99,
           "scenarios_above_bulk_tol": int((per > BWD_RTOL_BULK).sum()),
           "tol": list(bwd_rtol), "same_bits_on_rerun": same_bits,
           "tile": F.last_tile() if h.is_cuda else None,
           "ok": (finite and same_bits and p99 <= bwd_rtol[0]
                  and worst <= bwd_rtol[1])}
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


def profile_solve(phase: str, card: str, run, solve_s: float,
                  cuda_only: bool = False) -> dict:
    """Where one solve's time goes, for information: device time by kernel
    name under torch.profiler, and the idle share against the unprofiled
    host-clock time ``solve_s``. ``cuda_only`` records the device's events
    alone (no host operator events: a fraction of the profiler's own cost
    on runs of many small launches). Returns the record it prints."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
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
    rec = {"phase": phase, "card": card,
         "device_busy_ms": busy_ms if busy_ms > 0 else None,
         "solve_ms_unprofiled": solve_s * 1e3,
         "device_idle_share": (1.0 - busy_ms / (solve_s * 1e3)
                               if busy_ms > 0 else None),
         "device_kernel_launches": sum(r[2] for r in rows),
         "top_device_ms": [{"name": k[:60], "ms": us / 1e3, "calls": n}
                           for us, k, n in rows[:8] if us > 0]}
    say(rec)
    return rec


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
    adjoint on the kernel's own trajectory. The step and the rollout also
    give the same bits on a rerun, and the rollout's trajectory is, row for
    row and bit for bit, the step launched for each step in turn (one
    kernel: the step is a rollout of one step). Returns the records by
    kernel (errors always, times and bounds if asked)."""
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
    again = step(TB.sw2d_step_blocked)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    rec = record("sw2d_step_blocked", err, fwd_atol,
                 finite(got) and err <= fwd_atol and same,
                 same_bits_on_rerun=same, grid_blocks=TB.last_grid(),
                 plan=TB.rollout_plan(ops, meta, B))
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
    again = roll(TB.sw2d_rollout_blocked, ctrls, True)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # the step launched for each step in turn, from t0 + t dt
    st, as_steps = (h, hu, hv), True
    for t in range(n_steps):
        c = None if ctrls is None else ctrls[:, t // spc].contiguous()
        st = TB.sw2d_step_blocked(ops, meta, *st, c, dt, t0 + t * dt)
        as_steps = as_steps and all(torch.equal(a, b[:, t + 1])
                                    for a, b in zip(st, got[:3]))
    ok = finite(got) and err <= fwd_atol and same and as_steps
    traj = tuple(f.contiguous() for f in got[:3])
    for c in ([ctrls, None] if ctrls is not None else [None]):
        g2 = roll(TB.sw2d_rollout_blocked, c, False)
        r2 = roll(TB.sw2d_rollout_blocked_plain, c, False)
        torch.cuda.synchronize()
        e2 = max_abs(g2, r2)
        err, ok = max(err, e2), ok and finite(g2) and e2 <= fwd_atol
    rec = record("sw2d_rollout_blocked", err, fwd_atol, ok, n_steps=n_steps,
                 same_bits_on_rerun=same, equals_step_launches=as_steps)
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
                     entries=per.numel(), same_bits_on_rerun=same,
                     plan=TB.rollout_bwd_plan(ops, meta, B))
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
         "rollout_plan": TB.rollout_plan(ops, meta, bbx.BATCH)})

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
        plan = TB.rollout_plan(r.ops, r.meta, r.states.h.shape[0])
        grid = plan["grid"]
        ms = time_ms(run, 5, flush)
        B = r.states.h.shape[0]
        flops = TB.matmul_flops_per_step(r.meta) * B * r.n_steps
        ok = (all(bool(torch.isfinite(f).all()) for f in end)
              and 9.0 < float(end[0].min()) and float(end[0].max()) < 12.0)
        # what the barriers alone cost at this grid
        nb = 2 * r.n_steps
        probe = lambda n: TB.barrier_probe(n, grid, plan["threads"], dev)
        t_many = time_ms(lambda: probe(nb + 1), 5, flush)
        t_one = time_ms(lambda: probe(1), 5, flush)
        say({"phase": "blocked_rollout", "ok": ok, "card": card,
             "n_order": n_order, "k_elem": r.meta.k_elem, "batch": B,
             "n_steps": r.n_steps, "dt": r.dt, "ms": ms,
             "us_per_step": ms * 1e3 / r.n_steps,
             "us_per_step_per_scenario": ms * 1e3 / r.n_steps / B,
             "matmul_flops_per_step": TB.matmul_flops_per_step(r.meta),
             "matmul_gflops_per_s": flops / (ms * 1e-3) / 1e9,
             "plan": plan, "items": B * r.meta.k_elem,
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


# ---------------------------------------------------------------------------
# The curved path
# ---------------------------------------------------------------------------

def curved_rhs_flops(meta, use_filter: bool = True) -> float:
    """What one curved RHS of one scenario needs (ops/sw2d_curved_blocked.py,
    ``_curved_rhs_plain``): the per-element products on four fields at 2 per
    multiply-add (cubature interpolation, Dr^T and Ds^T, the Gauss
    interpolation of each trace once, the lift, the mass inverse, the
    filter), plus the pointwise formulas, each add, multiply, division,
    square root and maximum counted as one. The '+' trace is a fetch of the
    neighbour's interpolated value: interpolating it a second time, as the
    kernels do to save a grid barrier, is no part of the function."""
    np_, nc, nt = meta.n_p, meta.n_cub, meta.n_tr
    fma = 3 * nc * np_ + 2 * nt * np_ + np_ * np_
    fma += np_ * np_ if use_filter else 0
    # cubature point: fluxes 14, four weighted pairs 24
    # Gauss point: two flux sets 28, two speeds 18, central part 28, jumps 4,
    # weighted flux 12; face: maximum over its NG points, NG-1
    # node: sources up to 20, control 4 n_ctrl, stage update 8
    point = (38 * nc + 90 * nt + (meta.n_gauss - 1) * meta.n_faces
             + (8 + 4 * meta.n_ctrl + (20 if meta.cd or meta.f_cor else 0)
                + (6 if meta.has_bed else 0)) * np_)
    return meta.k_elem * (2.0 * 4 * fma + point)


def curved_vjp_flops(meta, use_filter: bool = True) -> float:
    """What one application of the curved RHS adjoint needs
    (``_curved_rhs_vjp_plain``), the recompute of cubature and Gauss values
    included; the '+' values are fetched, as in ``curved_rhs_flops``."""
    np_, nc, nt = meta.n_p, meta.n_cub, meta.n_tr
    # mass^T; Dr^T, Ds^T transposed, V and V^T; GI on the values, on the
    # cotangent, and transposed
    fma = np_ * np_ + 4 * nc * np_ + 3 * nt * np_
    fma += np_ * np_ if use_filter else 0
    # cubature point: weights 24, flux adjoint 36
    # Gauss point: two speeds 18, flux cotangents 16, speed cotangent 8, two
    # flux adjoints 72, speed part 8, two speed adjoints 24; face: the share
    # of the speed cotangent among its largest points, 3 NG
    # node: source adjoint up to 30, control 4 n_ctrl, lambda update 8
    point = (60 * nc + 146 * nt + 3 * nt
             + (8 + 4 * meta.n_ctrl + (30 if meta.cd or meta.f_cor else 0)
                + (5 if meta.has_bed else 0)) * np_)
    return meta.k_elem * (2.0 * 4 * fma + point)


def check_curved_case(TC, name, ops, meta, S, ctrls, dt, spc, flush, rng,
                      timed: bool = False, depth_only: bool = False,
                      bwd_rtol: tuple = (BWD_RTOL_BULK, BWD_RTOL_MAX)):
    """Compare the three curved kernels with their plain versions on one
    case: the step, the rollout with stored trajectories, the rollout
    without, with and without the controls, and the adjoint on the kernel's
    own trajectories (``depth_only``: a cotangent on the depth trajectory
    alone, None on the other three, as the MPC cost gives it). Returns the
    records by kernel (errors always, times and bounds if asked)."""
    B, n_cs = S[0].shape[0], ctrls.shape[1]
    n_steps = n_cs * spc
    finite = lambda fs: all(bool(torch.isfinite(f).all()) for f in fs)
    out = {}

    def record(kernel, err, tol, ok, **more):
        rec = {"case": name, "kernel": kernel, "max_abs_err": err, "tol": tol,
               "ok": bool(ok), **more}
        out[kernel] = rec
        return rec

    # --- step ---
    c0 = ctrls[:, 0].contiguous()
    step = lambda f: f(ops, meta, *S, c0, dt)
    got = step(TC.sw2d_curved_step_blocked)
    ref = step(TC.sw2d_curved_step_blocked_plain)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    unit = TC.unit_shape(meta, B)._asdict()
    rec = record("sw2d_curved_step_blocked", err, CRV_FWD_ATOL,
                 finite(got) and err <= CRV_FWD_ATOL,
                 grid_blocks=TC.last_grid(), units=TC.n_units(meta, B),
                 unit=unit)
    if timed:
        rec["ms"] = time_ms(lambda: step(TC.sw2d_curved_step_blocked), 9,
                            flush)
        rec["plain_ms"] = time_ms(
            lambda: step(TC.sw2d_curved_step_blocked_plain), 2, flush)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (8 * B * meta.n_v + B * meta.n_ctrl),
            B * 2 * curved_rhs_flops(meta))

    # --- rollout: stored trajectories; then none, with and without the
    # controls ---
    roll = lambda f, c, traj: f(ops, meta, *S, c, dt, spc,
                                n_steps=None if c is not None else n_steps,
                                store_traj=traj)
    got = roll(TC.sw2d_curved_rollout_blocked, ctrls, True)
    grid = TC.last_grid()
    ref = roll(TC.sw2d_curved_rollout_blocked_plain, ctrls, True)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    ok = finite(got) and err <= CRV_FWD_ATOL
    traj = tuple(f.contiguous() for f in got[:4])
    for c in (ctrls, None):
        g2 = roll(TC.sw2d_curved_rollout_blocked, c, False)
        r2 = roll(TC.sw2d_curved_rollout_blocked_plain, c, False)
        torch.cuda.synchronize()
        e2 = max_abs(g2, r2)
        err, ok = max(err, e2), ok and finite(g2) and e2 <= CRV_FWD_ATOL
    rec = record("sw2d_curved_rollout_blocked", err, CRV_FWD_ATOL, ok,
                 n_steps=n_steps, grid_blocks=grid,
                 units=TC.n_units(meta, B), unit=unit)
    if timed:
        rec["ms"] = time_ms(
            lambda: roll(TC.sw2d_curved_rollout_blocked, ctrls, True), 9,
            flush)
        rec["plain_ms"] = time_ms(
            lambda: roll(TC.sw2d_curved_rollout_blocked_plain, ctrls, True),
            2, flush)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (4 * B * meta.n_v + B * n_cs * meta.n_ctrl
                   + 4 * B * (n_steps + 1) * meta.n_v),
            B * n_steps * 2 * curved_rhs_flops(meta))

    # --- backward rollout, on the kernel's own trajectories ---
    tb = [torch.as_tensor(rng.standard_normal(tuple(traj[0].shape)),
                          dtype=torch.float32, device=S[0].device)
          for _ in range(4)]
    if depth_only:
        tb = [tb[0], None, None, None]
    bwd = lambda f: f(ops, meta, traj, tb, ctrls, dt, spc)
    gk = bwd(TC.sw2d_curved_rollout_bwd_blocked)
    grid, parts = TC.last_grid(), TC.last_parts()
    gp = bwd(TC.sw2d_curved_rollout_bwd_blocked_plain)
    again = bwd(TC.sw2d_curved_rollout_bwd_blocked)
    torch.cuda.synchronize()
    per = entry_rel(gk, gp)
    p99, worst = float(torch.quantile(per, 0.99)), float(per.max())
    same = all(torch.equal(a, b) for a, b in zip(gk, again))
    rec = record("sw2d_curved_rollout_bwd_blocked", max_abs(gk, gp),
                 list(bwd_rtol),
                 finite(gk) and same and p99 <= bwd_rtol[0]
                 and worst <= bwd_rtol[1],
                 max_rel_err=worst, p99_rel_err=p99,
                 entries_above_bulk_tol=int((per > BWD_RTOL_BULK).sum()),
                 entries=per.numel(), same_bits_on_rerun=same,
                 cotangents=sum(t is not None for t in tb),
                 grid_blocks=grid, units=TC.n_units(meta, B), unit=unit,
                 threads_per_lane=parts)
    if timed:
        rec["ms"] = time_ms(
            lambda: bwd(TC.sw2d_curved_rollout_bwd_blocked), 9, flush)
        rec["plain_ms"] = time_ms(
            lambda: bwd(TC.sw2d_curved_rollout_bwd_blocked_plain), 2, flush)
        n_tb = sum(t is not None for t in tb)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * ((4 + n_tb) * B * (n_steps + 1) * meta.n_v
                   + 2 * B * n_cs * meta.n_ctrl + 4 * B * meta.n_v),
            B * n_steps * (curved_rhs_flops(meta)
                           + 2 * curved_vjp_flops(meta)))
    for r in out.values():
        say(r)
        if not r["ok"]:
            raise RuntimeError(f"kernel out of tolerance: {r}")
    return out


def perturbed_curved(ctx, B, n_cs, n_ctrl, rng, device):
    """Generic four-field (B, nV) states near the rest state h = 1: per
    scenario a smooth bump of random height and place, a random uniform
    current, a tracer that follows the bump, a little node-wise noise; and
    random controls."""
    to = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    col = lambda lo, hi: to(rng.uniform(lo, hi, (B, 1)))
    x, y = to(ctx.x.reshape(1, -1)), to(ctx.y.reshape(1, -1))
    n_v = x.shape[1]
    noise = lambda: to(1e-3 * rng.standard_normal((B, n_v)))
    bump = torch.exp(-10.0 * ((x - col(-0.4, 0.4)) ** 2
                              + (y - col(-0.4, 0.4)) ** 2))
    h = 1.0 + col(0.01, 0.05) * bump + noise()
    hu = col(-0.05, 0.05) * h + noise()
    hv = col(-0.05, 0.05) * h + noise()
    hN = 0.5 + 0.3 * bump + noise()
    ctrls = to(0.3 * rng.standard_normal((B, n_cs, n_ctrl)))
    return tuple(f.contiguous() for f in (h, hu, hv, hN)), ctrls


def curved_phases(dev, card: str, rng, flush) -> list:
    """The curved path: kernels against plain versions, the MPC solves on
    both disks, and their cross-check against the plain composite. Returns
    the kernel records of the ``kernels`` line."""
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import (advance_plant_curved_blocked,
                                       solve_mpc,
                                       solve_mpc_curved_blocked,
                                       solve_mpc_curved_blocked_gn)
    from blitzdg_tpu_torch.mpc import curved_disk as cdk
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt
    from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.specgrid.cubature import (
        build_cubature_context, build_gauss_face_context)
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    n_cs, spc = cdk.HORIZON, cdk.STEPS_PER_CONTROL
    flat = lambda f: f.reshape(f.shape[0], -1).contiguous()
    t_set = time.perf_counter()
    large = cdk.curved_disk_problem(**cdk.LARGE, device=dev)
    t_large = time.perf_counter() - t_set
    small = cdk.curved_disk_problem(**cdk.SMALL, device=dev)
    say({"phase": "curved_setup", "seconds_large": t_large,
         "seconds_small": time.perf_counter() - t_set - t_large,
         "large": {"k_elem": large.bm.meta.k_elem, "dt": large.prob.dt,
                   "batch": cdk.LARGE["batch"]},
         "small": {"k_elem": small.bm.meta.k_elem, "dt": small.prob.dt,
                   "batch": cdk.SMALL["batch"]},
         "n_p": large.bm.meta.n_p, "n_cub": large.bm.meta.n_cub,
         "n_gauss": large.bm.meta.n_gauss,
         "mass_mode": large.bm.meta.mass_mode,
         "unit_large": TC.unit_shape(large.bm.meta,
                                     cdk.LARGE["batch"])._asdict(),
         "unit_small": TC.unit_shape(small.bm.meta,
                                     cdk.SMALL["batch"])._asdict()})

    # ---- kernels against their plain versions ----
    cases = []

    def check(name, *a, **kw):
        cases.append(name)
        return check_curved_case(TC, name, *a, **kw)

    meta = large.bm.meta
    S, ctrls = perturbed_curved(large.prob.ctx, cdk.LARGE["batch"], n_cs, 2,
                                rng, dev)
    head = check("curved_K1014_N3", large.bm.ops, meta, S, ctrls,
                 large.prob.dt, spc, flush, rng, timed=True)
    # the exact start of the solves: rest state, zero controls, a cotangent
    # on the depth trajectory alone
    check("curved_K1014_N3_rest", large.bm.ops, meta,
          tuple(flat(f) for f in large.states), torch.zeros_like(ctrls),
          large.prob.dt, spc, flush, rng, depth_only=True,
          bwd_rtol=(BWD_RTOL_REST, BWD_RTOL_REST))
    S, ctrls = perturbed_curved(small.prob.ctx, cdk.SMALL["batch"], n_cs, 2,
                                rng, dev)
    head_small = check("curved_K54_N3", small.bm.ops, small.bm.meta, S, ctrls,
                       small.prob.dt, spc, flush, rng, timed=True)
    # a batch that is no multiple of the scenario tile: the masked edge
    S, ctrls = perturbed_curved(small.prob.ctx, CRV_RAGGED_BATCH, n_cs, 2,
                                rng, dev)
    check(f"curved_K54_N3_B{CRV_RAGGED_BATCH}", small.bm.ops, small.bm.meta,
          S, ctrls, small.prob.dt, spc, flush, rng)
    # another order: the kernels' instantiation for run-time sizes (the
    # N=3 cases above run the one compiled for N=3's sizes)
    d2 = cdk.curved_disk_problem(rings=4, snap_tol=0.3, batch=32, n_order=2,
                                 device=dev)
    S, ctrls = perturbed_curved(d2.prob.ctx, 32, n_cs, 2, rng, dev)
    check("curved_K96_N2", d2.bm.ops, d2.bm.meta, S, ctrls, d2.prob.dt, spc,
          flush, rng)
    # straight elements: the 'affine' mass mode, with drag, Coriolis and a
    # bed slope
    mesh = box_triangles(8, 8)
    n_order = cdk.N_ORDER
    kw = dict(filter_cutoff=0.9 * n_order, filter_order=4)
    bc64 = build_triangle_context(n_order, mesh, dtype=torch.float64,
                                  device="cpu", **kw)
    xs, ys, V = bc64.x.numpy(), bc64.y.numpy(), bc64.V.numpy()
    bcub = build_cubature_context(n_order, mesh, xs, ys, V, device="cpu")
    bgauss = build_gauss_face_context(n_order, mesh, xs, ys, V, device="cpu")
    bump = np.exp(-8.0 * (xs ** 2 + ys ** 2))
    bops, bmeta = TC.build_curved_blocked_ops(
        bc64, bcub, bgauss, SWPhysics(g=9.81, cd=2e-3, f_cor=1e-2),
        np.stack([bump, 0 * bump]), np.stack([0 * bump, bump]),
        zx=0.1 * np.cos(xs), zy=0.05 * np.sin(2.0 * ys), device=dev)
    if not (bmeta.mass_mode == "affine" and bmeta.has_bed and bmeta.cd
            and bmeta.f_cor):
        raise RuntimeError("the box case does not switch every term on")
    S, ctrls = perturbed_curved(bc64, 32, n_cs, 2, rng, dev)
    check("curved_box_affine_sources_K128_N3", bops, bmeta, S, ctrls,
          cfl_dt(bc64, 9.81, 1.1, cfl=0.5), spc, flush, rng)
    say({"phase": "curved_kernels", "ok": True, "cases": cases})

    # ---- the main path: Adam on both disks, Gauss-Newton, plant advance ----
    wrappers = (TC.sw2d_curved_step_blocked, TC.sw2d_curved_rollout_blocked,
                TC.sw2d_curved_rollout_bwd_blocked)
    counts = lambda: {w.__name__: w.launches for w in wrappers}
    adam = lambda d, iters: solve_mpc_curved_blocked(
        d.prob, d.bm, d.states, d.targets, 2, iters=iters,
        learning_rate=cdk.LEARNING_RATE, H_rest=cdk.H_REST)
    gauss_newton = lambda d, fd_eps: solve_mpc_curved_blocked_gn(
        d.prob, d.bm, d.states, d.targets, 2, gn_iters=cdk.GN_ITERS,
        cg_iters=cdk.CG_ITERS, fd_eps=fd_eps, H_rest=cdk.H_REST)
    # warm-up: allocator, autograd (its first gradient with given cotangents
    # imports a symbolic-shapes module, seconds on the host)
    adam(large, 1)
    adam(small, 1)
    gauss_newton(large, cdk.FD_EPS)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    sol = adam(large, cdk.ADAM_ITERS)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    adam_launches = counts()
    t0 = time.perf_counter()
    sol_small = adam(small, cdk.ADAM_ITERS)
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    gn_runs = {"large": [], "small": []}
    for name, d in (("large", large), ("small", small)):
        for fd_eps in (cdk.FD_EPS, *CRV_FD_EPS_WIDER):
            t0 = time.perf_counter()
            gn = gauss_newton(d, fd_eps)
            torch.cuda.synchronize()
            gn_runs[name].append((fd_eps, gn, time.perf_counter() - t0))
    plant = advance_plant_curved_blocked(large.prob, large.bm, large.states,
                                         sol.controls[:, 0])
    torch.cuda.synchronize()
    launches = counts()

    # Adam: one rollout and one adjoint per iteration, one more of each for
    # the gradient norm. Gauss-Newton, per outer iteration: the linearization
    # (1 rollout), J^T r (1 adjoint), the curvature probe (1 rollout), per CG
    # step one difference rollout and one adjoint, the trial point
    # (1 rollout); one rollout and one adjoint at the end.
    gi, ci, n_gn = cdk.GN_ITERS, cdk.CG_ITERS, 2 * (1 + len(CRV_FD_EPS_WIDER))
    per_adam = cdk.ADAM_ITERS + 1
    expect_adam = {"sw2d_curved_step_blocked": 0,
                   "sw2d_curved_rollout_blocked": per_adam,
                   "sw2d_curved_rollout_bwd_blocked": per_adam}
    expect = {"sw2d_curved_step_blocked": spc,
              "sw2d_curved_rollout_blocked": 2 * per_adam
              + n_gn * (gi * (3 + ci) + 1),
              "sw2d_curved_rollout_bwd_blocked": 2 * per_adam
              + n_gn * (gi * (1 + ci) + 1)}
    with torch.no_grad():
        traj = large.bm.rollout(*(flat(f) for f in large.states),
                                sol.controls.contiguous())
    plant_err = max_abs([flat(f) for f in plant], [t[:, spc] for t in traj])
    finite = lambda *ts: all(bool(torch.isfinite(t).all()) for t in ts)
    # Both solvers start from zero controls. Gauss-Newton takes no step that
    # raises the cost, but sums it from residuals: equal to 1e-4 relative. A
    # difference step counts as one that improves where the median cost goes
    # down by more than a half per cent (the optimum lies one per cent below
    # the start on the large disk).
    gn_report, improved, below_adam, gn_ok = {}, {}, {}, True
    for name, adam_sol in (("large", sol), ("small", sol_small)):
        start = adam_sol.cost_history[0]
        gn_report[name], improved[name], below_adam[name] = [], [], []
        for fd_eps, gn, secs in gn_runs[name]:
            rel = gn.cost / start
            gn_ok = (gn_ok and finite(gn.cost_history, gn.cost, gn.controls,
                                      gn.grad_norm)
                     and float(rel.max()) <= 1.0 + 1e-4)
            if float(rel.median()) < 0.995:
                improved[name].append(fd_eps)
            if float((gn.cost / adam_sol.cost).median()) < 1.0:
                below_adam[name].append(fd_eps)
            gn_report[name].append({
                "fd_eps": fd_eps, "seconds": secs,
                "start_cost": float(start.median()),
                "final_cost": float(gn.cost.median()),
                "final_cost_vs_start": float(rel.median()),
                "final_cost_vs_adam":
                    float((gn.cost / adam_sol.cost).median()),
                "grad_norm": float(gn.grad_norm.median()),
                "scenarios_that_moved": int(
                    (gn.controls.abs().amax(dim=(1, 2)) > 0).sum())})
    decrease = float((sol.cost_history[0] / sol.cost).median())
    decrease_small = float((sol_small.cost_history[0]
                            / sol_small.cost).median())
    # Adam's denominator sqrt(v) + 1e-8 swallows gradients of 1e-9: on the
    # large disk (short horizon: 8 steps of 3.7e-4) five iterations move the
    # controls by 1e-2 and the cost by less than float32 resolves, so there
    # the solve is held to "within 1e-4 of the start" and the decrease is
    # shown by Gauss-Newton; on the small disk Adam's cost must go down.
    path_ok = (finite(sol.cost_history, sol.cost, sol.controls, sol.grad_norm,
                      sol_small.cost_history, sol_small.cost,
                      sol_small.controls, sol_small.grad_norm)
               and tuple(sol.controls.shape) == (cdk.LARGE["batch"], n_cs, 2)
               and tuple(sol_small.controls.shape)
               == (cdk.SMALL["batch"], n_cs, 2)
               and decrease >= 1.0 - 1e-4 and decrease_small > 1.0
               and float(sol.grad_norm.max()) > 0.0
               and gn_ok and cdk.FD_EPS_FLOAT32 in improved["large"]
               and cdk.FD_EPS_FLOAT32 in improved["small"]
               and adam_launches == expect_adam and launches == expect
               and plant_err <= CRV_FWD_ATOL)
    say({"phase": "curved_path", "ok": path_ok, "card": card,
         "n_order": cdk.N_ORDER, "n_steps": n_cs * spc,
         "adam_iters": cdk.ADAM_ITERS,
         "large": {"k_elem": meta.k_elem, "batch": cdk.LARGE["batch"],
                   "adam_first_cost": float(sol.cost_history[0].median()),
                   "adam_final_cost": float(sol.cost.median()),
                   "adam_cost_decrease": decrease,
                   "adam_grad_norm": float(sol.grad_norm.median()),
                   "adam_seconds_per_solve": adam_s,
                   "adam_scenario_solves_per_second":
                       cdk.LARGE["batch"] / adam_s,
                   "adam_launches": adam_launches},
         "small": {"k_elem": small.bm.meta.k_elem,
                   "batch": cdk.SMALL["batch"],
                   "adam_first_cost":
                       float(sol_small.cost_history[0].median()),
                   "adam_final_cost": float(sol_small.cost.median()),
                   "adam_cost_decrease": decrease_small,
                   "adam_grad_norm": float(sol_small.grad_norm.median()),
                   "adam_seconds_per_solve": small_s,
                   "adam_scenario_solves_per_second":
                       cdk.SMALL["batch"] / small_s},
         "gauss_newton": gn_report,
         "gauss_newton_fd_eps_that_improve": improved,
         "gauss_newton_fd_eps_below_adam": below_adam,
         "launches": launches, "expected_launches": expect,
         "plant_vs_rollout_max_abs": plant_err})
    if not path_ok:
        raise RuntimeError("curved path failed its checks")

    profile_solve("curved_profile", card,
                  lambda: adam(large, cdk.ADAM_ITERS), adam_s)

    # ---- the same solves through solve_mpc over the plain curved RHS ----
    before = counts()
    report, cross_ok = {}, True
    for name, d, s_kernel in (("large", large, sol), ("small", small,
                                                      sol_small)):
        t0 = time.perf_counter()
        ref = solve_mpc(d.prob, d.states, d.targets, d.control_to_forcing, 2,
                        iters=cdk.ADAM_ITERS, learning_rate=cdk.LEARNING_RATE,
                        H_rest=cdk.H_REST)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ratio = s_kernel.cost / ref.cost
        rmin, rmax = float(ratio.min()), float(ratio.max())
        cross_ok = (cross_ok and CRV_COST_RATIO[0] <= rmin
                    and rmax <= CRV_COST_RATIO[1])
        report[name] = {
            "scenarios": int(ratio.numel()), "cost_ratio_min": rmin,
            "cost_ratio_max": rmax, "plain_seconds_per_solve": secs,
            "controls_max_abs_diff":
                float((s_kernel.controls - ref.controls).abs().max())}
    if before != counts():
        raise RuntimeError("the plain-composite solve launched a kernel")
    say({"phase": "curved_cross_check", "ok": cross_ok,
         "tol": list(CRV_COST_RATIO), **report})
    if not cross_ok:
        raise RuntimeError("curved solve through the kernels disagrees with "
                           "the solve through the plain curved RHS")

    # ---- the record ----
    src = "blitzdg_tpu_torch/ops/csrc/sw2d_curved.cu"
    replaces = {
        "sw2d_curved_step_blocked":
            "blitzdg_tpu/ops/sw2d_curved_blocked.py:398",
        "sw2d_curved_rollout_blocked":
            "blitzdg_tpu/ops/sw2d_curved_blocked.py:454",
        "sw2d_curved_rollout_bwd_blocked":
            "blitzdg_tpu/ops/sw2d_curved_blocked.py:566"}
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             "device_launches_per_call": TC.DEVICE_LAUNCHES_PER_CALL,
             "ms_small_disk": head_small[name]["ms"],
             "grid_blocks": rec["grid_blocks"], "units": rec["units"],
             "grid_blocks_small_disk": head_small[name]["grid_blocks"],
             "units_small_disk": head_small[name]["units"]}
            for name, rec in head.items()]


# ---------------------------------------------------------------------------
# The sharded path
# ---------------------------------------------------------------------------

def check_sharded_case(TB, BS, name, sb, state, ctrl, dt, t, sponge, flush,
                       rng, adjoint: bool = True, timed: bool = False,
                       tol: float = BLK_FWD_ATOL, time_adjoint: bool = False):
    """Hold the two stage kernels against their plain versions on one case:
    stage 1 (base = cur, dt/2, no sponge) and stage 2 (base != cur, dt, the
    sponge if ``sponge``) with the receive buffers the ring exchange makes
    of the state's send buffer, stage 2 rerun for the same bits; the
    adjoint of stage 2 under random cotangents, rerun for the same bits.
    Returns the records by kernel; ``timed`` times every kernel and its
    plain version, ``time_adjoint`` the adjoint kernel alone."""
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    ops, meta = sb.ops, sb.meta
    S, B = state[0].shape[:2]
    L = ops.send.shape[1]
    ex = RingExchange(sb.plan, meta.n_fp, device=state[0].device)
    rb = ex(BS.initial_send_buffer(sb, state))
    finite = lambda fs: all(bool(torch.isfinite(f).all()) for f in fs)
    out = {}

    def record(kernel, err, tol, ok, **more):
        rec = {"case": name, "kernel": kernel, "max_abs_err": err, "tol": tol,
               "ok": bool(ok), **more}
        out[kernel] = rec
        return rec

    st1 = lambda f: f(ops, meta, state, state, rb, 0.5 * dt, t, ctrl)
    got1, ref1 = st1(TB.sw2d_stage_blocked), st1(TB.sw2d_stage_blocked_plain)
    torch.cuda.synchronize()
    cur = tuple(f.contiguous() for f in got1[:3])
    rb2 = ex(got1[3])
    st2 = lambda f: f(ops, meta, state, cur, rb2, dt, t + 0.5 * dt, ctrl,
                      True, sponge)
    got2, ref2 = st2(TB.sw2d_stage_blocked), st2(TB.sw2d_stage_blocked_plain)
    again = st2(TB.sw2d_stage_blocked)
    torch.cuda.synchronize()
    err = max(max_abs(got1, ref1), max_abs(got2, ref2))
    same = all(torch.equal(a, b) for a, b in zip(got2, again))
    n_wall = int(ops.wall.sum()) / S  # per shard
    rec = record("sw2d_stage_blocked", err, tol,
                 finite(got1) and finite(got2) and err <= tol and same,
                 same_bits_on_rerun=same, grid_blocks=TB.last_grid(),
                 slots=L, plan=TB.shard_plan(ops, meta, B))
    if timed:
        rec["ms"] = time_ms(lambda: st2(TB.sw2d_stage_blocked), 9, flush)
        rec["plain_ms"] = time_ms(lambda: st2(TB.sw2d_stage_blocked_plain), 2,
                                  flush)
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (9 * S * B * meta.n_v + 2 * 3 * S * B * L + meta.n_ctrl),
            S * B * rhs_flops(meta, n_wall))
    if adjoint:
        g = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                           dtype=torch.float32,
                                           device=state[0].device)
        lam = tuple(g(S, B, meta.n_v) for _ in range(3))
        lsb = g(S, B, L, 3)
        bwd = lambda f: f(ops, meta, cur, rb2, lam, lsb, dt, t + 0.5 * dt,
                          ctrl, True, sponge)
        gk = bwd(TB.sw2d_stage_bwd_blocked_v2)
        gp = bwd(TB.sw2d_stage_bwd_blocked_v2_plain)
        again = bwd(TB.sw2d_stage_bwd_blocked_v2)
        torch.cuda.synchronize()
        per = entry_rel(gk, gp)
        p99, worst = float(torch.quantile(per, 0.99)), float(per.max())
        same = all(torch.equal(a, b) for a, b in zip(gk, again))
        rec = record("sw2d_stage_bwd_blocked_v2", max_abs(gk, gp),
                     [BWD_RTOL_BULK, BWD_RTOL_MAX],
                     finite(gk) and same and p99 <= BWD_RTOL_BULK
                     and worst <= BWD_RTOL_MAX,
                     max_rel_err=worst, p99_rel_err=p99,
                     entries_above_bulk_tol=int((per > BWD_RTOL_BULK).sum()),
                     entries=per.numel(), same_bits_on_rerun=same,
                     plan=TB.shard_plan(ops, meta, B, adjoint=True))
        if timed or time_adjoint:
            rec["ms"] = time_ms(lambda: bwd(TB.sw2d_stage_bwd_blocked_v2), 9,
                                flush)
            rec["bound_ms"], rec["bound_by"] = bound(
                4.0 * (12 * S * B * meta.n_v + 9 * S * B * L
                       + S * B * meta.n_ctrl),
                S * B * vjp_flops(meta, n_wall))
            rec["shape"] = {"S": S, "B": B, "k_loc": meta.k_elem,
                            "n_p": meta.n_p}
        if timed:
            rec["plain_ms"] = time_ms(
                lambda: bwd(TB.sw2d_stage_bwd_blocked_v2_plain), 2, flush)
    for r in out.values():
        say(r)
        if not r["ok"]:
            raise RuntimeError(f"kernel out of tolerance: {r}")
    return out


def check_rdma_case(TB, BS, name, sb, state, ctrl, dt, t, flush,
                    timed: bool = False, tol: float = BLK_FWD_ATOL):
    """Hold the one-launch step kernel against its plain version on one
    case (the receive buffer the ring exchange makes of the state's send
    buffer), rerun it for the same bits and hold it bit-equal to the two
    stage kernels with the exchange between (both run the same stage
    code). Times the step, the two stage launches and the exchange gather
    between them back to back in CUDA graphs (``graph_us``). Returns its
    record."""
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    ops, meta, offs = sb.ops, sb.meta, sb.plan.offs
    S, B = state[0].shape[:2]
    L = ops.send.shape[1]
    ex = RingExchange(sb.plan, meta.n_fp, device=state[0].device)
    rb = ex(BS.initial_send_buffer(sb, state))
    launch = TB.RdmaLaunch(ops, meta, ex)
    step = lambda: launch(state, rb, dt, t, ctrl)
    plain = lambda: TB.sw2d_step_rdma_blocked_plain(ops, meta, state, rb, dt,
                                                    ex, t, ctrl)
    got = step()
    grid = TB.last_grid()
    ref = plain()
    again = step()
    *s1, sb1 = TB.sw2d_stage_blocked(ops, meta, state, state, rb, 0.5 * dt, t,
                                     ctrl)
    two = TB.sw2d_stage_blocked(ops, meta, state, tuple(s1), ex(sb1), dt,
                                t + 0.5 * dt, ctrl, True, True)
    torch.cuda.synchronize()
    err = max_abs(got, ref)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    two_same = all(torch.equal(a, b) for a, b in zip(got, two))
    finite = all(bool(torch.isfinite(f).all()) for f in got)
    cur, rb2 = tuple(s1), ex(sb1)
    in_graph = {
        "step": graph_us([step]),
        "two_stages": graph_us([
            lambda: TB.sw2d_stage_blocked(ops, meta, state, state, rb,
                                          0.5 * dt, t, ctrl),
            lambda: TB.sw2d_stage_blocked(ops, meta, state, cur, rb2, dt,
                                          t + 0.5 * dt, ctrl, True, True)]),
        "exchange": graph_us([lambda: ex(sb1)])}
    rec = {"case": name, "kernel": "sw2d_step_rdma_blocked",
           "max_abs_err": err, "tol": tol,
           "ok": finite and same and two_same and err <= tol,
           "same_bits_on_rerun": same,
           "same_bits_as_two_stage_kernels": two_same,
           "grid_blocks": grid, "n_shards": S, "batch": B, "slots": L,
           "ring_offsets": list(offs), "in_graph_us": in_graph,
           "plan": TB.shard_plan(ops, meta, B, step=True),
           "stage_plan": TB.shard_plan(ops, meta, B)}
    if timed:
        rec["ms"] = time_ms(step, 9, flush)
        rec["plain_ms"] = time_ms(plain, 2, flush)
        n_wall = int(ops.wall.sum()) / S  # per shard
        rec["bound_ms"], rec["bound_by"] = bound(
            4.0 * (6 * S * B * meta.n_v + 2 * 3 * S * B * L + meta.n_ctrl),
            S * B * 2 * rhs_flops(meta, n_wall))
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"kernel out of tolerance: {rec}")
    return rec


@contextlib.contextmanager
def plain_stages(BS, TB):
    """Run the sharded steps through the plain stage versions: the steps
    look the two wrappers up in ``parallel.blocked_shard`` at each call."""
    saved = BS.sw2d_stage_blocked, BS.sw2d_stage_bwd_blocked_v2
    BS.sw2d_stage_blocked = TB.sw2d_stage_blocked_plain
    BS.sw2d_stage_bwd_blocked_v2 = TB.sw2d_stage_bwd_blocked_v2_plain
    try:
        yield
    finally:
        BS.sw2d_stage_blocked, BS.sw2d_stage_bwd_blocked_v2 = saved


def sharded_phases(dev, card: str, rng, flush) -> list:
    """The sharded path: stage kernels against plain versions, the long
    sharded rollouts, the sharded MPC at both sizes with the gradient check
    against the blocked path, and the cross-check of the full-width solve.
    Returns the kernel records of the ``kernels`` line."""
    from blitzdg_tpu_torch.context import BC_OUT
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt, retag_east_open
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel import partition_mesh
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
    from blitzdg_tpu_torch.utils import build_sponge_coefficient

    f32 = torch.float32
    n_order, S, B = sbx.N_ORDER, 4, 8
    t_set = time.perf_counter()
    full = sbx.sharded_mpc_problem(sbx.FULL, device=dev)
    say({"phase": "sharded_setup", "seconds": time.perf_counter() - t_set,
         "k_elem": full.ctx.k_elem, "n_shards": full.sb.n_shards,
         "k_loc": full.sb.k_loc, "n_p": full.sb.meta.n_p, "dt": full.dt,
         "ring_offsets": list(full.sb.plan.offs),
         "max_send": full.sb.plan.max_send,
         "halo_slots": int(full.sb.ops.send.shape[1]),
         "stage_plan": TB.shard_plan(full.sb.ops, full.sb.meta, B)})

    # ---- stage kernels against their plain versions ----
    def shard_state(ctx, rest, B_, n_ctrl, S_=S):
        h, hu, hv, c = perturbed_blocked(ctx, rest, B_, 1, n_ctrl, rng, dev,
                                         ctrl_scale=1.0)
        return (tuple(BS.split_shards(f, S_) for f in (h, hu, hv)),
                c[0, 0].contiguous())

    cases = []

    def check(name, *a, **kw):
        cases.append(name)
        return check_sharded_case(TB, BS, name, *a, **kw)

    def check_rdma(name, *a, **kw):
        cases.append(name)
        return check_rdma_case(TB, BS, name, *a, flush, **kw)

    st, ctrl = shard_state(full.ctx, sbx.H_REST, B, 2)
    head = check("sharded_K2048_N3_S4", full.sb, st, ctrl, full.dt, 0.0,
                 False, flush, rng, timed=True)
    # the one-launch step on the same inputs, and at one shard (no ring
    # offsets: the inter-stage receive buffer is zeros)
    head["sw2d_step_rdma_blocked"] = check_rdma(
        "rdma_K2048_N3_S4", full.sb, st, ctrl, full.dt, 0.0, timed=True)
    one = BS.build_sharded_blocked(full.ctx, SWPhysics(g=9.81), 1,
                                   forcing_bu=sbx.injectors(full.ctx)[0],
                                   forcing_bv=sbx.injectors(full.ctx)[1],
                                   device=dev)
    st1, ctrl = shard_state(full.ctx, sbx.H_REST, B, 2, 1)
    check_rdma("rdma_K2048_N3_S1", one, st1, ctrl, full.dt, 0.0)
    # both sizes the main path runs: full width at its one scenario (the
    # one-launch step's rollouts run S=1 and S=4 at B=1 as well), and the
    # example's size (N=1, two nodes a face, 8 shards: six ring offsets and
    # flipped cut faces)
    st, ctrl = shard_state(full.ctx, sbx.H_REST, 1, 2)
    at_path = [check("sharded_K2048_N3_S4_B1", full.sb, st, ctrl, full.dt,
                     0.0, False, flush, rng, time_adjoint=True)]
    check_rdma("rdma_K2048_N3_S4_B1", full.sb, st, ctrl, full.dt, 0.0)
    st1, ctrl = shard_state(full.ctx, sbx.H_REST, 1, 2, 1)
    check_rdma("rdma_K2048_N3_S1_B1", one, st1, ctrl, full.dt, 0.0)
    del one, st1
    example = sbx.sharded_mpc_problem(sbx.EXAMPLE, device=dev)
    plan = example.sb.plan
    flipped_cut = int((plan.pflip.astype(bool)
                       & (plan.psrc >= plan.psrc.shape[1])).sum())
    if len(plan.offs) < 4 or flipped_cut == 0:
        raise RuntimeError("the example-size case has too few ring offsets "
                           f"({plan.offs}) or no flipped cut face")
    st, ctrl = shard_state(example.ctx, sbx.H_REST, 1, 2,
                           example.sb.n_shards)
    at_path.append(check("sharded_example_K128_N1_S8_B1", example.sb, st,
                         ctrl, example.dt, 0.0, False, flush, rng,
                         time_adjoint=True))
    # the adjoint's times at the shapes of the main path, in its record
    at_path = [{k: r["sw2d_stage_bwd_blocked_v2"][k]
                for k in ("case", "shape", "ms", "bound_ms", "bound_by",
                          "plan")} for r in at_path]
    head["sw2d_stage_bwd_blocked_v2"]["at_path_shapes"] = at_path
    check_rdma("rdma_example_K128_N1_S8_B1", example.sb, st, ctrl,
               example.dt, 0.0)

    def context(mesh):
        return build_triangle_context(n_order, mesh, dtype=f32, device=dev,
                                      filter_cutoff=0.9 * n_order,
                                      filter_order=4)

    # full coastal physics: bathymetry with the well-balanced star fluxes,
    # drag, Coriolis, tidal depth on the open east side, sponge toward it,
    # stage times from t0 = 1
    mesh = box_triangles(*sbx.CELLS)
    retag_east_open(mesh)
    cc = context(partition_mesh(mesh, S)[0])
    H = 10.0 + 2.0 * cc.x + torch.sin(2.0 * cc.y)
    open_nodes = (cc.bc_table[:, :, None].expand(-1, -1, cc.n_fp)
                  .reshape(cc.k_elem, -1) == BC_OUT).cpu().numpy()
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=2.0 * torch.ones_like(H), Hy=2.0 * torch.cos(2.0 * cc.y),
                     sponge=build_sponge_coefficient(cc, open_nodes, width=0.3,
                                                     strength=0.5))
    tidal = (12.0, 0.5, 2.0, 10.0)
    csb = BS.build_sharded_blocked(cc, phys, S, tidal=tidal,
                                   forcing_bu=sbx.injectors(cc)[0],
                                   forcing_bv=sbx.injectors(cc)[1], device=dev)
    cm = csb.meta
    if not (cm.wb and cm.has_bathy and cm.has_sponge and cm.cd and cm.f_cor
            and cm.tidal == tidal and int(csb.ops.obc.sum()) > 0):
        raise RuntimeError("the coastal case does not switch every term on")
    st, ctrl = shard_state(cc, H.reshape(1, -1), B, 2)
    check("sharded_coastal_K2048_N3_S4", csb, st, ctrl,
          cfl_dt(cc, 9.81, 13.5), 1.0, True, flush, rng)
    check_rdma("rdma_coastal_K2048_N3_S4", csb, st, ctrl,
               cfl_dt(cc, 9.81, 13.5), 1.0)
    del csb, cc

    # N=6, the highest order the sharded kernels take (their compile-time
    # instance, eight lanes an element; the adjoint: the run-time-size
    # instance, one lane), at the blocked path's N=6 tolerance
    c6 = build_triangle_context(6, partition_mesh(box_triangles(*sbx.CELLS),
                                                  S)[0], dtype=f32,
                                device=dev, filter_cutoff=0.9 * 6,
                                filter_order=4)
    bu6, bv6 = sbx.injectors(c6)
    sb6 = BS.build_sharded_blocked(c6, SWPhysics(g=9.81), S, forcing_bu=bu6,
                                   forcing_bv=bv6, device=dev)
    st, ctrl = shard_state(c6, sbx.H_REST, 32, 2)
    dt6 = cfl_dt(c6, 9.81, 11.0)
    check("sharded_K2048_N6_S4_B32", sb6, st, ctrl, dt6, 0.0, False, flush,
          rng, tol=BLK_FWD_ATOL_N6)
    rec = check_rdma("rdma_K2048_N6_S4_B32", sb6, st, ctrl, dt6, 0.0,
                     tol=BLK_FWD_ATOL_N6)
    if (rec["plan"]["lanes_per_element"] != 8
            or rec["stage_plan"]["lanes_per_element"] != 8):
        raise RuntimeError(f"N=6: expected eight lanes an element, got "
                           f"{rec['plan']}, {rec['stage_plan']}")
    del sb6, c6

    # wetting and drying, forward only: a sloping beach, dry beyond x = 2/3
    wc = context(partition_mesh(box_triangles(*sbx.CELLS, xlim=(0.0, 1.0),
                                              ylim=(0.0, 1.0)), S)[0])
    Hb = 1.0 - 1.5 * wc.x
    h_floor = 1e-3
    wphys = SWPhysics(g=9.81, cd=1e-3, H=Hb, Hx=-1.5 * torch.ones_like(Hb),
                      Hy=torch.zeros_like(Hb), well_balanced=False)
    wsb = BS.build_sharded_blocked(wc, wphys, S, wetdry=True, h_floor=h_floor,
                                   device=dev)
    scen = torch.arange(B, dtype=f32, device=dev)[:, None]
    wave = 0.05 * torch.exp(-30.0 * ((wc.x - 0.45) ** 2
                                     + (wc.y - 0.5) ** 2)).reshape(1, -1)
    hw = torch.clamp_min(Hb.reshape(1, -1) + (1.0 + 0.2 * scen) * wave,
                         h_floor)
    wet = (hw > 5.0 * h_floor).to(f32)
    noise = lambda: torch.as_tensor(rng.standard_normal(tuple(hw.shape)),
                                    dtype=f32, device=dev)
    huw, hvw = wet * hw * (0.3 + 0.05 * noise()), wet * hw * 0.1 * noise()
    if not (bool((hw <= h_floor).any()) and bool((hw > 0.5).any())):
        raise RuntimeError("the beach has no dry or no wet region")
    check("sharded_wetdry_beach_K2048_N3_S4", wsb,
          tuple(BS.split_shards(f, S) for f in (hw, huw, hvw)), None,
          cfl_dt(wc, 9.81, 1.1), 0.0, False, flush, rng, adjoint=False)
    del wsb, wc
    say({"phase": "sharded_kernels", "ok": True, "cases": cases,
         "example_ring_offsets": list(plan.offs),
         "example_flipped_cut_faces": flipped_cut})

    # ---- the long sharded rollouts: fused steps, then one-launch steps ----
    stage, rdma = TB.sw2d_stage_blocked, TB.sw2d_step_rdma_blocked

    def long_rollout(r, phase, make_step, expect):
        """Time ``r``'s 2048-step rollout through ``make_step``'s steps,
        profile a window of it and check the end state and the launch
        counts. Returns (run, end state, record)."""
        run = lambda n: sbx.sharded_rollout(r, n, make_step)
        run(16)  # warm-up
        torch.cuda.synchronize()
        rdma.launches = stage.launches = 0
        t0 = time.perf_counter()
        end = run(r.n_steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"sw2d_stage_blocked": stage.launches,
                  "sw2d_step_rdma_blocked": rdma.launches}
        t0 = time.perf_counter()
        run(SHD_PROFILE_STEPS)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        batch = r.state[0].shape[1]
        profile_solve(f"{phase}_profile_S{r.sb.n_shards}_B{batch}", card,
                      lambda: run(SHD_PROFILE_STEPS), window)
        h_end = BS.join_shards(end[0])
        rec = {"phase": phase, "card": card, "n_shards": r.sb.n_shards,
               "batch": batch, "k_elem": r.ctx.k_elem, "n_order": n_order,
               "n_steps": r.n_steps, "dt": r.dt, "seconds": secs,
               "us_per_step": secs * 1e6 / r.n_steps,
               "us_per_step_per_scenario": secs * 1e6 / r.n_steps / batch,
               "launches": counts,
               "h_min": float(h_end.min()), "h_max": float(h_end.max()),
               "ok": (all(bool(torch.isfinite(f).all()) for f in end)
                      and 9.0 < float(h_end.min())
                      and float(h_end.max()) < 12.0 and counts == expect)}
        return run, end, rec

    def finish(rec, what):
        say(rec)
        if not rec["ok"]:
            raise RuntimeError(f"a {what} rollout failed its checks")

    def clobber(r):
        """After a capture: free what nothing holds, then take memory of the
        sizes of what the graph reads outside its pool (the one-launch
        step's scratch, the exchange's index tables), eight tensors of each,
        filled with NaN. A graph whose step was freed replays into them, and
        its end state is no longer the loop's. Returns them (held until the
        replays are done)."""
        gc.collect()
        torch.cuda.empty_cache()
        S_, B_ = r.state[0].shape[:2]
        L_ = r.sb.ops.send.shape[1]
        # floats: the stage-1 triple, stage 2's receive buffer, an index
        # table (int64)
        sizes = (3 * S_ * B_ * r.sb.meta.n_v, S_ * B_ * L_ * 3, 2 * S_ * L_)
        held = [torch.full((n,), float("nan"), dtype=f32, device=dev)
                for n in sizes for _ in range(8)]
        torch.cuda.synchronize()
        return held

    def graph_rollout(r, make_step, kind, loop_end, loop_us):
        """``r``'s rollout through ``make_step``'s steps captured into one
        CUDA graph (``capture_sharded_rollout``) and replayed: its end state
        bit-equal to the per-step loop's (``loop_end``) on two replays made
        after the memory the graph does not own was taken and overwritten
        (``clobber``), the time a step of a replay (median of 3), the
        capture's time (with the graph's instantiation and one warm-up step)
        and launches recorded, and the idle share of a profiled replay."""
        batch, n = r.state[0].shape[1], r.n_steps
        rdma.launches = stage.launches = 0
        t0 = time.perf_counter()
        replay = sbx.capture_sharded_rollout(r, n, make_step)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        counts = {"sw2d_stage_blocked": stage.launches,
                  "sw2d_step_rdma_blocked": rdma.launches}
        held = clobber(r)
        t0 = time.perf_counter()
        end = replay()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(end, loop_end))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            replay()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        secs = statistics.median(times)
        prof = profile_solve(
            f"sharded_rollout_graph_profile_{kind}_S{r.sb.n_shards}_B{batch}",
            card, replay, secs)
        same_again = all(torch.equal(a, b) for a, b in zip(end, loop_end))
        del held
        # the warm-up step before the capture, then the n steps recorded
        per = {"rdma": {"sw2d_stage_blocked": 0, "sw2d_step_rdma_blocked": 1},
               "fused": {"sw2d_stage_blocked": 2,
                         "sw2d_step_rdma_blocked": 0}}[kind]
        expect = {k: v * (n + 1) for k, v in per.items()}
        us = secs * 1e6 / n
        rec = {"phase": "sharded_rollout_graph", "step": kind, "card": card,
               "n_shards": r.sb.n_shards, "batch": batch,
               "k_elem": r.ctx.k_elem, "n_order": n_order, "n_steps": n,
               "us_per_step": us, "loop_us_per_step": loop_us,
               "faster_than_loop": us < loop_us,
               "replay_seconds": times,
               "capture_and_instantiate_seconds": capture_s,
               "first_replay_seconds": first_s,
               "launches_at_capture": counts,
               "launches_recorded_per_step": per,
               "device_idle_share": prof["device_idle_share"],
               "device_busy_us_per_step": (
                   None if prof["device_busy_ms"] is None
                   else prof["device_busy_ms"] * 1e3 / n),
               "bit_equal_to_loop": same and same_again,
               "ok": same and same_again and counts == expect}
        finish(rec, "captured sharded")

    rdma_launches = 0
    for n_shards in sbx.ROLLOUT_SHARDS:
        for batch in sbx.ROLLOUT_BATCHES:
            r = sbx.sharded_rollout_problem(n_shards, batch, device=dev)
            check_two = n_shards > 1 and batch == max(sbx.ROLLOUT_BATCHES)
            run, fused_end, rec = long_rollout(
                r, "sharded_rollout", BS.make_sharded_blocked_step_fused,
                {"sw2d_stage_blocked": 2 * r.n_steps,
                 "sw2d_step_rdma_blocked": 0})
            if check_two:
                # the first steps against the unsharded blocked rollout on
                # the same partitioned mesh, from the same start
                ops, meta = TB.build_blocked_step_ops(
                    r.ctx, SWPhysics(g=9.81), device=dev)
                want = TB.sw2d_rollout_blocked(
                    ops, meta, *(BS.join_shards(f).contiguous()
                                 for f in r.state),
                    None, r.dt, n_steps=SHD_CHECK_STEPS)
                got = run(SHD_CHECK_STEPS)
                torch.cuda.synchronize()
                err = max_abs([BS.join_shards(f) for f in got], want)
                rec["vs_unsharded_blocked_max_abs"] = err
                rec["vs_unsharded_steps"] = SHD_CHECK_STEPS
                rec["ok"] = rec["ok"] and err <= BLK_FWD_ATOL
            finish(rec, "sharded")
            fused_us = rec["us_per_step"]

            # the same rollout, one launch a step; its end state against the
            # fused rollout's after all r.n_steps steps
            rrun, end, rec = long_rollout(
                r, "sharded_rollout_rdma", BS.make_sharded_blocked_step_rdma,
                {"sw2d_stage_blocked": 0,
                 "sw2d_step_rdma_blocked": r.n_steps})
            rdma_launches += rec["launches"]["sw2d_step_rdma_blocked"]
            err = max_abs(end, fused_end)
            rec.update(fused_us_per_step=fused_us,
                       vs_fused_end_max_abs=err,
                       vs_fused_end_bit_equal=all(
                           torch.equal(a, b) for a, b in zip(end, fused_end)))
            rec["ok"] = rec["ok"] and err <= BLK_FWD_ATOL
            if check_two:
                # the first steps against the fused rollout (two stage
                # kernels a step) from the same start
                got, want = rrun(SHD_CHECK_STEPS), run(SHD_CHECK_STEPS)
                torch.cuda.synchronize()
                err = max_abs(got, want)
                rec["vs_fused_max_abs"] = err
                rec["vs_fused_bit_equal"] = all(
                    torch.equal(a, b) for a, b in zip(got, want))
                rec["vs_fused_steps"] = SHD_CHECK_STEPS
                rec["ok"] = rec["ok"] and err <= BLK_FWD_ATOL
            finish(rec, "one-launch sharded")
            # both rollouts again, each captured into one CUDA graph
            graph_rollout(r, BS.make_sharded_blocked_step_rdma, "rdma", end,
                          rec["us_per_step"])
            graph_rollout(r, BS.make_sharded_blocked_step_fused, "fused",
                          fused_end, fused_us)
            del r, end, fused_end

    # ---- the main path: the sharded MPC at both sizes ----
    wrappers = (TB.sw2d_stage_blocked, TB.sw2d_stage_bwd_blocked_v2)
    counts = lambda: {w.__name__: w.launches for w in wrappers}
    sbx.solve_sharded_mpc(example, iters=1)  # warm-up: allocator, autograd
    sbx.solve_sharded_mpc(full, iters=1)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    sol_ex = sbx.solve_sharded_mpc(example)
    torch.cuda.synchronize()
    ex_s = time.perf_counter() - t0
    launches_example = counts()
    t0 = time.perf_counter()
    sol = sbx.solve_sharded_mpc(full)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    launches = counts()

    # per Adam iteration one rollout (2 stages a step) and its adjoint, one
    # more rollout for the final cost; two solves
    per_solve = sbx.MPC_ITERS * 2 * sbx.MPC_STEPS
    expect = {"sw2d_stage_blocked": 2 * (per_solve + 2 * sbx.MPC_STEPS),
              "sw2d_stage_bwd_blocked_v2": 2 * per_solve}
    # the control gradient at zero controls against the blocked path's
    # (the same cost through make_rollout_blocked on the same mesh)
    cs0 = torch.zeros_like(full.hidden, requires_grad=True)
    (g_sh,) = torch.autograd.grad(sbx.sharded_mpc_cost(full, cs0), cs0)
    ops, meta = TB.build_blocked_step_ops(full.ctx, SWPhysics(g=9.81),
                                          *sbx.injectors(full.ctx), device=dev)
    roll = TB.make_rollout_blocked(ops, meta, full.dt, 1)
    c_b = torch.zeros((1, *full.hidden.shape), dtype=f32, device=dev,
                      requires_grad=True)
    traj = roll(*(BS.join_shards(f).contiguous() for f in full.state0), c_b)
    cost_b = (((traj[1][:, -1] - BS.join_shards(full.target)) ** 2).sum()
              + sbx.R_CONTROL * (c_b ** 2).sum())
    (g_bl,) = torch.autograd.grad(cost_b, c_b)
    torch.cuda.synchronize()
    grad_err = float((g_sh - g_bl[0]).abs().max() / g_bl.abs().max())

    finite = lambda *ts: all(bool(torch.isfinite(t).all()) for t in ts)
    ex_ratio = float(sol_ex.cost / sol_ex.cost_history[0])
    full_ratio = float(sol.cost / sol.cost_history[0])
    path_ok = (finite(sol_ex.cost_history, sol_ex.controls, sol.cost_history,
                      sol.controls, g_sh)
               and ex_ratio < SHD_EXAMPLE_RATIO and full_ratio < 1.0
               and grad_err <= SHD_GRAD_RTOL and launches == expect)
    say({"phase": "sharded_path", "ok": path_ok, "card": card,
         "adam_iters": sbx.MPC_ITERS, "n_steps": sbx.MPC_STEPS,
         "example": {"k_elem": example.ctx.k_elem,
                     "n_shards": example.sb.n_shards,
                     "first_cost": float(sol_ex.cost_history[0]),
                     "final_cost": float(sol_ex.cost),
                     "final_over_first": ex_ratio,
                     "max_final_over_first": SHD_EXAMPLE_RATIO,
                     "controls_step0": sol_ex.controls[0].tolist(),
                     "seconds_per_solve": ex_s},
         "full": {"k_elem": full.ctx.k_elem, "n_shards": full.sb.n_shards,
                  "first_cost": float(sol.cost_history[0]),
                  "final_cost": float(sol.cost),
                  "final_over_first": full_ratio,
                  "seconds_per_solve": full_s,
                  "grad_vs_blocked_rel_err": grad_err,
                  "grad_tol": SHD_GRAD_RTOL},
         "launches": launches, "expected_launches": expect,
         "launches_example_solve": launches_example})
    if not path_ok:
        raise RuntimeError("sharded path failed its checks")
    # the adjoint's launches at each shape of the path: the full-width
    # solve's and the example's
    bwd = "sw2d_stage_bwd_blocked_v2"
    at_path[0]["launches"] = launches[bwd] - launches_example[bwd]
    at_path[1]["launches"] = launches_example[bwd]
    say({"phase": "sharded_adjoint_at_path_shapes", "card": card,
         "records": at_path})

    profile_solve("sharded_profile", card, lambda: sbx.solve_sharded_mpc(full),
                  full_s)

    # ---- the same full-width solve through the plain versions ----
    # (the kernels' target). First the rounding floor: the cost through the
    # plain versions at the hidden controls (the kernels' cost there is the
    # control term alone) and at the kernels' final controls.
    with torch.no_grad():
        hidden_kernel = float(sbx.sharded_mpc_cost(full, full.hidden))
    before = counts()
    with plain_stages(BS, TB):
        with torch.no_grad():
            hidden_plain = float(sbx.sharded_mpc_cost(full, full.hidden))
            same_plain = float(sbx.sharded_mpc_cost(full, sol.controls))
        t0 = time.perf_counter()
        ref = sbx.solve_sharded_mpc(full)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if before != counts():
        raise RuntimeError("the plain-version solve launched a kernel")
    ratio = float(sol.cost / ref.cost)
    cross_ok = SHD_COST_RATIO[0] <= ratio <= SHD_COST_RATIO[1]
    say({"phase": "sharded_cross_check", "ok": cross_ok, "cost_ratio": ratio,
         "tol": list(SHD_COST_RATIO), "plain_seconds_per_solve": plain_s,
         "hidden_cost_kernels": hidden_kernel,
         "hidden_cost_plain": hidden_plain,
         "rounding_floor_over_final_cost":
             (hidden_plain - hidden_kernel) / float(sol.cost),
         "same_controls_cost_ratio": float(sol.cost) / same_plain,
         "controls_max_abs_diff":
             float((sol.controls - ref.controls).abs().max())})
    if not cross_ok:
        raise RuntimeError("sharded solve through the kernels disagrees with "
                           "the solve through the plain versions")

    # ---- the record ----
    src = "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu"
    replaces = {
        "sw2d_stage_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:962",
        "sw2d_stage_bwd_blocked_v2": "blitzdg_tpu/ops/sw2d_blocked.py:1710",
        "sw2d_step_rdma_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:1118"}
    # the one-launch step's path is the four rollouts above
    launches["sw2d_step_rdma_blocked"] = rdma_launches
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             "device_launches_per_call": TB.DEVICE_LAUNCHES_PER_CALL,
             **({"at_path_shapes": rec["at_path_shapes"]}
                if "at_path_shapes" in rec else {})}
            for name, rec in head.items()]


# ---------------------------------------------------------------------------
# The elliptic path
# ---------------------------------------------------------------------------

def mgs_pair_us(n: int, dev, reps: int = 2000) -> float:
    """Host-issued time in us of one modified Gram-Schmidt pair (a dot
    product and an update, as ``solvers.krylov.gmres`` issues them) on
    vectors of ``n`` float32 entries, CUDA events over ``reps`` pairs."""
    v = torch.randn(n, device=dev)
    w = torch.randn(n, device=dev)
    for _ in range(10):
        w = w - torch.sum(v * w, dim=-1)[..., None] * v
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        w = w - torch.sum(v * w, dim=-1)[..., None] * v
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


def elliptic_phases(dev, card: str, rng, flush) -> list:
    """The elliptic solvers at the JAX benchmark's Poisson configuration.
    No kernel of its own: returns no kernel record."""
    import scipy.sparse.linalg as spla

    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.ops.poisson import (apply_mass, assemble_poisson2d,
                                               poisson2d_op)
    from blitzdg_tpu_torch.solvers import (CONV_DIVERGED, CONV_INF_OR_NAN,
                                           block_jacobi_from_assembled, cg,
                                           gmres, two_level_from_assembled)
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    # ---- set-up ----
    t0 = time.perf_counter()
    mesh = box_triangles(ELL_CELLS, ELL_CELLS)
    ctx = build_triangle_context(ELL_ORDER, mesh, dtype=torch.float32,
                                 device=dev)
    host = build_triangle_context(ELL_ORDER, mesh, dtype=torch.float64,
                                  device="cpu")
    t_ctx = time.perf_counter() - t0
    t0 = time.perf_counter()
    OP, MM = assemble_poisson2d(host)
    t_asm = time.perf_counter() - t0
    K, n_p = ctx.k_elem, ctx.n_p
    t0 = time.perf_counter()
    bj = block_jacobi_from_assembled(OP, K, n_p, device=dev)
    t_bj = time.perf_counter() - t0
    t0 = time.perf_counter()
    tl = two_level_from_assembled(host, OP, device=dev)
    t_tl = time.perf_counter() - t0
    t0 = time.perf_counter()
    lu = spla.splu(OP.tocsc())
    t_lu = time.perf_counter() - t0
    torch.cuda.synchronize()
    say({"phase": "elliptic_setup", "card": card, "k_elem": K,
         "n_order": ELL_ORDER, "n_dof": K * n_p,
         "reduced": ["mesh: box_triangles(23, 23), K=1058, for the "
                     "benchmark's box.msh (K=1046), which is not in the "
                     "repository"],
         "context_s": t_ctx, "assemble_s": t_asm, "block_jacobi_s": t_bj,
         "two_level_s": t_tl, "splu_factor_s": t_lu, "nnz": int(OP.nnz)})

    shape = (K, n_p)
    calls = {"matvec": 0}

    def mv(v):
        calls["matvec"] += 1
        return -poisson2d_op(ctx, v.reshape(*v.shape[:-1], *shape),
                             symmetrize=True).reshape(v.shape)

    def oracle_gap(x, rhs):
        """max |x - splu(OP) rhs| per right-hand side (float64 host)."""
        bh = rhs.double().cpu().numpy().reshape(-1, K * n_p)
        xh = x.double().cpu().numpy().reshape(-1, K * n_p)
        ref = lu.solve(bh.T).T
        return np.abs(xh - ref).max(axis=1)

    bad = (CONV_INF_OR_NAN, CONV_DIVERGED)
    uex = torch.sin(np.pi * ctx.x) * torch.sin(np.pi * ctx.y)
    b = apply_mass(ctx, 2.0 * np.pi ** 2 * uex).reshape(-1)

    # ---- GMRES(300), block-Jacobi ----
    kw = dict(tol=ELL_TOL, restart=ELL_RESTART, maxiter=ELL_GMRES_MAXITER,
              precon=bj)
    t0 = time.perf_counter()
    gmres(mv, b, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    calls["matvec"] = 0
    t0 = time.perf_counter()
    res = gmres(mv, b, **kw)
    torch.cuda.synchronize()
    gmres_ms = (time.perf_counter() - t0) * 1e3
    cycles = int(res.iters)
    # Arnoldi steps of each cycle: the same cycles one call at a time (each
    # call's matvecs: its initial residual, one a step, the true residual)
    steps, x = [], None
    for _ in range(cycles):
        calls["matvec"] = 0
        x = gmres(mv, b, x, **{**kw, "maxiter": 1}).x
        steps.append(calls["matvec"] - 2)
    pairs = sum(j * (j + 1) // 2 for j in steps)
    pair_us = mgs_pair_us(K * n_p, dev)
    gap = float(oracle_gap(res.x, b).max())
    flag = int(res.flag)
    ok = flag not in bad and gap < ELL_SPLU_ATOL
    say({"phase": "elliptic_gmres", "ok": ok, "card": card, "ms": gmres_ms,
         "first_call_s": first_s, "restarts": cycles,
         "arnoldi_steps_per_cycle": steps,
         "relres": float(res.relres), "flag": flag, "tol": ELL_TOL,
         "max_abs_vs_splu": gap, "gate": ELL_SPLU_ATOL,
         "mgs_pairs": pairs, "mgs_pair_us": pair_us,
         "mgs_ms_estimate": pairs * pair_us / 1e3})
    if not ok:
        raise RuntimeError("elliptic GMRES failed its gate")

    # ---- 64 right-hand sides through block-Jacobi CG ----
    offs = np.random.default_rng(0).uniform(-0.5, 0.5, size=(ELL_NB, 2))
    offs = torch.as_tensor(offs.astype(np.float32), device=dev)
    ox, oy = offs[:, 0, None, None], offs[:, 1, None, None]
    fs = apply_mass(ctx, 2.0 * np.pi ** 2 * torch.sin(np.pi * (ctx.x - ox))
                    * torch.sin(np.pi * (ctx.y - oy))).reshape(ELL_NB, -1)
    fs = fs.contiguous()
    kw = dict(tol=ELL_TOL, maxiter=ELL_CG_MAXITER, precon=bj)
    cg(mv, fs, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resb = cg(mv, fs, **kw)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    rel = resb.relres.double().cpu().numpy()
    its = resb.iters.cpu().numpy()
    flags = resb.flag.cpu().numpy()
    gaps = oracle_gap(resb.x, fs)
    ok = (not np.isin(flags, bad).any() and bool(np.isfinite(rel).all())
          and float(gaps.max()) < ELL_SPLU_ATOL)
    say({"phase": "elliptic_cg_batched", "ok": ok, "card": card,
         "rhs": ELL_NB, "ms": batch_s * 1e3,
         "ms_per_rhs": batch_s * 1e3 / ELL_NB,
         "relres_max": float(rel.max()), "relres_median": float(np.median(rel)),
         "iters_max": int(its.max()), "iters_min": int(its.min()),
         "iters_median": float(np.median(its)),
         "iters_spread": int(its.max() - its.min()),
         "flags": {str(int(f)): int((flags == f).sum())
                   for f in np.unique(flags)},
         "max_abs_vs_splu": float(gaps.max()), "gate": ELL_SPLU_ATOL})
    if not ok:
        raise RuntimeError("elliptic batched CG failed its gate")
    # the idle share over the first ELL_PROFILE_ITERS iterations (every
    # iteration issues the same launches)
    window = lambda: cg(mv, fs, **{**kw, "maxiter": ELL_PROFILE_ITERS})
    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    profile_solve("elliptic_cg_batched_profile", card, window,
                  time.perf_counter() - t0, cuda_only=True)

    # ---- one right-hand side: two-level CG beside block-Jacobi CG ----
    one = fs[0].contiguous()
    rows = {}
    for name, pre in (("two_level", tl), ("block_jacobi", bj)):
        cg(mv, one, tol=ELL_TOL, maxiter=ELL_CG_MAXITER, precon=pre)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r1 = cg(mv, one, tol=ELL_TOL, maxiter=ELL_CG_MAXITER, precon=pre)
        torch.cuda.synchronize()
        rows[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "iters": int(r1.iters), "relres": float(r1.relres),
                      "flag": int(r1.flag),
                      "max_abs_vs_splu": float(oracle_gap(r1.x, one).max())}
    ok = all(r["flag"] not in bad and r["max_abs_vs_splu"] < ELL_SPLU_ATOL
             for r in rows.values())
    say({"phase": "elliptic_cg_twolevel", "ok": ok, "card": card, **rows,
         "gate": ELL_SPLU_ATOL})
    if not ok:
        raise RuntimeError("elliptic two-level CG failed its gate")
    return []


# ---------------------------------------------------------------------------
# The MPC solvers over the plain composite
# ---------------------------------------------------------------------------

def solver_phases(dev, card: str, rng, flush) -> list:
    """Gauss-Newton and the receding-horizon loop at the headline shape
    over the plain composite, cross-checked against the B2 and B1 kernels.
    They launch no kernel on their own path: returns no kernel record."""
    import dataclasses

    from blitzdg_tpu_torch.mpc import (advance_plant_fused, build_fused_mpc,
                                       mpc_cost, mpc_cost_fused,
                                       receding_horizon, rollout_controls,
                                       solve_mpc_fused, solve_mpc_gn)
    from blitzdg_tpu_torch.mpc import coastal_box as cbx
    from blitzdg_tpu_torch.mpc.solver import _mpc_residuals
    from blitzdg_tpu_torch.ops import sw2d_fused as F
    from blitzdg_tpu_torch.ops.sw2d import sw2d_rhs

    cb = cbx.coastal_box_problem(device=dev)
    fm = build_fused_mpc(cb.prob, cb.forcing_bu, cb.forcing_bv,
                         tidal=cb.tidal, device=dev)
    ctx, phys = cb.prob.ctx, cb.prob.phys
    tide = lambda t: F._tidal_depth(fm.meta, t)
    prob = dataclasses.replace(
        cb.prob, rhs_fn=lambda s, t: sw2d_rhs(ctx, s, t, phys,
                                              tidal_forcing=tide))
    BU = torch.as_tensor(cb.forcing_bu, dtype=torch.float32, device=dev)
    BV = torch.as_tensor(cb.forcing_bv, dtype=torch.float32, device=dev)

    def forcing(c, control, state, t):
        return (torch.zeros_like(state.h),
                torch.einsum("...j,jkn->...kn", control, BU),
                torch.einsum("...j,jkn->...kn", control, BV))

    wrappers = (F.sw2d_step_fused, F.sw2d_rollout_fused,
                F.sw2d_rollout_bwd_fused)
    B, H = cbx.BATCH, prob.horizon
    zeros = torch.zeros((B, H, 2), device=dev)
    with torch.no_grad():
        cost0 = mpc_cost(prob, cb.states, zeros, cb.targets, forcing,
                         cb.H_rest)

    # ---- Gauss-Newton over the composite ----
    gn = lambda iters: solve_mpc_gn(prob, cb.states, cb.targets, forcing, 2,
                                    gn_iters=iters, cg_iters=GN_CG_ITERS,
                                    H_rest=cb.H_rest)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = gn(GN_ITERS)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = torch.cat([cost0[None], sol.cost_history], dim=0)  # (1+it, B)
    finite = bool(torch.isfinite(hist).all()) and bool(
        torch.isfinite(sol.controls).all())
    monotone = bool((hist[1:] <= hist[:-1]).all())
    with torch.no_grad():
        kcost = mpc_cost_fused(cb.prob, fm, cb.states, sol.controls,
                               cb.targets, cb.H_rest)
    ratio = kcost / sol.cost
    rmin, rmax = float(ratio.min()), float(ratio.max())
    # the main path's Adam solve, for comparison
    adam = solve_mpc_fused(cb.prob, fm, cb.states, cb.targets, 2,
                           iters=cbx.ITERS, learning_rate=cbx.LEARNING_RATE,
                           H_rest=cb.H_rest)
    q = lambda t: [float(v) for v in torch.quantile(
        t.double(), torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64,
                                 device=t.device))]
    ok = (finite and monotone and COST_RATIO[0] <= rmin
          and rmax <= COST_RATIO[1] and all(v == 0 for v in launches.values()))
    say({"phase": "gn_path", "ok": ok, "card": card, "batch": B,
         "gn_iters": GN_ITERS, "cg_iters": GN_CG_ITERS,
         "reduced": ["Gauss-Newton outer iterations 5 -> 2 (time)"],
         "seconds": gn_s, "peak_memory_gb": peak_gb,
         "cost_history_min_median_max": [q(hrow) for hrow in hist],
         "cost_history_first4": hist[:, :4].T.tolist(),
         "accepted_per_iter": [int((hist[i + 1] < hist[i]).sum())
                               for i in range(GN_ITERS)],
         "median_final_cost": float(sol.cost.median()),
         "median_final_cost_adam_main_path": float(adam.cost.median()),
         "adam_iters": cbx.ITERS,
         "grad_norm_median": float(sol.grad_norm.median()),
         "grad_norm_max": float(sol.grad_norm.max()),
         "launches": launches, "finite": finite, "non_increasing": monotone,
         "b2_cost_ratio_min": rmin, "b2_cost_ratio_max": rmax,
         "tol": list(COST_RATIO)})
    if not ok:
        raise RuntimeError("Gauss-Newton path failed its checks")
    # the idle share of one CG step of Gauss-Newton (its bulk: 8 of about
    # 9.5 rollout-sized passes an outer iteration are J v and a pullback),
    # through graphs recorded at GN's controls as the solver records them
    c_req = sol.controls.detach().requires_grad_(True)
    r = _mpc_residuals(prob, cb.states, c_req, cb.targets, forcing,
                       cb.H_rest)
    u = torch.zeros_like(r, requires_grad=True)
    jtu = torch.autograd.grad(r, c_req, u, create_graph=True)[0]
    v = torch.ones_like(c_req)

    def cg_step():
        jv = torch.autograd.grad(jtu, u, v, retain_graph=True)[0]
        torch.autograd.grad(r, c_req, jv, retain_graph=True)

    cg_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg_step()
    torch.cuda.synchronize()
    profile_solve("gn_profile_cg_step", card, cg_step,
                  time.perf_counter() - t0, cuda_only=True)
    del r, u, jtu

    # ---- receding horizon over the composite ----
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    end, applied, costs = receding_horizon(
        prob, cb.states, cb.targets, forcing, 2, n_cycles=RH_CYCLES,
        iters=RH_ITERS, learning_rate=cbx.LEARNING_RATE, H_rest=cb.H_rest)
    torch.cuda.synchronize()
    rh_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    # each cycle's plant step, composite against the B1 kernel, from the
    # same state and the cycle's applied control, clock at t = 0 (C23)
    plant = dataclasses.replace(prob, horizon=1)
    s_comp, s_kern, errs = cb.states, cb.states, []
    with torch.no_grad():
        for k in range(RH_CYCLES):
            ctl = applied[:, k].contiguous()
            s_next, _ = rollout_controls(plant, s_comp, ctl[:, None, :],
                                         forcing)
            s_kern = advance_plant_fused(cb.prob, fm, s_comp, ctl, t0=0.0)
            errs.append(max_abs(list(s_next), list(s_kern)))
            s_comp = s_next
    end_err = max_abs(list(end), list(s_comp))
    ok = (tuple(applied.shape) == (B, RH_CYCLES, 2)
          and bool(torch.isfinite(costs).all())
          and max(errs) <= FWD_ATOL and end_err <= FWD_ATOL
          and all(v == 0 for v in launches.values()))
    say({"phase": "receding_horizon_path", "ok": ok, "card": card,
         "batch": B, "n_cycles": RH_CYCLES, "iters": RH_ITERS,
         "seconds": rh_s, "applied_shape": list(applied.shape),
         "cost_median_per_cycle": [float(c) for c in costs.median(dim=0)
                                   .values],
         "plant_vs_b1_max_abs": errs, "tol": FWD_ATOL,
         "end_state_vs_replay_max_abs": end_err, "launches": launches})
    if not ok:
        raise RuntimeError("receding-horizon path failed its checks")
    return []


# ---------------------------------------------------------------------------
# Quadrilaterals, ins2d, the 1D solvers
# ---------------------------------------------------------------------------

def quads_phases(dev, card: str, rng, flush) -> list:
    """Quadrilateral elements: the sw2dquads example through the plain
    tensor code (``quads_sw2d``), B4-B9 on four-face elements against their
    plain versions (``quads_kernels``), the example's problem, a blocked
    Adam solve and the sharded steps through them (``quads_path``) and the
    solve's cross-check (``quads_cross_check``). Returns the quad rows of
    the ``kernels`` line."""
    from blitzdg_tpu_torch.context import BC_OUT
    from blitzdg_tpu_torch.mesh import box_quads
    from blitzdg_tpu_torch.mpc import (MPCProblem, build_blocked_mpc,
                                       solve_mpc_blocked)
    from blitzdg_tpu_torch.mpc import blocked_box as bbx
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt, retag_east_open
    from blitzdg_tpu_torch.mpc.sharded_box import injectors
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.ops.sw2d import (SWPhysics, SWState, apply_filter,
                                            sw2d_rhs, sw2d_timestep)
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel import partition_mesh
    from blitzdg_tpu_torch.specgrid.quad import build_quad_context
    from blitzdg_tpu_torch.timestepping import ssprk2_step
    from blitzdg_tpu_torch.utils import build_sponge_coefficient

    f32, N = torch.float32, QD_ORDER
    kw = dict(filter_cutoff=0.9 * N, filter_order=4)
    phys = SWPhysics(g=9.81)
    t0 = time.perf_counter()
    ctx = build_quad_context(N, box_quads(*QD_CELLS), dtype=f32, device=dev,
                             **kw)
    host = build_quad_context(N, box_quads(*QD_CELLS), dtype=torch.float64,
                              device="cpu", **kw)
    setup_s = time.perf_counter() - t0

    def weights(c):  # the mass-weighted quadrature weights, float64 host
        V = c.V.double().cpu().numpy()
        w = np.linalg.inv(V @ V.T).sum(axis=0)
        return w[None, :] * c.J.double().cpu().numpy()

    wq = weights(ctx)
    mass = lambda h: (wq * h.double().cpu().numpy().reshape(
        -1, *wq.shape)).sum(axis=(1, 2))

    def start(c, heights=(1.0,)):
        eta = torch.exp(-10.0 * (c.x**2 + c.y**2))
        amp = torch.tensor(heights, dtype=c.x.dtype, device=c.x.device)
        h = 10.0 + amp[:, None, None] * eta
        return SWState(h=h, hu=torch.zeros_like(h), hv=torch.zeros_like(h))

    def chunk(c, s, t, n):
        rhs = lambda a, b: sw2d_rhs(c, a, b, phys)
        post = lambda f: apply_filter(c, f)
        for _ in range(n):
            dt = sw2d_timestep(c, s, phys.g, QD_CFL)
            s = ssprk2_step(rhs, s, t, dt, post_stage=post)
            t = t + dt
        return s, t

    # ---- the example through the plain tensor code ----
    unb = lambda s: SWState(*(f[0] for f in s))
    s = unb(start(ctx))
    mass0 = float(mass(s.h)[0])
    t0 = time.perf_counter()
    ref, _ = chunk(host, unb(start(host)), torch.zeros((), dtype=torch.float64),
                   QD_CHUNK_STEPS)
    cpu_s = time.perf_counter() - t0
    t = torch.zeros((), dtype=f32, device=dev)
    chunk(ctx, s, t, 2)  # warm-up
    torch.cuda.synchronize()
    eta_max, first_err = [], None
    t0 = time.perf_counter()
    for i in range(QD_CHUNKS):
        s, t = chunk(ctx, s, t, QD_CHUNK_STEPS)
        eta_max.append(float((s.h - 10.0).abs().max()))  # the example's read
        if i == 0:
            first_err = max_abs([f.double().cpu() for f in s], list(ref))
    run_s = time.perf_counter() - t0
    drift = abs(float(mass(s.h)[0]) - mass0) / abs(mass0)
    ok = (all(bool(torch.isfinite(f).all()) for f in s)
          and all(np.isfinite(eta_max)) and drift < QD_MASS_DRIFT
          and first_err <= QD_CPU_ATOL)
    n_all = QD_CHUNKS * QD_CHUNK_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(ctx, s, t, QD_CHUNK_STEPS)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    say({"phase": "quads_sw2d", "ok": ok, "card": card,
         "k_elem": ctx.k_elem, "n_order": N, "n_p": ctx.n_p,
         "n_faces": ctx.n_faces, "steps": n_all, "t_final": float(t),
         "setup_s": setup_s, "ms_per_step": run_s * 1e3 / n_all,
         "eta_max_per_chunk": eta_max, "mass_drift": drift,
         "mass_drift_max": QD_MASS_DRIFT,
         "first_chunk_vs_cpu_float64": first_err, "tol": QD_CPU_ATOL,
         "cpu_float64_chunk_s": cpu_s})
    if not ok:
        raise RuntimeError("the quad shallow-water example failed its checks")
    profile_solve("quads_sw2d_profile", card,
                  lambda: chunk(ctx, s, t, QD_CHUNK_STEPS), chunk_s)

    # ---- B4/B5 on quads against their plain versions ----
    mesh = box_quads(*QD_CELLS)
    retag_east_open(mesh)
    cc = build_quad_context(N, mesh, dtype=f32, device=dev, **kw)
    H = 10.0 + 2.0 * cc.x + torch.sin(2.0 * cc.y)
    open_nodes = (cc.bc_table[:, :, None].expand(-1, -1, cc.n_fp)
                  .reshape(cc.k_elem, -1) == BC_OUT).cpu().numpy()
    cphys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                      Hx=2.0 * torch.ones_like(H),
                      Hy=2.0 * torch.cos(2.0 * cc.y),
                      sponge=build_sponge_coefficient(cc, open_nodes,
                                                      width=0.3, strength=0.5))
    xs, ys = cc.x.double().cpu().numpy(), cc.y.double().cpu().numpy()
    bump = np.exp(-8.0 * (xs ** 2 + ys ** 2))
    tidal = (12.0, 0.5, 2.0, 10.0)
    cops, cmeta = TB.build_blocked_step_ops(
        cc, cphys, np.stack([bump, 0 * bump]), np.stack([0 * bump, bump]),
        tidal=tidal, device=dev)
    if not (cmeta.n_faces == 4 and cmeta.wb and cmeta.has_sponge
            and cmeta.tidal == tidal and int(cops.obc.sum()) > 0):
        raise RuntimeError("the quad coastal case does not switch every "
                           "term on")
    h, hu, hv, ctrls = perturbed_blocked(cc, H.reshape(1, -1), QD_BATCH, 2,
                                         2, rng, dev)
    head = check_blocked_case(TB, f"quads_coastal_K{cc.k_elem}_N{N}", cops,
                              cmeta, h, hu, hv, ctrls,
                              cfl_dt(cc, 9.81, 13.5), 2, 4, 1.0, flush, rng,
                              timed=True)
    # the sharded kernels on the same mesh partitioned into QD_SHARDS
    sc = build_quad_context(N, partition_mesh(mesh, QD_SHARDS)[0], dtype=f32,
                            device=dev, **kw)
    Hs = 10.0 + 2.0 * sc.x + torch.sin(2.0 * sc.y)
    open_s = (sc.bc_table[:, :, None].expand(-1, -1, sc.n_fp)
              .reshape(sc.k_elem, -1) == BC_OUT).cpu().numpy()
    sphys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=Hs,
                      Hx=2.0 * torch.ones_like(Hs),
                      Hy=2.0 * torch.cos(2.0 * sc.y),
                      sponge=build_sponge_coefficient(sc, open_s, width=0.3,
                                                      strength=0.5))
    sbu, sbv = injectors(sc)
    ssb = BS.build_sharded_blocked(sc, sphys, QD_SHARDS, tidal=tidal,
                                   forcing_bu=sbu, forcing_bv=sbv, device=dev)
    if not (ssb.meta.n_faces == 4 and len(ssb.plan.offs) >= 2):
        raise RuntimeError("the partitioned quad mesh has no ring offsets")
    sdt = cfl_dt(sc, 9.81, 13.5)
    hs, hus, hvs, sc_ctrl = perturbed_blocked(sc, Hs.reshape(1, -1),
                                              QD_BATCH, 1, 2, rng, dev,
                                              ctrl_scale=1.0)
    sst = tuple(BS.split_shards(f, QD_SHARDS) for f in (hs, hus, hvs))
    sctrl = sc_ctrl[0, 0].contiguous()
    name = f"K{sc.k_elem}_N{N}_S{QD_SHARDS}_B{QD_BATCH}"
    head.update(check_sharded_case(TB, BS, f"quads_sharded_coastal_{name}",
                                   ssb, sst, sctrl, sdt, 1.0, True, flush,
                                   rng, timed=True))
    head["sw2d_step_rdma_blocked"] = check_rdma_case(
        TB, BS, f"quads_rdma_coastal_{name}", ssb, sst, sctrl, sdt, 1.0,
        flush, timed=True)
    plans = {"rollout": TB.rollout_plan(cops, cmeta, QD_BATCH),
             "rollout_bwd": TB.rollout_bwd_plan(cops, cmeta, QD_BATCH),
             "stage": TB.shard_plan(ssb.ops, ssb.meta, QD_BATCH),
             "stage_bwd": TB.shard_plan(ssb.ops, ssb.meta, QD_BATCH,
                                        adjoint=True),
             "step_rdma": TB.shard_plan(ssb.ops, ssb.meta, QD_BATCH,
                                        step=True)}
    # above N=4 (Np 36) every kernel refuses a quad set, naming itself
    o5, m5 = TB.build_blocked_step_ops(
        build_quad_context(5, box_quads(2, 2), dtype=f32, device=dev),
        phys, device=dev)
    refused = {}
    for which, kname in TB._KERNEL_NAMES.items():
        try:
            TB._shard_plan(TB._lib(), TB._desc(m5, blocked=True), o5, 1,
                           which)
            refused[kname] = False
        except ValueError as e:
            refused[kname] = "N <= 4" in str(e) and kname in str(e)
    # every q kernel takes the N=4 instance, eight lanes an element: the
    # blocked rollout (B5, B4), its adjoint (B6), the sharded stage (B7),
    # its adjoint (B8) and the one-launch step (B9, both modes)
    plans["step_rdma_peer"] = TB.shard_plan(rank_ops(ssb.ops, 0), ssb.meta,
                                            QD_BATCH, step=True, peer=True)
    kern_ok = all(refused.values()) and all(
        p["lanes_per_element"] == 8 for p in plans.values())
    say({"phase": "quads_kernels", "ok": kern_ok, "card": card,
         "cases": sorted({r["case"] for r in head.values()}),
         "refused_quads_n5": refused, "plans": plans})
    if not kern_ok:
        raise RuntimeError("a q kernel took quads above N=4, or a quad plan "
                           "has other lanes an element than its instance")

    # ---- the main path on quads: the example's problem through B5 and B4,
    # the blocked Adam solve (B5, B6) and the sharded steps on the
    # partitioned mesh (B7, B8, B9) ----
    ops, meta = TB.build_blocked_step_ops(ctx, phys, device=dev)
    heights = tuple(1.0 + 0.1 * b for b in range(QD_BATCH))
    st = tuple(f.reshape(QD_BATCH, -1).contiguous()
               for f in start(ctx, heights))
    dt = float(sw2d_timestep(ctx, unb(start(ctx)), phys.g, QD_CFL))
    m0 = mass(st[0])
    roll = lambda x, n: TB.sw2d_rollout_blocked(ops, meta, *x, None, dt,
                                                n_steps=n)
    # the references of the first launch: the plain version in float64 (its
    # operator set formed from the float64 host context) and in float32
    ops64, meta64 = TB.build_blocked_step_ops(host, phys, dtype=torch.float64,
                                              device=dev)
    ref64 = TB.sw2d_rollout_blocked_plain(ops64, meta64,
                                          *(f.double() for f in st), None, dt,
                                          n_steps=QD_CHUNK_STEPS)
    plain32 = TB.sw2d_rollout_blocked_plain(ops, meta, *st, None, dt,
                                            n_steps=QD_CHUNK_STEPS)

    # the blocked MPC on the quad mesh: rest start, the two injectors, a
    # reachable target (the end state under the hidden controls)
    qdt = cfl_dt(host, 9.81, 11.0, cfl=0.7)
    hx, hy = host.x.numpy(), host.y.numpy()
    qbump = np.exp(-8.0 * (hx ** 2 + hy ** 2))
    qprob = MPCProblem(ctx=ctx, phys=SWPhysics(g=9.81), dt=qdt,
                       horizon=bbx.HORIZON,
                       steps_per_control=bbx.STEPS_PER_CONTROL, q_eta=0.0,
                       q_terminal=1e6, r_control=1e-8)
    quad_mpc = lambda **fb: build_blocked_mpc(
        qprob, np.stack([qbump, 0 * qbump]), np.stack([0 * qbump, qbump]),
        device=dev, **fb)
    qbm = quad_mpc()
    qh0 = torch.full((QD_BATCH, ctx.k_elem, ctx.n_p), bbx.H_REST, dtype=f32,
                     device=dev)
    qstates = SWState(qh0, torch.zeros_like(qh0), torch.zeros_like(qh0))
    scale = 1.0 + 0.1 * torch.arange(QD_BATCH, dtype=f32, device=dev)
    hidden = QD_HIDDEN * scale[:, None, None] * torch.ones(
        QD_BATCH, bbx.HORIZON, 2, dtype=f32, device=dev)
    qflat = lambda f: f.reshape(QD_BATCH, -1).contiguous()
    with torch.no_grad():
        qth, _, _ = qbm.rollout(qflat(qh0), qflat(qstates.hu),
                                qflat(qstates.hv), hidden)
    qtargets = (qth[:, -1] - bbx.H_REST).reshape(qh0.shape).contiguous()
    adam = lambda bm: solve_mpc_blocked(
        qprob, bm, qstates, qtargets, 2, iters=QD_ADAM_ITERS,
        learning_rate=QD_LR, H_rest=bbx.H_REST)

    # the sharded steps: fused (B7), one-launch (B9), differentiable (B7,
    # B8), QD_SHARD_STEPS steps from the sharded state above
    fused = BS.make_sharded_blocked_step_fused(ssb, sdt)
    rdma = BS.make_sharded_blocked_step_rdma(ssb, sdt)
    diff = BS.make_sharded_blocked_step_diff(ssb, sdt)

    def sharded_roll(step, state):
        carry, t = (state, BS.initial_send_buffer(ssb, state)), 1.0
        for _ in range(QD_SHARD_STEPS):
            carry = step(carry, t, sctrl)
            t += sdt
        return carry

    w_end = torch.as_tensor(rng.standard_normal(tuple(sst[0].shape)),
                            dtype=f32, device=dev)

    def sharded_grad():
        h0 = sst[0].clone().requires_grad_(True)
        (hN, _, _), _ = sharded_roll(diff, (h0, sst[1], sst[2]))
        return torch.autograd.grad((hN * w_end).sum(), h0)[0]

    adam(qbm)  # warm-up: allocator, autograd
    roll(st, 1)
    sharded_roll(fused, sst)
    sharded_roll(rdma, sst)
    sharded_grad()
    torch.cuda.synchronize()
    wrappers = (TB.sw2d_step_blocked, TB.sw2d_rollout_blocked,
                TB.sw2d_rollout_bwd_blocked, TB.sw2d_stage_blocked,
                TB.sw2d_stage_bwd_blocked_v2, TB.sw2d_step_rdma_blocked)
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    x, first = st, None
    for i in range(QD_CHUNKS):
        x = roll(x, QD_CHUNK_STEPS)
        first = x if i == 0 else first
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    for k in range(QD_STEPS):
        x = TB.sw2d_step_blocked(ops, meta, *x, None, dt,
                                 (n_all + k) * dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = adam(qbm)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    end_fused = sharded_roll(fused, sst)
    end_rdma = sharded_roll(rdma, sst)
    gsh = sharded_grad()
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}

    drift = float(np.max(np.abs(mass(x[0]) - m0) / np.abs(m0)))
    err = max_abs([f.double() for f in first], ref64)
    # the sharded rollouts against the unsharded blocked rollout (B5) on the
    # same partitioned mesh, and the sharded gradient against its adjoint
    # (B6); the controls one vector a step, as the sharded steps take them
    bops, bmeta = TB.build_blocked_step_ops(sc, sphys, sbu, sbv, tidal=tidal,
                                            device=dev)
    join = lambda f: BS.join_shards(f).contiguous()
    bctrl = sctrl.reshape(1, 1, -1).expand(QD_BATCH, QD_SHARD_STEPS,
                                           -1).contiguous()
    broll = TB.make_rollout_blocked(bops, bmeta, sdt, 1, t0=1.0)
    bh0 = join(sst[0]).requires_grad_(True)
    bth, _, _ = broll(bh0, join(sst[1]), join(sst[2]), bctrl)
    bgrad = torch.autograd.grad((bth[:, -1] * join(w_end)).sum(), bh0)[0]
    with torch.no_grad():
        bref = TB.sw2d_rollout_blocked(bops, bmeta, join(sst[0]),
                                       join(sst[1]), join(sst[2]), bctrl,
                                       sdt, t0=1.0)
    fused_vs_blocked = max_abs([join(f) for f in end_fused[0]], bref)
    rdma_same = all(torch.equal(a, b) for a, b in zip(end_fused[0],
                                                      end_rdma[0]))
    grad_rel = float((join(gsh) - bgrad).abs().max() / bgrad.abs().max())
    expect_nonzero = all(v > 0 for v in launches.values())
    decrease = float((sol.cost_history[0] / sol.cost).median())
    ok = (all(bool(torch.isfinite(f).all()) for f in x)
          and drift < QD_MASS_DRIFT and err <= QD_PATH_ATOL
          and expect_nonzero and bool(torch.isfinite(sol.cost).all())
          and decrease > 1.0 and rdma_same
          and fused_vs_blocked <= BLK_FWD_ATOL and grad_rel <= SHD_GRAD_RTOL)
    say({"phase": "quads_path", "ok": ok, "card": card, "batch": QD_BATCH,
         "k_elem": meta.k_elem, "n_order": N, "dt": dt,
         "steps": n_all + QD_STEPS, "launches": launches,
         "ms_per_rollout_step": roll_s * 1e3 / n_all,
         "us_per_step_per_scenario": roll_s * 1e6 / n_all / QD_BATCH,
         "mass_drift_max_over_scenarios": drift,
         "first_chunk_vs_plain_float64_max_abs": err, "tol": QD_PATH_ATOL,
         "plain_float32_vs_float64_max_abs": max_abs(
             [f.double() for f in plain32], ref64),
         "first_chunk_vs_plain_float32_max_abs": max_abs(first, plain32),
         "plan": TB.rollout_plan(ops, meta, QD_BATCH),
         "adam_iters": QD_ADAM_ITERS, "adam_seconds_per_solve": adam_s,
         "adam_first_cost": float(sol.cost_history[0].median()),
         "adam_final_cost": float(sol.cost.median()),
         "adam_cost_decrease": decrease,
         "sharded_steps": QD_SHARD_STEPS, "n_shards": QD_SHARDS,
         "sharded_seconds": shard_s,
         "sharded_fused_vs_blocked_max_abs": fused_vs_blocked,
         "sharded_rdma_same_bits_as_fused": rdma_same,
         "sharded_grad_vs_blocked_rel": grad_rel,
         "grad_tol": SHD_GRAD_RTOL})
    if not ok:
        raise RuntimeError("the quad path through B4-B9 failed its checks")
    profile_solve("quads_adam_profile", card, lambda: adam(qbm), adam_s)
    profile_solve("quads_sharded_profile", card,
                  lambda: (sharded_roll(fused, sst), sharded_roll(rdma, sst),
                           sharded_grad()), shard_s)

    # ---- the same Adam solve through the plain versions on the card ----
    before = {w.__name__: w.launches for w in wrappers}
    ref = adam(quad_mpc(forward=TB.sw2d_rollout_blocked_plain,
                        backward=TB.sw2d_rollout_bwd_blocked_plain))
    torch.cuda.synchronize()
    if before != {w.__name__: w.launches for w in wrappers}:
        raise RuntimeError("the plain-version quad solve launched a kernel")
    ratio = sol.cost / ref.cost
    rmin, rmax = float(ratio.min()), float(ratio.max())
    cross_ok = COST_RATIO[0] <= rmin and rmax <= COST_RATIO[1]
    say({"phase": "quads_cross_check", "ok": cross_ok,
         "scenarios": QD_BATCH, "cost_ratio_min": rmin,
         "cost_ratio_max": rmax, "tol": list(COST_RATIO)})
    if not cross_ok:
        raise RuntimeError("the quad Adam solve through the kernels "
                           "disagrees with the solve through the plain "
                           "versions")

    # ---- B9's peer mode on the partitioned mesh, four ranks in this
    # process ----
    peer_row = quads_peer_in_process(TB, BS, ssb, sst, sdt, card, rng, flush)

    src = "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu"
    replaces = {"sw2d_step_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:1288",
                "sw2d_rollout_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:1352",
                "sw2d_rollout_bwd_blocked":
                    "blitzdg_tpu/ops/sw2d_blocked.py:1491",
                "sw2d_stage_blocked": "blitzdg_tpu/ops/sw2d_blocked.py:962",
                "sw2d_stage_bwd_blocked_v2":
                    "blitzdg_tpu/ops/sw2d_blocked.py:1710",
                "sw2d_step_rdma_blocked":
                    "blitzdg_tpu/ops/sw2d_blocked.py:1118"}
    plan_of = {"sw2d_step_blocked": "rollout",
               "sw2d_rollout_blocked": "rollout",
               "sw2d_rollout_bwd_blocked": "rollout_bwd",
               "sw2d_stage_blocked": "stage",
               "sw2d_stage_bwd_blocked_v2": "stage_bwd",
               "sw2d_step_rdma_blocked": "step_rdma"}
    return [{"name": name + "_quads", "route": "cuda", "source": src,
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": None,
             "device_launches_per_call": TB.DEVICE_LAUNCHES_PER_CALL,
             "lanes_per_element": plans[plan_of[name]]["lanes_per_element"]}
            for name, rec in head.items()] + [peer_row]


def quads_peer_in_process(TB, BS, sb, state, dt: float, card: str, rng,
                          flush) -> dict:
    """``peer_quads_S4_in_process``: B9's peer mode on the quad path's
    partitioned mesh (``sb``: K=144 in 4 shards, N=4, coastal, tidal),
    its four ranks in this process on four streams
    (``run_peer_in_process``), PEER_STEPS steps from ``state`` (B=8) at
    ``dt`` from t0 = 1 with a control vector a step, the step's counter
    zeroed just before and read just after; every rank's end state, send
    buffer and step-boundary slots bit-equal to its shard of the stacked
    one-launch rollout, every state finite. Then rank 0's step alone (its
    flags set past any epoch, the others idle) from the first step's
    inputs and its stage-2 halo as the stacked step made it: bit-equal to
    the stacked step's shard 0, against the plain version, timed. Returns
    its row of the ``kernels`` line."""
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    S, B, meta = sb.n_shards, state[0].shape[1], sb.meta
    dev = state[0].device
    cs = torch.as_tensor(0.3 * rng.standard_normal((PEER_STEPS,
                                                    meta.n_ctrl)),
                         dtype=torch.float32, device=dev)
    t0 = 1.0
    # the reference: the stacked one-launch rollout, its first step's
    # stage-2 halo kept
    ex = RingExchange(sb.plan, meta.n_fp, device=dev)
    sbuf0 = BS.initial_send_buffer(sb, state)
    stacked = TB.RdmaLaunch(sb.ops, meta, ex)
    first = stacked(state, ex(sbuf0), dt, t0, cs[0])
    rb2_first = stacked._scratch[1][:1].clone()
    rstep = BS.make_sharded_blocked_step_rdma(sb, dt)
    carry, t = (state, sbuf0), t0
    for k in range(PEER_STEPS):
        carry = rstep(carry, t, cs[k])
        t += dt
    want = (*carry[0], carry[1])
    last_rb = ex(carry[1])
    torch.cuda.synchronize()
    TB.sw2d_step_rdma_blocked.launches = 0
    ends, us, rings, launches, free = run_peer_in_process(sb, state, cs, dt,
                                                          t0, dev)
    n_launches = TB.sw2d_step_rdma_blocked.launches
    try:
        bits = [all(torch.equal(a, b[r:r + 1]) for a, b in
                    zip(ends[r], want)) for r in range(S)]
        slots = [torch.equal(rings[r].rbb, last_rb[r:r + 1])
                 for r in range(S)]
        finite = all(bool(torch.isfinite(f).all())
                     for f in (*want[:3], *(g for e in ends for g in e[:3])))
        # rank 0 alone, from the first step's inputs
        ring0, ops0 = rings[0], rank_ops(sb.ops, 0)
        ring0.flags[1:] = 1 << 60
        st0 = tuple(f[:1] for f in state)
        rb0 = ex(sbuf0)[:1]
        ring0.rbb.copy_(rb0)
        ring0.rb2.copy_(rb2_first)
        alone = lambda: launches[0](st0, ring0.rbb, dt, t0, cs[0])
        got = alone()
        grid = TB.last_grid()
        alone_same = all(torch.equal(a, b[:1]) for a, b in zip(got, first))
        plain = lambda: TB.sw2d_step_rdma_blocked_plain(
            ops0, meta, st0, rb0, dt, lambda _: rb2_first, t0, cs[0])
        err = max_abs(got, plain())
        ms = time_ms(alone, 9, flush)
        plain_ms = time_ms(plain, 2, flush)
    finally:
        free()
    L = sb.ops.send.shape[1]
    n_wall = int(ops0.wall.sum())
    # the halos: stage 1's stored into the peers and read back in stage 2,
    # and stage 2's step-boundary one stored into the peers
    step_bound = bound(4.0 * (6 * B * meta.n_v + 2 * 3 * B * L + meta.n_ctrl)
                       + 4.0 * 3 * 3 * B * L, B * 2 * rhs_flops(meta, n_wall))
    plan = TB.shard_plan(ops0, meta, B, step=True, peer=True)
    ok = (all(bits) and all(slots) and finite and alone_same
          and err <= BLK_FWD_ATOL and n_launches == 2 * S * PEER_STEPS)
    say({"phase": "peer_quads_S4_in_process", "ok": ok, "card": card,
         "n_shards": S, "steps": PEER_STEPS, "batch": B,
         "k_elem": S * meta.k_elem, "n_order": QD_ORDER,
         "ring_offsets": list(sb.plan.offs), "bit_equal_to_stacked": bits,
         "slots_bit_equal_to_stacked_gather": slots, "finite": finite,
         "launches": n_launches, "us_per_step_host_clock": us,
         "rank0_alone_bit_equal_to_stacked_step": alone_same,
         "rank0_alone_vs_plain_max_abs": err, "tol": BLK_FWD_ATOL,
         "rank0_alone_ms": ms, "plan": plan, "grid_blocks": grid,
         "note": "four ranks on four streams of one process, their step "
                 "launches resident together; launches: an untimed and a "
                 "timed run of PEER_STEPS steps, four ranks each"})
    if not ok:
        raise RuntimeError("B9's peer mode on quads failed its checks")
    return {"name": "sw2d_step_rdma_blocked (peer)_quads", "route": "cuda",
            "source": "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu",
            "replaces": "blitzdg_tpu/ops/sw2d_blocked.py:1118",
            "launches": n_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": step_bound[0],
            "bound_by": step_bound[1], "library_ms": None,
            "lanes_per_element": plan["lanes_per_element"]}


def ins2d_phases(dev, card: str, rng, flush) -> list:
    """``examples/ins2d.py`` at ``examples/ins2d.nml`` (plain tensor code:
    no kernel of its own). Returns no kernel record."""
    from blitzdg_tpu_torch.config import namelist_get, read_namelist
    from blitzdg_tpu_torch.mesh import box_quads
    from blitzdg_tpu_torch.ops import ins2d as I2
    from blitzdg_tpu_torch.specgrid.quad import build_quad_context

    cfg = read_namelist(str(Path(__file__).resolve().parent / "examples"
                            / "ins2d.nml"))
    g = namelist_get(cfg, "gravitationalAcceleration", float, 9.81)
    t_init = namelist_get(cfg, "initialTime", float, 0.0)
    t_final = namelist_get(cfg, "finalTime", float, 0.2)
    N = namelist_get(cfg, "polynomialOrder", int, 2)
    kw = dict(filter_cutoff=namelist_get(cfg, "filterCutoff", float, 1.5),
              filter_order=namelist_get(cfg, "filterOrder", int, 4))
    steps = int(round((t_final - t_init) / INS_DT))
    mesh = box_quads(*INS_CELLS)

    def blob(c):
        rho = 0.01 * torch.exp(-8.0 * (c.x**2 + c.y**2))
        return I2.INSState(rho=rho, u=torch.zeros_like(rho),
                           v=torch.zeros_like(rho))

    def run(c, n, s=None):
        s = blob(c) if s is None else s
        for i in range(n):
            s, p = I2.ins2d_step(c, s, t_init + i * INS_DT, INS_DT, g=g)
        return s, p

    ke = lambda s: float((s.u.double() ** 2 + s.v.double() ** 2).sum())
    host = build_quad_context(N, mesh, dtype=torch.float64, device="cpu", **kw)
    t0 = time.perf_counter()
    ref, _ = run(host, steps)
    cpu_s = time.perf_counter() - t0
    ctx = build_quad_context(N, mesh, dtype=torch.float32, device=dev, **kw)
    run(ctx, 2)  # warm-up

    # CG iterations of every pressure solve, and the L2 norm (mass-
    # weighted) and the maximum of div u before and after each projection
    # (the module's own functions, wrapped; restored after the run)
    iters, divs = [], []
    orig_cg, orig_pp = I2.cg, I2.pressure_project
    wq = I2._quad_weights(ctx)

    def div_norms(c, u, v):
        d = I2.divergence(c, u, v)
        return torch.stack([torch.sqrt((wq * d * d).sum()), d.abs().max()])

    def counting_cg(*a, **k):
        res = orig_cg(*a, **k)
        iters.append(res.iters)
        return res

    def recording_pp(c, u, v, dt, **k):
        out = orig_pp(c, u, v, dt, **k)
        divs.append(torch.cat([div_norms(c, u, v),
                               div_norms(c, out[0], out[1])]))
        return out

    I2.cg, I2.pressure_project = counting_cg, recording_pp
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, p = run(ctx, steps)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        I2.cg, I2.pressure_project = orig_cg, orig_pp
    it = [int(i) for i in iters]
    d = torch.stack(divs).cpu().double().numpy()  # l2, max before; after
    lowered = bool((d[:, 2] < d[:, 0]).all())
    ke_gpu, ke_cpu = ke(s), ke(ref)
    ke_rel = abs(ke_gpu - ke_cpu) / ke_cpu
    finite = all(bool(torch.isfinite(f).all()) for f in (*s, p))
    u_max = float(s.u.abs().max())
    ok = (finite and u_max <= 1.0 and lowered and len(it) == steps
          and ke_rel <= INS_KE_RTOL)
    say({"phase": "ins2d", "ok": ok, "card": card, "k_elem": ctx.k_elem,
         "n_order": N, "steps": steps, "dt": INS_DT, "g": g,
         "ms_per_step": run_s * 1e3 / steps,
         "cg_iters_per_step": {"min": min(it), "median":
                               statistics.median(it), "max": max(it)},
         "ke": ke_gpu, "ke_cpu_float64": ke_cpu, "ke_rel_diff": ke_rel,
         "ke_rtol": INS_KE_RTOL, "u_max": u_max,
         "div_l2_after_over_before_max": float((d[:, 2] / d[:, 0]).max()),
         "every_projection_lowers_div_l2": lowered,
         "div_max_before_last": float(d[-1, 1]),
         "div_max_after_last": float(d[-1, 3]),
         "projections_not_lowering_div_max": int((d[:, 3] >= d[:, 1]).sum()),
         "cpu_float64_run_s": cpu_s,
         "note": "ms_per_step includes four divergence norms a step"})
    if not ok:
        raise RuntimeError("the ins2d example failed its checks")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(ctx, INS_PROFILE_STEPS, s)
    torch.cuda.synchronize()
    profile_solve("ins2d_profile", card,
                  lambda: run(ctx, INS_PROFILE_STEPS, s),
                  time.perf_counter() - t0)
    return []


def dg1d_phases(dev, card: str, rng, flush) -> list:
    """``examples/advec1d.py`` and ``examples/burgers1d.py`` through
    ``integrate(lserk4_step, ...)`` in float32 (plain tensor code: no
    kernel of its own). Returns no kernel record."""
    from blitzdg_tpu_torch.ops import advec1d_rhs, burgers1d_rhs, burgers_exact
    from blitzdg_tpu_torch.specgrid import build_nodes1d
    from blitzdg_tpu_torch.timestepping import integrate, lserk4_step

    f32 = torch.float32
    recs, ok_all = [], True

    def timed(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # advection: N=4, K=30, x in [-1, 4], c=0.1, CFL 0.8, T=20
    N, K, c, CFL, T = 4, 30, 0.1, 0.8, 20.0
    ctx = build_nodes1d(N, K, -1.0, 4.0, dtype=f32, device=dev)
    x = ctx.x.double().cpu().numpy()
    dt = CFL * (x[0, 1] - x[0, 0]) / abs(c)
    n = int(np.ceil(T / dt))
    u, sec = timed(lambda: integrate(
        lserk4_step, lambda v, t: advec1d_rhs(ctx, v, t, c),
        torch.exp(-10.0 * ctx.x**2), 0.0, dt, n))
    err = float((u - torch.exp(-10.0 * (ctx.x - c * n * dt) ** 2)).abs().max())
    recs.append({"solver": "advec1d", "n_order": N, "k_elem": K,
                 "steps": n, "dt": dt, "max_err": err,
                 "bound": ADV_ERR_BOUND, "ms_per_step": sec * 1e3 / n})
    ok_all &= bool(np.isfinite(err)) and err < ADV_ERR_BOUND

    # viscous Burgers: N=6, K=40, x in [-5, 5], nu=0.1, c=0.5, CFL 0.75
    N, K, nu, c, alpha, CFL, T = 6, 40, 0.1, 0.5, 1.0, 0.75, 0.1
    ctx = build_nodes1d(N, K, -5.0, 5.0, dtype=f32, device=dev)
    x = ctx.x.double().cpu().numpy()
    md = x[0, 1] - x[0, 0]
    dt = CFL * min(md / abs(c), md**2 / np.sqrt(nu))
    n = int(np.ceil(T / dt))
    u, sec = timed(lambda: integrate(
        lserk4_step,
        lambda v, t: burgers1d_rhs(ctx, v, t, c=c, alpha=alpha, nu=nu),
        burgers_exact(ctx.x, 0.0, alpha, nu, c), 0.0, dt, n))
    err = float((u - burgers_exact(ctx.x, n * dt, alpha, nu, c)).abs().max())
    recs.append({"solver": "burgers1d", "n_order": N, "k_elem": K,
                 "steps": n, "dt": dt, "max_err": err,
                 "bound": BRG_ERR_BOUND, "ms_per_step": sec * 1e3 / n})
    ok_all &= bool(np.isfinite(err)) and err < BRG_ERR_BOUND
    say({"phase": "dg1d", "ok": ok_all, "card": card, "runs": recs})
    if not ok_all:
        raise RuntimeError("a 1D solver missed its error bound")
    return []


def halo_disk_case(dev, dtype=torch.float32):
    """The large Gordon-Hall disk (``mpc/curved_disk.py``, K=1014, N=3) with
    an open eastern arc, partitioned into max(HALO_CURVED_SHARDS) blocks,
    in ``dtype`` on ``dev``: its context, cubature and Gauss-face contexts,
    a moving four-field state, the physics and the tidal forcing."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.context import BC_OUT
    from blitzdg_tpu_torch.mesh import disk_triangles
    from blitzdg_tpu_torch.mesh.curved import (circle_projection,
                                               gordon_hall_deform,
                                               snap_boundary_vertices)
    from blitzdg_tpu_torch.mpc import curved_disk as cdk
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.ops.sw2d_curved import SWStateTracer
    from blitzdg_tpu_torch.specgrid.cubature import (build_cubature_context,
                                                     build_gauss_face_context)
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    N = 3
    dmesh = disk_triangles(cdk.LARGE["rings"], radius=1.0)
    bc = np.asarray(dmesh.bc_type).copy()
    mids = 0.5 * (dmesh.verts[dmesh.etov]
                  + dmesh.verts[np.roll(dmesh.etov, -1, axis=1)])
    bc[(bc > 0) & (mids[:, :, 0] > 0.7)] = BC_OUT
    dmesh.set_bc_type(bc)
    dmesh = TP.partition_mesh(dmesh, max(HALO_CURVED_SHARDS))[0]
    proj = circle_projection(0.0, 0.0, 1.0)
    faces = snap_boundary_vertices(dmesh, proj, tol=cdk.LARGE["snap_tol"])
    straight = build_triangle_context(N, dmesh, dtype=torch.float64,
                                      device="cpu")
    V = straight.V.numpy()
    x, y, _ = gordon_hall_deform(N, dmesh, straight.x.numpy(),
                                 straight.y.numpy(), faces, proj)
    dctx = build_triangle_context(N, dmesh, coords=(x, y), dtype=dtype,
                                  device=dev)
    cub = build_cubature_context(N, dmesh, x, y, V, dtype=dtype, device=dev)
    gauss = build_gauss_face_context(N, dmesh, x, y, V, dtype=dtype,
                                     device=dev)
    dphys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4)
    dforce = lambda t: 1.0 + 0.05 * np.cos(0.3 * t)
    deta = 0.05 * torch.exp(-5.0 * ((dctx.x - 0.2) ** 2 + dctx.y ** 2))
    dstate = SWStateTracer(1.0 + deta, 0.02 * deta, -0.01 * deta, deta)
    return dctx, cub, gauss, dstate, dphys, dforce


def halo_elliptic_case(dev, S: int = 4) -> dict:
    """The elliptic configuration (N=ELL_ORDER, box_triangles(ELL_CELLS,
    ELL_CELLS), K=1058) in float64 on ``dev``, partitioned into S and
    ghost-padded by ``pad_context``: the context, the padded one, its halo
    plan, the global penalty, the right-hand side of the manufactured
    solution unsharded (``b``) and padded into the shards (``bs``, (S,
    K_loc, Np)), the real elements' rows, the exact solution."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.ops.poisson import apply_mass
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    f64 = torch.float64
    emesh = box_triangles(ELL_CELLS, ELL_CELLS)
    sizes = TP.partition_block_sizes(emesh, S)
    ectx = build_triangle_context(ELL_ORDER, TP.partition_mesh(emesh, S)[0],
                                  dtype=f64, device=dev)
    pctx, real = TP.pad_context(ectx, sizes)
    tau = float((ectx.n_order + 1) ** 2 * ectx.fscale.max())
    uex = torch.sin(np.pi * ectx.x) * torch.sin(np.pi * ectx.y)
    b = -apply_mass(ectx, -2.0 * np.pi ** 2 * uex)
    bp = torch.zeros((pctx.k_elem, ectx.n_p), dtype=f64, device=dev)
    ridx = torch.as_tensor(np.flatnonzero(real), device=dev)
    bp[ridx] = b
    return {"S": S, "ctx": ectx, "pctx": pctx,
            "plan": TP.build_halo_plan(pctx, S), "tau": tau, "b": b,
            "bs": bp.reshape(S, -1, ectx.n_p), "ridx": ridx, "uex": uex}


def halo_phases(dev, card: str, rng, flush) -> list:
    """The element-sharded plain-tensor path of ``parallel/halo.py`` (no
    kernel of its own), every shard stacked on the card: the halo RHS
    against the unsharded RHS (``halo_rhs``), the scaling study's rollout
    and a coastal rollout with the sharded adaptive dt
    (``halo_rollout``), the curved halo RHS (``halo_curved``) and the
    sharded CG (``halo_elliptic``). Returns no kernel record."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
    from blitzdg_tpu_torch.ops.poisson import poisson2d_op
    from blitzdg_tpu_torch.ops.sw2d import (SWPhysics, SWState, sw2d_rhs,
                                            sw2d_timestep)
    from blitzdg_tpu_torch.ops.sw2d_curved import (SWStateTracer,
                                                   sw2d_curved_rhs)
    from blitzdg_tpu_torch.solvers import cg
    from blitzdg_tpu_torch.solvers.krylov import CONV_SUCCESS
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
    from blitzdg_tpu_torch.timestepping import ssprk2_step

    f32, N = torch.float32, 3
    rel = lambda got, ref: max(float((g.reshape(r.shape) - r).abs().max()
                                     / r.abs().max())
                               for g, r in zip(got, ref))
    mesh0 = box_triangles(32, 32)
    phys = SWPhysics(g=9.81)

    # ---- the halo RHS and the scaling study's rollout at S = 1, 2, 4, on
    # one partition into max(S) blocks (S shards: runs of those blocks) ----
    ctx = build_triangle_context(
        N, TP.partition_mesh(mesh0, max(HALO_SHARDS))[0], dtype=f32,
        device=dev)
    h = 10.0 + torch.exp(-10.0 * (ctx.x ** 2 + ctx.y ** 2))
    moving = SWState(h, 0.3 * h, -0.2 * h)
    ref = sw2d_rhs(ctx, moving, 0.0, phys)

    def rollout(rhs, s, n=HALO_STEPS):
        for _ in range(n):
            s = ssprk2_step(rhs, s, 0.0, HALO_DT)
        return s

    def timed(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rest = SWState(h, torch.zeros_like(h), torch.zeros_like(h))
    single_rhs = lambda a, t: sw2d_rhs(ctx, a, t, phys)
    ref_end, single = timed(lambda: rollout(single_rhs, rest))
    rows, ok = [], True
    for S in HALO_SHARDS:
        plan = TP.build_halo_plan(ctx, S)
        tables = TP.halo_tables(plan, device=dev)
        sc = TP.shard_context(ctx, S)
        split = lambda f: f.reshape(S, -1, ctx.n_p)
        rhs = lambda s, t, hd=None: TP.halo_sw2d_rhs(sc, s, t, phys, tables,
                                                     plan, halo_dtype=hd)
        sm = SWState(*map(split, moving))
        err = rel(rhs(sm, 0.0), ref)
        err_bf16 = rel(rhs(sm, 0.0, torch.bfloat16), ref)
        srest = SWState(*map(split, rest))
        end, sec = timed(lambda: rollout(rhs, srest))
        end_err = max_abs([f.reshape(r.shape) for f, r in zip(end, ref_end)],
                          ref_end)
        # the idle share of a 20-step window (the profiler's own cost grows
        # with the launches it records)
        _, win_s = timed(lambda: rollout(rhs, srest, 20))
        prof = profile_solve(f"halo_rollout_S{S}_profile", card,
                             lambda: rollout(rhs, srest, 20), win_s,
                             cuda_only=True)
        rows.append({"n_shards": S, "ring_offsets": list(plan.offs),
                     "max_send": plan.max_send, "rhs_rel_err": err,
                     "rhs_rel_err_bf16_halo": err_bf16,
                     "us_per_step": sec * 1e6 / HALO_STEPS,
                     "end_vs_unsharded_max_abs": end_err,
                     "device_idle_share": prof["device_idle_share"],
                     "launches_per_step": prof["device_kernel_launches"]
                     / 20})
        ok &= (err <= HALO_RHS_RTOL and end_err <= HALO_ROLL_ATOL
               and all(bool(torch.isfinite(f).all()) for f in end))
    say({"phase": "halo_rhs_rollout", "ok": ok, "card": card,
         "k_elem": ctx.k_elem, "n_order": N, "steps": HALO_STEPS,
         "dt": HALO_DT, "rows": rows,
         "unsharded_us_per_step": single * 1e6 / HALO_STEPS,
         "rhs_rtol": HALO_RHS_RTOL, "end_atol": HALO_ROLL_ATOL})
    if not ok:
        raise RuntimeError("the halo RHS or rollout disagrees with the "
                           "unsharded one")

    # ---- a coastal rollout with the sharded adaptive dt, S=4 ----
    S = 4
    m = box_triangles(32, 32)
    retag_east_open(m)
    ctx = build_triangle_context(N, TP.partition_mesh(m, S)[0], dtype=f32,
                                 device=dev)
    plan = TP.build_halo_plan(ctx, S)
    tables, sc = TP.halo_tables(plan, device=dev), TP.shard_context(ctx, S)
    split = lambda f: f.reshape(S, -1, ctx.n_p)
    H = 10.0 + 2.0 * ctx.x + torch.as_tensor(
        rng.uniform(0.0, 1.0, (ctx.k_elem, 1)), dtype=f32, device=dev)
    Hx, Hy = ctx.grad(H)
    cphys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy)
    sphys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=split(H),
                      Hx=split(Hx), Hy=split(Hy))
    forcing = lambda t: 12.0 + 0.5 * torch.cos(0.3 * t)
    eta = 0.1 * torch.exp(-5.0 * (ctx.x ** 2 + ctx.y ** 2))
    s1 = SWState(H + eta, 0.05 * eta, torch.zeros_like(eta))
    s4 = SWState(*map(split, s1))
    t1 = t4 = torch.zeros((), dtype=f32, device=dev)
    for _ in range(HALO_COASTAL_STEPS):
        d4 = TP.halo_sw2d_timestep(sc, s4, 9.81, 0.3)
        s4 = ssprk2_step(lambda a, t: TP.halo_sw2d_rhs(
            sc, a, t, sphys, tables, plan, tidal_forcing=forcing), s4, t4, d4)
        t4 = t4 + d4
        d1 = sw2d_timestep(ctx, s1, 9.81, 0.3)
        s1 = ssprk2_step(lambda a, t: sw2d_rhs(ctx, a, t, cphys,
                                               tidal_forcing=forcing),
                         s1, t1, d1)
        t1 = t1 + d1
    t_rel = abs(float(t4) - float(t1)) / float(t1)
    c_err = max_abs([f.reshape(r.shape) for f, r in zip(s4, s1)], s1)
    ok = t_rel <= HALO_ROLL_ATOL and c_err <= HALO_ROLL_ATOL
    say({"phase": "halo_coastal_adaptive_dt", "ok": ok, "card": card,
         "n_shards": S, "steps": HALO_COASTAL_STEPS, "t_end": float(t4),
         "t_end_rel_err": t_rel, "end_vs_unsharded_max_abs": c_err,
         "tol": HALO_ROLL_ATOL})
    if not ok:
        raise RuntimeError("the coastal halo rollout disagrees with the "
                           "unsharded one")

    # ---- the curved halo RHS on the large disk ----
    t0 = time.perf_counter()
    dctx, cub, gauss, dstate, dphys, dforce = halo_disk_case(dev)
    setup_s = time.perf_counter() - t0
    dref = sw2d_curved_rhs(dctx, cub, gauss, dstate, 0.37, dphys,
                           tidal_forcing=dforce)
    crv = []
    for S in HALO_CURVED_SHARDS:
        gplan = TP.build_gauss_halo_plan(gauss, S)
        got = TP.halo_sw2d_curved_rhs(
            TP.shard_context(dctx, S), TP.shard_context(cub, S),
            TP.shard_context(gauss, S),
            SWStateTracer(*(f.reshape(S, -1, dctx.n_p) for f in dstate)),
            0.37, dphys, TP.halo_tables(gplan, device=dev), gplan,
            tidal_forcing=dforce)
        crv.append({"n_shards": S, "ring_offsets": list(gplan.offs),
                    "rel_err": rel(got, dref)})
    ok = all(r["rel_err"] <= HALO_RHS_RTOL for r in crv)
    say({"phase": "halo_curved", "ok": ok, "card": card,
         "k_elem": dctx.k_elem, "n_order": N, "rows": crv,
         "rtol": HALO_RHS_RTOL, "setup_s": setup_s})
    if not ok:
        raise RuntimeError("the curved halo RHS disagrees with "
                           "sw2d_curved_rhs")

    # ---- the sharded CG on the ghost-padded elliptic configuration ----
    e = halo_elliptic_case(dev)
    S, ectx, pctx, eplan, tau, b, bs, ridx, uex = (
        e["S"], e["ctx"], e["pctx"], e["plan"], e["tau"], e["b"], e["bs"],
        e["ridx"], e["uex"])
    etables, esc = TP.halo_tables(eplan, device=dev), TP.shard_context(pctx, S)
    solve1 = lambda: cg(lambda v: -poisson2d_op(
        ectx, v.reshape(b.shape), tau=tau, symmetrize=True).reshape(-1),
        b.reshape(-1), tol=HALO_CG_TOL, maxiter=4000)
    solve4 = lambda: cg(lambda v: -TP.halo_poisson2d_op(
        esc, v.reshape(bs.shape), tau, etables, eplan,
        symmetrize=True).reshape(-1), bs.reshape(-1), tol=HALO_CG_TOL,
        maxiter=4000)
    timed = {}
    for key, fn in (("unsharded", solve1), ("sharded", solve4)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed[key] = (fn(), None)
        torch.cuda.synchronize()
        timed[key] = (timed[key][0], time.perf_counter() - t0)
    r1, s1_ = timed["unsharded"]
    r4, s4_ = timed["sharded"]
    x4 = r4.x.reshape(-1, ectx.n_p)[ridx]
    x_err = float((x4.reshape(-1) - r1.x).abs().max())
    u_err = float((x4 - uex).abs().max())
    ok = (int(r1.flag) == int(r4.flag) == CONV_SUCCESS
          and int(r1.iters) == int(r4.iters) and x_err <= HALO_CG_ATOL)
    say({"phase": "halo_elliptic", "ok": ok, "card": card,
         "k_elem": ectx.k_elem, "k_padded": pctx.k_elem, "n_shards": S,
         "n_order": ELL_ORDER, "dtype": "float64", "tol": HALO_CG_TOL,
         "iters_unsharded": int(r1.iters), "iters_sharded": int(r4.iters),
         "x_vs_unsharded_max_abs": x_err, "atol": HALO_CG_ATOL,
         "x_vs_exact_max_abs": u_err,
         "ms_per_iter_unsharded": s1_ * 1e3 / max(int(r1.iters), 1),
         "ms_per_iter_sharded": s4_ * 1e3 / max(int(r4.iters), 1)})
    if not ok:
        raise RuntimeError("the sharded CG disagrees with the unsharded CG")
    return []


def compat_phases(dev, card: str, rng, flush) -> list:
    """The pyblitzdg-compatible API (``compat.py``): the reference's
    advec1d numpy script through ``Nodes1DProvisioner`` and its poisson2d
    pattern through ``MeshManager``, ``TriangleNodesProvisioner`` (its
    context on the card) and ``Poisson2DSparseMatrix``, solved with scipy.
    Returns no kernel record."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from blitzdg_tpu_torch import compat as dg
    from blitzdg_tpu_torch.mesh import box_triangles

    t0 = time.perf_counter()
    p = dg.Nodes1DProvisioner(4, 30, -1.0, 4.0)
    p.buildNodes()
    p.computeJacobian()
    on_card = p._ctx.x.device.type == "cuda"
    x = p.xGrid
    Dr, rx, Lift, Fscale, nx = p.Dr, p.rx, p.Lift, p.Fscale, p.nx
    vmapM, vmapP, mapI, mapO = p.vmapM, p.vmapP, p.mapI, p.mapO
    c = 0.1

    def computeRHS(u):
        uVec = u.flatten("F")
        nxVec = nx.flatten("F")
        uM = uVec[vmapM]
        uP = uVec[vmapP].copy()
        uP[mapO] = uM[mapO]
        uP[mapI] = 0.0
        du = (uM - uP) * 0.5 * (c * nxVec - np.abs(c * nxVec))
        duMat = np.reshape(du, (2, 30), order="F")
        return -c * rx * (Dr @ u) + Lift @ (Fscale * duMat)

    u = np.exp(-10.0 * x ** 2)
    dt = 0.8 * (x[1, 0] - x[0, 0]) / c
    res = np.zeros_like(u)
    steps = int(np.ceil(20.0 / dt))
    for _ in range(steps):
        for i in range(5):
            res = dg.LSERK4.rk4a[i] * res + dt * computeRHS(u)
            u = u + dg.LSERK4.rk4b[i] * res
    adv_err = float(np.max(np.abs(u - np.exp(-10.0 * (x - c * steps * dt)
                                             ** 2))))
    adv_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mesh = box_triangles(12, 12)
    mm = dg.MeshManager()
    mm.buildMesh(mesh.etov, np.concatenate([mesh.verts,
                                            0 * mesh.verts[:, :1]], 1))
    tri = dg.TriangleNodesProvisioner(2, mm)
    view = tri.dgContext()
    on_card = on_card and tri._ctx.x.device.type == "cuda"
    poisson = dg.Poisson2DSparseMatrix(view, mm)
    OP, MM = poisson.getOP(), poisson.getMM()
    n = view.numLocalPoints * view.numElements
    A = sp.csc_matrix((OP[:, 2], (OP[:, 0].astype(int),
                                  OP[:, 1].astype(int))), shape=(n, n))
    M = sp.csr_matrix((MM[:, 2], (MM[:, 0].astype(int),
                                  MM[:, 1].astype(int))), shape=(n, n))
    # the port's element-major (K, Np) numbering: the view's (Np, K) fields
    # transposed
    xs, ys = view.x.T.reshape(-1), view.y.T.reshape(-1)
    uex = np.sin(np.pi * xs) * np.sin(np.pi * ys)
    sol = spla.spsolve(A, M @ (2.0 * np.pi ** 2 * uex))
    poi_err = float(np.max(np.abs(sol - uex)))
    poi_s = time.perf_counter() - t0
    ok = (on_card and adv_err < ADV_ERR_BOUND and poi_err < CMP_POISSON_ERR)
    say({"phase": "compat", "ok": ok, "card": card,
         "contexts_on_card": on_card,
         "advec1d": {"steps": steps, "max_err": adv_err,
                     "bound": ADV_ERR_BOUND, "seconds": adv_s},
         "poisson2d": {"k_elem": view.numElements, "n_order": 2,
                       "nnz": int(OP.shape[0]), "max_err": poi_err,
                       "bound": CMP_POISSON_ERR, "seconds": poi_s}})
    if not ok:
        raise RuntimeError("the pyblitzdg-compatible scripts failed")
    return []


# ---------------------------------------------------------------------------
# PEER path: the one-launch step across ranks, one process a shard
# ---------------------------------------------------------------------------

PEER_STEPS = 64
PEER_BATCH = 8
# (name, shards, delayed rank: (rank, every n-th step, seconds slept before
# it) or None)
PEER_CASES = (("peer_S4", 4, None), ("peer_S2", 2, None),
              ("peer_S4_delayed_rank", 4, (2, 8, 0.5)))
PEER_WORKER_TIMEOUT = 300  # seconds, each worker process
PEER_TIMED_REPS = 9
# the long in-process run: steps; the most cycles a rank drawn at each
# step is held on its stream before it (about 0.1 ms at 1.98 GHz, three
# steps of a rank alone); its dt, a fraction of the set's, so that its
# steps span the time of 256 of the set's. Over a longer time the coastal
# set's currents grow at its open boundary until its state is no longer
# finite: after 449 steps of the set's dt from the inputs of
# tests/test_torch_coastal_blowup.py in float64, and after 450 in the JAX
# package's plain step on the same inputs (ROADMAP C31), so it is the
# reference's. 256 steps' time is 0.57 of that, where bits still tell a
# stale halo from a fresh one.
PEER_LONG_STEPS = 2048
PEER_LONG_DELAY_CYCLES = 200_000
PEER_LONG_DT_FRACTION = 1 / 8
# the fresh-process run: steps
PEER_FRESH_STEPS = 8


def peer_problem(S: int, dev, shards=None, dtype=torch.float32):
    """The coastal set of ``rdma_coastal_K2048_N3_S4`` (K=2048, N=3,
    bathymetry with the well-balanced star fluxes, drag, Coriolis, tidal
    depth on the open east side, sponge toward it, two controls) on the
    box partitioned into S shards: (context, set, still-water depth, dt).
    ``shards``: the shards held here (one rank's, or all); ``dtype``: the
    set's. The context is built in float64 on the host, so that every
    process that builds the set gets the same bits."""
    from blitzdg_tpu_torch.context import BC_OUT
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc import sharded_box as sbx
    from blitzdg_tpu_torch.mpc.coastal_box import cfl_dt, retag_east_open
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel import partition_mesh
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
    from blitzdg_tpu_torch.utils import build_sponge_coefficient

    n = sbx.N_ORDER
    mesh = box_triangles(*sbx.CELLS)
    retag_east_open(mesh)
    cc = build_triangle_context(n, partition_mesh(mesh, S)[0],
                                dtype=torch.float64, device="cpu",
                                filter_cutoff=0.9 * n, filter_order=4)
    H = 10.0 + 2.0 * cc.x + torch.sin(2.0 * cc.y)
    open_nodes = (cc.bc_table[:, :, None].expand(-1, -1, cc.n_fp)
                  .reshape(cc.k_elem, -1) == BC_OUT).cpu().numpy()
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=2.0 * torch.ones_like(H),
                     Hy=2.0 * torch.cos(2.0 * cc.y),
                     sponge=build_sponge_coefficient(cc, open_nodes, width=0.3,
                                                     strength=0.5))
    bu, bv = sbx.injectors(cc)
    sb = BS.build_sharded_blocked(cc, phys, S, dtype=dtype,
                                  tidal=(12.0, 0.5, 2.0, 10.0),
                                  forcing_bu=bu, forcing_bv=bv, device=dev,
                                  shards=shards)
    return cc, sb, H, cfl_dt(cc, 9.81, 13.5)


def peer_worker(cfg: dict) -> int:
    """One rank of a peer case, in a process of its own: joins the gloo
    group, builds its shard of the set on the card, runs PEER_STEPS steps of
    ``make_sharded_blocked_step_rdma(sb, dt, group=g)`` (counters zeroed
    just before and read just after), holds its step-boundary slots (its
    peers' last send buffers) against the group's plain exchange (gloo, on
    CPU copies), and, where asked, times its step kernel and its exchange
    alone (every other rank idle at a barrier, this rank's flags set past
    any epoch, so that no wait holds it; the exchange's device time too, a
    launch of a CUDA graph of STAGE_PEER_GRAPH_LAUNCHES). Writes its
    results to the case's directory."""
    import torch.distributed as dist

    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel import peer as PR
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    S, rank, B = cfg["S"], cfg["rank"], cfg["batch"]
    delay = cfg["delay"]
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{cfg['port']}", world_size=S, rank=rank)
    group = dist.group.WORLD
    inp = torch.load(Path(cfg["dir"]) / "inputs.pt")
    sb = peer_problem(S, dev, shards=(rank,))[1]
    dt, t0 = inp["dt"], inp["t0"]
    state = tuple(inp[k][rank:rank + 1].to(dev) for k in ("h", "hu", "hv"))
    cs = inp["cs"].to(dev)
    step = BS.make_sharded_blocked_step_rdma(sb, dt, group=group)
    carry = (state, BS.initial_send_buffer(sb, state))
    kern, exch = TB.sw2d_step_rdma_blocked, PR.peer_ring_exchange
    stage = TB.sw2d_stage_blocked
    torch.cuda.synchronize()
    dist.barrier()
    kern.launches = exch.launches = stage.launches = 0
    t = t0
    for k in range(PEER_STEPS):
        if delay is not None and rank == delay[0] and k % delay[1] == 0:
            time.sleep(delay[2])
        carry = step(carry, t, cs[k])
        t += dt
        if k == 0:
            # the first step also made the ring (a collective set-up):
            # the wall clock starts after it
            first = [f.clone() for f in (*carry[0], carry[1])]
            torch.cuda.synchronize()
            w0 = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    ring = step.ring
    launches = {"sw2d_step_rdma_blocked (peer)": kern.launches,
                "peer_ring_exchange": exch.launches,
                "sw2d_stage_blocked": stage.launches}
    dist.barrier()
    # the step-boundary slots that the peers' last steps filled against the
    # plain version: the process group's ring exchange of the last send
    # buffers (gloo point-to-point on CPU copies)
    rbb = ring.rbb.cpu()
    plain_rb = RingExchange(sb.plan, sb.meta.n_fp, group)(carry[1].cpu())
    out = {"final": [f.cpu() for f in (*carry[0], carry[1])],
           "first": [f.cpu() for f in first], "rbb": rbb,
           "exchange_vs_gloo": float((rbb - plain_rb).abs().max()),
           "launches": launches, "wall_s": wall,
           "device": torch.cuda.get_device_name(0)}
    if cfg["timed"]:
        scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                              device=dev)
        flush = lambda: scratch.zero_()
        launch = TB.RdmaLaunch(sb.ops, sb.meta, ring)
        st1, sb1 = tuple(first[:3]), first[3]
        for r in range(S):
            if r == rank:
                ring.flags[1:] = 1 << 60
                torch.cuda.synchronize()
                out["step_ms"] = time_ms(
                    lambda: launch(st1, ring.rbb, dt, t0, cs[0]),
                    PEER_TIMED_REPS, flush)
                # (the exchange kernel's launch: ring(sbuf) launches it
                # for a ring's first step only)
                out["exchange_ms"] = time_ms(lambda: ring._exchange(sb1),
                                             PEER_TIMED_REPS, flush)
                out["exchange_device_ms"] = graph_us(
                    [lambda: ring._exchange(sb1)],
                    n=STAGE_PEER_GRAPH_LAUNCHES) / 1e3
                out["plan"] = TB.shard_plan(sb.ops, sb.meta, B, step=True,
                                            peer=True)
            dist.barrier()
    ring.close()
    torch.save(out, Path(cfg["dir"]) / f"rank{rank}.pt")
    dist.destroy_process_group()
    print(f"PEER_OK rank={rank}", flush=True)
    return 0


def peer_fresh_worker(cfg: dict) -> int:
    """The S=4 ring's ranks in one fresh process (this script started with
    ``--peer-fresh``; lazy module loading): builds the set and the state on
    the card (torch's own kernels), loads one torch kernel of its own that
    the loop launches (``torch.cuda._sleep``), makes the rings and the
    ranks' launches and runs PEER_FRESH_STEPS steps, at each step one rank
    held back on its stream before it; no kernel of the port is launched
    before the first step, so each of them is first launched inside the
    loop, while its peers' steps wait at their flags. Writes the ranks' end
    (h, hu, hv, sb) to the case's directory."""
    dev = torch.device("cuda", 0)
    inp = torch.load(Path(cfg["dir"]) / "inputs.pt")
    S = 4
    sb = peer_problem(S, dev)[1]
    from blitzdg_tpu_torch.parallel import blocked_shard as BS

    state = tuple(inp[k].to(dev) for k in ("h", "hu", "hv"))
    cs, dt, t = inp["cs"].to(dev), inp["dt"], inp["t0"]
    sbuf0 = BS.initial_send_buffer(sb, state)
    torch.cuda._sleep(1)  # the caller's own kernel of the loop, loaded
    torch.cuda.synchronize()
    rings, launches, streams, free = peer_ranks_in_process(
        sb, state[0].shape[1], dev)
    try:
        carry = [(tuple(f[r:r + 1] for f in state), sbuf0[r:r + 1])
                 for r in range(S)]
        for k in range(PEER_FRESH_STEPS):
            for r in range(S):
                with torch.cuda.stream(streams[r]):
                    if r == k % S:
                        torch.cuda._sleep(PEER_LONG_DELAY_CYCLES)
                    st, sbuf = carry[r]
                    *s2, sb2 = launches[r](st, rings[r](sbuf), dt, t, cs[k])
                    carry[r] = (tuple(s2), sb2)
            t += dt
        torch.cuda.synchronize()
        ends = [[f.cpu() for f in (*c[0], c[1])] for c in carry]
    finally:
        free()
    torch.save(ends, Path(cfg["dir"]) / "fresh.pt")
    print("PEER_FRESH_OK", flush=True)
    return 0


def run_peer_fresh(case_dir: Path) -> list:
    """``peer_fresh_worker`` in a process of its own (lazy module loading
    asked for), under PEER_WORKER_TIMEOUT, always ended; fails unless it
    exits 0. Returns the ranks' ends."""
    import os

    env = dict(os.environ, CUDA_MODULE_LOADING="LAZY")
    p = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--peer-fresh",
         json.dumps({"dir": str(case_dir)})], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
    try:
        log = p.communicate(timeout=PEER_WORKER_TIMEOUT)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 0 or "PEER_FRESH_OK" not in log:
        raise RuntimeError(f"the fresh-process ring failed (exit "
                           f"{p.returncode}):\n{log[-4000:]}")
    return torch.load(case_dir / "fresh.pt")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_peer_workers(S: int, case_dir: Path, delay, timed: bool) -> list:
    """S worker processes of this script (``--peer-worker``), one a rank,
    each on the card; waits for all (each under its own timeout), always
    ends them, and fails unless every one exits 0. Returns their results
    by rank."""
    port = _free_port()
    procs = []
    for r in range(S):
        cfg = {"S": S, "rank": r, "batch": PEER_BATCH, "port": port,
               "dir": str(case_dir), "delay": delay, "timed": timed}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--peer-worker",
             json.dumps(cfg)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PEER_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0 or f"PEER_OK rank={r}" not in log:
            raise RuntimeError(f"peer worker {r} of {S} failed (exit "
                               f"{p.returncode}):\n{log[-4000:]}")
    return [torch.load(case_dir / f"rank{r}.pt") for r in range(S)]


def peer_ranks_in_process(sb, batch: int, dev):
    """The S ranks of ``sb``'s ring in this process: S regions of this
    process, each rank's ``PeerRing`` over plain pointers into the others
    (``PeerRing.over_regions``), its own operator set and its own stream.
    Returns the rings, the ranks' ``RdmaLaunch``es, their streams and a
    function that frees the regions."""
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import peer as PR

    S = sb.n_shards
    lib = PR._lib()
    lay = PR.region_layout(batch, sb.ops.send.shape[1], len(sb.plan.offs))
    bases = {}

    def free():
        torch.cuda.synchronize()
        for p in bases.values():
            lib.peer_free(p)

    for r in range(S):
        p = ctypes.c_void_p()
        PR._check(lib, lib.peer_alloc(dev.index or 0, lay["bytes"],
                                      ctypes.byref(p)), "peer_alloc")
        bases[r] = p.value
    rings = [PR.PeerRing.over_regions(sb.plan, sb.meta.n_fp, batch, r, bases,
                                      dev) for r in range(S)]
    launches = [TB.RdmaLaunch(rank_ops(sb.ops, r), sb.meta, rings[r])
                for r in range(S)]
    streams = [torch.cuda.Stream(dev) for _ in range(S)]
    return rings, launches, streams, free


def run_peer_in_process(sb, state, cs, dt: float, t0: float, dev,
                        n_steps: int = PEER_STEPS):
    """The S ranks of ``sb``'s ring in this process
    (``peer_ranks_in_process``): ``n_steps`` steps enqueued rank after
    rank, untimed, then again over new rings (a ring carries its steps'
    send buffers, so a rollout from the start takes a ring of its own) on
    the host clock (synchronised). The ranks' step launches are resident on
    the card together and meet only through their flags: the only run in
    which their kernels run at the same time (processes without MPS
    time-slice the card). Returns each rank's end (h, hu, hv, sb), the us a
    step of the timed run, the timed run's rings and ranks' launches (their
    slots; a rank timed alone) and a function that frees the regions."""
    from blitzdg_tpu_torch.parallel import blocked_shard as BS

    S = sb.n_shards
    sbuf0 = BS.initial_send_buffer(sb, state)

    def run(rings, launches, streams):
        carry = [(tuple(f[r:r + 1] for f in state), sbuf0[r:r + 1])
                 for r in range(S)]
        t = t0
        for k in range(n_steps):
            for r in range(S):
                with torch.cuda.stream(streams[r]):
                    st, sbuf = carry[r]
                    *s2, sb2 = launches[r](st, rings[r](sbuf), dt, t, cs[k])
                    carry[r] = (tuple(s2), sb2)
            t += dt
        return carry

    torch.cuda.synchronize()
    *warm, free_warm = peer_ranks_in_process(sb, state[0].shape[1], dev)
    try:
        run(*warm)
        torch.cuda.synchronize()
    finally:
        free_warm()
    rings, launches, streams, free = peer_ranks_in_process(
        sb, state[0].shape[1], dev)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    carry = run(rings, launches, streams)
    torch.cuda.synchronize()
    us = (time.perf_counter() - w0) * 1e6 / n_steps
    ends = [(*c[0], c[1]) for c in carry]
    return ends, us, rings, launches, free


def bit_digest(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits digested along its first axis: the sum of
    each entry's words as int32, in int64 (a changed word changes it)."""
    return t.contiguous().view(torch.int32).reshape(t.shape[0], -1).sum(
        1, dtype=torch.int64)


def run_peer_in_process_checked(sb, state, cs, dt: float, t0: float, dev,
                                rng, n_steps: int = PEER_LONG_STEPS):
    """The S ranks of ``sb``'s ring in this process for ``n_steps`` steps
    (the controls ``cs`` cycled), at each step one rank, drawn from
    ``rng``, held on its stream for up to ``PEER_LONG_DELAY_CYCLES``
    before it, so that its peers wait at their flags for it in every
    order. After each step, on each rank's stream, the bits of its state,
    its send buffer and its stage-2 receive slots (the peers' stage-1 halo
    that IN2 guards and its stage 2 read) are digested and held to the
    stacked one-launch rollout's of the same step and shard. This caller's
    own kernels of the loop (the digests) are launched once before it: a
    kernel's first launch loads its module (CUDA's lazy loading), which
    waits for the context's running kernels, and a rank's step that waits
    for a peer's then never ends (the ring and the ranks' launches load the
    port's kernels themselves).
    Returns the steps whose digests differ, a list a rank, the steps each
    rank was held back, and whether the stacked rollout's state stayed
    finite."""
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    S = sb.n_shards
    who = rng.integers(0, S, n_steps)
    cycles = rng.integers(0, PEER_LONG_DELAY_CYCLES, n_steps)
    sbuf0 = BS.initial_send_buffer(sb, state)
    # the stacked rollout's digests, step by step
    ex = RingExchange(sb.plan, sb.meta.n_fp, device=dev)
    stacked = TB.RdmaLaunch(sb.ops, sb.meta, ex)
    want = torch.empty((n_steps, S, 5), dtype=torch.int64, device=dev)
    carry, t = (state, sbuf0), t0
    for k in range(n_steps):
        *s2, sb2 = stacked(carry[0], ex(carry[1]), dt, t, cs[k % len(cs)])
        rb2 = stacked._scratch[1]  # the step's stage-2 receive buffer
        want[k] = torch.stack([bit_digest(f) for f in (*s2, sb2, rb2)], 1)
        carry, t = (tuple(s2), sb2), t + dt
    finite = all(bool(torch.isfinite(f).all()) for f in carry[0])
    got = torch.empty_like(want)
    rings, launches, streams, free = peer_ranks_in_process(
        sb, state[0].shape[1], dev)
    try:
        carry = [(tuple(f[r:r + 1] for f in state), sbuf0[r:r + 1])
                 for r in range(S)]
        for r in range(S):  # the loop's other kernels, loaded
            got[0, r] = torch.cat([bit_digest(f) for f in (
                *carry[r][0], carry[r][1], rings[r].rb2)])
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t = t0
        for k in range(n_steps):
            for r in range(S):
                with torch.cuda.stream(streams[r]):
                    if r == who[k]:
                        torch.cuda._sleep(int(cycles[k]))
                    st, sbuf = carry[r]
                    *s2, sb2 = launches[r](st, rings[r](sbuf), dt, t,
                                           cs[k % len(cs)])
                    got[k, r] = torch.cat([bit_digest(f) for f in (
                        *s2, sb2, rings[r].rb2)])
                    carry[r] = (tuple(s2), sb2)
            t += dt
        torch.cuda.synchronize()
    finally:
        free()
    bad = (got != want).any(2).cpu()
    return ([torch.nonzero(bad[:, r]).flatten().tolist() for r in range(S)],
            np.bincount(who, minlength=S).tolist(), finite)


def _gpu_query(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peer_phases(dev, card: str, rng, flush) -> list:
    """The one-launch step across ranks on the one card: S=4, S=2 and S=4
    with a delayed rank, each rank a process of its own (gloo group, CUDA
    IPC regions), PEER_STEPS steps at K=2048, N=3, B=8 on the coastal set;
    every rank's end state and send buffer bit-equal to its shard of the
    stacked one-launch rollout run here, its first step against the plain
    version, its last step-boundary slots bit-equal to the stacked gather,
    its counters exact. Returns the kernel records of the ``kernels``
    line."""
    import tempfile

    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import blocked_shard as BS
    from blitzdg_tpu_torch.parallel.halo import RingExchange

    mps = subprocess.run(["pgrep", "-f", "nvidia-cuda-mps"],
                         capture_output=True, text=True).returncode == 0
    say({"phase": "peer_setup", "card": card,
         "compute_mode": _gpu_query("compute_mode"), "mps_running": mps,
         "note": "without MPS the ranks' kernels time-slice on the card: "
                 "wall_us_per_step measures the time slices, not the "
                 "transport"})
    gc.collect()
    torch.cuda.empty_cache()
    total = {"sw2d_step_rdma_blocked (peer)": 0, "peer_ring_exchange": 0}
    timed = None
    refs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, S, delay in PEER_CASES:
            if S not in refs:
                cc, sb, H, dt = peer_problem(S, dev)
                on_card = lambda a: a.to(dev, torch.float32)
                xy = types.SimpleNamespace(x=on_card(cc.x), y=on_card(cc.y))
                h, hu, hv, _ = perturbed_blocked(
                    xy, on_card(H).reshape(1, -1), PEER_BATCH, 1, 2, rng,
                    dev)
                state = tuple(BS.split_shards(f, S) for f in (h, hu, hv))
                cs = torch.as_tensor(0.3 * rng.standard_normal(
                    (PEER_STEPS, 2)), dtype=torch.float32, device=dev)
                t0 = 1.0
                inputs = {"h": state[0].cpu(), "hu": state[1].cpu(),
                          "hv": state[2].cpu(), "cs": cs.cpu(), "dt": dt,
                          "t0": t0}
                # the reference: the stacked one-launch rollout (the same
                # stage code on the same inputs), and its first step
                # through the plain version
                ex = RingExchange(sb.plan, sb.meta.n_fp, device=dev)
                sbuf0 = BS.initial_send_buffer(sb, state)
                plain1 = TB.sw2d_step_rdma_blocked_plain(
                    sb.ops, sb.meta, state, ex(sbuf0), dt, ex, t0, cs[0])
                rstep = BS.make_sharded_blocked_step_rdma(sb, dt)
                carry, t = (state, sbuf0), t0
                for k in range(PEER_STEPS):
                    carry = rstep(carry, t, cs[k])
                    t += dt
                    if k == PEER_FRESH_STEPS - 1:
                        fresh_end = (*carry[0], carry[1])
                last_rb = ex(carry[1])
                torch.cuda.synchronize()
                refs[S] = {"inputs": inputs, "sb": sb, "ex": ex,
                           "sbuf0": sbuf0, "plain1": plain1,
                           "final": (*carry[0], carry[1]),
                           "last_rb": last_rb, "dt": dt, "t0": t0, "cs": cs,
                           "state": state, "fresh_end": fresh_end}
                del cc
            ref = refs[S]
            case_dir = Path(tmp) / name
            case_dir.mkdir()
            torch.save(ref["inputs"], case_dir / "inputs.pt")
            is_timed = timed is None and delay is None
            t_case = time.perf_counter()
            res = run_peer_workers(S, case_dir, delay, is_timed)
            seconds = time.perf_counter() - t_case
            bits, rb_bits, err1, counts, walls = [], [], 0.0, [], []
            for r, o in enumerate(res):
                want = [f[r:r + 1].cpu() for f in ref["final"]]
                bits.append(all(torch.equal(a, b)
                                for a, b in zip(o["final"], want)))
                rb_bits.append(torch.equal(o["rbb"],
                                           ref["last_rb"][r:r + 1].cpu()))
                err1 = max(err1, max_abs(
                    o["first"], [f[r:r + 1].cpu() for f in ref["plain1"]]))
                counts.append(o["launches"])
                walls.append(o["wall_s"] * 1e6 / (PEER_STEPS - 1))
                for k in total:
                    total[k] += o["launches"][k]
            rec = {"phase": name, "n_shards": S, "steps": PEER_STEPS,
                   "batch": PEER_BATCH, "k_elem": 2048, "n_order": 3,
                   "delayed_rank": delay,
                   "ring_offsets": list(ref["sb"].plan.offs),
                   "bit_equal_to_stacked": bits,
                   "slots_bit_equal_to_stacked_gather": rb_bits,
                   "slots_vs_gloo_exchange": [o["exchange_vs_gloo"]
                                              for o in res],
                   "first_step_vs_plain_max_abs": err1, "tol": BLK_FWD_ATOL,
                   "launches": counts,
                   "wall_us_per_step_time_sliced": walls,
                   "seconds": seconds, "devices": [o["device"] for o in res],
                   "card": card}
            ok = (all(bits) and all(rb_bits) and err1 <= BLK_FWD_ATOL
                  and all(o["exchange_vs_gloo"] == 0.0 for o in res)
                  and all(c == {"sw2d_step_rdma_blocked (peer)": PEER_STEPS,
                                "peer_ring_exchange": 1,
                                "sw2d_stage_blocked": 0} for c in counts))
            if is_timed:
                timed = (S, ref, res[0], err1)
                rec["step_ms_alone"] = [o["step_ms"] for o in res]
                rec["exchange_ms_alone"] = [o["exchange_ms"] for o in res]
                rec["exchange_device_ms_alone"] = [o["exchange_device_ms"]
                                                   for o in res]
                rec["plan"] = res[0]["plan"]
            rec["ok"] = ok
            say(rec)
            if not ok:
                raise RuntimeError(f"the peer case {name} failed: {rec}")
    # the S=4 ranks in this process, on four streams at once
    ref = refs[4]
    ends, us, _, _, free = run_peer_in_process(ref["sb"], ref["state"],
                                               ref["cs"], ref["dt"],
                                               ref["t0"], dev)
    try:
        bits = [all(torch.equal(a, b[r:r + 1])
                    for a, b in zip(ends[r], ref["final"]))
                for r in range(len(ends))]
    finally:
        free()
    rec = {"phase": "peer_S4_in_process", "n_shards": 4, "steps": PEER_STEPS,
           "batch": PEER_BATCH, "bit_equal_to_stacked": bits,
           "us_per_step_host_clock": us,
           "note": "four ranks on four streams of one process, their step "
                   "launches resident together; four launches a step from "
                   "the host (the exchange kernel at the first step only)",
           "card": card, "ok": all(bits)}
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"the in-process peer case failed: {rec}")
    # the same ranks' first steps in a fresh process
    w0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(ref["inputs"], Path(tmp) / "inputs.pt")
        fresh = run_peer_fresh(Path(tmp))
    bits = [all(torch.equal(a, b[r:r + 1].cpu())
                for a, b in zip(fresh[r], ref["fresh_end"]))
            for r in range(len(fresh))]
    rec = {"phase": "peer_S4_fresh_process", "n_shards": 4,
           "steps": PEER_FRESH_STEPS, "batch": PEER_BATCH,
           "module_loading": "LAZY", "bit_equal_to_stacked": bits,
           "seconds": time.perf_counter() - w0,
           "note": "no kernel of the port launched before the ring's first "
                   "step; the ring and the ranks' launches load their own",
           "card": card, "ok": all(bits)}
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"the fresh-process peer case failed: {rec}")
    # the same, long, with a rank held back at every step, each step's bits
    # held to the stacked rollout's
    w0 = time.perf_counter()
    dt_long = ref["dt"] * PEER_LONG_DT_FRACTION
    bad, held, finite = run_peer_in_process_checked(
        ref["sb"], ref["state"], ref["cs"], dt_long, ref["t0"], dev, rng)
    rec = {"phase": "peer_S4_in_process_long", "n_shards": 4,
           "steps": PEER_LONG_STEPS, "batch": PEER_BATCH, "dt": dt_long,
           "stacked_state_finite": finite,
           "steps_held_back_per_rank": held,
           "most_cycles_held": PEER_LONG_DELAY_CYCLES,
           "checked_each_step": ["h", "hu", "hv", "send buffer",
                                 "stage-2 receive slots"],
           "steps_not_bit_equal_to_stacked": [b[:8] for b in bad],
           "n_steps_not_bit_equal": [len(b) for b in bad],
           "seconds": time.perf_counter() - w0, "card": card,
           "ok": finite and not any(bad)}
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"the long in-process peer case failed: {rec}")
    # the kernels line: rank 0 of the S=4 case, alone
    S, ref, r0, err1 = timed
    sb, meta, B = ref["sb"], ref["sb"].meta, PEER_BATCH
    L = sb.ops.send.shape[1]
    ops0 = rank_ops(sb.ops, 0)
    st0 = tuple(f[:1] for f in ref["state"])
    rb0 = ref["ex"](ref["sbuf0"])[:1]
    *s1, sb1 = TB.sw2d_stage_blocked_plain(sb.ops, meta, ref["state"],
                                           ref["state"], ref["ex"](
                                               ref["sbuf0"]),
                                           0.5 * ref["dt"], ref["t0"],
                                           ref["cs"][0])
    rb2_0 = ref["ex"](sb1)[:1]
    plain = lambda: TB.sw2d_step_rdma_blocked_plain(
        ops0, meta, st0, rb0, ref["dt"], lambda _: rb2_0, ref["t0"],
        ref["cs"][0])
    plain_ms = time_ms(plain, 2, flush)
    gather = lambda: ref["ex"](ref["sbuf0"])
    gather_ms = time_ms(gather, PEER_TIMED_REPS, flush)
    n_wall = int(ops0.wall.sum())
    # the halos: stage 1's stored into the peers and read back in stage 2,
    # and stage 2's step-boundary one stored into the peers
    halo = 4.0 * 3 * 3 * B * L
    step_bound = bound(4.0 * (6 * B * meta.n_v + 2 * 3 * B * L + meta.n_ctrl)
                       + halo, B * 2 * rhs_flops(meta, n_wall))
    ex_bound = bound(4.0 * 2 * 3 * B * L, 0.0)
    return [
        {"name": "sw2d_step_rdma_blocked (peer)", "route": "cuda",
         "source": "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu",
         "replaces": "blitzdg_tpu/ops/sw2d_blocked.py:1118",
         "launches": total["sw2d_step_rdma_blocked (peer)"],
         "max_abs_err": err1, "ms": r0["step_ms"], "plain_ms": plain_ms,
         "bound_ms": step_bound[0], "bound_by": step_bound[1],
         "library_ms": None,
         "lanes_per_element": r0["plan"]["lanes_per_element"]},
        {"name": "peer_ring_exchange", "route": "cuda",
         "source": "blitzdg_tpu_torch/ops/csrc/peer.cu",
         "replaces": "blitzdg_tpu/parallel/blocked_shard.py:550",
         "launches": total["peer_ring_exchange"], "max_abs_err": 0.0,
         "ms": r0["exchange_ms"], "device_ms": r0["exchange_device_ms"],
         "plain_ms": gather_ms,
         "bound_ms": ex_bound[0], "bound_by": ex_bound[1],
         "library_ms": None}]


# ---------------------------------------------------------------------------
# RANKS path: the sharded MPC one shard a rank, over the stage ring
# ---------------------------------------------------------------------------

RANKS_WORKER_TIMEOUT = 300  # seconds, each worker process
# the name of a rank's thread in this process (``on_rank_threads``), its
# rank appended
RANK_THREAD = "rank thread "
# Adam iterations of the short solves that are profiled (the idle share)
RANKS_PROFILE_ITERS = 5
RANKS_TIMED_REPS = 9
# the stage ring's check at the main path's shapes: floats of the summed
# vector (the control sequence's cotangent, 8 steps x 2 controls)
RANKS_SUM_LEN = 16


def ranks_counters() -> dict:
    """The launch counters of the kernels a rank of the sharded MPC may
    launch, by name (the one-launch step's must stay 0)."""
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel import peer as PR

    return {"sw2d_stage_blocked": TB.sw2d_stage_blocked,
            "sw2d_stage_bwd_blocked_v2": TB.sw2d_stage_bwd_blocked_v2,
            "sw2d_stage_blocked_peer": TB.sw2d_stage_blocked_peer,
            "sw2d_stage_bwd_blocked_peer": TB.sw2d_stage_bwd_blocked_peer,
            "peer_stage_exchange": PR.peer_stage_exchange,
            "peer_stage_exchange_reverse": PR.peer_stage_exchange_reverse,
            "peer_rank_sum": PR.peer_rank_sum,
            "sw2d_step_rdma_blocked": TB.sw2d_step_rdma_blocked,
            "peer_ring_exchange": PR.peer_ring_exchange}


def ranks_expected(n_steps: int, iters: int, n_ranks: int) -> dict:
    """The launches of ``ranks_program`` over ``n_ranks`` ranks: a rank's
    target rollout, the gradient at zero controls and the solve's ``iters``
    gradients (each a rollout, its adjoint and two sums: the cost and the
    controls' cotangent), and the solve's final cost (a rollout, a sum).
    A rollout is one exchange (its constant start's send buffer) and two
    stages a step, each one launch of the stage's peer mode, the exchange
    folded in; its adjoint two launches of the adjoint's peer mode a step,
    the reverse folded in (the first stage's receive-buffer cotangent stays
    with it: the constant start's send buffer needs none)."""
    evals = 1 + iters
    rollouts = 1 + evals + 1
    per = {"sw2d_stage_blocked": 0, "sw2d_stage_bwd_blocked_v2": 0,
           "sw2d_stage_blocked_peer": 2 * n_steps * rollouts,
           "sw2d_stage_bwd_blocked_peer": 2 * n_steps * evals,
           "peer_stage_exchange": rollouts,
           "peer_stage_exchange_reverse": 0,
           "peer_rank_sum": 2 * evals + 1, "sw2d_step_rdma_blocked": 0,
           "peer_ring_exchange": 0}
    return {k: n_ranks * v for k, v in per.items()}


def ranks_program(size: dict, rank: int, dev, barrier, sync, ring=None,
                  group=None, iters: int | None = None):
    """One rank's program (the same on every rank): its problem
    (``sharded_mpc_problem(size, rank=rank)``: its shard, the target through
    the ranks' fused step), the gradient at zero controls, then the timed
    Adam solve, between two meetings of the ranks (``barrier``) after their
    work was waited for (``sync``). Ranks in one process: their rings meet
    their hosts before each ring launch and the step paces each rollout
    (the port's guard, ``StageRing.over_regions``). Returns the problem and
    the results."""
    from blitzdg_tpu_torch.mpc import sharded_box as sbx

    iters = sbx.MPC_ITERS if iters is None else iters
    t0 = time.perf_counter()
    mp = sbx.sharded_mpc_problem(size, rank=rank, ring=ring, group=group,
                                 device=dev)
    cs0 = torch.zeros_like(mp.hidden, requires_grad=True)
    (g0,) = torch.autograd.grad(sbx.sharded_mpc_cost(mp, cs0), cs0)
    sync()
    barrier()
    w0 = time.perf_counter()
    sol = sbx.solve_sharded_mpc(mp, iters=iters)
    sync()
    wall = time.perf_counter() - w0
    barrier()
    return mp, {"target": mp.target.cpu(), "grad0": g0.cpu(),
                "controls": sol.controls.cpu(),
                "history": sol.cost_history.cpu(), "final": sol.cost.cpu(),
                "solve_s": wall, "setup_s": w0 - t0}


def profile_union(run, solve_s: float, ready=lambda: None) -> dict:
    """Device time of ``run()`` under torch.profiler (CUDA events only): the
    sum of the kernels' times by name and the union of their intervals,
    which kernels of ranks on several streams overlap in; the idle share is
    one less the union over ``solve_s``, the unprofiled host-clock time of
    the same run. The ring's kernels (``peer_*``) spend most of their time
    waiting at flags, so the union is also given without them: the share
    of the time in which no other kernel runs is the compute idle share.
    ``ready()`` runs once the profiler has started (ranks in processes of
    their own meet there: a rank's profiler start takes longer than its
    peers' flag waits may)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        ready()
        run()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if b > a:
            # (a template kernel's name starts with its return type)
            name = ev.name.removeprefix("void ")
            spans.append((a, b, name.startswith("peer_")))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)

    def union(keep) -> float:
        total, end = 0.0, None
        for a, b, ring in sorted(spans):
            if not keep(ring):
                continue
            if end is None or a > end:
                total, end = total + (b - a), b
            elif b > end:
                total, end = total + (b - end), b
        return total / 1e3

    idle = lambda ms: 1.0 - ms / (solve_s * 1e3) if spans else None
    every, compute = union(lambda ring: True), union(lambda ring: not ring)
    return {"device_union_ms": every if spans else None,
            "device_union_ms_without_ring_kernels":
                compute if spans else None,
            "solve_ms_unprofiled": solve_s * 1e3,
            "device_idle_share": idle(every),
            "device_idle_share_compute": idle(compute),
            "device_kernels": len(spans),
            "top_device_ms": [{"name": k[:60], "ms": v / 1e3} for k, v in
                              sorted(by_name.items(), key=lambda kv: -kv[1])
                              [:6]]}


def ranks_profile(mp, sync, barrier, profiled: bool):
    """A short solve (RANKS_PROFILE_ITERS iterations) timed on the host
    clock, then again under the profiler where ``profiled`` (every rank
    runs both: the solves are collective; the ranks meet before the
    second, once the profiler has started). The profile's record, or
    None."""
    from blitzdg_tpu_torch.mpc import sharded_box as sbx

    run = lambda: sbx.solve_sharded_mpc(mp, iters=RANKS_PROFILE_ITERS)
    sync()
    barrier()
    t0 = time.perf_counter()
    run()
    sync()
    short_s = time.perf_counter() - t0
    if not profiled:
        barrier()
        run()
        sync()
        return None
    return profile_union(run, short_s, ready=barrier)


def ranks_worker(cfg: dict) -> int:
    """One rank of the sharded MPC in a process of its own: joins the gloo
    group, runs ``ranks_program`` with the stage ring that
    ``sharded_mpc_problem`` makes over the group (CUDA IPC), its counters
    zeroed just before and read just after, then, for the idle share, a
    short solve (rank 0 profiles it); writes its results to the case's
    directory."""
    import torch.distributed as dist

    from blitzdg_tpu_torch.mpc import sharded_box as sbx

    import datetime

    S, rank = cfg["S"], cfg["rank"]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    mark = lambda what: print(f"[rank {rank}] {time.perf_counter() - t0:.1f}"
                              f" s: {what}", flush=True)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{cfg['port']}", world_size=S,
        rank=rank, timeout=datetime.timedelta(seconds=RANKS_WORKER_TIMEOUT))
    size = dict(getattr(sbx, cfg["size"]), n_shards=S)
    counters = ranks_counters()
    for f in counters.values():
        f.launches = 0
    mark("joined")
    mp, res = ranks_program(size, rank, dev, dist.barrier,
                            torch.cuda.synchronize,
                            group=dist.group.WORLD)
    res["launches"] = {k: f.launches for k, f in counters.items()}
    mark(f"solved in {res['solve_s']:.2f} s")
    res["profile"] = ranks_profile(mp, torch.cuda.synchronize, dist.barrier,
                                   rank == 0)
    res["device"] = torch.cuda.get_device_name(0)
    mark("profiled")
    mp.ring.close()
    torch.save(res, Path(cfg["dir"]) / f"rank{rank}.pt")
    dist.destroy_process_group()
    print(f"RANKS_OK rank={rank}", flush=True)
    return 0


def run_ranks_workers(S: int, case_dir: Path, flag: str = "--ranks-worker",
                      tag: str = "RANKS_OK", **extra) -> list:
    """S worker processes of this script (``flag``: ``--ranks-worker``, or
    ``--halo-worker``; ``extra`` joins each one's configuration), one a
    rank, each on the card, each under RANKS_WORKER_TIMEOUT; once one
    fails, the others are given a few seconds and then ended; every one is
    ended in the end. Fails, with every rank's log, unless every one exits
    0 and printed ``tag``. Their results by rank."""
    port = _free_port()
    procs, logs = [], []
    for r in range(S):
        cfg = {"S": S, "rank": r, "port": port, "dir": str(case_dir),
               **extra}
        log = open(case_dir / f"rank{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag,
             json.dumps(cfg)], stdout=log, stderr=subprocess.STDOUT,
            text=True))
    t0 = time.perf_counter()
    failed_at = None
    try:
        while any(p.poll() is None for p in procs):
            now = time.perf_counter()
            if failed_at is None and any(p.poll() not in (None, 0)
                                         for p in procs):
                failed_at = now
            if (now - t0 > RANKS_WORKER_TIMEOUT
                    or (failed_at is not None and now - failed_at > 20)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    bad = [r for r, (p, t) in enumerate(zip(procs, texts))
           if p.returncode != 0 or f"{tag} rank={r}" not in t]
    if bad:
        raise RuntimeError(
            f"ranks workers {bad} of {S} failed (exits "
            f"{[p.returncode for p in procs]}):\n" + "\n".join(
                f"--- rank {r}:\n{t[-3000:]}" for r, t in enumerate(texts)))
    return [torch.load(case_dir / f"rank{r}.pt") for r in range(S)]


def ring_regions(S: int, nbytes: int, make, dev):
    """S zeroed regions of ``nbytes`` of this process and ``make(r,
    bases)``, rank r's ring over them, for each rank; with a function that
    frees the regions."""
    from blitzdg_tpu_torch.parallel import peer as PR

    lib = PR._lib()
    bases = {}

    def free():
        torch.cuda.synchronize()
        for p in bases.values():
            lib.peer_free(p)

    for r in range(S):
        p = ctypes.c_void_p()
        PR._check(lib, lib.peer_alloc(dev.index or 0, nbytes,
                                      ctypes.byref(p)), "peer_alloc")
        bases[r] = p.value
    return [make(r, bases) for r in range(S)], free


def stage_ring_regions(plan, n_fp: int, dev, meet=None):
    """S zeroed stage-ring regions of this process (batch 1) and each rank's
    ring over them (``StageRing.over_regions``, with ``meet``); with a
    function that frees the regions."""
    from blitzdg_tpu_torch.parallel import peer as PR

    lay = PR.stage_region_layout(1, PR._n_slots(plan, n_fp), len(plan.offs),
                                 plan.n_shards)
    return ring_regions(
        plan.n_shards, lay["bytes"],
        lambda r, bases: PR.StageRing.over_regions(plan, n_fp, 1, r, bases,
                                                   dev, meet=meet), dev)


def halo_ring_regions(plan, slot_bytes: int, dev, meet=None):
    """S zeroed halo-ring regions of this process (slots of ``slot_bytes``)
    and each rank's ring over them (``HaloRing.over_regions``, with
    ``meet``); with a function that frees the regions."""
    from blitzdg_tpu_torch.parallel import peer as PR

    lay = PR.ring_region_layout(slot_bytes, len(plan.offs), plan.n_shards)
    return ring_regions(
        plan.n_shards, lay["bytes"],
        lambda r, bases: PR.HaloRing.over_regions(plan, slot_bytes, r, bases,
                                                  dev, meet=meet), dev)


def on_rank_threads(streams, fn, on_error=lambda: None) -> list:
    """``fn(r)`` on a thread a rank, each on its stream ``streams[r]``;
    ``on_error()`` when one raises (to free ranks waiting for it). Fails
    unless every thread ends within RANKS_WORKER_TIMEOUT without an error.
    Each rank's result."""
    S = len(streams)
    out, errors = [None] * S, []

    def run(r):
        try:
            with torch.cuda.stream(streams[r]):
                out[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 (raised below)
            errors.append((r, repr(e)))
            on_error()

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"{RANK_THREAD}{r}") for r in range(S)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(RANKS_WORKER_TIMEOUT)
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a rank's thread did not end")
    if errors:
        raise RuntimeError(f"ranks in process failed: {errors}")
    return out


def ranks_in_process(regions, counters: dict, dev, program, warm,
                     short=None):
    """The S ranks of a ring in this process, each on a thread and a stream
    of its own, over rings on regions of this process (``regions(meet)``:
    the rings, made with ``meet``, and a function that frees them): their
    kernels run at the same time and meet only through their flags (and
    autograd runs each rank's backward on its stream), their hosts before
    each launch of a ring kernel (the port's guard: each rank's thread
    binds its ring, whose ``meet`` is a barrier of the S threads). First
    ``warm(r, ring, sync, barrier)`` for each rank r in turn, alone and on
    its stream, over rings of their own (``parallel.peer.warm_ranks``), so
    that every kernel any rank launches is loaded, and each stream's
    caching allocator holds its blocks, before the ranks meet. Then
    ``program(r, ring, sync, barrier)`` on every rank, the ``counters``
    zeroed just before and read just after; then, where ``short(r, ring)``
    is given, the ranks' short window timed and profiled
    (``profile_union``). Returns each rank's results, the launches, the
    profile and the wall seconds."""
    from blitzdg_tpu_torch.parallel import peer as PR

    warm_rings, free_warm = regions(None)
    S = len(warm_rings)
    streams = [torch.cuda.Stream(dev) for _ in range(S)]
    try:
        PR.warm_ranks(warm_rings, streams, lambda r, ring: warm(
            r, ring, streams[r].synchronize, lambda: None))
    finally:
        free_warm()
    meet, launch_meet = threading.Barrier(S), threading.Barrier(S)
    rings, free = regions(launch_meet)
    abort = lambda: (meet.abort(), launch_meet.abort())
    on_ranks = lambda fn: on_rank_threads(
        streams, lambda r: (rings[r].bind(), fn(r))[1], on_error=abort)
    try:
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        w0 = time.perf_counter()
        out = on_ranks(lambda r: program(r, rings[r], streams[r].synchronize,
                                         meet.wait))
        seconds = time.perf_counter() - w0
        launches = {k: f.launches for k, f in counters.items()}
        prof = None
        if short is not None:
            def run():
                on_ranks(lambda r: short(r, rings[r]))
                torch.cuda.synchronize()

            run()
            t0 = time.perf_counter()
            run()
            prof = profile_union(run, time.perf_counter() - t0)
    finally:
        free()
    return out, launches, prof, seconds


def run_ranks_in_process(size: dict, plan, n_fp: int, dev,
                         iters: int | None = None, profile: bool = True):
    """The S ranks of the sharded MPC in this process over stage rings on
    regions of this process (``ranks_in_process``): each rank's program
    alone first, then every rank's (each rank's step paced by the port),
    then, with ``profile``, the profiled short solves. Returns each rank's
    results, the counts, the profile and the wall time of the whole."""
    from blitzdg_tpu_torch.mpc import sharded_box as sbx

    problems = [None] * plan.n_shards

    def program(r, ring, sync, barrier):
        problems[r], out = ranks_program(size, r, dev, barrier, sync,
                                         ring=ring, iters=iters)
        return out

    warm = lambda r, ring, sync, barrier: ranks_program(
        size, r, dev, barrier, sync, ring=ring, iters=1)
    short = lambda r, ring: sbx.solve_sharded_mpc(problems[r],
                                                  iters=RANKS_PROFILE_ITERS)
    return ranks_in_process(
        lambda meet: stage_ring_regions(plan, n_fp, dev, meet),
        ranks_counters(), dev, program, warm, short if profile else None)


def stage_ring_check(plan, n_fp: int, dev, rng, flush) -> dict:
    """The stage ring's three kernels on the card at the main path's shapes
    (B=1, the plan's receive buffer; a 16-float sum), S ranks in this
    process on S streams, against their plain versions on the same inputs:
    the stacked gather of every rank's buffer (forward and reverse) and the
    rank-order sum, bit for bit. Then each kernel of rank 0 alone, its
    flags set past any epoch (no wait holds it), CUDA events, L2 flushed,
    beside its plain version, and its device time, a launch of a CUDA
    graph of STAGE_PEER_GRAPH_LAUNCHES back to back (``device_ms``).
    Launches counted here are not the main path's. Returns a record by
    kernel name."""
    from blitzdg_tpu_torch.parallel import peer as PR
    from blitzdg_tpu_torch.parallel.halo import _stacked, _stacked_source

    S = plan.n_shards
    rings, free = stage_ring_regions(plan, n_fp, dev)
    try:
        L = rings[0].n_slots
        bufs = torch.as_tensor(rng.standard_normal((S, 1, L, 3)),
                               dtype=torch.float32, device=dev)
        xs = torch.as_tensor(rng.standard_normal((S, RANKS_SUM_LEN)),
                             dtype=torch.float32, device=dev)
        streams = [torch.cuda.Stream(dev) for _ in range(S)]
        torch.cuda.synchronize()
        got = {"peer_stage_exchange": [], "peer_stage_exchange_reverse": [],
               "peer_rank_sum": []}
        for r in range(S):
            with torch.cuda.stream(streams[r]):
                got["peer_stage_exchange"].append(
                    PR.peer_stage_exchange(rings[r], bufs[r:r + 1]))
        for r in range(S):
            with torch.cuda.stream(streams[r]):
                got["peer_stage_exchange_reverse"].append(
                    PR.peer_stage_exchange_reverse(rings[r], bufs[r:r + 1]))
        for r in range(S):
            with torch.cuda.stream(streams[r]):
                got["peer_rank_sum"].append(
                    PR.peer_rank_sum(rings[r], xs[r]))
        torch.cuda.synchronize()
        chunk = plan.max_send * n_fp
        src = torch.as_tensor(_stacked_source(plan, chunk, 1), device=dev)
        src_rev = torch.as_tensor(_stacked_source(plan, chunk, -1),
                                  device=dev)
        plain = {
            "peer_stage_exchange": lambda: _stacked(bufs, src),
            "peer_stage_exchange_reverse": lambda: _stacked(bufs, src_rev),
            "peer_rank_sum": lambda: PR.rank_order_sum(list(xs))}
        recs = {}
        rings[0].flags[:] = 1 << 60
        torch.cuda.synchronize()
        alone = {
            "peer_stage_exchange": lambda: rings[0]._exchange(bufs[:1],
                                                              False),
            "peer_stage_exchange_reverse": lambda: rings[0]._exchange(
                bufs[:1], True),
            "peer_rank_sum": lambda: rings[0]._reduce(xs[0], 0)}
        for name, fn in plain.items():
            want = fn()
            rows = (torch.cat(got[name]) if name != "peer_rank_sum"
                    else torch.stack(got[name]))
            ref = want if name != "peer_rank_sum" else want.expand_as(rows)
            n = 4 * (rows[:1].numel())
            bnd = bound(2.0 * n, 0.0)
            recs[name] = {
                "max_abs_err": float((rows - ref).abs().max()),
                "bit_equal": bool(torch.equal(rows, ref)),
                "ms": time_ms(alone[name], RANKS_TIMED_REPS, flush),
                "device_ms": graph_us([alone[name]],
                                      n=STAGE_PEER_GRAPH_LAUNCHES) / 1e3,
                "plain_ms": time_ms(fn, RANKS_TIMED_REPS, flush),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "shape": list(rows[:1].shape)}
    finally:
        free()
    return recs


# stages of the folded launches' check: two steps' (stage 1: dt/2, no
# sponge; stage 2: dt, the sponge)
STAGE_PEER_STAGES = 4
# launches a CUDA graph of rank 0's folded launch (and of B7's or B8's)
# holds where its device time is taken
STAGE_PEER_GRAPH_LAUNCHES = 50


def stage_peer_check(mp, dev, rng, flush) -> dict:
    """The stage's and its adjoint's peer modes (the stage ring's exchange
    and its reverse folded into B7's and B8's launches) on the card at the
    main path's shapes (``mp``: the full-width stacked sharded MPC; one
    shard a rank, B=1, its two controls), from a perturbed rest state: S
    ranks in this process on S streams, launched from this thread (a folded
    launch waits only for its peers' launches of the round before). B7's
    peer mode over STAGE_PEER_STAGES epochs (the first stage with its
    receive buffer given, as after a rollout's first exchange, then each
    reading the ring's slots), then B8's over the same stages in reverse
    (the last stage's send-buffer cotangent given, the first keeping its
    receive buffer's), each rank's outputs bit-equal to B7 and B8 launched
    on its shard with the stacked exchange and its reverse between them
    (plain PyTorch gathers). Then each peer mode of rank 0 alone, its flags
    set past any epoch (no wait holds it), CUDA events, L2 flushed, beside
    its plain version (the stage's or its adjoint's plain version on rank
    0's shard and the stacked gather over the ranks) and B7's or B8's
    launch alone on the same inputs (``unfolded_kernel_ms``); and the
    device time of each, a launch of a CUDA graph of
    STAGE_PEER_GRAPH_LAUNCHES back to back (``device_ms``,
    ``unfolded_kernel_device_ms``: no host between the launches, the gaps
    between them included; their difference ``fold_device_ms`` is what
    the fold costs the card). Launches counted here are not the main
    path's. Returns a record by kernel name."""
    from blitzdg_tpu_torch.ops import sw2d_blocked as TB
    from blitzdg_tpu_torch.parallel.blocked_shard import initial_send_buffer
    from blitzdg_tpu_torch.parallel.halo import (RingExchange, _stacked,
                                                 _stacked_source)

    sb, meta, dt = mp.sb, mp.sb.meta, mp.dt
    plan, S = sb.plan, sb.n_shards
    L = sb.ops.send.shape[1]
    f32 = torch.float32
    g = lambda *shape, scale=1.0: scale * torch.as_tensor(
        rng.standard_normal(shape), dtype=f32, device=dev)
    state = (10.0 + g(S, 1, meta.n_v, scale=0.01), g(S, 1, meta.n_v,
                                                       scale=0.01),
             g(S, 1, meta.n_v, scale=0.01))
    ctrl = g(meta.n_ctrl, scale=0.3)
    ops = [rank_ops(sb.ops, r) for r in range(S)]
    ex = RingExchange(plan, meta.n_fp, device=dev)
    src = torch.as_tensor(_stacked_source(plan, plan.max_send * meta.n_fp, 1),
                          device=dev)
    rb0 = ex(initial_send_buffer(sb, state))
    stages = [(0.5 * dt if k % 2 == 0 else dt, 0.5 * dt * k, k % 2 == 1)
              for k in range(STAGE_PEER_STAGES)]
    lam = [[tuple(g(1, 1, meta.n_v) for _ in range(3)) for _ in range(S)]
           for _ in stages]
    lsb_end = g(S, 1, L, 3)
    row = lambda t, r: t[r:r + 1]

    # the reference: B7 and B8 on each rank's shard, the stacked gathers
    want_f, cur, rb = [], state, rb0
    for c_dt, t, sponge in stages:
        outs = [TB._run_stage(ops[r], meta, tuple(row(f, r) for f in state),
                              tuple(row(f, r) for f in cur), row(rb, r),
                              c_dt, t, ctrl, True, sponge) for r in range(S)]
        want_f.append((outs, rb))
        cur = tuple(torch.cat([o[i] for o in outs]) for i in range(3))
        rb = _stacked(torch.cat([o[3] for o in outs]), src)
    want_b, lsb = [None] * len(stages), lsb_end
    for k in reversed(range(len(stages))):
        c_dt, t, sponge = stages[k]
        ins = state if k == 0 else tuple(
            torch.cat([o[i] for o in want_f[k - 1][0]]) for i in range(3))
        want_b[k] = [TB._run_stage_bwd(ops[r], meta,
                                       tuple(row(f, r) for f in ins),
                                       row(want_f[k][1], r), lam[k][r],
                                       row(lsb, r), c_dt, t, ctrl, True,
                                       sponge) for r in range(S)]
        lsb = TB._stacked_reverse(torch.cat([x[6] for x in want_b[k]]), ex)
    torch.cuda.synchronize()

    rings, free = stage_ring_regions(plan, meta.n_fp, dev)
    try:
        streams = [torch.cuda.Stream(dev) for _ in range(S)]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(dev))
        fwd = [[None] * S for _ in stages]
        for k, (c_dt, t, sponge) in enumerate(stages):
            for r in range(S):
                with torch.cuda.stream(streams[r]):
                    fwd[k][r] = TB.sw2d_stage_blocked_peer(
                        ops[r], meta, tuple(row(f, r) for f in state),
                        tuple(row(f, r) for f in state) if k == 0
                        else tuple(fwd[k - 1][r][:3]),
                        row(rb0, r) if k == 0 else None, rings[r], c_dt, t,
                        ctrl, True, sponge)
        bwd = [[None] * S for _ in stages]
        for k in reversed(range(len(stages))):
            c_dt, t, sponge = stages[k]
            for r in range(S):
                ins = (tuple(row(f, r) for f in state) if k == 0
                       else tuple(fwd[k - 1][r][:3]))
                with torch.cuda.stream(streams[r]):
                    bwd[k][r] = TB.sw2d_stage_bwd_blocked_peer(
                        ops[r], meta, ins, fwd[k][r][4], lam[k][r],
                        row(lsb_end, r) if k == len(stages) - 1 else None,
                        rings[r], c_dt, t, ctrl, True, sponge, send=k > 0)
        torch.cuda.synchronize()
        errs = {"sw2d_stage_blocked_peer": [], "sw2d_stage_bwd_blocked_peer":
                []}
        same = {k: True for k in errs}
        for k in range(len(stages)):
            for r in range(S):
                got, ref = fwd[k][r], (*want_f[k][0][r], row(want_f[k][1], r))
                errs["sw2d_stage_blocked_peer"].append(max_abs(got, ref))
                same["sw2d_stage_blocked_peer"] &= all(
                    torch.equal(a, b) for a, b in zip(got, ref))
                got = [x for x in bwd[k][r] if x is not None]
                ref = [x for x in want_b[k][r] if x is not None]
                errs["sw2d_stage_bwd_blocked_peer"].append(max_abs(got, ref))
                same["sw2d_stage_bwd_blocked_peer"] &= len(got) == len(
                    ref) and all(torch.equal(a, b) for a, b in zip(got, ref))

        # rank 0 alone at stage 2's inputs (the sponge), its flags past any
        # epoch; the plain versions on rank 0's shard and the stacked gather
        c_dt, t, sponge = stages[1]
        base0 = tuple(row(f, 0) for f in state)
        cur0, rb1 = tuple(fwd[0][0][:3]), fwd[1][0][4]
        sbs = torch.cat([fwd[1][r][3] for r in range(S)])
        orbs = torch.cat([bwd[1][r][6] for r in range(S)])
        rings[0].flags[:] = 1 << 60
        torch.cuda.synchronize()
        n_wall = int(ops[0].wall.sum())
        alone = {
            "sw2d_stage_blocked_peer": lambda: TB.sw2d_stage_blocked_peer(
                ops[0], meta, base0, cur0, None, rings[0], c_dt, t, ctrl,
                True, sponge),
            "sw2d_stage_bwd_blocked_peer":
                lambda: TB.sw2d_stage_bwd_blocked_peer(
                    ops[0], meta, cur0, rb1, lam[1][0], None, rings[0], c_dt,
                    t, ctrl, True, sponge)}
        plain = {
            "sw2d_stage_blocked_peer": lambda: (TB.sw2d_stage_blocked_plain(
                ops[0], meta, base0, cur0, rb1, c_dt, t, ctrl, True, sponge),
                _stacked(sbs, src)),
            "sw2d_stage_bwd_blocked_peer": lambda: (
                TB.sw2d_stage_bwd_blocked_v2_plain(
                    ops[0], meta, cur0, rb1, lam[1][0], row(lsb_end, 0),
                    c_dt, t, ctrl, True, sponge),
                TB._stacked_reverse(orbs, ex))}
        # bytes: each input read once, each output written once (the
        # exchange's chunks to the peers and the slots' copy for autograd
        # among them); operations: one RHS, or one RHS adjoint, a node
        B, nV = 1, meta.n_v
        bounds = {
            "sw2d_stage_blocked_peer": bound(
                4.0 * (9 * B * nV + 4 * 3 * B * L + meta.n_ctrl),
                B * rhs_flops(meta, n_wall)),
            "sw2d_stage_bwd_blocked_peer": bound(
                4.0 * (12 * B * nV + 12 * B * L + B * meta.n_ctrl),
                B * vjp_flops(meta, n_wall))}
        # B7 and B8 launched alone on the same inputs (the exchange apart)
        unfolded = {
            "sw2d_stage_blocked_peer": lambda: TB._run_stage(
                ops[0], meta, base0, cur0, rb1, c_dt, t, ctrl, True, sponge),
            "sw2d_stage_bwd_blocked_peer": lambda: TB._run_stage_bwd(
                ops[0], meta, cur0, rb1, lam[1][0], row(lsb_end, 0), c_dt, t,
                ctrl, True, sponge)}
        recs = {}
        for name in alone:
            # (a CUDA graph of launches back to back: the profiler, after
            # the earlier phases' sessions in this process, drops records)
            dev_ms = graph_us([alone[name]], n=STAGE_PEER_GRAPH_LAUNCHES) / 1e3
            unfolded_dev_ms = graph_us([unfolded[name]],
                                       n=STAGE_PEER_GRAPH_LAUNCHES) / 1e3
            recs[name] = {
                "max_abs_err": max(errs[name]), "bit_equal": same[name],
                "ms": time_ms(alone[name], RANKS_TIMED_REPS, flush),
                "unfolded_kernel_ms": time_ms(unfolded[name],
                                              RANKS_TIMED_REPS, flush),
                "device_ms": dev_ms,
                "unfolded_kernel_device_ms": unfolded_dev_ms,
                "fold_device_ms": dev_ms - unfolded_dev_ms,
                "plain_ms": time_ms(plain[name], RANKS_TIMED_REPS, flush),
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "epochs": len(stages),
                "plan": TB.shard_plan(ops[0], meta, 1, peer=True,
                                      adjoint="bwd" in name)}
    finally:
        free()
    return recs


def fold_gate_grads(mp) -> dict:
    """The gradients of the folded steps' two gates (ROADMAP C36, C35) on
    a problem of the sharded MPC (stacked, or one shard a rank over its
    ring: every rank makes the same calls), from its rest state under half
    its hidden controls: ``c36``, of a cost of the last state plus 20
    times the sum of the momenta in the send buffer after the first step
    (the two parts of that buffer's cotangent of one size), which the
    second step's first stage reads from the ring's slots (its cotangent
    the ring's part plus autograd's), in the initial depth and the
    controls; ``c35_restricted``, two backwards of the cost of the last
    state that autograd restricts to the depth after the first step
    (``inputs=``: the first step's stages do not run, so the reverse epoch
    that the second step's first stage sends is never read); ``c35``, then
    the whole gradient of that cost on a new rollout."""
    from blitzdg_tpu_torch.parallel.blocked_shard import (
        initial_send_buffer, sum_over_ranks_grad, total_over_ranks)

    ex = mp.step.exchange

    def rollout(h0, c):
        cc = sum_over_ranks_grad(c, ex)
        state = (h0, *mp.state0[1:])
        carry, out = (state, initial_send_buffer(mp.sb, state)), []
        for i in range(mp.n_steps):
            carry = mp.step(carry, i * mp.dt, cc[i])
            out.append(carry)
        return out

    def cost(out, sbuf=False):
        h, hu, hv = out[-1][0]
        loc = 1e3 * (hu ** 2).sum() + (h * hv).sum()
        if sbuf:
            loc = loc + 20.0 * out[0][1][..., 1:].sum()
        return total_over_ranks(loc, ex)

    def leaves():
        return (mp.state0[0].clone().requires_grad_(True),
                (0.5 * mp.hidden).requires_grad_(True))

    h0, c = leaves()
    res = {"c36": torch.autograd.grad(cost(rollout(h0, c), True), (h0, c))}
    out = rollout(*leaves())
    last, mid = cost(out), out[0][0][0]
    res["c35_restricted"] = tuple(
        torch.autograd.grad(last, (mid,), retain_graph=True)[0]
        for _ in range(2))
    h0, c = leaves()
    res["c35"] = torch.autograd.grad(cost(rollout(h0, c)), (h0, c))
    return {k: tuple(x.cpu() for x in v) for k, v in res.items()}


def fold_gates_check(full, dev, card: str) -> None:
    """The folded steps' gates on the card (ROADMAP C36, C35): the four
    ranks of FULL on threads and streams of this process over stage rings
    (the port's guard), each rank's ``fold_gate_grads`` against the stacked
    problem's through the stacked differentiable step: every gradient
    within SHD_GRAD_RTOL of the stacked one's largest entry (the initial
    depth's and the restricted ones' rows joined over the ranks), the
    controls' the same bits on every rank, the two restricted gradients
    the same, no trap."""
    from blitzdg_tpu_torch.mpc import sharded_box as sbx

    want = fold_gate_grads(full)
    torch.cuda.synchronize()

    def program(r, ring, sync, barrier):
        mp = sbx.sharded_mpc_problem(sbx.FULL, rank=r, ring=ring, device=dev)
        out = fold_gate_grads(mp)
        sync()
        barrier()
        return out

    res, launches, _, seconds = ranks_in_process(
        lambda meet: stage_ring_regions(full.sb.plan, full.sb.meta.n_fp, dev,
                                        meet),
        ranks_counters(), dev, program, program)
    S = len(res)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    errs = {}
    for k, w in want.items():
        if k == "c35_restricted":
            errs[k] = max(rel(torch.cat([o[k][i] for o in res]), w[i])
                          for i in range(2))
            continue
        errs[k + "_h0"] = rel(torch.cat([o[k][0] for o in res]), w[0])
        errs[k + "_controls"] = max(rel(o[k][1], w[1]) for o in res)
    same = all(torch.equal(o[k][1], res[0][k][1]) for o in res
               for k in ("c36", "c35"))
    same_restricted = all(torch.equal(*o["c35_restricted"]) for o in res)
    rec = {"phase": "sharded_fold_gates_S4_in_process", "card": card,
           "n_shards": S, "rel_err_to_stacked": errs,
           "grad_tol": SHD_GRAD_RTOL, "controls_bit_equal_on_ranks": same,
           "restricted_twice_bit_equal": same_restricted,
           "launches": launches, "seconds": seconds,
           "note": "C36: a cost also of the send buffer after the first "
                   "step (read from the ring's slots by the second); C35: "
                   "two backwards restricted to the depth after the first "
                   "step (inputs=), then a whole gradient"}
    rec["ok"] = (all(e <= SHD_GRAD_RTOL for e in errs.values()) and same
                 and same_restricted
                 and launches["sw2d_stage_bwd_blocked_peer"] > 0)
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"the folded steps' gates failed: {rec}")


def ranks_phases(dev, card: str, rng, flush) -> list:
    """The sharded MPC one shard a rank on the one card, over the stage
    ring: its kernels against their plain versions; 4 ranks in this process
    at full width (``sharded_mpc_S4_in_process``), the example's 8 ranks in
    this process (``sharded_mpc_example_S8_in_process``) and 4 processes at
    full width (``sharded_mpc_S4_ranks``), each held to the stacked solve
    run here. Returns the kernel records of the ``kernels`` line."""
    import tempfile

    from blitzdg_tpu_torch.mpc import sharded_box as sbx

    # the references: the stacked problems, their gradients at zero
    # controls through the stacked differentiable step, their solves
    refs = {}
    for name in ("FULL", "EXAMPLE"):
        mp = sbx.sharded_mpc_problem(getattr(sbx, name), device=dev)
        cs0 = torch.zeros_like(mp.hidden, requires_grad=True)
        (g0,) = torch.autograd.grad(sbx.sharded_mpc_cost(mp, cs0), cs0)
        sbx.solve_sharded_mpc(mp, iters=1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = sbx.solve_sharded_mpc(mp, iters=sbx.MPC_ITERS)
        torch.cuda.synchronize()
        refs[name] = {"mp": mp, "grad0": g0.cpu(), "sol": sol,
                      "solve_s": time.perf_counter() - t0}
    full, example = refs["FULL"]["mp"], refs["EXAMPLE"]["mp"]

    checks = stage_ring_check(full.sb.plan, full.sb.meta.n_fp, dev, rng,
                              flush)
    ok = all(c["bit_equal"] for c in checks.values())
    say({"phase": "stage_ring_kernels", "card": card, "n_shards": 4,
         "records": checks, "ok": ok})
    if not ok:
        raise RuntimeError(f"the stage ring's kernels disagree with their "
                           f"plain versions: {checks}")
    folded = stage_peer_check(full, dev, rng, flush)
    ok = all(c["bit_equal"] for c in folded.values())
    say({"phase": "stage_peer_kernels", "card": card, "n_shards": 4,
         "records": folded, "ok": ok})
    if not ok:
        raise RuntimeError(f"the folded stage launches disagree with B7 and "
                           f"B8 and the exchange between them: {folded}")
    fold_gates_check(full, dev, card)

    def judge(phase, name, res, launches, expect, extra):
        ref = refs[name]
        S = len(res)
        want_t = ref["mp"].target.cpu()
        tgt_bits = [torch.equal(o["target"], want_t[r:r + 1])
                    for r, o in enumerate(res)]
        g_ref = ref["grad0"]
        grad_err = max(float((o["grad0"] - g_ref).abs().max()
                             / g_ref.abs().max()) for o in res)
        same = [all(torch.equal(o[k], res[0][k]) for k in
                    ("controls", "history", "final", "grad0")) for o in res]
        first = float(res[0]["history"][0])
        final = float(res[0]["final"])
        ratio = final / float(ref["sol"].cost)
        limit = SHD_EXAMPLE_RATIO if name == "EXAMPLE" else 1.0
        finite = all(bool(torch.isfinite(o[k]).all()) for o in res
                     for k in ("controls", "history", "grad0"))
        rec = {"phase": phase, "card": card, "size": name, "n_shards": S,
               "k_elem": ref["mp"].ctx.k_elem, "adam_iters": sbx.MPC_ITERS,
               "n_steps": sbx.MPC_STEPS,
               "target_bit_equal_to_stacked": tgt_bits,
               "grad0_vs_stacked_rel_err": grad_err,
               "grad_tol": SHD_GRAD_RTOL,
               "ranks_bit_equal": same,
               "first_cost": first, "final_cost": final,
               "final_over_first": final / first,
               "max_final_over_first": limit,
               "stacked_final_cost": float(ref["sol"].cost),
               "cost_ratio_to_stacked": ratio, "tol": list(COST_RATIO),
               "stacked_seconds_per_solve": ref["solve_s"],
               "launches": launches, "expected_launches": expect, **extra}
        rec["ok"] = (all(tgt_bits) and grad_err <= SHD_GRAD_RTOL
                     and all(same) and finite
                     and COST_RATIO[0] <= ratio <= COST_RATIO[1]
                     and final / first < limit and launches == expect)
        say(rec)
        if not rec["ok"]:
            raise RuntimeError(f"the ranks' MPC failed its checks: {rec}")
        return launches

    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    # four ranks in this process, full width; the example's eight
    for phase, name, mp in (("sharded_mpc_S4_in_process", "FULL", full),
                            ("sharded_mpc_example_S8_in_process", "EXAMPLE",
                             example)):
        size = getattr(sbx, name)
        res, launches, prof, seconds = run_ranks_in_process(
            size, mp.sb.plan, mp.sb.meta.n_fp, dev)
        add(judge(phase, name, res, launches,
                  ranks_expected(sbx.MPC_STEPS, sbx.MPC_ITERS,
                                 size["n_shards"]),
                  {"seconds_per_solve": max(o["solve_s"] for o in res),
                   "setup_seconds": max(o["setup_s"] for o in res),
                   "seconds": seconds, "profile": prof,
                   "note": "the ranks on threads and streams of one "
                           "process, their kernels resident together"}))

    # four processes, full width
    w0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks_workers(4, Path(tmp), size="FULL")
    seconds = time.perf_counter() - w0
    launches = {k: sum(o["launches"][k] for o in res)
                for k in res[0]["launches"]}
    per_rank_ok = all(o["launches"] == ranks_expected(sbx.MPC_STEPS,
                                                      sbx.MPC_ITERS, 1)
                      for o in res)
    add(judge("sharded_mpc_S4_ranks", "FULL", res, launches,
              ranks_expected(sbx.MPC_STEPS, sbx.MPC_ITERS, 4),
              {"seconds_per_solve": [o["solve_s"] for o in res],
               "setup_seconds": [o["setup_s"] for o in res],
               "launches_exact_on_every_rank": per_rank_ok,
               "seconds": seconds,
               "profile_rank0": res[0]["profile"],
               "devices": [o["device"] for o in res],
               "note": "a rank a process, the processes time-sliced on the "
                       "card (no MPS): the time a solve measures the "
                       "slices; rank 0's idle share counts its own kernels"}))
    if not per_rank_ok:
        raise RuntimeError("a rank's launches are not its program's")

    src = "blitzdg_tpu_torch/ops/csrc/peer.cu"
    replaces = {
        "peer_stage_exchange": "blitzdg_tpu/parallel/blocked_shard.py:647",
        "peer_stage_exchange_reverse":
            "blitzdg_tpu/parallel/blocked_shard.py:647",
        "peer_rank_sum": "examples/mpc_sharded.py:123",
        "sw2d_stage_blocked_peer": "blitzdg_tpu/ops/sw2d_blocked.py:962",
        "sw2d_stage_bwd_blocked_peer": "blitzdg_tpu/ops/sw2d_blocked.py:1710"}
    notes = {"peer_stage_exchange_reverse":
             "folded into the adjoint's peer mode on this path: "
             "launched for a send buffer that needs its cotangent only; "
             "held against its plain version in stage_ring_kernels"}
    sources = {"sw2d_stage_blocked_peer":
               "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu",
               "sw2d_stage_bwd_blocked_peer":
               "blitzdg_tpu_torch/ops/csrc/sw2d_blocked.cu"}
    return [{"name": name, "route": "cuda", "source": sources.get(name, src),
             "replaces": replaces[name], "launches": totals[name],
             "max_abs_err": c["max_abs_err"], "ms": c["ms"],
             "device_ms": c["device_ms"],
             "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
             "bound_by": c["bound_by"], "library_ms": None,
             **({"note": notes[name]} if name in notes else {})}
            for name, c in {**checks, **folded}.items()]


# ---------------------------------------------------------------------------
# HALO RANKS path: the element-sharded plain-tensor path one shard a rank
# ---------------------------------------------------------------------------

# The element-sharded plain-tensor path one shard a rank over a halo ring
# (``parallel.HaloRing``), held to the stacked transport on the same card.
# The scaling study's full width (box_triangles(32, 32), K=2048, N=3,
# float32, HALO_STEPS SSP-RK2 steps at HALO_DT from rest): the ranks on
# threads and streams of this process at S = HALO_RANKS_SHARDS, with
# full-precision and bfloat16 halos, and 4 processes for
# HALO_RANKS_PROC_STEPS steps (the time slices make each meeting cost
# milliseconds). Gates (the HALO_* tolerances above): the RHS within
# HALO_RHS_RTOL of the stacked RHS's largest entry (the same arithmetic;
# cuBLAS may pick another algorithm for one shard's batch: at S=4 a
# split-K product, 1.8e-6 of the largest entry on the card), the end state
# within HALO_ROLL_ATOL (with bfloat16 halos within HALO_BF16_ROLL_ATOL:
# a difference of 1e-6 in a trace can flip its rounding to bfloat16,
# which moves it by one bfloat16 step, 2^-7 of 8 at the depths here, 8 <
# h < 12; the gate is one such step), every '+' face row (what the
# exchange delivered, gathered) bit-equal to the stacked roll's; at S=4
# the gradient of a
# linear functional of the RHS through the reverse exchange within
# HALO_RHS_RTOL of the stacked one's largest entry. The coastal rollout
# with halo_sw2d_timestep at S=4: every step's dt the stacked run's bits
# on every rank. The curved RHS on the large disk at S = HALO_CURVED_SHARDS
# ranks, held to the same RHS in float64: each field's largest error at
# most HALO_CURVED_NOISE times the unsharded float32 RHS's own (one shard's
# products take other cuBLAS algorithms, and the weak form's cancellations
# make the float32 RHS's rounding error 4e-6 to 2e-5 of each momentum and
# depth field's largest entry and 2.6e-2 of the tracer's: a float32 and a
# float64 run on the CPU), not within HALO_RHS_RTOL of the unsharded
# float32 RHS, which the stacked transport meets because it runs the very
# same products. The float64 elliptic configuration at S=4 under CG (tol
# HALO_CG_TOL: 19 iterations, as halo_elliptic's) and GMRES(HALO_RANKS_GMRES:
# one cycle of 30 to tol 1e-12, its relative residual 5.6e-13 in a float64
# run of the same solve on the CPU, so that no rounding moves the flag or
# the count): the iterations and flags of the stacked run, x within
# HALO_CG_ATOL, the flag, the iterations and the relative residual the
# same bits on every rank.
HALO_RANKS_SHARDS = (2, 4)
HALO_BF16_ROLL_ATOL = 2.0 ** -7 * 8
HALO_CURVED_NOISE = 2.0
HALO_RANKS_PROC_STEPS = 20
HALO_RANKS_PROFILE_STEPS = 20
HALO_RANKS_GMRES = {"tol": 1e-12, "restart": 30, "maxiter": 3}
HALO_RANKS_CG_MAXITER = 4000


def halo_ring_counters() -> dict:
    """The launch counters of the halo ring's kernels, by name (the halo
    path's sums are the Krylov dots', all float64)."""
    from blitzdg_tpu_torch.parallel import peer as PR

    return {"peer_halo_exchange": PR.peer_halo_exchange,
            "peer_halo_exchange_reverse": PR.peer_halo_exchange_reverse,
            "peer_rank_max": PR.peer_rank_max,
            "peer_rank_sum": PR.peer_rank_sum}


def halo_box_case(dev):
    """The scaling study's set (``examples/scaling_study.py --mode xla``):
    box_triangles(32, 32) partitioned into 4 blocks (runs of them for fewer
    shards), N=3, float32 on ``dev``; a moving state (the RHS checks) and
    the study's state at rest (the rollouts)."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.ops.sw2d import SWState
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    ctx = build_triangle_context(
        3, TP.partition_mesh(box_triangles(32, 32), 4)[0],
        dtype=torch.float32, device=dev)
    h = 10.0 + torch.exp(-10.0 * (ctx.x ** 2 + ctx.y ** 2))
    zero = torch.zeros_like(h)
    return ctx, SWState(h, 0.3 * h, -0.2 * h), SWState(h, zero, zero)


def halo_rank_blocks(ctx, plan, dev, ranks=None) -> list:
    """Each rank's shard context and halo tables (None for a rank not in
    ``ranks``)."""
    from blitzdg_tpu_torch import parallel as TP

    S = plan.n_shards
    return [(TP.shard_context(ctx, S, r), TP.halo_tables(plan, dev, rank=r))
            if ranks is None or r in ranks else None for r in range(S)]


def halo_rhs_program(ctx, plan, blocks, moving, rest, hd, steps: int,
                     grad_w=None):
    """The scaling study's program of each rank r of ``plan`` over its ring
    (the same on every rank): the halo RHS of the moving state, the '+'
    face rows of its fields, with ``grad_w`` (stacked weights) the gradient
    of a linear functional of the RHS, then, between meetings, ``steps``
    timed SSP-RK2 steps from rest; ``hd``: the halo dtype."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState
    from blitzdg_tpu_torch.timestepping import ssprk2_step

    S, phys = plan.n_shards, SWPhysics(g=9.81)
    fm = ctx.fmask.reshape(-1)
    rows = torch.stack([f[..., fm] for f in moving]).reshape(
        3, S, -1, ctx.n_fp)

    def program(r, ring, sync, barrier):
        sc, tables = blocks[r]
        mine = lambda fs: [f.reshape(S, -1, ctx.n_p)[r:r + 1] for f in fs]
        rhs = lambda s, t: TP.halo_sw2d_rhs(sc, s, t, phys, tables, plan,
                                            halo_dtype=hd, ring=ring)
        out = {"rhs": rhs(SWState(*mine(moving)), 0.0),
               "rows": TP.halo_face_rows(rows[:, r:r + 1], tables, plan,
                                         halo_dtype=hd, ring=ring)}
        if grad_w is not None:
            st = [f.clone().requires_grad_() for f in mine(moving)]
            loss = sum((a * w).sum() for a, w in
                       zip(rhs(SWState(*st), 0.0), mine(grad_w)))
            out["grad"] = torch.autograd.grad(loss, st)
        sync()
        barrier()
        t0 = time.perf_counter()
        s = SWState(*mine(rest))
        for _ in range(steps):
            s = ssprk2_step(rhs, s, 0.0, HALO_DT)
        sync()
        out["seconds"] = time.perf_counter() - t0
        barrier()
        out["end"] = s
        return out

    return program


def halo_in_process(plan, slot_bytes: int, dev, program, warm, short=None):
    """``ranks_in_process`` over halo rings of ``slot_bytes`` for ``plan``,
    with the halo ring's counters."""
    return ranks_in_process(
        lambda meet: halo_ring_regions(plan, slot_bytes, dev, meet),
        halo_ring_counters(), dev, program, warm, short)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bits of a float tensor, as integers (NaN compares equal)."""
    return t.view({torch.float32: torch.int32, torch.float64: torch.int64,
                   torch.bfloat16: torch.int16}[t.dtype])


def halo_ring_check(plan, n_fp: int, dev, rng, flush) -> dict:
    """The halo ring's kernels on the card at the scaling study's S=4
    shapes (a face-row buffer of three fields, the RHS's, (n_off, 3,
    max_send, Nfp), in float32, float64 and bfloat16; a one-value max, the
    time step's, and a one-value float64 sum, a Krylov dot's), four ranks
    on four streams, against their plain versions on the same inputs: the
    stacked roll of each offset's rows over the ranks (forward and
    reverse), ``rank_order_max`` and ``rank_order_sum``, bit for bit. Then
    each kernel of rank 0 alone, its flags set past any epoch (no wait
    holds it), CUDA events, L2 flushed, beside its plain version, and its
    device time, a launch of a CUDA graph of STAGE_PEER_GRAPH_LAUNCHES
    back to back (``device_ms``). Launches counted here are not the main
    path's. Returns a record by kernel name."""
    from blitzdg_tpu_torch.parallel import peer as PR

    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    S, offs = plan.n_shards, plan.offs
    shape = (len(offs), 3, plan.max_send, n_fp)
    slot = PR.halo_slot_bytes(plan, n_fp, 3, f64)
    roll = lambda b, sign: torch.stack(
        [torch.roll(b[:, i], sign * d, 0) for i, d in enumerate(offs)], 1)
    bufs = {dt: torch.as_tensor(rng.standard_normal((S,) + shape),
                                device=dev).to(dt) for dt in (f32, f64, bf16)}
    xs = {dt: torch.as_tensor(rng.standard_normal((S, 1)), device=dev).to(dt)
          for dt in (f32, f64)}
    calls = [(fn, bufs[dt]) for dt in (f32, f64, bf16)
             for fn in (PR.peer_halo_exchange, PR.peer_halo_exchange_reverse)]
    calls += [(fn, xs[dt]) for dt in (f32, f64)
              for fn in (PR.peer_rank_max, PR.peer_rank_sum)]
    # every call once by rank 0 alone (its flags past any epoch), so that
    # each kernel a call launches is loaded before the ranks meet
    warm, free_warm = halo_ring_regions(plan, slot, dev)
    try:
        warm[0].flags[:] = 1 << 60
        kept = [fn(warm[0], x[0].contiguous()) for fn, x in calls]
        torch.cuda.synchronize()
        del kept
    finally:
        free_warm()
    rings, free = halo_ring_regions(plan, slot, dev)
    try:
        streams = [torch.cuda.Stream(dev) for _ in range(S)]
        torch.cuda.synchronize()

        def on_ranks(fn, x):
            """``fn`` of each rank's row of ``x``, launched on its stream
            from this thread (the launches do not block)."""
            got = []
            for r in range(S):
                with torch.cuda.stream(streams[r]):
                    got.append(fn(rings[r], x[r].contiguous()))
            torch.cuda.synchronize()
            return torch.stack(got)

        cases = {"peer_halo_exchange": [], "peer_halo_exchange_reverse": [],
                 "peer_rank_max": [], "peer_rank_sum (float64)": []}
        for dt in (f32, f64, bf16):
            for name, fn, sign in (
                    ("peer_halo_exchange", PR.peer_halo_exchange, 1),
                    ("peer_halo_exchange_reverse",
                     PR.peer_halo_exchange_reverse, -1)):
                cases[name].append((str(dt), on_ranks(fn, bufs[dt]),
                                    roll(bufs[dt], sign)))
        for dt in (f32, f64):
            cases["peer_rank_max"].append(
                (str(dt), on_ranks(PR.peer_rank_max, xs[dt]),
                 PR.rank_order_max(list(xs[dt])).expand(S, 1)))
        cases["peer_rank_sum (float64)"].append(
            (str(f64), on_ranks(PR.peer_rank_sum, xs[f64]),
             PR.rank_order_sum(list(xs[f64])).expand(S, 1)))
        rings[0].flags[:] = 1 << 60
        torch.cuda.synchronize()
        alone = {
            "peer_halo_exchange": (
                lambda: PR.peer_halo_exchange(rings[0], bufs[f32][0]),
                lambda: roll(bufs[f32], 1), bufs[f32][0]),
            "peer_halo_exchange_reverse": (
                lambda: PR.peer_halo_exchange_reverse(rings[0],
                                                      bufs[f32][0]),
                lambda: roll(bufs[f32], -1), bufs[f32][0]),
            "peer_rank_max": (
                lambda: PR.peer_rank_max(rings[0], xs[f32][0]),
                lambda: PR.rank_order_max(list(xs[f32])), xs[f32][0]),
            "peer_rank_sum (float64)": (
                lambda: PR.peer_rank_sum(rings[0], xs[f64][0]),
                lambda: PR.rank_order_sum(list(xs[f64])), xs[f64][0])}
        recs = {}
        for name, got in cases.items():
            fn, plain, x = alone[name]
            bnd = bound(2.0 * x.numel() * x.element_size(), 0.0)
            recs[name] = {
                "bit_equal": {dt: bool(torch.equal(_bits(g), _bits(w)))
                              for dt, g, w in got},
                "max_abs_err": max(float((g.double() - w.double()).abs()
                                         .max()) for _, g, w in got),
                "ms": time_ms(fn, RANKS_TIMED_REPS, flush),
                "device_ms": graph_us([fn],
                                      n=STAGE_PEER_GRAPH_LAUNCHES) / 1e3,
                "plain_ms": time_ms(plain, RANKS_TIMED_REPS, flush),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "timed": f"{x.dtype}, shape {list(x.shape)}"}
    finally:
        free()
    return recs


def halo_worker(cfg: dict) -> int:
    """One rank of the scaling study's halo rollout in a process of its
    own: joins the gloo group, makes a halo ring over it (CUDA IPC), runs
    ``halo_rhs_program`` for HALO_RANKS_PROC_STEPS steps with full-precision
    and with bfloat16 halos, its ring's counters zeroed just before and
    read just after; writes its results to the case's directory."""
    import datetime

    import torch.distributed as dist

    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.parallel import peer as PR

    S, rank = cfg["S"], cfg["rank"]
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{cfg['port']}", world_size=S,
        rank=rank, timeout=datetime.timedelta(seconds=RANKS_WORKER_TIMEOUT))
    ctx, moving, rest = halo_box_case(dev)
    plan = TP.build_halo_plan(ctx, S)
    blocks = halo_rank_blocks(ctx, plan, dev, ranks=(rank,))
    ring = PR.HaloRing(plan, PR.halo_slot_bytes(plan, ctx.n_fp, 3,
                                                torch.float32),
                       dist.group.WORLD, device=dev)
    counters = halo_ring_counters()
    for f in counters.values():
        f.launches = 0
    res = {}
    for key, hd in (("full", None), ("bf16", torch.bfloat16)):
        out = halo_rhs_program(ctx, plan, blocks, moving, rest, hd,
                               HALO_RANKS_PROC_STEPS)(
            rank, ring, torch.cuda.synchronize, dist.barrier)
        res[key] = {"rhs": [f.cpu() for f in out["rhs"]],
                    "rows": out["rows"].cpu(),
                    "end": [f.cpu() for f in out["end"]],
                    "seconds": out["seconds"]}
    res["launches"] = {k: f.launches for k, f in counters.items()}
    ring.close()
    torch.save(res, Path(cfg["dir"]) / f"rank{rank}.pt")
    dist.destroy_process_group()
    print(f"HALO_OK rank={rank}", flush=True)
    return 0


def add_launches(totals: dict, launches: dict):
    """Adds each counter's launches to ``totals``."""
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def halo_rel(got, ref) -> float:
    """The largest difference over the fields of ``got`` and ``ref``, each
    relative to the reference field's largest entry."""
    return max(float((g.reshape(r.shape) - r).abs().max() / r.abs().max())
               for g, r in zip(got, ref))


def halo_cat(outs, key) -> list:
    """The ranks' fields ``key`` (lists of (1, ...) tensors), each joined
    on the shard axis."""
    return [torch.cat([o[key][i] for o in outs])
            for i in range(len(outs[0][key]))]


def halo_rollout(rhs, s, n: int):
    """``n`` SSP-RK2 steps of ``rhs`` at HALO_DT from ``s``."""
    from blitzdg_tpu_torch.timestepping import ssprk2_step

    for _ in range(n):
        s = ssprk2_step(rhs, s, 0.0, HALO_DT)
    return s


def halo_rhs_ranks(dev, card: str, rng, ctx, moving, rest):
    """The scaling study's RHS and rollout one shard a rank, S =
    HALO_RANKS_SHARDS ranks in this process, full-precision and bfloat16
    halos (``halo_rhs_S{S}_ranks_in_process``). Returns the launches and
    the stacked references of the RHS and face rows by (S, halo dtype)."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState
    from blitzdg_tpu_torch.parallel import peer as PR

    f32, bf16 = torch.float32, torch.bfloat16
    phys = SWPhysics(g=9.81)
    rel, cat, rollout = halo_rel, halo_cat, halo_rollout
    totals = {}
    fm = ctx.fmask.reshape(-1)
    refs = {}
    for S in HALO_RANKS_SHARDS:
        ref_ends = {}
        plan = TP.build_halo_plan(ctx, S)
        tables, sc = TP.halo_tables(plan, device=dev), TP.shard_context(ctx, S)
        blocks = halo_rank_blocks(ctx, plan, dev)
        split = lambda fs: SWState(*(f.reshape(S, -1, ctx.n_p) for f in fs))
        rows = torch.stack([f[..., fm] for f in moving]).reshape(
            3, S, -1, ctx.n_fp)
        slot = PR.halo_slot_bytes(plan, ctx.n_fp, 3, f32)
        for hd in (None, bf16):
            srhs = lambda s, t: TP.halo_sw2d_rhs(sc, s, t, phys, tables,
                                                 plan, halo_dtype=hd)
            grad_w = None
            if S == max(HALO_RANKS_SHARDS) and hd is None:
                grad_w = [torch.as_tensor(rng.standard_normal(
                    tuple(ctx.x.shape)), dtype=f32, device=dev)
                    for _ in range(3)]
            ref_rhs = srhs(split(moving), 0.0)
            ref_rows = TP.halo_face_rows(rows, tables, plan, halo_dtype=hd)
            rollout(srhs, split(rest), 2)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref_end = rollout(srhs, split(rest), HALO_STEPS)
            torch.cuda.synchronize()
            stacked_s = time.perf_counter() - t0
            ref_ends[hd] = ref_end
            atol = HALO_ROLL_ATOL if hd is None else HALO_BF16_ROLL_ATOL
            refs[(S, hd)] = (ref_rhs, ref_rows)
            if grad_w is not None:
                st = [f.clone().requires_grad_() for f in split(moving)]
                loss = sum((a * w.reshape(a.shape)).sum()
                           for a, w in zip(srhs(SWState(*st), 0.0), grad_w))
                ref_grad = torch.autograd.grad(loss, st)
            prog = lambda n: halo_rhs_program(ctx, plan, blocks, moving,
                                              rest, hd, n, grad_w)

            def short(r, ring):
                sc_r, tb_r = blocks[r]
                rollout(lambda s, t: TP.halo_sw2d_rhs(
                    sc_r, s, t, phys, tb_r, plan, halo_dtype=hd, ring=ring),
                    SWState(*(f.reshape(S, -1, ctx.n_p)[r:r + 1]
                              for f in rest)), HALO_RANKS_PROFILE_STEPS)

            res, launches, prof, seconds = halo_in_process(
                plan, slot, dev, prog(HALO_STEPS), prog(2), short)
            add_launches(totals, launches)
            rhs_err = rel(cat(res, "rhs"), ref_rhs)
            end = cat(res, "end")
            end_err = max_abs([f.reshape(r.shape) for f, r in
                               zip(end, ref_end)], ref_end)
            rows_bits = [bool(torch.equal(_bits(o["rows"]),
                                          _bits(ref_rows[:, r:r + 1])))
                         for r, o in enumerate(res)]
            grad_err = (rel(cat(res, "grad"), ref_grad)
                        if grad_w is not None else None)
            expect = {k: 0 for k in launches}
            expect["peer_halo_exchange"] = S * (
                2 + (grad_w is not None) + 2 * HALO_STEPS)
            expect["peer_halo_exchange_reverse"] = S * (grad_w is not None)
            finite = all(bool(torch.isfinite(f).all()) for f in end)
            rec = {"phase": f"halo_rhs_S{S}_ranks_in_process", "card": card,
                   "n_shards": S, "halo_dtype": str(hd), "k_elem": ctx.k_elem,
                   "n_order": ctx.n_order, "steps": HALO_STEPS,
                   "dt": HALO_DT, "ring_offsets": list(plan.offs),
                   "max_send": plan.max_send,
                   "rhs_rel_err": rhs_err, "rhs_rtol": HALO_RHS_RTOL,
                   "grad_rel_err": grad_err,
                   "face_rows_bit_equal_to_stacked": rows_bits,
                   "end_vs_stacked_max_abs": end_err, "end_atol": atol,
                   "stacked_bf16_gap_end": (
                       None if hd is None else max_abs(ref_end,
                                                       ref_ends[None])),
                   "us_per_step": max(o["seconds"] for o in res) * 1e6
                   / HALO_STEPS,
                   "stacked_us_per_step": stacked_s * 1e6 / HALO_STEPS,
                   "ring_launches_per_step_a_rank": 2,
                   "device_kernels_per_step_a_rank":
                       prof["device_kernels"] / HALO_RANKS_PROFILE_STEPS / S,
                   "profile": prof, "seconds": seconds,
                   "launches": launches, "expected_launches": expect,
                   "note": "the ranks on threads and streams of one "
                           "process, their kernels resident together"}
            rec["ok"] = (rhs_err <= HALO_RHS_RTOL and all(rows_bits)
                         and end_err <= atol and finite
                         and (grad_err is None or grad_err <= HALO_RHS_RTOL)
                         and launches == expect)
            say(rec)
            if not rec["ok"]:
                raise RuntimeError(f"the halo path one shard a rank "
                                   f"disagrees with the stacked one: {rec}")

    return totals, refs


def halo_rhs_procs(dev, card: str, ctx, rest, refs) -> dict:
    """The scaling study's RHS and HALO_RANKS_PROC_STEPS steps in 4 worker
    processes of this script (``halo_rhs_S4_ranks``), held to the stacked
    references ``refs``. Returns the launches."""
    import tempfile

    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState

    bf16, phys = torch.bfloat16, SWPhysics(g=9.81)
    rel, cat, rollout = halo_rel, halo_cat, halo_rollout
    S = 4
    plan = TP.build_halo_plan(ctx, S)
    tables, sc = TP.halo_tables(plan, device=dev), TP.shard_context(ctx, S)
    w0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_ranks_workers(S, Path(tmp), flag="--halo-worker",
                                tag="HALO_OK")
    seconds = time.perf_counter() - w0
    rows_ = []
    ok = True
    for key, hd in (("full", None), ("bf16", bf16)):
        ref_rhs, ref_rows = refs[(S, hd)]
        ref_end = rollout(lambda s, t: TP.halo_sw2d_rhs(
            sc, s, t, phys, tables, plan, halo_dtype=hd),
            SWState(*(f.reshape(S, -1, ctx.n_p) for f in rest)),
            HALO_RANKS_PROC_STEPS)
        got = [o[key] for o in res]
        rhs_err = rel([f.to(dev) for f in cat(got, "rhs")], ref_rhs)
        end_err = max_abs([f.to(dev).reshape(r.shape) for f, r in
                           zip(cat(got, "end"), ref_end)], ref_end)
        rows_bits = [bool(torch.equal(_bits(o["rows"]),
                                      _bits(ref_rows[:, r:r + 1].cpu())))
                     for r, o in enumerate(got)]
        atol = HALO_ROLL_ATOL if hd is None else HALO_BF16_ROLL_ATOL
        rows_.append({"halo_dtype": str(hd), "rhs_rel_err": rhs_err,
                      "face_rows_bit_equal_to_stacked": rows_bits,
                      "end_vs_stacked_max_abs": end_err, "end_atol": atol,
                      "ms_per_step": [o["seconds"] * 1e3
                                      / HALO_RANKS_PROC_STEPS for o in got]})
        ok &= (rhs_err <= HALO_RHS_RTOL and all(rows_bits)
               and end_err <= atol)
    per_rank = {k: 0 for k in res[0]["launches"]}
    per_rank["peer_halo_exchange"] = 2 * (2 + 2 * HALO_RANKS_PROC_STEPS)
    launches = {k: sum(o["launches"][k] for o in res) for k in per_rank}
    exact = all(o["launches"] == per_rank for o in res)
    rec = {"phase": "halo_rhs_S4_ranks", "card": card, "n_shards": S,
           "steps": HALO_RANKS_PROC_STEPS, "rows": rows_,
           "launches": launches, "launches_exact_on_every_rank": exact,
           "seconds": seconds, "rhs_rtol": HALO_RHS_RTOL, "ok": ok and exact,
           "note": "a rank a process, the processes time-sliced on the card "
                   "(no MPS): the time a step measures the slices"}
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"the halo path across processes failed: {rec}")

    return launches


def halo_coastal_ranks(dev, card: str, rng) -> dict:
    """The coastal rollout with the adaptive dt, S=4 ranks in this process
    (``halo_coastal_adaptive_dt_ranks``). Returns the launches."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.mesh import box_triangles
    from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState
    from blitzdg_tpu_torch.parallel import peer as PR
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
    from blitzdg_tpu_torch.timestepping import ssprk2_step

    f32 = torch.float32
    S = 4
    m = box_triangles(32, 32)
    retag_east_open(m)
    cctx = build_triangle_context(3, TP.partition_mesh(m, S)[0], dtype=f32,
                                  device=dev)
    plan = TP.build_halo_plan(cctx, S)
    tables, sc = TP.halo_tables(plan, device=dev), TP.shard_context(cctx, S)
    blocks = halo_rank_blocks(cctx, plan, dev)
    split = lambda f: f.reshape(S, -1, cctx.n_p)
    H = 10.0 + 2.0 * cctx.x + torch.as_tensor(
        rng.uniform(0.0, 1.0, (cctx.k_elem, 1)), dtype=f32, device=dev)
    Hx, Hy = cctx.grad(H)
    cphys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=split(H),
                      Hx=split(Hx), Hy=split(Hy))
    forcing = lambda t: 12.0 + 0.5 * torch.cos(0.3 * t)
    eta = 0.1 * torch.exp(-5.0 * (cctx.x ** 2 + cctx.y ** 2))
    s0 = SWState(*map(split, (H + eta, 0.05 * eta, torch.zeros_like(eta))))

    def coastal(sc_, st, ph, tb, n, ring=None):
        t, dts = torch.zeros((), dtype=f32, device=dev), []
        for _ in range(n):
            dt = TP.halo_sw2d_timestep(sc_, st, 9.81, 0.3, ring=ring)
            st = ssprk2_step(lambda a, tt: TP.halo_sw2d_rhs(
                sc_, a, tt, ph, tb, plan, tidal_forcing=forcing, ring=ring),
                st, t, dt)
            t = t + dt
            dts.append(dt)
        return st, torch.stack(dts)

    ref_st, ref_dts = coastal(sc, s0, cphys, tables, HALO_COASTAL_STEPS)
    mine_phys = lambda r: SWPhysics(
        g=9.81, cd=2.5e-3, f_cor=1e-4, H=cphys.H[r:r + 1],
        Hx=cphys.Hx[r:r + 1], Hy=cphys.Hy[r:r + 1])
    prog = lambda n: lambda r, ring, sync, barrier: coastal(
        blocks[r][0], SWState(*(f[r:r + 1] for f in s0)), mine_phys(r),
        blocks[r][1], n, ring)
    res, launches, _, seconds = halo_in_process(
        plan, PR.halo_slot_bytes(plan, cctx.n_fp, 4, f32), dev,
        prog(HALO_COASTAL_STEPS), prog(2))
    dt_bits = [bool(torch.equal(_bits(d), _bits(ref_dts))) for _, d in res]
    c_err = max(max_abs([f for f in st], [f[r:r + 1] for f in ref_st])
                for r, (st, _) in enumerate(res))
    expect = {k: 0 for k in launches}
    expect["peer_halo_exchange"] = S * 2 * HALO_COASTAL_STEPS
    expect["peer_rank_max"] = S * HALO_COASTAL_STEPS
    rec = {"phase": "halo_coastal_adaptive_dt_ranks", "card": card,
           "n_shards": S, "steps": HALO_COASTAL_STEPS,
           "dt_bit_equal_to_stacked": dt_bits,
           "dts": [float(d) for d in ref_dts],
           "end_vs_stacked_max_abs": c_err, "tol": HALO_ROLL_ATOL,
           "launches": launches, "expected_launches": expect,
           "seconds": seconds}
    rec["ok"] = all(dt_bits) and c_err <= HALO_ROLL_ATOL and launches == expect
    say(rec)
    if not rec["ok"]:
        raise RuntimeError(f"the coastal rollout across ranks failed: {rec}")

    return launches


def halo_curved_ranks(dev, card: str) -> dict:
    """The curved RHS on the large disk, S = HALO_CURVED_SHARDS ranks in
    this process (``halo_curved_ranks``). Returns the launches."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.ops.sw2d_curved import (SWStateTracer,
                                                   sw2d_curved_rhs)
    from blitzdg_tpu_torch.parallel import peer as PR

    f32, rel, totals = torch.float32, halo_rel, {}
    dctx, cub, gauss, dstate, dphys, dforce = halo_disk_case(dev)
    dref = sw2d_curved_rhs(dctx, cub, gauss, dstate, 0.37, dphys,
                           tidal_forcing=dforce)
    # the same problem in float64 (the float32 state widened): the float32
    # RHS's own rounding error, the yardstick of the gate
    c64 = halo_disk_case(dev, torch.float64)
    dref64 = sw2d_curved_rhs(*c64[:3], SWStateTracer(*(
        f.double() for f in dstate)), 0.37, dphys, tidal_forcing=dforce)
    noise = [float((a.double() - b).abs().max())
             for a, b in zip(dref, dref64)]
    crv, ok = [], True
    for S in HALO_CURVED_SHARDS:
        gplan = TP.build_gauss_halo_plan(gauss, S)
        gblocks = [([TP.shard_context(c, S, r) for c in (dctx, cub, gauss)],
                    TP.halo_tables(gplan, device=dev, rank=r))
                   for r in range(S)]
        prog = lambda r, ring, sync, barrier: TP.halo_sw2d_curved_rhs(
            *gblocks[r][0], SWStateTracer(*(f.reshape(S, -1, dctx.n_p)
                                            [r:r + 1] for f in dstate)),
            0.37, dphys, gblocks[r][1], gplan, tidal_forcing=dforce,
            ring=ring)
        res, launches, _, seconds = halo_in_process(
            gplan, PR.halo_slot_bytes(gplan, gauss.n_gauss, 4, f32), dev,
            prog, prog)
        add_launches(totals, launches)
        got = [torch.cat([o[i] for o in res]) for i in range(4)]
        err64 = [float((g.reshape(b.shape).double() - b).abs().max())
                 for g, b in zip(got, dref64)]
        row = {"n_shards": S, "ring_offsets": list(gplan.offs),
               "rel_err_vs_unsharded": rel(got, dref),
               "max_abs_err_vs_float64": err64, "launches": launches,
               "seconds": seconds}
        crv.append(row)
        ok &= (all(e <= HALO_CURVED_NOISE * n for e, n in zip(err64, noise))
               and launches["peer_halo_exchange"] == S)
    say({"phase": "halo_curved_ranks", "ok": ok, "card": card,
         "k_elem": dctx.k_elem, "rows": crv,
         "unsharded_max_abs_err_vs_float64": noise,
         "noise_factor": HALO_CURVED_NOISE})
    if not ok:
        raise RuntimeError(f"the curved halo RHS across ranks disagrees "
                           f"with sw2d_curved_rhs: {crv}")

    return totals


def halo_elliptic_ranks(dev, card: str) -> dict:
    """CG and GMRES on the float64 elliptic configuration's halo Laplacian,
    S=4 ranks in this process (``halo_elliptic_ranks``). Returns the
    launches."""
    from blitzdg_tpu_torch import parallel as TP
    from blitzdg_tpu_torch.parallel import peer as PR
    from blitzdg_tpu_torch.solvers import cg, gmres

    e = halo_elliptic_case(dev)
    S, eplan, tau, bs, pctx = e["S"], e["plan"], e["tau"], e["bs"], e["pctx"]
    etables, esc = TP.halo_tables(eplan, device=dev), TP.shard_context(pctx, S)
    eblocks = halo_rank_blocks(pctx, eplan, dev)
    solvers = {"cg": (cg, {"tol": HALO_CG_TOL,
                           "maxiter": HALO_RANKS_CG_MAXITER}),
               "gmres": (gmres, HALO_RANKS_GMRES)}
    refs_e = {name: solve(lambda v: -TP.halo_poisson2d_op(
        esc, v.reshape(bs.shape), tau, etables, eplan,
        symmetrize=True).reshape(-1), bs.reshape(-1), **kw)
        for name, (solve, kw) in solvers.items()}
    counters = halo_ring_counters()
    snaps = {}

    def eprog(warm):
        def program(r, ring, sync, barrier):
            sc_r, tb_r = eblocks[r]
            br = bs[r:r + 1]
            mv = lambda v: -TP.halo_poisson2d_op(
                sc_r, v.reshape(br.shape), tau, tb_r, eplan, symmetrize=True,
                ring=ring).reshape(-1)
            out = {}
            for name, (solve, kw) in solvers.items():
                if warm:  # a few iterations load every kernel
                    kw = dict(kw, maxiter=min(kw["maxiter"], 3 if name == "cg"
                                              else 1))
                sync()
                barrier()
                if r == 0:
                    snaps[name] = {k: f.launches for k, f in counters.items()}
                barrier()
                t0 = time.perf_counter()
                res = solve(mv, br.reshape(-1), ring=ring, **kw)
                sync()
                out[name] = (res, time.perf_counter() - t0)
                barrier()
                if r == 0:
                    snaps[name] = {k: f.launches - snaps[name][k]
                                   for k, f in counters.items()}
            if warm:
                # every width of the update's product (rows of the basis)
                n = br.numel()
                for k in range(1, HALO_RANKS_GMRES["restart"] + 1):
                    torch.einsum("...k,...kn->...n", br.new_zeros(k),
                                 br.new_zeros((k, n)))
            return out
        return program

    res, launches, _, seconds = halo_in_process(
        eplan, PR.halo_slot_bytes(eplan, pctx.n_fp, 2, torch.float64), dev,
        eprog(False), eprog(True))
    erows, ok = {}, True
    for name, ref in refs_e.items():
        outs = [o[name][0] for o in res]
        x_err = max(float((o.x - ref.x.reshape(S, -1)[r]).abs().max())
                    for r, o in enumerate(outs))
        same = [bool(torch.equal(o.flag, outs[0].flag)
                     and torch.equal(o.iters, outs[0].iters)
                     and torch.equal(_bits(o.relres), _bits(outs[0].relres)))
                for o in outs]
        its = max(int(ref.iters), 1)
        ring_l = snaps[name]
        erows[name] = {
            "iters": [int(o.iters) for o in outs],
            "iters_stacked": int(ref.iters),
            "flags": [int(o.flag) for o in outs],
            "flag_stacked": int(ref.flag),
            "relres": float(outs[0].relres),
            "x_vs_stacked_max_abs": x_err, "atol": HALO_CG_ATOL,
            "same_bits_on_every_rank": same,
            "ms_per_iteration": max(o[name][1] for o in res) * 1e3 / its,
            "ring_launches_per_iteration_a_rank": {
                k: v / its / S for k, v in ring_l.items() if v}}
        ok &= (all(int(o.iters) == int(ref.iters)
                   and int(o.flag) == int(ref.flag) for o in outs)
               and x_err <= HALO_CG_ATOL and all(same))
    say({"phase": "halo_elliptic_ranks", "card": card, "n_shards": S,
         "k_elem": e["ctx"].k_elem, "k_padded": pctx.k_elem,
         "n_order": ELL_ORDER, "dtype": "float64", "solvers": erows,
         "gmres": HALO_RANKS_GMRES, "launches": launches,
         "seconds": seconds, "ok": ok})
    if not ok:
        raise RuntimeError(f"the Krylov solves across ranks disagree with "
                           f"the stacked ones: {erows}")

    return launches


def halo_ranks_phases(dev, card: str, rng, flush) -> list:
    """The element-sharded plain-tensor path one shard a rank on the one
    card, over the halo ring: its kernels against their plain versions
    (``halo_ring_kernels``); the scaling study's RHS and rollout at S = 2, 4
    ranks in this process, full-precision and bfloat16 halos
    (``halo_rhs_S{S}_ranks_in_process``), and 4 processes
    (``halo_rhs_S4_ranks``); the coastal rollout with the adaptive dt
    (``halo_coastal_adaptive_dt_ranks``); the curved RHS
    (``halo_curved_ranks``); CG and GMRES on the halo Laplacian
    (``halo_elliptic_ranks``); each held to the stacked transport run here.
    Returns the kernel records of the ``kernels`` line."""
    from blitzdg_tpu_torch import parallel as TP

    ctx, moving, rest = halo_box_case(dev)
    # ---- the ring's kernels alone, at the S=4 plan's shapes ----
    checks = halo_ring_check(TP.build_halo_plan(ctx, 4), ctx.n_fp, dev, rng,
                             flush)
    ok = all(all(c["bit_equal"].values()) for c in checks.values())
    say({"phase": "halo_ring_kernels", "card": card, "n_shards": 4,
         "records": checks, "ok": ok})
    if not ok:
        raise RuntimeError(f"the halo ring's kernels disagree with their "
                           f"plain versions: {checks}")

    totals, refs = halo_rhs_ranks(dev, card, rng, ctx, moving, rest)
    add_launches(totals, halo_rhs_procs(dev, card, ctx, rest, refs))
    add_launches(totals, halo_coastal_ranks(dev, card, rng))
    add_launches(totals, halo_curved_ranks(dev, card))
    add_launches(totals, halo_elliptic_ranks(dev, card))

    src = "blitzdg_tpu_torch/ops/csrc/peer.cu"
    replaces = {
        "peer_halo_exchange": "blitzdg_tpu/parallel/halo.py:198",
        "peer_halo_exchange_reverse": "blitzdg_tpu/parallel/halo.py:198",
        "peer_rank_max": "blitzdg_tpu/parallel/halo.py:431",
        "peer_rank_sum (float64)": "blitzdg_tpu/solvers/krylov.py:61"}
    # (the halo path's sums are the Krylov loops' float64 dots)
    launched = lambda name: totals.get(name.removesuffix(" (float64)"), 0)
    for name in replaces:
        if launched(name) < 1:
            raise RuntimeError(f"{name} was not launched on the halo path")
    return [{"name": name, "route": "cuda", "source": src,
             "replaces": replaces[name], "launches": launched(name),
             "max_abs_err": c["max_abs_err"], "ms": c["ms"],
             "device_ms": c["device_ms"],
             "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
             "bound_by": c["bound_by"], "library_ms": None}
            for name, c in checks.items()]


def rank_ops(ops, r: int):
    """Shard r's operator set of a stacked set, with its shard axis (one
    rank's set)."""
    return dataclasses.replace(ops, **{
        f.name: getattr(ops, f.name)[r:r + 1]
        for f in dataclasses.fields(ops)})


def ptxas_summary(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel in one source's
    ``ptxas -v`` output, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln or "Function properties for" in ln:
            name = (ln.split("'")[1] if "'" in ln else ln.split()[-1])
            out.setdefault(name, {})
        elif name and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name]["stack_bytes"] = nums[0]
            out[name]["spill_bytes"] = nums[1] + nums[2]
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def sass_mix(lib, keep=lambda name: True) -> dict:
    """Static instruction counts of the kernels of a built library, from
    ``cuobjdump -sass`` (the toolkit's, beside nvcc), by mangled name: all
    instructions, FFMA, shared-memory loads (LDS, any width) and block
    barriers (BAR). Static: a loop's body counts once, whatever its trip
    count."""
    from blitzdg_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        ln = ln.strip()
        if ln.startswith("Function :"):
            name = ln.split(":", 1)[1].strip()
            if not keep(name):
                name = None
                continue
            out[name] = {"instructions": 0, "FFMA": 0, "LDS": 0, "BAR": 0}
        elif name and ln.startswith("/*") and "*/" in ln:
            words = ln.split("*/", 1)[1].split()
            if not words or words[0].startswith("/*"):
                continue  # the encoding's second word
            op = words[1] if words[0].startswith("@") else words[0]
            op = op.split(".")[0]
            out[name]["instructions"] += 1
            if op in ("FFMA", "LDS", "BAR"):
                out[name][op] += 1
    for v in out.values():
        v["FFMA_per_LDS"] = v["FFMA"] / max(v["LDS"], 1)
    return out


# The curved rollout kernels (mangled names) in both instantiations: N=3's
# sizes and the run-time sizes.
CURVED_ROLLOUT_KERNELS = [
    k + z for k in ("_Z26sw2d_curved_rollout_kernel",
                    "_Z30sw2d_curved_rollout_bwd_kernel")
    for z in ("I5SizesILi10ELi34ELi8EEE", "I5SizesILi0ELi0ELi0EEE")]
# The three dense kernels in both instantiations: N=1 with two controls and
# the run-time sizes.
DENSE_KERNELS = [
    k + z for k in ("_Z16sw2d_step_kernel", "_Z19sw2d_rollout_kernel",
                    "_Z23sw2d_rollout_bwd_kernel")
    for z in ("I6DSizesILi3ELi2ELi2EEE", "I6DSizesILi0ELi0ELi0EEE")]


# The q kernels in their three instantiations: N=3 with two controls, N=3
# with others, the run-time sizes; the forward ones also at N=6. The
# sharded path's: the stage kernel, its adjoint (and its wide
# instantiations: two at N=3, 16 lanes an element, one at N=1 with two
# controls, 8) and the one-launch step; the blocked path's: the rollout
# (the step's kernel too) and its adjoint. (QSizes<NP, NFP, NC, LANES,
# NFACES>, mangled.)
Q_SIZES = ("I6QSizesILi10ELi4ELi2ELi4ELi3EEE",
           "I6QSizesILi10ELi4ELin1ELi4ELi3EEE",
           "I6QSizesILi0ELi0ELin1ELi1ELi3EEE")
Q_SIZES_N6 = "I6QSizesILi28ELi7ELin1ELi8ELi3EEE"
Q_SIZES_WIDE_N3 = ("I6QSizesILi10ELi4ELi2ELi16ELi3EEE",
                   "I6QSizesILi10ELi4ELin1ELi16ELi3EEE")
# quadrilaterals at N=4, eight lanes an element (every q kernel's)
Q_SIZES_QUAD_N4 = "I6QSizesILi25ELi5ELin1ELi8ELi4EEE"
SHARDED_KERNELS = [
    k + z for k in ("_Z17sw2d_stage_kernel", "_Z21sw2d_stage_bwd_kernel",
                    "_Z21sw2d_step_rdma_kernel")
    for z in Q_SIZES] + [
    "_Z21sw2d_stage_bwd_kernel" + z
    for z in Q_SIZES_WIDE_N3 + ("I6QSizesILi3ELi2ELi2ELi8ELi3EEE",)
] + [k + Q_SIZES_N6 for k in ("_Z17sw2d_stage_kernel",
                              "_Z21sw2d_step_rdma_kernel")]
BLOCKED_ADJOINT_KERNELS = ["_Z31sw2d_blocked_rollout_bwd_kernel" + z
                           for z in Q_SIZES + (Q_SIZES_QUAD_N4,)]
BLOCKED_FORWARD_KERNELS = ["_Z27sw2d_blocked_rollout_kernel" + z
                           for z in Q_SIZES + (Q_SIZES_N6,)]
# Quadrilaterals run the N=4 instantiation of every q kernel (the
# one-launch step in both modes) and every q kernel's run-time-size one.
QUAD_KERNELS = [k + Q_SIZES_QUAD_N4 for k in (
    "_Z27sw2d_blocked_rollout_kernel",
    "_Z31sw2d_blocked_rollout_bwd_kernel", "_Z17sw2d_stage_kernel",
    "_Z21sw2d_stage_bwd_kernel", "_Z21sw2d_step_rdma_kernel",
    "_Z26sw2d_step_rdma_peer_kernel")] + [
    k + Q_SIZES[2] for k in (
        "_Z27sw2d_blocked_rollout_kernel",
        "_Z31sw2d_blocked_rollout_bwd_kernel", "_Z17sw2d_stage_kernel",
        "_Z21sw2d_stage_bwd_kernel", "_Z21sw2d_step_rdma_kernel")]


# The one-launch step's peer mode in its five instantiations, and the
# step-boundary exchange.
PEER_KERNELS = ["_Z26sw2d_step_rdma_peer_kernel" + z
                for z in Q_SIZES + (Q_SIZES_N6, Q_SIZES_QUAD_N4)]
PEER_EXCHANGE_KERNELS = ["_Z25peer_ring_exchange_kernel"]
# The stage ring's exchange (both directions) and its sum over ranks.
STAGE_RING_KERNELS = ["_Z26peer_stage_exchange_kernel",
                      "_Z23peer_rank_reduce_kernelIfLi0EE"]
# The stage's and its adjoint's peer modes (the exchange and its reverse
# folded in) in every instantiation of their stacked kernels.
STAGE_PEER_KERNELS = [
    "_Z22sw2d_stage_peer_kernel" + z
    for z in Q_SIZES + (Q_SIZES_N6, Q_SIZES_QUAD_N4)] + [
    "_Z26sw2d_stage_bwd_peer_kernel" + z
    for z in Q_SIZES + Q_SIZES_WIDE_N3 + ("I6QSizesILi3ELi2ELi2ELi8ELi3EEE",
                                          Q_SIZES_QUAD_N4)]
# The halo ring's: the same exchange kernel, the maximum in float and
# double, the sum in double.
HALO_RING_KERNELS = ["_Z26peer_stage_exchange_kernel",
                     "_Z23peer_rank_reduce_kernelIfLi1EE",
                     "_Z23peer_rank_reduce_kernelIdLi1EE",
                     "_Z23peer_rank_reduce_kernelIdLi0EE"]


def check_no_spills(report: dict, kernels: list):
    """Fails unless ptxas's report (this build's, or the one kept beside a
    library built before) covers every kernel named (by mangled-name
    prefix) and none of them spills."""
    for k in kernels:
        found = [v for name, v in report.items() if name.startswith(k)]
        if len(found) != 1 or "spill_bytes" not in found[0]:
            raise RuntimeError(f"no ptxas report of {k}: {found}")
        if found[0]["spill_bytes"] > 0:
            raise RuntimeError(f"ptxas spills in {k}: {found[0]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("dense", "blocked", "curved",
                                       "sharded", "peer", "ranks",
                                       "elliptic", "solver", "quads",
                                       "ins2d", "dg1d", "halo", "compat",
                                       "halo_ranks"),
                    help="run one path's phases alone (default: all)")
    ap.add_argument("--peer-worker", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--peer-fresh", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--ranks-worker", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--halo-worker", metavar="JSON", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    if args.peer_worker:
        return peer_worker(json.loads(args.peer_worker))
    if args.peer_fresh:
        return peer_fresh_worker(json.loads(args.peer_fresh))
    if args.ranks_worker:
        return ranks_worker(json.loads(args.ranks_worker))
    if args.halo_worker:
        return halo_worker(json.loads(args.halo_worker))

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
    libs = _build.build_all()
    curved = ptxas_summary(_build.last_build_log.get("sw2d_curved", ""))
    dense = ptxas_summary(_build.last_build_log.get("sw2d_dense", ""))
    blocked = ptxas_summary(_build.last_build_log.get("sw2d_blocked", ""))
    peer = ptxas_summary(_build.last_build_log.get("peer", ""))
    say({"phase": "build", "seconds": time.perf_counter() - t0,
         "ptxas": [ln for log in _build.last_build_log.values()
                   for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln][:32],
         "ptxas_curved": curved, "ptxas_dense": dense,
         "ptxas_q": {k: v for k, v in blocked.items() if "QSizes" in k},
         "ptxas_peer": peer,
         "sass_curved_N3": sass_mix(libs["sw2d_curved"],
                                    lambda n: "Li10ELi34ELi8E" in n),
         "sass_dense": sass_mix(libs["sw2d_dense"],
                                lambda n: "_kernel" in n),
         "sass_q": sass_mix(libs["sw2d_blocked"], lambda n: "QSizes" in n)})

    rng = np.random.default_rng(0)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = lambda: scratch.zero_()  # 256 MB written: empties the 50 MB L2

    kernels = []
    if args.only in (None, "dense"):
        kernels += dense_phases(dev, card, rng, flush)
    if args.only in (None, "blocked"):
        kernels += blocked_phases(dev, card, rng, flush)
    if args.only in (None, "curved"):
        kernels += curved_phases(dev, card, rng, flush)
    if args.only in (None, "sharded"):
        kernels += sharded_phases(dev, card, rng, flush)
    if args.only in (None, "peer"):
        kernels += peer_phases(dev, card, rng, flush)
    if args.only in (None, "ranks"):
        kernels += ranks_phases(dev, card, rng, flush)
    if args.only in (None, "elliptic"):
        kernels += elliptic_phases(dev, card, rng, flush)
    if args.only in (None, "solver"):
        kernels += solver_phases(dev, card, rng, flush)
    if args.only in (None, "quads"):
        kernels += quads_phases(dev, card, rng, flush)
    if args.only in (None, "ins2d"):
        kernels += ins2d_phases(dev, card, rng, flush)
    if args.only in (None, "dg1d"):
        kernels += dg1d_phases(dev, card, rng, flush)
    if args.only in (None, "halo"):
        kernels += halo_phases(dev, card, rng, flush)
    if args.only in (None, "compat"):
        kernels += compat_phases(dev, card, rng, flush)
    if args.only in (None, "halo_ranks"):
        kernels += halo_ranks_phases(dev, card, rng, flush)

    say({"phase": "total", "seconds": time.perf_counter() - t_start})
    if args.only in (None, "curved"):
        check_no_spills(curved, CURVED_ROLLOUT_KERNELS)
    if args.only in (None, "dense"):
        check_no_spills(dense, DENSE_KERNELS)
    if args.only in (None, "blocked"):
        check_no_spills(blocked, BLOCKED_ADJOINT_KERNELS)
        check_no_spills(blocked, BLOCKED_FORWARD_KERNELS)
    if args.only in (None, "sharded"):
        check_no_spills(blocked, SHARDED_KERNELS)
    if args.only in (None, "peer"):
        check_no_spills(blocked, PEER_KERNELS)
        check_no_spills(peer, PEER_EXCHANGE_KERNELS)
    if args.only in (None, "ranks"):
        check_no_spills(blocked, SHARDED_KERNELS)
        check_no_spills(blocked, STAGE_PEER_KERNELS)
        check_no_spills(peer, STAGE_RING_KERNELS)
    if args.only in (None, "quads"):
        check_no_spills(blocked, QUAD_KERNELS)
    if args.only in (None, "halo_ranks"):
        check_no_spills(peer, HALO_RING_KERNELS)
    say({"kernels": kernels})
    print(card, flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
