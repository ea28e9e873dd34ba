"""The stage ring's kernels (``ops/csrc/peer.cu``: the exchange between the
RK stages across ranks, its reverse, the sum over ranks) compiled for the
CPU with ``g++ -std=c++20 -pthread`` behind the shim header of
``test_torch_blocked_kernel_shim.py`` (every CUDA thread a host thread,
``cuda::atomic_ref`` as ``std::atomic_ref``, the global timer as the steady
clock, ``__trap`` an exception that fails the launch), with S ranks as S
host threads over each other's host memory (``StageRing.over_regions``):
the ranks' launches run at once and meet only through their flags.

 - the exchange and its reverse bit-equal to the stacked gather
   (``halo._stacked`` with ``_stacked_source(plan, chunk, +-1)``) over
   several epochs, at S=2 (one offset, rank + 1 and rank - 1 the same
   peer), S=4 with offsets 1, 2 and 3, and S=3 with offset 1 alone (no
   symmetric offset: every rank sends to one peer and receives from
   another);
 - the sum bit-equal on every rank and to the rank-order sum, a vector
   longer than a sum slot in two launches;
 - a rank that sleeps before its calls gives the same bits; a rank that
   never launches makes its peers' launches trap after the ring's bound,
   an error and not a hang;
 - the ranks' threads meet before each ring launch (``meet=`` of
   ``over_regions``, which ranks on threads of their own need);
 - the receive buffer is memory torch owns: after a second exchange into
   the same slots the first receive buffer keeps its values, and autograd
   pairs the exchange with its reverse;
 - the whole rank-local sharded MPC (``sharded_mpc_problem(rank=,
   ring=)``: the stages the stage's and its adjoint's peer modes, the
   exchange folded in, a rollout's first exchange and the sums the ring's
   kernels, all on the shim of ``sw2d_blocked.cu`` with ``peer.cu``),
   ranks as threads, in float32: the cost and the control gradient against
   the stacked problem's through the same stage kernels, the controls
   bit-equal on every rank after two Adam iterations, and the launch
   counts of each kernel.
"""
import ctypes
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_blocked_kernel_shim import (CUDA_ATOMIC, SHIM, _shim_flags,
                                            build_shim_lib)

from blitzdg_tpu_torch.mpc import sharded_box as sbx
from blitzdg_tpu_torch.ops import _build
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel import peer as PR
from blitzdg_tpu_torch.parallel.halo import (HaloPlan, RingExchange,
                                             _stacked, _stacked_source)

F32 = torch.float32
SHIM_THREADS = 32  # a block's threads on the shim (one warp)


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel source cannot be "
                    "compiled for the CPU")
    d = tmp_path_factory.mktemp("peer_stage_shim")
    (d / "shim.h").write_text(SHIM)
    (d / "cuda_runtime.h").write_text('#pragma once\n#include "shim.h"\n')
    (d / "cuda").mkdir()
    (d / "cuda" / "atomic").write_text(CUDA_ATOMIC)
    (d / "peer.cu").write_text((_build.CSRC / "peer.cu").read_text())
    (d / "peer_flags.cuh").write_text(
        _shim_flags((_build.CSRC / "peer_flags.cuh").read_text()))
    lib = d / "libpeer_shim.so"
    cmd = [gxx, "-std=c++20", "-pthread", "-O1", "-shared", "-fPIC", "-w",
           "-include", str(d / "shim.h"), "-I", str(d), "-x", "c++",
           str(d / "peer.cu"), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def lib(shim_lib, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: shim_lib)
    monkeypatch.setattr(PR, "THREADS", SHIM_THREADS)
    return shim_lib


def _plan(S: int, offs: tuple, max_send: int = 3) -> HaloPlan:
    """A plan with the given ring offsets (the ring reads only these, the
    shard count and the slots an offset)."""
    n = max(len(offs), 1)
    return HaloPlan(send_idx=np.zeros((S, n, max_send), np.int32),
                    psrc=np.zeros((S, 1), np.int32),
                    pflip=np.zeros((S, 1), bool), offs=offs, n_shards=S,
                    max_send=max_send)


def _rings(plan, n_fp, batch, timeout_s=30.0, meet=True):
    """The S ranks' rings over zeroed host regions of this process; with
    ``meet`` their threads meet before each ring launch (a barrier of S,
    for ranks on threads of their own; without, one thread launches)."""
    S = plan.n_shards
    lay = PR.stage_region_layout(batch, PR._n_slots(plan, n_fp),
                                 len(plan.offs), S)
    regions = [torch.zeros(lay["bytes"], dtype=torch.uint8) for _ in range(S)]
    bases = {r: g.data_ptr() for r, g in enumerate(regions)}
    barrier = threading.Barrier(S) if meet else None
    rings = [PR.StageRing.over_regions(plan, n_fp, batch, r, bases, "cpu",
                                       timeout_s, barrier) for r in range(S)]
    return rings, regions


def _on_threads(S, fn, missing=(), join_s=120.0):
    """``fn(r)`` on a thread a rank (not for ranks in ``missing``); each
    rank's result and error."""
    out, errors = [None] * S, [None] * S

    def run(r):
        try:
            out[r] = fn(r)
        except RuntimeError as e:
            errors[r] = e

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(S) if r not in missing]
    t0 = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(join_s - (time.monotonic() - t0), 0.0))
    assert not any(th.is_alive() for th in threads), \
        "a rank is still waiting: a wait that does not end"
    return out, errors


EXCHANGE_CASES = {
    "S2_offset1": (2, (1,), 3),
    "S4_offsets123": (4, (1, 2, 3), 2),
    "S3_offset1_alone": (3, (1,), 1),
}
N_FP, EPOCHS = 2, 3


@pytest.mark.parametrize("name", list(EXCHANGE_CASES))
def test_stage_exchange_and_reverse_match_the_stacked_gather(lib, name):
    """Each rank's receive buffer of each of EPOCHS forward exchanges, and
    of each reverse one after them, bit-equal to its row of the stacked
    gather of every rank's buffer; the flags read the last epoch of each
    use (the GO flags one ahead: the slots read and freed)."""
    S, offs, B = EXCHANGE_CASES[name]
    plan = _plan(S, offs)
    rings, _ = _rings(plan, N_FP, B)
    L = rings[0].n_slots
    g = torch.Generator().manual_seed(S)
    fwd = [torch.randn((S, B, L, 3), generator=g) for _ in range(EPOCHS)]
    rev = [torch.randn((S, B, L, 3), generator=g) for _ in range(EPOCHS)]

    def rank(r):
        got = [PR.peer_stage_exchange(rings[r], f[r:r + 1].contiguous())
               for f in fwd]
        got += [PR.peer_stage_exchange_reverse(rings[r],
                                               f[r:r + 1].contiguous())
                for f in rev]
        return got

    out, errors = _on_threads(S, rank)
    assert errors == [None] * S
    chunk = plan.max_send * N_FP
    src = torch.as_tensor(_stacked_source(plan, chunk, 1))
    src_rev = torch.as_tensor(_stacked_source(plan, chunk, -1))
    want = [_stacked(f, src) for f in fwd] + [_stacked(f, src_rev)
                                             for f in rev]
    for r in range(S):
        for k, w in enumerate(want):
            assert torch.equal(out[r][k], w[r:r + 1]), (r, k)
    n_off = len(offs)
    for ring in rings:
        f = ring.flags.tolist()
        assert f[:4 * n_off] == [EPOCHS + 1, EPOCHS] * 2 * n_off
        assert ring.epochs == {"forward": EPOCHS, "reverse": EPOCHS,
                               "sum": 0}


@pytest.mark.parametrize("S", [2, 4])
def test_rank_sum_is_the_rank_order_sum_on_every_rank(lib, S):
    """Vectors of 1, 16 and 300 floats (the last longer than the ring's 256
    floats a sum slot: two launches), three rounds: every rank's sum has
    the same bits, those of the rank-order sum; at S=4 a float32 sum in
    another order differs in its last bits for some entries."""
    rings, _ = _rings(_plan(S, (1,) if S == 2 else (1, 2, 3)), N_FP, 1)
    g = torch.Generator().manual_seed(10 + S)
    lens = (1, 16, 300) * 3
    # magnitudes spread over decades, so that the order of the adds shows
    xs = [torch.randn((S, n), generator=g)
          * 10.0 ** torch.randint(-3, 4, (S, n), generator=g) for n in lens]
    out, errors = _on_threads(S, lambda r: [
        PR.peer_rank_sum(rings[r], x[r].contiguous()) for x in xs])
    assert errors == [None] * S
    other_order = False
    for k, x in enumerate(xs):
        want = PR.rank_order_sum(list(x))
        for r in range(S):
            assert torch.equal(out[r][k], want), (r, k)
        other_order |= not torch.equal(PR.rank_order_sum(list(x.flip(0))),
                                       want)
    assert other_order == (S > 2)  # (two parts commute)
    assert rings[0].epochs["sum"] == 3 * (1 + 1 + 2)


def test_a_delayed_rank_gives_the_same_bits(lib):
    """S=4, rank 2 sleeping before every second call: its peers wait at its
    flags, and every rank's exchanges, reverse exchanges and sums carry the
    bits of the run without delay."""
    S, B = 4, 2
    plan = _plan(S, (1, 2, 3))

    def run(delay):
        rings, _ = _rings(plan, N_FP, B)
        g = torch.Generator().manual_seed(5)
        L = rings[0].n_slots
        bufs = [torch.randn((S, B, L, 3), generator=g) for _ in range(4)]

        def rank(r):
            got = []
            for k, b in enumerate(bufs):
                if delay and r == 2 and k % 2 == 0:
                    time.sleep(0.2)
                x = b[r:r + 1].contiguous()
                got.append(PR.peer_stage_exchange(rings[r], x))
                got.append(PR.peer_stage_exchange_reverse(rings[r], x))
                got.append(PR.peer_rank_sum(rings[r], x[0, 0, :5, 0]
                                            .contiguous()))
            return got

        out, errors = _on_threads(S, rank)
        assert errors == [None] * S
        return out

    plain, delayed = run(False), run(True)
    for r in range(S):
        assert all(torch.equal(a, b) for a, b in zip(plain[r], delayed[r]))


@pytest.mark.parametrize("what", ["exchange", "reverse", "sum"])
def test_a_lost_peer_traps(lib, what):
    """S=2 with rank 1 absent: rank 0's launch stores its part and waits
    for rank 1's, which never comes; past the ring's bound (0.3 s) it traps,
    which fails the launch: an error, not a hang (the test's own bound:
    60 s). (Rank 0's thread alone launches: no meeting.)"""
    rings, _ = _rings(_plan(2, (1,)), N_FP, 1, timeout_s=0.3, meet=False)
    x = torch.ones((1, 1, rings[0].n_slots, 3))
    call = {"exchange": PR.peer_stage_exchange,
            "reverse": PR.peer_stage_exchange_reverse,
            "sum": lambda ring, t: PR.peer_rank_sum(ring, t[0, 0, :4, 0]
                                                     .contiguous())}[what]
    t0 = time.monotonic()
    out, errors = _on_threads(2, lambda r: call(rings[r], x), missing=(1,),
                              join_s=60.0)
    assert out == [None, None] and errors[1] is None
    assert isinstance(errors[0], RuntimeError)
    assert ("peer_rank_sum" if what == "sum" else "peer_stage_exchange") \
        in str(errors[0])
    assert time.monotonic() - t0 < 60.0


def test_receive_buffer_is_owned_and_the_backward_is_the_reverse(lib):
    """Through ``RingExchange(..., ring=)``: two exchanges into the same
    slots; the first receive buffer still holds the first exchange's
    values after the second (a view of the slots would hold the second's,
    and autograd, which keeps the receive buffer for the stage adjoint,
    would then differentiate at the wrong point), it does not lie in the
    region, and the gradients of a cost of both are the reverse gathers of
    its cotangents."""
    S, B = 4, 1
    plan = _plan(S, (1, 2, 3))
    rings, regions = _rings(plan, N_FP, B)
    L = rings[0].n_slots
    g = torch.Generator().manual_seed(7)
    s1, s2, w1, w2 = (torch.randn((S, B, L, 3), generator=g)
                      for _ in range(4))
    n0 = (PR.peer_stage_exchange.launches,
          PR.peer_stage_exchange_reverse.launches)

    def rank(r):
        ex = RingExchange(plan, N_FP, ring=rings[r])
        a = s1[r:r + 1].clone().requires_grad_(True)
        b = s2[r:r + 1].clone().requires_grad_(True)
        rb1 = ex(a)
        first = rb1.detach().clone()
        rb2 = ex(b)
        loss = (w1[r:r + 1] * rb1).sum() + (w2[r:r + 1] * rb2).sum()
        ga, gb = torch.autograd.grad(loss, (a, b))
        return rb1.detach(), first, rb2.detach(), ga, gb

    out, errors = _on_threads(S, rank)
    assert errors == [None] * S
    chunk = plan.max_send * N_FP
    src = torch.as_tensor(_stacked_source(plan, chunk, 1))
    src_rev = torch.as_tensor(_stacked_source(plan, chunk, -1))
    want = (_stacked(s1, src), _stacked(s2, src), _stacked(w1, src_rev),
            _stacked(w2, src_rev))
    for r in range(S):
        rb1, first, rb2, ga, gb = out[r]
        assert torch.equal(rb1, first) and torch.equal(rb1, want[0][r:r + 1])
        assert torch.equal(rb2, want[1][r:r + 1])
        assert not torch.equal(rb1, rb2)
        assert torch.equal(ga, want[2][r:r + 1])
        assert torch.equal(gb, want[3][r:r + 1])
        lo = regions[r].data_ptr()
        assert not lo <= rb1.data_ptr() < lo + regions[r].numel()
    assert (PR.peer_stage_exchange.launches - n0[0],
            PR.peer_stage_exchange_reverse.launches - n0[1]) == (2 * S, 2 * S)


# the rank-local MPC on the shim: the example's mesh in 4 shards, 4 steps
MPC_SIZE = dict(sbx.EXAMPLE, n_shards=4)
MPC_STEPS, MPC_ITERS = 4, 2


@pytest.fixture(scope="module")
def blocked_lib(tmp_path_factory):
    return build_shim_lib(tmp_path_factory)


@pytest.fixture
def blocked(blocked_lib, monkeypatch):
    """The stage kernels' source with the ring's on the shim (two SMs of
    one block), the ring kernels' block one warp."""
    monkeypatch.setattr(_build, "load", lambda name: blocked_lib)
    monkeypatch.setattr(TB, "_plans", {})
    monkeypatch.setattr(PR, "THREADS", SHIM_THREADS)
    ctypes.c_int.in_dll(blocked_lib, "shim_sms").value = 2
    ctypes.c_int.in_dll(blocked_lib, "shim_per_sm").value = 1
    return blocked_lib


def kernel_stages(monkeypatch, counts):
    """B7 and B8 launched on the shim for CPU tensors where a step calls
    them without a ring (the stacked steps' stages), counted in
    ``counts``."""
    stage, stage_bwd = BS.sw2d_stage_blocked, BS.sw2d_stage_bwd_blocked_v2

    def fwd(ops, meta, base, cur, rb, c_dt, t=0.0, ctrl=None,
            use_filter=True, apply_sponge=False, ring=None):
        if ring is not None:
            return stage(ops, meta, base, cur, rb, c_dt, t, ctrl,
                         use_filter, apply_sponge, ring=ring)
        counts["B7"] += 1
        return TB._run_stage(ops, meta, base, cur, rb, c_dt, t, ctrl,
                             use_filter, apply_sponge)

    def bwd(ops, meta, cur, rb, lam, lsb, c_dt, t=0.0, ctrl=None,
            use_filter=True, apply_sponge=False, ring=None, send=True,
            lam_sb_add=None):
        if ring is not None:
            return stage_bwd(ops, meta, cur, rb, lam, lsb, c_dt, t, ctrl,
                             use_filter, apply_sponge, ring=ring, send=send,
                             lam_sb_add=lam_sb_add)
        counts["B8"] += 1
        return TB._run_stage_bwd(ops, meta, cur, rb, lam, lsb, c_dt, t,
                                 ctrl, use_filter, apply_sponge)

    monkeypatch.setattr(BS, "sw2d_stage_blocked", fwd)
    monkeypatch.setattr(BS, "sw2d_stage_bwd_blocked_v2", bwd)


def test_rank_local_mpc_over_the_ring_kernels(blocked, monkeypatch):
    """Four ranks as threads, each ``sharded_mpc_problem(MPC_SIZE,
    rank=r, ring=its StageRing)`` on the CPU in float32 (every stage a
    launch of the stage's or its adjoint's peer mode, a rollout's first
    exchange and the sums the ring's kernels, on the shim): each rank's
    target is its shard of the stacked target through the same stage
    kernels (B7 on the stacked set, the stacked exchange), bit for bit;
    the cost and control gradient at the hidden controls' half match the
    stacked problem's (float32: 1e-5 relative); after two Adam iterations
    every rank's controls and cost history have the same bits, and they
    match the stacked solve's to 1e-5; each rank launched its folded
    stages, exchanges, reverse exchanges and sums as the program has
    them."""
    S = MPC_SIZE["n_shards"]
    counts = {"B7": 0, "B8": 0}
    kernel_stages(monkeypatch, counts)
    ref = sbx.sharded_mpc_problem(MPC_SIZE, MPC_STEPS, device="cpu")
    rings, _ = _rings(ref.sb.plan, ref.sb.meta.n_fp, 1, timeout_s=60.0)
    c_half = 0.5 * ref.hidden
    counters = (TB.sw2d_stage_blocked_peer, TB.sw2d_stage_bwd_blocked_peer,
                PR.peer_stage_exchange, PR.peer_stage_exchange_reverse,
                PR.peer_rank_sum)
    n0 = [f.launches for f in counters]

    def rank(r):
        mp = sbx.sharded_mpc_problem(MPC_SIZE, MPC_STEPS, device="cpu",
                                     rank=r, ring=rings[r])
        c = c_half.clone().requires_grad_(True)
        cost = sbx.sharded_mpc_cost(mp, c)
        (grad,) = torch.autograd.grad(cost, c)
        sol = sbx.solve_sharded_mpc(mp, iters=MPC_ITERS)
        return mp.target, cost.detach(), grad, sol

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    got = [f.launches - n for f, n in zip(counters, n0)]
    c = c_half.clone().requires_grad_(True)
    cost = sbx.sharded_mpc_cost(ref, c)
    (grad,) = torch.autograd.grad(cost, c)
    cost = cost.detach()
    sol = sbx.solve_sharded_mpc(ref, iters=MPC_ITERS)
    for r in range(S):
        tgt, cr, gr, sr = out[r]
        assert torch.equal(tgt, ref.target[r:r + 1])
        np.testing.assert_allclose(float(cr), float(cost), rtol=1e-5)
        np.testing.assert_allclose(gr.numpy(), grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(grad.abs().max()))
        for a, b in ((gr, out[0][2]), (cr, out[0][1]),
                     (sr.controls, out[0][3].controls),
                     (sr.cost_history, out[0][3].cost_history),
                     (sr.cost, out[0][3].cost)):
            assert torch.equal(a, b), r
        np.testing.assert_allclose(sr.controls.numpy(), sol.controls.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sr.cost_history.numpy(),
                                   sol.cost_history.numpy(), rtol=1e-5)
    # a rank: rollouts of the target, of each cost evaluation (its
    # gradient's too) and of the final cost, each 2 folded stages a step
    # and one exchange (of the constant start's send buffer, whose
    # cotangent is not needed: no reverse); per evaluation two sums, the
    # final cost one
    evals = 1 + MPC_ITERS
    rollouts = 1 + evals + 1
    assert got == [S * 2 * MPC_STEPS * rollouts, S * 2 * MPC_STEPS * evals,
                   S * rollouts, 0, S * (2 * evals + 1)]
    assert counts["B7"] and counts["B8"]
