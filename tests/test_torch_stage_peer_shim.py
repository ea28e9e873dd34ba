"""The stage ring's exchange and its reverse folded into the sharded
stage's (B7) and its adjoint's (B8) launches, one shard a rank
(``ops/csrc/sw2d_blocked.cu``: ``sw2d_stage_peer_kernel``,
``sw2d_stage_bwd_peer_kernel``), and the guard of ranks that share a
process (ROADMAP C34), on the CPU: the kernels' source and the ring's
(``peer.cu``) compiled with g++ behind the shim of
``test_torch_blocked_kernel_shim.py``, S ranks as host threads over each
other's host memory (``StageRing.over_regions``), their launches at once,
meeting only through their flags.

 - B7's peer mode over several epochs, a rollout's first stage with its
   receive buffer given, then each reading its slots: every rank's state,
   send buffer and receive buffer bit-equal to B7 launched on its shard
   followed by the stacked exchange; then B8's peer mode in reverse, the
   last stage's send-buffer cotangent given, then each reading its reverse
   slots, the first stage keeping its receive buffer's cotangent: every
   cotangent bit-equal to B8 launched on the rank's shard followed by the
   stacked reverse exchange. At S=2 and S=4 on triangles (N=3, four lanes
   an element) and on quadrilaterals at N=4 (``QOrder4Quad``, eight lanes
   an element), and with a rank that sleeps before every second launch;
 - the standalone exchange and its reverse (``peer.cu``) between folded
   launches over one ring, two rounds, every output the same bits;
 - a rank that never launches makes its peer's folded launch trap after
   the ring's bound: an error, not a hang;
 - the rank-local MPC with the folded steps: its target bit-equal to the
   stacked problem's through the same stage kernels, its cost and control
   gradient within 1e-5 of that problem's and of the stacked plain
   versions', one exchange launch a rollout and none in reverse, the ranks
   meeting before each ring launch (``meet=``) and each rank's step paced
   once a rollout;
 - a cost of the state after an early step of a longer rollout, after a
   gradient of the whole rollout (the later stages' backwards do not run,
   so the reverse slots hold the earlier gradient's cotangents): its
   gradient that of the stacked steps; a cost that also takes a send
   buffer that a later stage read raises;
 - C34: a rank whose host is held past the ring's bound before its launch
   traps its peer where the ranks do not meet and gives the stacked
   exchange's bits where they do; a second rank thread that launches over
   the rings of one region set without ``meet=`` is refused, naming it,
   while one thread that launches for every rank is not; a rank whose
   peers never reach the meeting raises after six times the ring's bound
   instead of hanging.
"""
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_blocked_kernel_shim import (F32, F64, FWD_ATOL, Case,
                                            _check_adjoint, _max_abs,
                                            _rank_ops, _same, device,
                                            shim_lib)  # noqa: F401
from test_torch_peer_stage_shim import _on_threads, kernel_stages

from blitzdg_tpu_torch.mpc import sharded_box as sbx
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel import peer as PR
from blitzdg_tpu_torch.parallel.halo import _stacked, _stacked_source

SHIM_THREADS = 32  # the ring kernels' block on the shim (one warp)


@pytest.fixture
def dev(device, monkeypatch):
    monkeypatch.setattr(PR, "THREADS", SHIM_THREADS)
    return device


def _rings(plan, n_fp, batch, timeout_s=30.0, meet=None):
    """The S ranks' stage rings over zeroed host regions of this process
    (made on this thread), each with ``meet``."""
    S = plan.n_shards
    lay = PR.stage_region_layout(batch, PR._n_slots(plan, n_fp),
                                 len(plan.offs), S)
    regions = [torch.zeros(lay["bytes"], dtype=torch.uint8) for _ in range(S)]
    bases = {r: g.data_ptr() for r, g in enumerate(regions)}
    rings = [PR.StageRing.over_regions(plan, n_fp, batch, r, bases, "cpu",
                                       timeout_s, meet) for r in range(S)]
    return rings, regions


# (N, shards, batch, quadrilaterals, cells, shim device (SMs, blocks an
# SM)); small meshes: on the host build every lane is a thread
FOLD_CASES = {
    # one offset, both ways one peer
    "N3_S2_B1": (3, 2, 1, False, (6, 6), (2, 1)),
    "N3_S4_B1": (3, 4, 1, False, (6, 6), (2, 1)),  # three offsets
    "quads_N4_S4_B1": (4, 4, 1, True, (8, 8), (2, 1)),
}
N_STAGES = 4  # two steps' stages


class FoldCase:
    """A case's set and the stages of two steps, each rank's shard alone:
    the unfolded reference (B7, the stacked exchange; B8, the stacked
    reverse) and the ranks' folded launches."""

    def __init__(self, name, seed=11):
        n, S, B, quads, cells, self.dev = FOLD_CASES[name]
        self.c = Case(n, S, B, seed=seed, quads=quads, cells=cells)
        self.S, self.B = S, B
        sb = self.c.sets[F32]
        self.ops = [_rank_ops(sb.ops, r) for r in range(S)]
        c = self.c
        self.stages = [(0.5 * c.dt if k % 2 == 0 else c.dt,
                        c.t + 0.5 * c.dt * k, k % 2 == 1)
                       for k in range(N_STAGES)]
        rng = np.random.default_rng(seed)
        g = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                           dtype=F32)
        m = sb.meta
        self.lam = [[tuple(g(1, B, m.n_v) for _ in range(3))
                     for _ in range(S)] for _ in range(N_STAGES)]
        self.lsb_end = [g(1, B, sb.ops.send.shape[1], 3) for _ in range(S)]
        self.lsb_add = [g(1, B, sb.ops.send.shape[1], 3) for _ in range(S)]

    def reference(self, add_at=None):
        """Per stage: each rank's (h, hu, hv, sb), its receive buffer, and
        in reverse each rank's eight cotangents; with ``add_at``, that
        stage's send-buffer cotangent has ``lsb_add`` added (a cost that
        also takes its send buffer)."""
        c, sb = self.c, self.c.sets[F32]
        m, S = sb.meta, self.S
        row = lambda t, r: t[r:r + 1]
        base = c.state
        cur, rb = c.state, c.rb
        fwd = []
        for c_dt, t, sponge in self.stages:
            outs = [TB._run_stage(self.ops[r], m,
                                  tuple(row(f, r) for f in base),
                                  tuple(row(f, r) for f in cur), row(rb, r),
                                  c_dt, t, c.ctrl, True, sponge)
                    for r in range(S)]
            fwd.append((outs, rb))
            cur = tuple(torch.cat([o[i] for o in outs]) for i in range(3))
            rb = c.ex[F32](torch.cat([o[3] for o in outs]))
        bwd = [None] * N_STAGES
        lsb = torch.cat(self.lsb_end)
        for k in reversed(range(N_STAGES)):
            c_dt, t, sponge = self.stages[k]
            ins = self.c.state if k == 0 else tuple(
                torch.cat([o[i] for o in fwd[k - 1][0]]) for i in range(3))
            rb_k = fwd[k][1]
            if k == add_at:
                lsb = lsb + torch.cat(self.lsb_add)
            g_k = [TB._run_stage_bwd(self.ops[r], m,
                                     tuple(row(f, r) for f in ins),
                                     row(rb_k, r), self.lam[k][r],
                                     row(lsb, r), c_dt, t, c.ctrl, True,
                                     sponge) for r in range(S)]
            bwd[k] = g_k
            lsb = TB._stacked_reverse(torch.cat([g[6] for g in g_k]),
                                      c.ex[F32])
        return fwd, bwd

    def ranks(self, delay=None, missing=(), timeout_s=30.0, join_s=120.0,
              add_at=None):
        """Each rank's folded stages, then its folded adjoints in reverse
        (with ``add_at``, that stage's adjoint also given ``lsb_add``):
        per rank the forward outputs (h, hu, hv, sb, rb) and the
        cotangents by stage; the errors; the rings."""
        c, sb = self.c, self.c.sets[F32]
        m = sb.meta
        # (the regions kept with the case: the rings only point into them)
        rings, self.regions = _rings(
            sb.plan, m.n_fp, self.B, timeout_s,
            None if missing else threading.Barrier(self.S))
        n = [0]

        def hold(r):
            if delay is not None and r == delay[0]:
                n[0] += 1
                if n[0] % 2 == 0:
                    time.sleep(delay[1])

        def rank(r):
            row = lambda t: t[r:r + 1]
            ring, ops = rings[r], self.ops[r]
            base = tuple(row(f) for f in c.state)
            cur, rb = base, row(c.rb)
            fwd = []
            for c_dt, t, sponge in self.stages:
                hold(r)
                out = TB.sw2d_stage_blocked(ops, m, base, cur, rb, c_dt, t,
                                            c.ctrl, True, sponge, ring=ring)
                fwd.append(out)
                cur, rb = tuple(out[:3]), None
            bwd = [None] * N_STAGES
            for k in reversed(range(N_STAGES)):
                c_dt, t, sponge = self.stages[k]
                hold(r)
                ins = base if k == 0 else tuple(fwd[k - 1][:3])
                bwd[k] = TB.sw2d_stage_bwd_blocked_v2(
                    ops, m, ins, fwd[k][4], self.lam[k][r],
                    self.lsb_end[r] if k == N_STAGES - 1 else None, c_dt, t,
                    c.ctrl, True, sponge, ring=ring, send=k > 0,
                    lam_sb_add=self.lsb_add[r] if k == add_at else None)
            return fwd, bwd

        out, errors = _on_threads(self.S, rank, missing=missing,
                                  join_s=join_s)
        return out, errors, rings


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_folded_stages_match_the_stage_and_the_exchange(dev, name):
    """B7's peer mode over four epochs and B8's over three reverse epochs
    (the fourth adjoint keeps its cotangent): each rank's outputs bit-equal
    to B7 and B8 launched on its shard with the stacked exchange and its
    reverse between them; the rings count four forward and three reverse
    epochs."""
    fc = FoldCase(name)
    dev(*fc.dev)
    (want_f, want_b) = fc.reference()
    got, errors, rings = fc.ranks()
    assert errors == [None] * fc.S
    for r in range(fc.S):
        fwd, bwd = got[r]
        for k in range(N_STAGES):
            outs, rb = want_f[k]
            assert _same(fwd[k][:4], outs[r]), (r, k)
            assert torch.equal(fwd[k][4], rb[r:r + 1]), (r, k)
            w = want_b[k][r]
            assert (bwd[k][7] is None) == (w[7] is None)
            assert _same([x for x in bwd[k] if x is not None],
                         [x for x in w if x is not None]), (r, k)
    for ring in rings:
        assert ring.epochs == {"forward": N_STAGES,
                               "reverse": N_STAGES - 1, "sum": 0}
    # the plain versions (the stacked stage and the stacked exchange, in
    # float64 on the same inputs), to the kernels' tolerances: the first
    # stage and what the second read; the last stage's adjoint and the
    # send-buffer cotangent the stage before read
    c = fc.c
    cat = lambda k, i, side=0: torch.cat([got[r][side][k][i]
                                          for r in range(fc.S)])
    c_dt, t, sponge = fc.stages[0]
    want = c.ref(TB.sw2d_stage_blocked_peer_plain, c.state, c.state, c.rb,
                 c.ex[F64], c_dt, t, c.ctrl, True, sponge)
    assert _max_abs([cat(0, i) for i in range(4)] + [cat(1, 4)],
                    want) <= FWD_ATOL
    k = N_STAGES - 1
    c_dt, t, sponge = fc.stages[k]
    ins = tuple(cat(k - 1, i) for i in range(3))
    lam = tuple(torch.cat([fc.lam[k][r][i] for r in range(fc.S)])
                for i in range(3))
    want = c.ref(TB.sw2d_stage_bwd_blocked_peer_plain, ins, cat(k, 4), lam,
                 torch.cat(fc.lsb_end), c.ex[F64], c_dt, t, c.ctrl, True,
                 sponge)
    _check_adjoint([cat(k, i, 1) for i in range(7)]
                   + [torch.cat([got[r][1][k][7] for r in range(fc.S)])
                      .sum(1)], [*want[:7], want[7].sum(1)])
    orb = torch.cat([w[6] for w in want_b[k]])
    _check_adjoint([TB._stacked_reverse(orb, c.ex[F32])], [want[8]])


@pytest.mark.parametrize("name", ["N3_S4_B1", "quads_N4_S4_B1"])
def test_folded_adjoint_adds_a_second_cotangent(dev, name):
    """C36 in the kernel: B8's peer mode at the third stage (its
    send-buffer cotangent read from the reverse slots) also given a second
    part, ``lam_sb_add``: every rank's cotangents bit-equal to B8 launched
    on its shard with the sum of the stacked reverse exchange's and that
    part (the stacked steps' autograd adds the two), the stages before
    too; and the plain version given the same two parts, to the kernels'
    tolerances."""
    fc = FoldCase(name, seed=15)
    dev(*fc.dev)
    k = 2
    want_f, want_b = fc.reference(add_at=k)
    got, errors, rings = fc.ranks(add_at=k)
    assert errors == [None] * fc.S
    for r in range(fc.S):
        for j in range(N_STAGES):
            w = [x for x in want_b[j][r] if x is not None]
            assert _same([x for x in got[r][1][j] if x is not None], w), \
                (r, j)
    c = fc.c
    cat = lambda j, i, side=0: torch.cat([got[r][side][j][i]
                                          for r in range(fc.S)])
    c_dt, t, sponge = fc.stages[k]
    lam = tuple(torch.cat([fc.lam[k][r][i] for r in range(fc.S)])
                for i in range(3))
    lsb = TB._stacked_reverse(torch.cat([w[6] for w in want_b[k + 1]]),
                              c.ex[F32])
    want = c.ref(TB.sw2d_stage_bwd_blocked_peer_plain,
                 tuple(cat(k - 1, i) for i in range(3)), cat(k, 4), lam, lsb,
                 c.ex[F64], c_dt, t, c.ctrl, True, sponge,
                 lam_sb_add=torch.cat(fc.lsb_add).to(F64))
    _check_adjoint([cat(k, i, 1) for i in range(7)]
                   + [torch.cat([got[r][1][k][7] for r in range(fc.S)])
                      .sum(1)], [*want[:7], want[7].sum(1)])


def test_standalone_exchanges_between_folded_launches(dev):
    """Over one ring, two rounds of: the standalone exchange of the initial
    send buffer (``peer_stage_exchange``, ``peer.cu``'s kernel: a send
    block and a receive block a ring offset), B7's peer mode over four
    epochs from that receive buffer, B8's over three reverse epochs, then
    the standalone reverse of the first stage's receive-buffer cotangent
    (``peer_stage_exchange_reverse``). The standalone kernel and the
    folded launches share each use's epochs and slot sets (the second
    round's standalone exchange sends into the set of an epoch no launch
    read), and every output of both rounds keeps the bits of B7 and B8
    with the stacked exchange and its reverse between them."""
    fc = FoldCase("N3_S4_B1", seed=13)
    dev(*fc.dev)
    want_f, want_b = fc.reference()
    c, sb = fc.c, fc.c.sets[F32]
    m = sb.meta
    sbuf0 = BS.initial_send_buffer(sb, c.state)
    rings, fc.regions = _rings(sb.plan, m.n_fp, fc.B,
                               meet=threading.Barrier(fc.S))

    def rank(r):
        row = lambda t: t[r:r + 1]
        ring, ops = rings[r], fc.ops[r]
        base = tuple(row(f) for f in c.state)
        rounds = []
        for _ in range(2):
            rb = first = PR.peer_stage_exchange(ring, row(sbuf0).contiguous())
            cur, fwd = base, []
            for c_dt, t, sponge in fc.stages:
                out = TB.sw2d_stage_blocked(ops, m, base, cur, rb, c_dt, t,
                                            c.ctrl, True, sponge, ring=ring)
                fwd.append(out)
                cur, rb = tuple(out[:3]), None
            bwd = [None] * N_STAGES
            for k in reversed(range(N_STAGES)):
                c_dt, t, sponge = fc.stages[k]
                ins = base if k == 0 else tuple(fwd[k - 1][:3])
                bwd[k] = TB.sw2d_stage_bwd_blocked_v2(
                    ops, m, ins, fwd[k][4], fc.lam[k][r],
                    fc.lsb_end[r] if k == N_STAGES - 1 else None, c_dt, t,
                    c.ctrl, True, sponge, ring=ring, send=k > 0)
            back = PR.peer_stage_exchange_reverse(ring,
                                                  bwd[0][6].contiguous())
            rounds.append((first, fwd, bwd, back))
        return rounds

    out, errors = _on_threads(fc.S, rank)
    assert errors == [None] * fc.S
    back_want = TB._stacked_reverse(torch.cat([w[6] for w in want_b[0]]),
                                    c.ex[F32])
    for r in range(fc.S):
        for first, fwd, bwd, back in out[r]:
            assert torch.equal(first, c.rb[r:r + 1]), r
            for k in range(N_STAGES):
                outs, rb = want_f[k]
                assert _same(fwd[k][:4], outs[r]), (r, k)
                assert torch.equal(fwd[k][4], rb[r:r + 1]), (r, k)
                assert _same([x for x in bwd[k] if x is not None],
                             [x for x in want_b[k][r] if x is not None]), \
                    (r, k)
            assert torch.equal(back, back_want[r:r + 1]), r
    for ring in rings:
        assert ring.epochs == {"forward": 2 * (1 + N_STAGES),
                               "reverse": 2 * N_STAGES, "sum": 0}


def test_folded_stages_hold_with_a_delayed_rank(dev):
    """S=4, rank 3 sleeping before every second launch: the others wait at
    its flags (a launch waits only for the round before, so a rank may run
    one launch ahead) and every rank's outputs keep the bits of the run
    without delay."""
    fc = FoldCase("N3_S4_B1", seed=12)
    dev(*fc.dev)
    plain, errors, _ = fc.ranks()
    assert errors == [None] * fc.S
    held, errors, _ = fc.ranks(delay=(3, 0.2))
    assert errors == [None] * fc.S
    for r in range(fc.S):
        for k in range(N_STAGES):
            assert _same(held[r][0][k], plain[r][0][k]), (r, k)
            assert _same([x for x in held[r][1][k] if x is not None],
                         [x for x in plain[r][1][k] if x is not None])


def test_folded_stage_traps_when_a_rank_never_launches(dev):
    """S=2 with rank 1 absent: rank 0's first stage (its receive buffer
    given) stores its send buffer and ends; its second waits for rank 1's
    chunk and traps after the ring's bound (0.3 s), which fails the launch:
    an error, not a hang (the test's own bound: 60 s)."""
    fc = FoldCase("N3_S2_B1")
    dev(*fc.dev)
    t0 = time.monotonic()
    got, errors, rings = fc.ranks(missing=(1,), timeout_s=0.3, join_s=60.0)
    assert got == [None, None] and errors[1] is None
    assert isinstance(errors[0], RuntimeError)
    assert "sw2d_stage_blocked_peer" in str(errors[0])
    assert time.monotonic() - t0 < 60.0
    # rank 0's first stage released FIN = 1 at rank 1
    assert int(rings[1].flags[1]) == 1


# the rank-local MPC: the example's mesh in 4 shards, 2 steps
MPC_SIZE = dict(sbx.EXAMPLE, n_shards=4)
MPC_STEPS = 2


def test_folded_mpc_matches_the_stacked(dev, monkeypatch):
    """Four ranks as threads over rings with ``meet=``, each with its
    rank-local MPC problem: the folded fused step's target bit-equal to
    the stacked problem's through the same stage kernels (B7 on the
    stacked set, the stacked exchange), the folded differentiable step's
    cost and control gradient within 1e-5 of that problem's and of the
    stacked plain versions', the same bits on every rank; a folded rollout
    launches the ring's exchange once and B7's peer mode twice a step, its
    gradient B8's peer mode twice a step and no reverse exchange; each
    rank's step paced once a differentiable rollout."""
    dev(2, 1)
    S = MPC_SIZE["n_shards"]
    plain = sbx.sharded_mpc_problem(MPC_SIZE, MPC_STEPS, device="cpu")
    counts = {"B7": 0, "B8": 0}
    kernel_stages(monkeypatch, counts)
    ref = sbx.sharded_mpc_problem(MPC_SIZE, MPC_STEPS, device="cpu")
    rings, regions = _rings(ref.sb.plan, ref.sb.meta.n_fp, 1,
                            timeout_s=60.0, meet=threading.Barrier(S))
    c_half = 0.5 * ref.hidden
    counters = (TB.sw2d_stage_blocked_peer, TB.sw2d_stage_bwd_blocked_peer,
                PR.peer_stage_exchange, PR.peer_stage_exchange_reverse)
    meet = threading.Barrier(S, timeout=120.0)

    def rank(r):
        ring = rings[r]
        mp = sbx.sharded_mpc_problem(MPC_SIZE, MPC_STEPS, device="cpu",
                                     rank=r, ring=ring)
        meet.wait()  # (every rank's target rollout has ended)
        n0 = [f.launches for f in counters]
        paces = ring.paces
        meet.wait()
        c = c_half.clone().requires_grad_(True)
        cost = sbx.sharded_mpc_cost(mp, c)
        (grad,) = torch.autograd.grad(cost, c)
        meet.wait()
        return (mp.target, cost.detach(), grad,
                [f.launches - n for f, n in zip(counters, n0)],
                ring.paces - paces)

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    for p in (ref, plain):
        c = c_half.clone().requires_grad_(True)
        cost = sbx.sharded_mpc_cost(p, c)
        (grad,) = torch.autograd.grad(cost, c)
        for r in range(S):
            tgt, cr, gr, _, paces = out[r]
            if p is ref:
                assert torch.equal(tgt, ref.target[r:r + 1]), r
            else:
                np.testing.assert_allclose(tgt.numpy(),
                                           p.target[r:r + 1].numpy(),
                                           rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(cr), float(cost.detach()),
                                       rtol=1e-5)
            np.testing.assert_allclose(gr.numpy(), grad.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(grad.abs().max()))
            assert torch.equal(gr, out[0][2]) and torch.equal(cr, out[0][1])
            assert paces == 1
    # (the counters are shared by the threads: every rank's launches of
    # one cost and gradient, read between meetings of all ranks)
    assert out[0][3] == [S * 2 * MPC_STEPS, S * 2 * MPC_STEPS, S, 0]
    assert counts["B7"] and counts["B8"]


def _states(step, sb, state0, cs, dt):
    """A rollout of ``step`` from ``state0`` under the controls ``cs``:
    every step's carry."""
    carry = (state0, BS.initial_send_buffer(sb, state0))
    out = []
    for i in range(cs.shape[0]):
        carry = step(carry, i * dt, cs[i])
        out.append(carry)
    return out


def _cost_grads(problem, step, sb, ex, stop, sbuf_of=None):
    """The gradient in (h0, controls) of a cost of the state after step
    ``stop`` (and of the send buffer after step ``sbuf_of``) of a rollout
    of ``step`` from ``problem``'s initial state under half its hidden
    controls; one shard a rank with ``ex`` (the rank's rows of
    ``problem``'s state; the controls' cotangent and the cost summed over
    the ranks), stacked with ``ex`` None."""
    h0 = problem.state0[0].clone().requires_grad_(True)
    c = (0.5 * problem.hidden).requires_grad_(True)
    cc = c if ex is None else BS.sum_over_ranks_grad(c, ex)
    out = _states(step, sb, (h0, *problem.state0[1:]), cc, problem.dt)
    return torch.autograd.grad(_cost(out, ex, stop, sbuf_of), (h0, c))


def _cost(out, ex, stop, sbuf_of=None):
    """A cost of the state after step ``stop`` of a rollout's carries
    ``out`` (and of the send buffer after step ``sbuf_of``), summed over
    ``ex``'s ranks."""
    h, hu, hv = out[stop - 1][0]
    w = torch.linspace(0.5, 1.5, h.shape[-1])
    loc = (w * hu ** 2).sum() + (h * hv).sum()
    if sbuf_of is not None:
        loc = loc + (out[sbuf_of - 1][1] ** 2).sum()
    return loc if ex is None else BS.total_over_ranks(loc, ex)


def _close(got, want, what):
    """``got`` within 1e-5 of ``want`` (relative, and of its largest
    entry)."""
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()),
                               err_msg=what)


def _check_rank_grads(out, want, S):
    """Each rank's (h0 rows, controls) gradients ``out[r]`` against the
    stacked ``want``: the rows joined, the controls' on every rank, the
    same bits on every rank."""
    _close(torch.cat([out[r][0] for r in range(S)]), want[0], "h0")
    for r in range(S):
        _close(out[r][1], want[1], f"controls, rank {r}")
        assert torch.equal(out[r][1], out[0][1])


def _rank_problem(r, ring, n):
    """Rank r's problem of ``n`` steps over ``ring``."""
    return sbx.sharded_mpc_problem(MPC_SIZE, n, device="cpu", rank=r,
                                   ring=ring)


def test_cost_of_an_early_state_after_a_whole_gradient(dev, monkeypatch):
    """Four ranks over rings with ``meet=``, three steps of the folded
    differentiable step: first the gradient of a cost of the last state
    (every stage's backward runs, the reverse slots hold its cotangents),
    then, on a new rollout, the gradient of a cost of the state after the
    first step alone (the later stages' backwards do not run: the first
    step's send-buffer cotangent is autograd's zeros, not the reverse
    slots' earlier values). Then a cost of the last state that also takes
    the first step's send buffer, which the second step read from the
    ring's slots (C36): that buffer's cotangent is the sum of the ring's
    part and autograd's, added in B8's peer mode. Every gradient, in the
    controls and in the initial depth, within 1e-5 of the stacked steps'
    through the same stage kernels."""
    dev(2, 1)
    S, n = MPC_SIZE["n_shards"], 3
    counts = {"B7": 0, "B8": 0}
    kernel_stages(monkeypatch, counts)
    ref = sbx.sharded_mpc_problem(MPC_SIZE, n, device="cpu")
    rings, regions = _rings(ref.sb.plan, ref.sb.meta.n_fp, 1,
                            timeout_s=60.0, meet=threading.Barrier(S))
    cases = ((n, None), (1, None), (n, 1))
    want = [_cost_grads(ref, ref.step, ref.sb, None, *c) for c in cases]

    def rank(r):
        mp = _rank_problem(r, rings[r], n)
        return [_cost_grads(mp, mp.step, mp.sb, mp.step.exchange, *c)
                for c in cases]

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    for k in range(len(cases)):
        _check_rank_grads([o[k] for o in out], want[k], S)
    # (the ring's part of the first step's send buffer: a cost of the
    # last state alone gives that buffer another cotangent)
    assert not torch.allclose(want[2][1], want[0][1])


def test_restricted_backwards_then_a_whole_gradient(dev, monkeypatch):
    """C35: four ranks, the ring's bound 2 s, three steps. On one rollout
    two backwards that autograd restricts to the state after the first
    step (``inputs=``: the first step's stages do not run, so the reverse
    epoch that the second step's first stage sent is never read), then on
    the same graph the gradient of a cost of the state after the first
    step (its stages' backwards alone: the mark of the send buffer that
    the restricted backwards left is not read), then on a new rollout the
    whole gradient. No launch traps (the unread epochs are skipped, the
    senders' GO flags released past them), and every gradient is within
    1e-5 of the stacked steps' through the same stage kernels."""
    dev(2, 1)
    S, n = MPC_SIZE["n_shards"], 3
    counts = {"B7": 0, "B8": 0}
    kernel_stages(monkeypatch, counts)
    ref = sbx.sharded_mpc_problem(MPC_SIZE, n, device="cpu")
    rings, regions = _rings(ref.sb.plan, ref.sb.meta.n_fp, 1,
                            timeout_s=2.0, meet=threading.Barrier(S))

    def run(p, step, sb, ex):
        h0 = p.state0[0].clone().requires_grad_(True)
        c = (0.5 * p.hidden).requires_grad_(True)
        cc = c if ex is None else BS.sum_over_ranks_grad(c, ex)
        out = _states(step, sb, (h0, *p.state0[1:]), cc, p.dt)
        last, mid = _cost(out, ex, n), out[0][0][0]
        g = [torch.autograd.grad(last, (mid,), retain_graph=True)[0]
             for _ in range(2)]
        g.append(torch.autograd.grad(_cost(out, ex, 1), (h0, c)))
        g.append(_cost_grads(p, step, sb, ex, n))
        return g

    want = run(ref, ref.step, ref.sb, None)

    def rank(r):
        mp = _rank_problem(r, rings[r], n)
        return run(mp, mp.step, mp.sb, mp.step.exchange)

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    for k in range(2):
        _close(torch.cat([o[k] for o in out]), want[k], f"restricted {k}")
    for k in (2, 3):
        _check_rank_grads([o[k] for o in out], want[k], S)
    # every reverse epoch read or released (the restricted backwards' last
    # ones skipped by the chains after them)
    for ring in rings:
        assert ring._freed["reverse"] == ring.epochs["reverse"]


def test_fold_releases_only_the_epochs_that_no_launch_reads(dev):
    """The epochs of the folded adjoint launches (read, sent, released
    first) over one ring: a whole chain (a start given its cotangent, a
    launch that reads and sends, the first stage that only reads) skips
    nothing; a chain that a restricted backward ends after a send leaves
    its last epoch unread, which the next chain's start releases before
    it sends; a launch that neither reads nor sends releases nothing
    that a later launch might still read."""
    fc = FoldCase("N3_S2_B1")
    sb = fc.c.sets[F32]
    rings, regions = _rings(sb.plan, sb.meta.n_fp, fc.B)
    ring = rings[0]
    calls = [(False, True), (True, True), (True, False),  # whole
             (False, True), (True, True),  # restricted: epoch 4 unread
             (False, True), (True, False),  # whole: 4 released first
             (False, False), (True, True)]
    got = [ring._fold("reverse", *c) for c in calls]
    assert got == [(0, 1, 0), (1, 2, 0), (2, 0, 0), (0, 3, 0), (3, 4, 0),
                   (0, 5, 4), (5, 0, 0), (0, 0, 0), (5, 6, 0)]
    assert ring.epochs["reverse"] == 6 and ring._freed["reverse"] == 5


def test_two_rollouts_in_one_cost(dev, monkeypatch):
    """C35's first limit: one cost of two rollouts over one ring (the sum
    of a cost of each one's last state; the second under other controls),
    one backward. Autograd's order by sequence number runs the second
    rollout's stages' backwards, then the first's, so no launch over the
    ring comes between a stage's send of a cotangent and its read: the
    gradient, within 1e-5 of the stacked steps', and no refusal."""
    dev(2, 1)
    S, n = MPC_SIZE["n_shards"], 2
    counts = {"B7": 0, "B8": 0}
    kernel_stages(monkeypatch, counts)
    ref = sbx.sharded_mpc_problem(MPC_SIZE, n, device="cpu")
    rings, regions = _rings(ref.sb.plan, ref.sb.meta.n_fp, 1,
                            timeout_s=60.0, meet=threading.Barrier(S))

    def run(p, step, sb, ex):
        h0 = p.state0[0].clone().requires_grad_(True)
        c = (0.5 * p.hidden).requires_grad_(True)
        cc = c if ex is None else BS.sum_over_ranks_grad(c, ex)
        loss = sum(_cost(_states(step, sb, (h0, *p.state0[1:]), a * cc,
                                 p.dt), ex, n) for a in (1.0, 0.5))
        return torch.autograd.grad(loss, (h0, c))

    want = run(ref, ref.step, ref.sb, None)

    def rank(r):
        mp = _rank_problem(r, rings[r], n)
        return run(mp, mp.step, mp.sb, mp.step.exchange)

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    _check_rank_grads(out, want, S)


class _NoMeeting:
    """A ``meet`` whose wait returns at once: ranks that do not meet."""

    def wait(self, timeout=None):
        return 0


def test_held_host_traps_without_meet_and_not_with_it(dev):
    """S=2, rank 1's host held 0.6 s before its second exchange, the ring's
    bound 0.3 s. Where the ranks' threads do not meet (a ``meet`` that
    returns at once) rank 0's second exchange is on the device first and
    waits for rank 1's chunk past the bound: it traps. With a meeting of
    both threads rank 0 waits there instead, and every exchange gives the
    stacked gather's bits."""
    S, B, n_fp = 2, 1, 2
    from test_torch_peer_stage_shim import _plan

    plan = _plan(S, (1,))
    L = PR._n_slots(plan, n_fp)
    g = torch.Generator().manual_seed(3)
    bufs = [torch.randn((S, B, L, 3), generator=g) for _ in range(3)]

    def run(meet):
        rings, _ = _rings(plan, n_fp, B, timeout_s=0.3, meet=meet)

        def rank(r):
            got = []
            for k, buf in enumerate(bufs):
                if r == 1 and k == 1:
                    time.sleep(0.6)
                got.append(PR.peer_stage_exchange(rings[r],
                                                  buf[r:r + 1].contiguous()))
            return got

        return _on_threads(S, rank, join_s=60.0)

    out, errors = run(_NoMeeting())
    assert isinstance(errors[0], RuntimeError)
    assert "peer_stage_exchange" in str(errors[0])
    out, errors = run(threading.Barrier(S))
    assert errors == [None] * S
    src = torch.as_tensor(_stacked_source(plan, plan.max_send * n_fp, 1))
    for r in range(S):
        for k, buf in enumerate(bufs):
            assert torch.equal(out[r][k], _stacked(buf, src)[r:r + 1])


def _first_stage(fc, rings, r):
    """Rank r's first folded stage (its receive buffer given: its waits
    pass at once)."""
    c, m = fc.c, fc.c.sets[F32].meta
    row = lambda t: t[r:r + 1]
    base = tuple(row(f) for f in c.state)
    return TB.sw2d_stage_blocked(fc.ops[r], m, base, base, row(c.rb),
                                 0.5 * c.dt, c.t, c.ctrl, True, False,
                                 ring=rings[r])


def test_rank_threads_without_meet_are_refused(dev):
    """Rings of one region set without ``meet=``: rank 0's thread launches
    and stays, then another thread's launch for rank 1 raises before it
    launches, naming ``meet=``. One thread that launches for every rank over a region
    set of its own is not refused, and each receiver's slots hold the
    stacked exchange of the send buffers."""
    fc = FoldCase("N3_S2_B1", seed=13)
    dev(*fc.dev)
    sb = fc.c.sets[F32]
    rings, regions = _rings(sb.plan, sb.meta.n_fp, fc.B)
    out, errors = [], []
    launched, done = threading.Event(), threading.Event()

    def launch(r):
        try:
            out.append(_first_stage(fc, rings, r))
        except ValueError as e:
            errors.append(e)
        if r == 0:  # (alive while rank 1's thread launches)
            launched.set()
            done.wait(60.0)

    threads = [threading.Thread(target=launch, args=(r,))
               for r in range(fc.S)]
    threads[0].start()
    assert launched.wait(60.0)
    threads[1].start()
    threads[1].join()
    done.set()
    threads[0].join()
    assert len(out) == 1 and len(errors) == 1
    assert "meet=" in str(errors[0])
    assert rings[1].epochs["forward"] == 0
    # one thread for every rank
    rings, regions = _rings(sb.plan, sb.meta.n_fp, fc.B)
    outs = [_first_stage(fc, rings, r) for r in range(fc.S)]
    want = fc.c.ex[F32](torch.cat([o[3] for o in outs]))
    for r, ring in enumerate(rings):
        lay = PR.stage_region_layout(fc.B, ring.n_slots, len(sb.plan.offs),
                                     fc.S)
        slots = PR._view(ring.table[0].item() + lay["cap"],
                         (1, fc.B, ring.n_slots, 3), F32, ring.device)
        assert torch.equal(slots, want[r:r + 1])


def test_a_meeting_that_its_peers_never_reach_raises(dev):
    """A ring with ``meet=`` (a barrier of two threads) launched from one
    thread for both ranks: the first launch waits at the meeting alone and
    raises after six times the ring's bound (0.2 s), naming ``meet=``,
    instead of hanging; nothing was launched."""
    fc = FoldCase("N3_S2_B1", seed=14)
    dev(*fc.dev)
    sb = fc.c.sets[F32]
    rings, regions = _rings(sb.plan, sb.meta.n_fp, fc.B, timeout_s=0.2,
                            meet=threading.Barrier(fc.S))
    n0 = TB.sw2d_stage_blocked_peer.launches
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="meet="):
        _first_stage(fc, rings, 0)
    assert 1.2 <= time.monotonic() - t0 < 30.0
    assert TB.sw2d_stage_blocked_peer.launches == n0
