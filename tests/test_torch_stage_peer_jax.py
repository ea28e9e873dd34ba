"""The folded differentiable sharded step one shard a rank (the stage
ring's exchange and its reverse inside the launches of B7's and B8's peer
modes) against the JAX package's ``make_sharded_blocked_step_diff`` under
``shard_map`` (interpret mode, float64, 4 virtual devices) on the same
seeded numpy inputs: the cost of ``tests/test_torch_sharded_diff.py``
after one step on its coastal set (N=1, bathymetry, drag, Coriolis,
sponge, tidal depth, two controls), its gradient in the initial depth
(whose send buffer needs its cotangent: the standalone exchange's
reverse after the first stage's adjoint) and in the controls. The four
ranks run as host threads over each other's host memory, meeting before
each ring launch (``meet=``), the kernels
(``sw2d_blocked.cu`` with ``peer.cu``) compiled with g++ behind the shim of
``test_torch_blocked_kernel_shim.py``, in float32: the cost within 1e-5
relative, the gradients within 1e-4 of their largest entry (the sharded
MPC's gradient gate across ranks in ``chip_smoke.py``).

The JAX gradient (about 40 s of interpret-mode compilation) is the cost of
this file."""
import threading

import numpy as np
import pytest
import torch

from test_torch_blocked_kernel_shim import (_rank_ops, device,  # noqa: F401
                                            shim_lib)
from test_torch_peer_stage_shim import _on_threads
from test_torch_sharded_diff import DT, S, _jax_grads, _problem
from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel import peer as PR

F32 = torch.float32
N_STEPS = 1


@pytest.fixture(scope="module")
def coastal():
    jc, phys_np, kw, _, t0, state, cs, tgt = _problem("coastal")
    cs = cs[:N_STEPS]
    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(arrays, static, phys_np, S,
                                            device="cpu", dtype=F32, **kw)
    return sb, t0, state, cs, tgt, _jax_grads(jc, phys_np, kw, t0, state,
                                               cs, tgt)


def test_folded_step_gradients_match_jax(device, monkeypatch, coastal):
    sb, t0, state, cs, tgt, (v_ref, gh_ref, gc_ref) = coastal
    device(2, 1)
    monkeypatch.setattr(PR, "THREADS", 32)
    lay = PR.stage_region_layout(1, sb.ops.send.shape[1], len(sb.plan.offs),
                                 S)
    regions = [torch.zeros(lay["bytes"], dtype=torch.uint8) for _ in range(S)]
    bases = {r: g.data_ptr() for r, g in enumerate(regions)}
    meet = threading.Barrier(S)  # (the ranks' threads, before each launch)
    rings = [PR.StageRing.over_regions(sb.plan, sb.meta.n_fp, 1, r, bases,
                                       "cpu", 60.0, meet) for r in range(S)]
    split = lambda f: BS.split_shards(
        torch.as_tensor(f, dtype=F32).reshape(1, -1), S)
    h0_all, rest, tgt_all = split(state[0]), [split(f) for f in state[1:]], \
        split(tgt)
    n0 = (TB.sw2d_stage_blocked_peer.launches,
          TB.sw2d_stage_bwd_blocked_peer.launches,
          PR.peer_stage_exchange_reverse.launches)

    def rank(r):
        ring = rings[r]
        mine = sb._replace(ops=_rank_ops(sb.ops, r), shards=(r,))
        step = BS.make_sharded_blocked_step_diff(mine, DT, ring=ring)
        row = lambda f: f[r:r + 1].clone()
        h0 = row(h0_all).requires_grad_(True)
        c = torch.as_tensor(cs, dtype=F32).requires_grad_(True)
        st = (h0, row(rest[0]), row(rest[1]))
        cc = BS.sum_over_ranks_grad(c, step.exchange)
        carry, t = (st, BS.initial_send_buffer(mine, st)), t0
        for i in range(N_STEPS):
            carry = step(carry, t, cc[i])
            t += DT
        h, hu, hv = carry[0]
        loc = (((h - row(tgt_all)) ** 2).sum() + 0.1 * (hu ** 2).sum()
               + hv.sum())
        loss = BS.total_over_ranks(loc, step.exchange)
        gh, gc = torch.autograd.grad(loss, (h0, c))
        return loss.detach(), gh, gc

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    gh = torch.cat([o[1] for o in out]).numpy()
    for loss, _, gc in out:
        np.testing.assert_allclose(float(loss), v_ref, rtol=1e-5)
        np.testing.assert_allclose(gc.numpy(), gc_ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(gc_ref).max())
        assert torch.equal(gc, out[0][2])
    np.testing.assert_allclose(gh, gh_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(gh_ref).max())
    # two folded stages a step on each rank, forward and backward; the
    # initial send buffer's cotangent through the standalone reverse
    assert (TB.sw2d_stage_blocked_peer.launches - n0[0],
            TB.sw2d_stage_bwd_blocked_peer.launches - n0[1],
            PR.peer_stage_exchange_reverse.launches - n0[2]) == (
        2 * N_STEPS * S, 2 * N_STEPS * S, S)
