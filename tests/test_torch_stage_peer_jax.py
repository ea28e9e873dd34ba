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

Then two steps whose cost also takes the send buffer after the first step
(exposed by the JAX step's carry), which the second step's first stage
reads from the ring's slots: that buffer's cotangent is the ring's part
plus autograd's, added in B8's peer mode (ROADMAP C36), held against
``jax.grad`` likewise.

The JAX gradients (about 40 s of interpret-mode compilation each) are the
cost of this file."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from blitzdg_tpu.ops.sw2d import SWPhysics as JPhys
from blitzdg_tpu.parallel.blocked_shard import (
    build_sharded_blocked as j_build_sharded, initial_send_buffer as j_isb,
    make_sharded_blocked_step_diff as j_diff, pack_local, unpack_local)

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
# the cost's weight of the send buffer after the first of two steps
W_SBUF = 0.5


@pytest.fixture(scope="module")
def coastal():
    jc, phys_np, kw, _, t0, state, cs, tgt = _problem("coastal")
    cs = cs[:N_STEPS]
    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(arrays, static, phys_np, S,
                                            device="cpu", dtype=F32, **kw)
    return sb, t0, state, cs, tgt, _jax_grads(jc, phys_np, kw, t0, state,
                                               cs, tgt)


def _jax_sbuf_grads(jc, phys_np, kw, t0, state, cs, tgt):
    """``jax.grad`` of the cost of ``test_torch_sharded_diff._jax_grads``
    after ``len(cs)`` steps plus W_SBUF times the sum of squares of the
    send buffer after the first step (the scan's carry, collected), in
    the initial depth and the controls."""
    jphys = JPhys(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in phys_np.items()})
    sb = j_build_sharded(jc, jphys, S, dtype=jnp.float64, **kw)
    meta, k_loc = sb.meta, sb.k_loc
    step = j_diff(sb, DT, interpret=True)
    el_mesh = Mesh(np.array(jax.devices()[:S]), ("element",))
    pk = lambda f: jnp.concatenate([pack_local(meta, f[s * k_loc:(s + 1)
                                                       * k_loc])
                                    for s in range(S)], axis=0)
    vm = sb.ops.vmask[0][None]
    op_specs = jax.tree.map(lambda a: P("element", *([None] * (a.ndim - 1))),
                            sb.ops)
    st = P("element", None, None, None)

    def loss_local(ops_l, c_all, h_l, hu_l, hv_l, tgt_l):
        p3 = (h_l, hu_l, hv_l)

        def body(carry, c):
            st_, tt = carry
            nxt = step(ops_l, st_, tt, ctrl=c)
            return (nxt, tt + DT), nxt[1]

        (((out, _), _), sbufs) = jax.lax.scan(
            body, ((p3, j_isb(sb, ops_l, p3)), t0), c_all)
        loc = (jnp.sum(vm * (out[0] - tgt_l) ** 2)
               + 0.1 * jnp.sum(vm * out[1] ** 2) + jnp.sum(vm * out[2])
               + W_SBUF * jnp.sum(sbufs[0] ** 2))
        return jax.lax.psum(loc, "element")

    def total(h_pk, c_all, hu_pk, hv_pk, tgt_pk):
        fn = jax.shard_map(loss_local, mesh=el_mesh,
                           in_specs=(op_specs, P()) + (st,) * 4,
                           out_specs=P(), check_vma=False)
        return fn(sb.ops, c_all, h_pk, hu_pk, hv_pk, tgt_pk)

    args = (pk(state[0]), jnp.asarray(cs), pk(state[1]), pk(state[2]),
            pk(tgt))
    v, (gh, gc) = jax.value_and_grad(total, argnums=(0, 1))(*args)
    gh = np.concatenate([np.asarray(unpack_local(meta, gh[s:s + 1]))
                         for s in range(S)], axis=0)
    return float(v), gh.reshape(S, 1, -1), np.asarray(gc)


def _folded_ranks(sb, t0, state, cs, tgt, w_sbuf):
    """The cost after ``len(cs)`` folded steps on each of S ranks as host
    threads (plus ``w_sbuf`` times the sum of squares of the send buffer
    after the first step), its value and gradients in the rank's initial
    depth rows and the controls; the launches of B7's and B8's peer modes
    and of the standalone reverse exchange."""
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
    counters = (TB.sw2d_stage_blocked_peer, TB.sw2d_stage_bwd_blocked_peer,
                PR.peer_stage_exchange_reverse)
    n0 = [f.launches for f in counters]

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
        sbufs = []
        for i in range(len(cs)):
            carry = step(carry, t, cc[i])
            sbufs.append(carry[1])
            t += DT
        h, hu, hv = carry[0]
        loc = (((h - row(tgt_all)) ** 2).sum() + 0.1 * (hu ** 2).sum()
               + hv.sum())
        if w_sbuf:
            loc = loc + w_sbuf * (sbufs[0] ** 2).sum()
        loss = BS.total_over_ranks(loc, step.exchange)
        gh, gc = torch.autograd.grad(loss, (h0, c))
        return loss.detach(), gh, gc

    out, errors = _on_threads(S, rank, join_s=300.0)
    assert errors == [None] * S
    return out, [f.launches - n for f, n in zip(counters, n0)]


def _check(out, v_ref, gh_ref, gc_ref):
    gh = torch.cat([o[1] for o in out]).numpy()
    for loss, _, gc in out:
        np.testing.assert_allclose(float(loss), v_ref, rtol=1e-5)
        np.testing.assert_allclose(gc.numpy(), gc_ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(gc_ref).max())
        assert torch.equal(gc, out[0][2])
    np.testing.assert_allclose(gh, gh_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(gh_ref).max())


def test_folded_step_gradients_match_jax(device, monkeypatch, coastal):
    sb, t0, state, cs, tgt, (v_ref, gh_ref, gc_ref) = coastal
    device(2, 1)
    monkeypatch.setattr(PR, "THREADS", 32)
    out, launches = _folded_ranks(sb, t0, state, cs, tgt, 0.0)
    _check(out, v_ref, gh_ref, gc_ref)
    # two folded stages a step on each rank, forward and backward; the
    # initial send buffer's cotangent through the standalone reverse
    assert launches == [2 * N_STEPS * S, 2 * N_STEPS * S, S]


def test_folded_gradient_of_a_read_send_buffer_matches_jax(device,
                                                           monkeypatch):
    """C36: two steps, the cost also of the send buffer after the first
    step, which the second step's first stage read from the ring's slots:
    the value and the gradients against ``jax.grad`` of the same cost
    through the JAX step (its carry's send buffer)."""
    jc, phys_np, kw, _, t0, state, cs, tgt = _problem("coastal")
    cs = cs[:2]
    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(arrays, static, phys_np, S,
                                            device="cpu", dtype=F32, **kw)
    device(2, 1)
    monkeypatch.setattr(PR, "THREADS", 32)
    out, launches = _folded_ranks(sb, t0, state, cs, tgt, W_SBUF)
    _check(out, *_jax_sbuf_grads(jc, phys_np, kw, t0, state, cs, tgt))
    assert launches == [4 * S, 4 * S, S]
