"""The sharded MPC one shard a rank on the CPU: S gloo processes each build
their own shard of the JAX example's problem (``examples/mpc_sharded.py``:
``box_triangles(8, 8)``, N=1, two injectors, 8 control steps, dt 1e-3; here
partitioned into S shards) with ``sharded_mpc_problem(rank=r, group=g)``
and run ``solve_sharded_mpc`` over their part of the cost, in float64. The
ranks exchange through the process group's point-to-point transport
(``batch_isend_irecv``, both directions) and sum the cost and the
controls' cotangent over the group in rank order (an ``all_gather`` and the
sum: the plain version of the stage ring's sum kernel).

 - every rank's controls at every cost evaluation of 3 Adam iterations, its
   cost history, its final cost and its gradient at a set of controls have
   the same bits as every other rank's;
 - they equal the stacked ``solve_sharded_mpc`` (every shard in one
   process) to 1e-12, at S=2 (one ring offset) and S=4 (offsets 1, 2, 3),
   and at S=4 with the control weight ``R_CONTROL`` 1e-3 (10^4 times the
   example's), where the control term sets most of the gradient: a term
   counted once a rank would be S times too large there;
 - at S=4, the cost and control gradient at one set of controls equal
   ``jax.value_and_grad`` of the JAX example's ``total`` (the JAX
   package's differentiable sharded step under ``shard_map`` over 4 of
   conftest's 8 host devices, the stage kernels in interpret mode, the
   cost ``psum``-reduced), built in float64: 1e-9 relative.

The processes are started as ``tests/test_torch_sharded_dist.py`` starts
them, each with a timeout of its own, and always ended.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from blitzdg_tpu_torch.mpc import sharded_box as sbx

ITERS = 3
PROCESS_TIMEOUT = 120  # seconds, each worker
LARGE_R = 1e-3
F64 = torch.float64


def _test_controls() -> torch.Tensor:
    """The controls at which the gradients are compared."""
    rng = np.random.default_rng(0)
    hidden = np.array([sbx.HIDDEN_CONTROL] * sbx.MPC_STEPS)
    return torch.as_tensor(0.5 * hidden + 0.1 * rng.standard_normal(
        hidden.shape))


def _solve(mp):
    """The cost and gradient at the test controls, then ``ITERS`` Adam
    iterations of ``solve_sharded_mpc``, with the controls of every cost
    evaluation recorded."""
    c = _test_controls().requires_grad_(True)
    cost = sbx.sharded_mpc_cost(mp, c)
    (grad,) = torch.autograd.grad(cost, c)
    seen = []
    cost_fn = sbx.sharded_mpc_cost

    def recording(mp_, cs):
        seen.append(cs.detach().clone())
        return cost_fn(mp_, cs)

    sbx.sharded_mpc_cost = recording
    try:
        sol = sbx.solve_sharded_mpc(mp, iters=ITERS)
    finally:
        sbx.sharded_mpc_cost = cost_fn
    return {"cost": cost.detach(), "grad": grad, "seen": torch.stack(seen),
            "controls": sol.controls, "history": sol.cost_history,
            "final": sol.cost}


_WORKER = r'''
import os, sys
port, rank, S, r_control, repo, out = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), float(sys.argv[4]),
                                       sys.argv[5], sys.argv[6])
sys.path.insert(0, repo)
sys.path.insert(0, os.path.join(repo, "tests"))
import torch
import torch.distributed as dist
from blitzdg_tpu_torch.mpc import sharded_box as sbx
from blitzdg_tpu_torch.parallel import distributed_init
from test_torch_sharded_mpc_dist import _solve

info = distributed_init(f"tcp://localhost:{port}", S, rank, backend="gloo")
assert info["n_processes"] == S and info["process_id"] == rank, info
sbx.R_CONTROL = r_control
mp = sbx.sharded_mpc_problem(dict(sbx.EXAMPLE, n_shards=S),
                             dtype=torch.float64, device="cpu", rank=rank,
                             group=dist.group.WORLD)
res = _solve(mp)
res["target"] = mp.target
torch.save(res, out)
dist.destroy_process_group()
print(f"MPC_OK rank={rank}")
'''


def _run_ranks(tmp, S: int, r_control: float) -> list:
    """S gloo processes of the rank-local MPC; each rank's results."""
    worker = tmp / "mpc_worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [tmp / f"rank{r}.pt" for r in range(S)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(r), str(S),
         repr(r_control), repo, str(outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(S)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
        assert f"MPC_OK rank={r}" in log, log
    return [torch.load(o) for o in outs]


def _stacked(S: int, r_control: float, monkeypatch) -> dict:
    monkeypatch.setattr(sbx, "R_CONTROL", r_control)
    mp = sbx.sharded_mpc_problem(dict(sbx.EXAMPLE, n_shards=S), dtype=F64,
                                 device="cpu")
    res = _solve(mp)
    res["target"] = mp.target
    return res


@pytest.fixture(scope="module")
def ranks_S4(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("mpc_S4"), 4, sbx.R_CONTROL)


CASES = {"S2": (2, sbx.R_CONTROL), "S4": (4, sbx.R_CONTROL),
         "S4_large_control_weight": (4, LARGE_R)}


@pytest.mark.parametrize("name", list(CASES))
def test_gloo_ranks_match_the_stacked_solve(name, ranks_S4, tmp_path,
                                            monkeypatch):
    S, r_control = CASES[name]
    got = (ranks_S4 if name == "S4" else
           _run_ranks(tmp_path, S, r_control))
    want = _stacked(S, r_control, monkeypatch)
    assert want["seen"].shape[0] == ITERS + 1
    for r in range(S):
        for k in ("cost", "grad", "seen", "controls", "history", "final"):
            assert torch.equal(got[r][k], got[0][k]), (r, k)
        np.testing.assert_array_equal(got[r]["target"].numpy(),
                                      want["target"][r:r + 1].numpy())
    for k in ("cost", "grad", "seen", "controls", "history", "final"):
        w = want[k].numpy()
        np.testing.assert_allclose(got[0][k].numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max(), err_msg=k)
    if r_control == LARGE_R:
        # the control term's share of the gradient at the test controls
        reg = 2 * LARGE_R * _test_controls()
        assert float((reg - want["grad"]).abs().max()) < 0.2 * float(
            reg.abs().max())


def _jax_value_and_grad(S: int, cs: np.ndarray):
    """``jax.value_and_grad`` of the JAX example's ``total`` at ``cs``,
    built as ``examples/mpc_sharded.py`` builds it (``main``), in float64,
    over S of the host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from blitzdg_tpu.mesh import box_triangles
    from blitzdg_tpu.ops.sw2d import SWPhysics
    from blitzdg_tpu.parallel import partition_mesh
    from blitzdg_tpu.parallel.blocked_shard import (
        build_sharded_blocked, initial_send_buffer,
        make_sharded_blocked_step_diff, pack_local)
    from blitzdg_tpu.specgrid.triangle import build_triangle_context

    n_steps = cs.shape[0]
    mesh2d, _, _ = partition_mesh(box_triangles(8, 8), S)
    ctx = build_triangle_context(1, mesh2d, filter_cutoff=0.9,
                                 filter_order=1, dtype=jnp.float64)
    bump = np.exp(-8.0 * (np.asarray(ctx.x) ** 2 + np.asarray(ctx.y) ** 2))
    sb = build_sharded_blocked(ctx, SWPhysics(g=9.81), S, dtype=jnp.float64,
                               forcing_bu=np.stack([bump, 0 * bump]),
                               forcing_bv=np.stack([0 * bump, bump]))
    meta, k_loc = sb.meta, sb.k_loc
    step = make_sharded_blocked_step_diff(sb, 1e-3, interpret=True)
    el_mesh = Mesh(np.array(jax.devices()[:S]), ("element",))
    zero_pk = jnp.concatenate([pack_local(meta, np.zeros((k_loc, ctx.n_p)))
                               for _ in range(S)], axis=0)
    vm = sb.ops.vmask[0][None]
    op_specs = jax.tree.map(
        lambda a: P("element", *([None] * (a.ndim - 1))), sb.ops)
    st_spec = P("element", None, None, None)
    cs_ref = jnp.asarray(np.array([sbx.HIDDEN_CONTROL] * n_steps))

    def rollout_local(ops_l, cs_, z_l):
        pk = (10.0 * vm, z_l, z_l)
        sb0 = initial_send_buffer(sb, ops_l, pk)

        def body(carry, c):
            return step(ops_l, carry, 0.0, ctrl=c), None

        return jax.lax.scan(body, (pk, sb0), cs_)[0][0][1]

    tgt_pk = jax.jit(jax.shard_map(
        rollout_local, mesh=el_mesh, in_specs=(op_specs, P(), st_spec),
        out_specs=st_spec, check_vma=False))(sb.ops, cs_ref, zero_pk)

    def loss_local(ops_l, cs_, tgt_l, z_l):
        pk = (10.0 * vm, z_l, z_l)
        sb0 = initial_send_buffer(sb, ops_l, pk)

        def body(carry, c):
            return step(ops_l, carry, 0.0, ctrl=c), None

        hu_end = jax.lax.scan(body, (pk, sb0), cs_)[0][0][1]
        loc = jnp.sum(vm * (hu_end - tgt_l) ** 2)
        return jax.lax.psum(loc, "element") + sbx.R_CONTROL * jnp.sum(cs_ ** 2)

    def total(cs_):
        fn = jax.shard_map(loss_local, mesh=el_mesh,
                           in_specs=(op_specs, P()) + (st_spec,) * 2,
                           out_specs=P(), check_vma=False)
        return fn(sb.ops, cs_, tgt_pk, zero_pk)

    v, g = jax.jit(jax.value_and_grad(total))(jnp.asarray(cs))
    return float(v), np.asarray(g)


def test_gloo_ranks_match_jax_value_and_grad(ranks_S4):
    """The S=4 ranks' cost and control gradient at the test controls against
    the JAX example's ``total`` (1e-9 relative: float64 on both sides, the
    sums in other orders; the control term is as large as the gradient's
    second component there, far above the tolerance, so a term counted S
    times would show)."""
    cs = _test_controls().numpy()
    v, g = _jax_value_and_grad(4, cs)
    got = ranks_S4[0]
    np.testing.assert_allclose(float(got["cost"]), v, rtol=1e-9)
    np.testing.assert_allclose(got["grad"].numpy(), g, rtol=1e-9,
                               atol=1e-9 * np.abs(g).max())
    reg = 2 * sbx.R_CONTROL * cs
    assert np.abs(reg).max() > 1e-6 * np.abs(g).max()
