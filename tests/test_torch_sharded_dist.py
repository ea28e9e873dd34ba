"""The sharded path's process-group transport: S gloo processes hold one
shard each of ``box_triangles(6, 6)`` at N = 2 with coastal physics
(bathymetry, drag, Coriolis, sponge, tidal depth on the open east side) and
controls, and run 3 fused steps and 3 differentiable steps through
``torch.distributed`` (one ``batch_isend_irecv`` round per ring offset). Each
process writes its shard's states, send buffer and gradients (the controls'
cotangent summed over the ranks by ``sum_over_ranks_grad``); they must equal
the stacked transport's results for the same S in one process to 1e-12.
S = 2 has the one ring offset 1, where the peers rank + 1 and rank - 1 are
the same; S = 4 has the offsets (1, 2, 3), so a send in the wrong direction
or a chunk in the wrong order shows. The processes are started as
``tests/test_distributed_multiproc.py`` starts its workers, with a timeout
of their own, and always ended.

Also: ``distributed_init`` without arguments joins nothing and reports.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from blitzdg_tpu_torch.parallel import distributed_init

_SETUP = r'''
import numpy as np, torch
from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.ops.sw2d import SWPhysics
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel.partition import partition_mesh
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

S, N_STEPS, DT, T0 = __S__, 3, 5e-4, 0.02
F64 = torch.float64


def problem(shards=None):
    mesh = box_triangles(6, 6, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    retag_east_open(mesh)
    mesh = partition_mesh(mesh, S)[0]
    ctx = build_triangle_context(2, mesh, filter_cutoff=1.8, filter_order=4,
                                 device="cpu")
    x, y = ctx.x, ctx.y
    H = 10.0 + 0.5 * x + 0.3 * torch.sin(2.0 * y)
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                     Hx=0.5 * torch.ones_like(H), Hy=0.6 * torch.cos(2.0 * y),
                     sponge=0.2 * torch.exp(-10.0 * (x - 1.0) ** 2))
    bump = np.exp(-8.0 * ((x.numpy() - 0.5) ** 2 + (y.numpy() - 0.5) ** 2))
    sb = BS.build_sharded_blocked(
        ctx, phys, S, dtype=F64, tidal=(10.4, 0.3, 2.0, 0.01),
        forcing_bu=np.stack([bump, 0 * bump]),
        forcing_bv=np.stack([0 * bump, bump]), device="cpu", shards=shards)
    eta = torch.exp(-8.0 * ((x - 0.4) ** 2 + (y - 0.6) ** 2)).reshape(1, -1)
    eta = torch.cat([eta, 0.5 * eta])  # two scenarios
    split = lambda f: BS.split_shards(f, S)
    state = (split(H.reshape(1, -1) + 0.3 * eta), split(0.1 * eta),
             split(0.05 * eta))
    tgt = split((H + 0.1 * torch.exp(-8.0 * x ** 2)).reshape(1, -1)
                .expand(2, -1))
    cs = torch.as_tensor(0.3 * np.random.default_rng(3)
                         .standard_normal((N_STEPS, 2)))
    keep = list(range(S)) if shards is None else list(shards)
    return sb, tuple(f[keep] for f in state), tgt[keep], cs


def run(sb, state, tgt, cs, group=None):
    """3 fused steps, then the cost through 3 differentiable steps and its
    gradients (this process's part of the cost)."""
    step = BS.make_sharded_blocked_step_fused(sb, DT, group=group)
    carry, t = (state, BS.initial_send_buffer(sb, state)), T0
    for i in range(N_STEPS):
        carry = step(carry, t, cs[i])
        t += DT
    h0 = state[0].clone().requires_grad_(True)
    c = cs.clone().requires_grad_(True)
    st = (h0, state[1], state[2])
    dstep = BS.make_sharded_blocked_step_diff(sb, DT, group=group)
    # one shard a rank: the controls' cotangent summed over the ranks
    c_all = BS.sum_over_ranks_grad(c, dstep.exchange)
    dcarry, t = (st, BS.initial_send_buffer(sb, st)), T0
    for i in range(N_STEPS):
        dcarry = dstep(dcarry, t, c_all[i])
        t += DT
    h, hu, hv = dcarry[0]
    loss = ((h - tgt) ** 2).sum() + 0.1 * (hu ** 2).sum() + hv.sum()
    gh, gc = torch.autograd.grad(loss, (h0, c))
    return {"h": carry[0][0], "hu": carry[0][1], "hv": carry[0][2],
            "sbuf": carry[1], "dh": dcarry[0][0].detach(), "gh": gh,
            "gc": gc}
'''

_WORKER = r'''
import os, sys
port, rank, repo, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import torch.distributed as dist
from sharded_setup import problem, run, S
from blitzdg_tpu_torch.parallel import distributed_init

info = distributed_init(f"tcp://localhost:{port}", S, rank, backend="gloo")
assert info["n_processes"] == S and info["process_id"] == rank, info
sb, state, tgt, cs = problem(shards=(rank,))
res = run(sb, state, tgt, cs, group=dist.group.WORLD)
np.savez(out, **{k: v.detach().numpy() for k, v in res.items()})
dist.destroy_process_group()
print(f"SHARD_OK rank={rank}")
'''


def test_distributed_init_without_arguments_only_reports():
    info = distributed_init()
    assert info["n_processes"] == 1 and info["process_id"] == 0
    assert not torch.distributed.is_initialized()


def _gloo_processes_match_the_stacked_transport(tmp_path, S, offs):
    (tmp_path / "sharded_setup.py").write_text(_SETUP.replace("__S__", str(S)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [tmp_path / f"rank{r}.npz" for r in range(S)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(r), repo, str(outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(S)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
        assert f"SHARD_OK rank={r}" in log, log

    # the stacked transport in this process
    sys.path.insert(0, str(tmp_path))
    try:
        import sharded_setup
        sb, state, tgt, cs = sharded_setup.problem()
        ref = sharded_setup.run(sb, state, tgt, cs)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("sharded_setup", None)
    assert sb.plan.offs == offs
    for r in range(S):
        got = np.load(outs[r])
        for name in ("h", "hu", "hv", "sbuf", "dh", "gh"):
            want = ref[name][r:r + 1].detach().numpy()
            np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-12,
                                       err_msg=f"rank {r} {name}")
        gc = ref["gc"].numpy()
        np.testing.assert_allclose(got["gc"], gc, rtol=1e-12,
                                   atol=1e-12 * np.abs(gc).max(),
                                   err_msg=f"rank {r} control gradient")


def test_two_gloo_processes_match_the_stacked_transport(tmp_path):
    _gloo_processes_match_the_stacked_transport(tmp_path, 2, (1,))


def test_four_gloo_processes_match_the_stacked_transport(tmp_path):
    _gloo_processes_match_the_stacked_transport(tmp_path, 4, (1, 2, 3))
