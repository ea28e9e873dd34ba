"""The one-launch sharded step across ranks on the CPU: S gloo processes
hold one shard each and run ``make_sharded_blocked_step_rdma(sb, dt,
group=g)``, which on CPU tensors is the plain version over the group's
``RingExchange`` (one ``batch_isend_irecv`` round per ring offset, both
exchanges of a step); on the card the same call takes a ``PeerRing``
(``parallel/peer.py``), which the shim cases of
``test_torch_blocked_kernel_shim.py`` and ``chip_smoke.py --only peer``
hold.

 - the coastal ``box_triangles(6, 6)`` at N = 2 (bathymetry, drag,
   Coriolis, sponge, tidal depth on the open east side, controls), B = 2,
   3 steps, at S = 2 (one ring offset: rank + 1 and rank - 1 the same
   peer) and S = 4 (offsets 1, 2, 3): each rank's states and send buffer
   equal the stacked one-launch step's shard to 1e-12 in float64;
 - at B = 1, S = 2 on ``test_torch_sharded_rdma.py``'s coastal N = 2 case:
   equal to the JAX one-launch step (remote DMA simulated in interpret
   mode with race detection, under ``shard_map``) to 1e-12;
 - refusals: a ``PeerRing`` on a CPU device, or over a group whose size is
   not the plan's shard count (in the processes: a real group of 2 against
   a plan of 4 shards), a group's step of a set that holds every shard, and
   a wet/dry set.

The processes are started as ``test_torch_sharded_dist.py`` starts them,
each with a timeout of its own, and always ended.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_sharded_rdma import CASES as JAX_CASES
from test_torch_sharded_rdma import _case, _jax_run
from test_torch_sharded_rdma import DT as JAX_DT
from test_torch_sharded_rdma import N_STEPS as JAX_STEPS
from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.ops.sw2d import SWPhysics
from blitzdg_tpu_torch.parallel import PeerRing
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel.partition import partition_mesh
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

F64 = torch.float64
N_STEPS, DT, T0 = 3, 5e-4, 0.02
PROCESS_TIMEOUT = 180  # seconds, each worker

_WORKER = r'''
import dataclasses, sys
port, rank, S, data, out, repo = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4], sys.argv[5],
                                  sys.argv[6])
sys.path.insert(0, repo)
import torch
import torch.distributed as dist
from blitzdg_tpu_torch.parallel import PeerRing, distributed_init
from blitzdg_tpu_torch.parallel import blocked_shard as BS

d = torch.load(data, weights_only=False)
info = distributed_init(f"tcp://localhost:{port}", S, rank, backend="gloo")
assert info["n_processes"] == S and info["process_id"] == rank, info
g = dist.group.WORLD
sb = d["sb"]
# this rank's set: what build_sharded_blocked(..., shards=(rank,)) makes
mine = sb._replace(shards=(rank,), ops=dataclasses.replace(sb.ops, **{
    f.name: getattr(sb.ops, f.name)[rank:rank + 1]
    for f in dataclasses.fields(sb.ops)}))
# refusals: a ring over a group of the wrong size, a group's step of a set
# that holds every shard
refused = []
if d["other_plan"] is not None:
    try:
        PeerRing(d["other_plan"], sb.meta.n_fp, 1, g, device="cuda")
    except ValueError as e:
        refused.append("size" if "ranks" in str(e) else str(e))
try:
    BS.make_sharded_blocked_step_rdma(sb, d["dt"], group=g)
except ValueError:
    refused.append("stacked set")
step = BS.make_sharded_blocked_step_rdma(mine, d["dt"], group=g)
assert step.ring is None  # CPU tensors: the plain version, no ring
state = tuple(f[rank:rank + 1] for f in d["state"])
carry, t = (state, BS.initial_send_buffer(mine, state)), d["t0"]
cs = d["cs"]
for k in range(d["n_steps"]):
    carry = step(carry, t, None if cs is None else cs[k])
    t += d["dt"]
torch.save({"h": carry[0][0], "hu": carry[0][1], "hv": carry[0][2],
            "sbuf": carry[1], "refused": refused}, out)
dist.destroy_process_group()
print(f"RDMA_OK rank={rank}")
'''


def _run_ranks(tmp_path, data: dict, S: int) -> list:
    """S gloo processes over ``data`` (the stacked set, its state, controls
    and step); each rank's results."""
    path = tmp_path / f"data_S{S}.pt"
    torch.save(data, path)
    worker = tmp_path / "rdma_worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [tmp_path / f"rdma_S{S}_rank{r}.pt" for r in range(S)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(r), str(S), str(path),
         str(outs[r]), repo],
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
        assert f"RDMA_OK rank={r}" in log, log
    return [torch.load(o, weights_only=False) for o in outs]


def _stacked(sb, state, cs, dt, t0, n_steps):
    """The stacked one-launch step's states and send buffer."""
    step = BS.make_sharded_blocked_step_rdma(sb, dt)
    carry, t = (state, BS.initial_send_buffer(sb, state)), t0
    for k in range(n_steps):
        carry = step(carry, t, None if cs is None else cs[k])
        t += dt
    return {"h": carry[0][0], "hu": carry[0][1], "hv": carry[0][2],
            "sbuf": carry[1]}


def _coastal(S: int):
    """The coastal box of ``test_torch_sharded_dist.py`` partitioned into S
    shards: the stacked float64 set, a two-scenario state, controls."""
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
        forcing_bv=np.stack([0 * bump, bump]), device="cpu")
    eta = torch.exp(-8.0 * ((x - 0.4) ** 2 + (y - 0.6) ** 2)).reshape(1, -1)
    eta = torch.cat([eta, 0.5 * eta])
    split = lambda f: BS.split_shards(f, S)
    state = (split(H.reshape(1, -1) + 0.3 * eta), split(0.1 * eta),
             split(0.05 * eta))
    cs = torch.as_tensor(0.3 * np.random.default_rng(3)
                         .standard_normal((N_STEPS, 2)))
    return sb, state, cs


def _assert_ranks_match(got, want, S, tol=1e-12):
    for r in range(S):
        for name in ("h", "hu", "hv", "sbuf"):
            np.testing.assert_allclose(
                got[r][name].numpy(), want[name][r:r + 1].numpy(), rtol=0,
                atol=tol, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("S,offs", [(2, (1,)), (4, (1, 2, 3))])
def test_gloo_ranks_match_the_stacked_one_launch_step(tmp_path, S, offs):
    sb, state, cs = _coastal(S)
    assert sb.plan.offs == offs
    other = _coastal(4)[0].plan if S == 2 else None
    got = _run_ranks(tmp_path, {"sb": sb, "state": state, "cs": cs,
                                "dt": DT, "t0": T0, "n_steps": N_STEPS,
                                "other_plan": other}, S)
    _assert_ranks_match(got, _stacked(sb, state, cs, DT, T0, N_STEPS), S)
    for r in range(S):
        want = ["size", "stacked set"] if S == 2 else ["stacked set"]
        assert got[r]["refused"] == want


def test_gloo_ranks_match_the_jax_one_launch_step(tmp_path):
    """B = 1, S = 2, the coastal N = 2 case of ``test_torch_sharded_rdma``:
    each rank against the JAX one-launch step's shard."""
    kind, n = JAX_CASES[1][:2]
    S = 2
    jc, phys_np, kw, t0, cs, state = _case(kind, n, S)
    j_states, j_sbuf = _jax_run(jc, phys_np, kw, t0, cs, state, S)
    sb = convert.sharded_blocked_from_numpy(
        *jax_arrays(jc), phys_np, S, device="cpu", dtype=F64, **kw)
    assert sb.plan.offs == (1,)
    st = tuple(BS.split_shards(torch.as_tensor(f), S) for f in state)
    got = _run_ranks(tmp_path, {"sb": sb, "state": st,
                                "cs": torch.as_tensor(cs), "dt": JAX_DT,
                                "t0": t0, "n_steps": JAX_STEPS,
                                "other_plan": None}, S)
    want = {"h": torch.as_tensor(j_states[0]),
            "hu": torch.as_tensor(j_states[1]),
            "hv": torch.as_tensor(j_states[2]),
            "sbuf": torch.as_tensor(j_sbuf)}
    _assert_ranks_match(got, want, S)


def test_peer_ring_and_the_rdma_step_refuse():
    """A ring on a CPU device raises before it touches a group or a card;
    so does one without a group; a wet/dry set's one-launch step raises
    with or without a group."""
    sb = _coastal(2)[0]
    for dev in ("cpu", torch.device("cpu")):
        with pytest.raises(ValueError, match="CUDA device"):
            PeerRing(sb.plan, sb.meta.n_fp, 1, object(), device=dev)
    with pytest.raises(ValueError, match="process group"):
        PeerRing(sb.plan, sb.meta.n_fp, 1, None, device="cuda")
    mesh = partition_mesh(box_triangles(4, 4, xlim=(0.0, 1.0),
                                        ylim=(0.0, 1.0)), 2)[0]
    ctx = build_triangle_context(1, mesh, device="cpu")
    H = 1.0 - 1.5 * ctx.x
    wet = BS.build_sharded_blocked(
        ctx, SWPhysics(g=9.81, H=H, Hx=-1.5 * torch.ones_like(H),
                       Hy=torch.zeros_like(H), well_balanced=False), 2,
        wetdry=True, dtype=F64, device="cpu")
    for group in (None, object()):
        with pytest.raises(NotImplementedError):
            BS.make_sharded_blocked_step_rdma(wet, DT, group=group)
