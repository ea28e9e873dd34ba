"""The sharded rollout's entry points on the CPU, in float64: the per-step
loop (``sharded_rollout``) through either step is the step applied
``n_steps`` times from the problem's start, and the CUDA-graph capture
(``capture_sharded_rollout``) refuses a problem that does not lie on the
card instead of running a loop in its place. The captured rollout itself
runs on the card only (``chip_smoke.py``, phase ``sharded_rollout_graph``:
its end state bit-equal to the loop's at the four rollout shapes).
"""
import pytest
import torch

from blitzdg_tpu_torch.mpc import sharded_box as sbx
from blitzdg_tpu_torch.parallel import blocked_shard as BS

F64 = torch.float64
N_STEPS = 3


@pytest.fixture(scope="module")
def problem():
    """The rollout problem cut to ``box_triangles(8, 8)`` at N=1, 4 shards
    of 32 elements, two scenarios."""
    return sbx.sharded_rollout_problem(4, 2, n_steps=N_STEPS, n_order=1,
                                       cells=(8, 8), dtype=F64, device="cpu")


@pytest.mark.parametrize("make_step", [BS.make_sharded_blocked_step_fused,
                                       BS.make_sharded_blocked_step_rdma])
def test_sharded_rollout_is_the_step_loop(problem, make_step):
    r = problem
    step = make_step(r.sb, r.dt)
    carry = (r.state, BS.initial_send_buffer(r.sb, r.state))
    for i in range(N_STEPS):
        carry = step(carry, i * r.dt)
    got = sbx.sharded_rollout(r, make_step=make_step)
    assert all(torch.equal(a, b) for a, b in zip(got, carry[0]))
    # the default step is the fused one, and the one-launch step gives its
    # bits (both are the plain stage composition on the CPU)
    fused = sbx.sharded_rollout(r)
    assert all(torch.equal(a, b) for a, b in zip(got, fused))
    assert all(torch.isfinite(f).all() for f in got)
    assert not torch.equal(got[0], r.state[0])  # the state moved


@pytest.mark.parametrize("make_step", [BS.make_sharded_blocked_step_fused,
                                       BS.make_sharded_blocked_step_rdma])
def test_capture_refuses_a_cpu_problem(problem, make_step):
    with pytest.raises(RuntimeError, match="CUDA graph, which needs the card"):
        sbx.capture_sharded_rollout(problem, N_STEPS, make_step)
