"""The plain reference agrees with the port's plain versions at a small
size, in float64 on the CPU: the cost, its gradient and the plant step of
both configurations (the frozen builders and right-hand sides on one side,
the port's operator sets and plain kernels' stand-ins on the other)."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import spec, traffic
from portbench.reference import models, optim

LOAD = {"pool": 1, "batch": 3, "horizon": 2, "steps_per_control": 2,
        "state": {"elevation": [0.01, 0.05], "width": 10.0,
                  "centre": [-0.5, 0.5], "current": [-0.05, 0.05],
                  "tracer": [0.1, 0.5]},
        "target": {"amp": [5e-4, 2e-3], "width": 5.0,
                   "centre_x": [-0.3, 0.3], "centre_y": [-0.3, 0.3]}}


def _inputs(model, seed=7):
    batch = traffic.make_pool(LOAD, model, seed, "cpu")[0]
    state = tuple(f.double() for f in batch.state)
    rng = np.random.default_rng(seed)
    c = torch.as_tensor(0.3 * rng.standard_normal((3, 2, 2)))
    return state, batch.targets.double(), c


def _reference(model, state, targets, c):
    total = lambda cc: models.cost(model, state, cc, targets, 2)
    cost, gnorm = optim.cost_and_grad_norm(total, c)
    with torch.no_grad():
        plant = models.plant(model, state, c[:, 0], 2)
    return cost, gnorm, plant


def _port_gradient(cost_fn, c):
    c = c.clone().requires_grad_(True)
    costs = cost_fn(c)
    (g,) = torch.autograd.grad(costs.sum(), c)
    return costs.detach(), torch.sqrt((g * g).sum(dim=(-2, -1)))


def test_coastal_box_matches_the_port():
    from blitzdg_tpu_torch.mpc import advance_plant_fused, mpc_cost_fused
    from blitzdg_tpu_torch.ops.sw2d import SWState

    from portbench.drivers import coastal_box_k40_n1 as drv

    cfg = spec.config("coastal_box_k40_n1")
    model = models.build_model(cfg)
    state, targets, c = _inputs(model)
    sut = drv.build(cfg, {"horizon": 2, "steps_per_control": 2}, "cpu",
                    torch.float64)
    assert sut.prob.dt == pytest.approx(model.dt, rel=1e-15)
    s = SWState(*state)
    cost, gnorm = _port_gradient(lambda cc: mpc_cost_fused(
        sut.prob, sut.fm, s, cc, targets, sut.H_rest), c)
    plant = advance_plant_fused(sut.prob, sut.fm, s, c[:, 0].contiguous())
    r_cost, r_g, r_plant = _reference(model, state, targets, c)
    assert torch.allclose(cost, r_cost, rtol=1e-9, atol=0)
    assert torch.allclose(gnorm, r_g, rtol=1e-8, atol=0)
    for a, b in zip(plant, r_plant):
        assert torch.allclose(a, b, rtol=0, atol=1e-11)


def test_curved_disk_matches_the_port():
    from blitzdg_tpu_torch.mpc import (advance_plant_curved_blocked,
                                       mpc_cost_curved_blocked)
    from blitzdg_tpu_torch.mpc.curved_disk import curved_disk_problem
    from blitzdg_tpu_torch.ops.sw2d_curved import SWStateTracer

    cfg = spec.config("curved_disk_k864_n4")
    cfg = {**cfg, "mesh": {**cfg["mesh"], "rings": 3, "snap_tol": 0.3}}
    model = models.build_model(cfg)
    state, targets, c = _inputs(model)
    d = curved_disk_problem(rings=3, snap_tol=0.3, batch=1, horizon=2,
                            steps_per_control=2, n_order=cfg["mesh"]["N"],
                            dtype=torch.float64, device="cpu")
    assert (d.bm.meta.n_p, d.bm.meta.n_cub, d.bm.meta.n_gauss) == (15, 47, 10)
    assert d.prob.dt == pytest.approx(model.dt, rel=1e-15)
    s = SWStateTracer(*state)
    cost, gnorm = _port_gradient(lambda cc: mpc_cost_curved_blocked(
        d.prob, d.bm, s, cc, targets, 1.0), c)
    plant = advance_plant_curved_blocked(d.prob, d.bm, s,
                                         c[:, 0].contiguous())
    r_cost, r_g, r_plant = _reference(model, state, targets, c)
    assert torch.allclose(cost, r_cost, rtol=1e-9, atol=0)
    assert torch.allclose(gnorm, r_g, rtol=1e-8, atol=0)
    for a, b in zip(plant, r_plant):
        assert torch.allclose(a, b, rtol=0, atol=1e-11)


def test_model_moves_whole():
    cfg = spec.config("coastal_box_k40_n1")
    m = models.build_model(cfg).to("cpu", torch.float32)
    leaves = [m.x, m.wj, m.parts["ctx"].Dr, m.parts["phys"].H]
    assert all(t.dtype == torch.float32 for t in leaves)
    assert m.parts["ctx"].vmapM.dtype == torch.int64
    assert dataclasses.is_dataclass(m)
