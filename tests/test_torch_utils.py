"""Observability and robustness utilities of the port (``utils.py``).

Mirrors ``tests/test_utils.py``: the blow-up guard, the freeze-on-blowup
update (on a dict and on a NamedTuple state), the sponge ramp (against the
JAX function at 1e-15) and the step timer; and the profiler wrappers
(``trace`` writes a Chrome trace that holds the ``annotate`` region).
"""
import json

import numpy as np
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_tri
from blitzdg_tpu.utils import build_sponge_coefficient as j_sponge

from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.ops.sw2d import SWState
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context
from blitzdg_tpu_torch.utils import (StepTimer, annotate,
                                     build_sponge_coefficient,
                                     checked_update, instability_guard, trace)


def test_instability_guard():
    ok = torch.ones((4, 4))
    assert not bool(instability_guard(ok))
    assert bool(instability_guard(ok * torch.inf))
    bad = ok.clone()
    bad[0, 0] = torch.nan
    assert bool(instability_guard(bad))
    assert bool(instability_guard(ok * 1e9))
    assert bool(instability_guard(ok, ok * 1e9))
    assert not bool(instability_guard(ok * 1e9, threshold=1e10))
    assert isinstance(instability_guard(ok), torch.Tensor)


def test_checked_update_freezes_on_blowup():
    old = {"u": torch.ones(3)}
    good = {"u": 2 * torch.ones(3)}
    bad = {"u": torch.tensor([1.0, torch.nan, 3.0])}
    out, flag = checked_update(good, old)
    assert not bool(flag)
    np.testing.assert_allclose(out["u"].numpy(), 2.0)
    out, flag = checked_update(bad, old)
    assert bool(flag)
    np.testing.assert_allclose(out["u"].numpy(), 1.0)
    s_old = SWState(*(torch.ones(2) for _ in range(3)))
    s_new = s_old._replace(hv=torch.tensor([0.0, 1e9]))
    out, flag = checked_update(s_new, s_old)
    assert bool(flag) and isinstance(out, SWState)
    assert torch.equal(out.hv, s_old.hv)


def test_sponge_coefficient_ramp():
    ctx = build_triangle_context(2, box_triangles(4, 4), device="cpu")
    # mark east boundary faces as open
    mask = np.zeros((ctx.k_elem, ctx.n_faces * ctx.n_fp), dtype=bool)
    vm = ctx.vmapM.numpy()
    xf = ctx.x.numpy().reshape(-1)[vm]
    mask[(xf > 1.0 - 1e-9)] = True
    sponge = build_sponge_coefficient(ctx, mask, width=0.5,
                                      strength=2.0).numpy()
    x = ctx.x.numpy()
    # max at the open boundary, zero far away
    assert sponge[x > 0.999].min() > 1.9
    assert np.allclose(sponge[x < 0.4], 0.0)
    assert sponge.max() <= 2.0 + 1e-12
    want = np.asarray(j_sponge(j_tri(2, j_box_triangles(4, 4)), mask,
                               width=0.5, strength=2.0))
    np.testing.assert_allclose(sponge, want, rtol=0, atol=1e-15)


def test_step_timer():
    t = StepTimer()
    assert t.summary() == "no samples"
    with t.measure():
        pass
    out = torch.zeros(3)
    with t.measure(result_to_block=(out, {"a": out})):
        out += 1.0
    assert len(t.times) == 2 and all(s >= 0.0 for s in t.times)
    assert "mean" in t.summary() and t.mean >= 0.0


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path)):
        with annotate("blitzdg_region"):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "blitzdg_region" in names
