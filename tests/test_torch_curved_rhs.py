"""The plain curved weak-form RHS (``ops/sw2d_curved.py``) against the JAX
package's ``sw2d_curved_rhs`` on the CPU in float64, on the same contexts
(carried over as numpy) and the same states: 1e-12 absolute.

Cases: flat bottom; drag + Coriolis; bed slope; tidal depth on BC_OUT Gauss
nodes; wetting/drying (``wetdry=True`` with bathymetry);
``ssprk2_step_curved_wetdry``; lake at rest (RHS zero to 1e-12); batched
states equal the unbatched ones; the ``rhs_fn`` hook of ``MPCProblem``
against the JAX ``mpc_cost`` with the same hook.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mpc import MPCProblem as JMPCProblem
from blitzdg_tpu.mpc import mpc_cost as j_mpc_cost
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_curved as JR

from torch_parity import jax_arrays, jax_curved_contexts, jax_fields

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mpc import MPCProblem, mpc_cost
from blitzdg_tpu_torch.ops import sw2d_curved as TR
from blitzdg_tpu_torch.ops.sw2d import SWPhysics

F64 = torch.float64
T = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)


class Pair:
    """One curved discretization on both sides, float64."""

    def __init__(self, geom="disk", open_east=False):
        self.jctx, self.jcub, self.jgauss = jax_curved_contexts(geom)
        if open_east:  # retag the boundary faces right of x = 0.5 as BC_OUT
            self.jgauss = self._retag(self.jgauss)
        arrays, static = jax_arrays(self.jctx)
        to = dict(device="cpu", dtype=F64)
        self.ctx = convert.context_from_numpy(arrays, static, **to)
        self.cub = convert.cubature_from_numpy(jax_fields(self.jcub), **to)
        self.gauss = convert.gauss_from_numpy(jax_fields(self.jgauss), **to)
        self.x, self.y = np.asarray(self.jctx.x), np.asarray(self.jctx.y)

    @staticmethod
    def _retag(g):
        """Move the wall Gauss points with x > 0.5 to the BC_OUT list."""
        from blitzdg_tpu.context import BC_WALL
        idx = np.asarray(g.bc_idx[BC_WALL])[np.asarray(g.bc_mask[BC_WALL])]
        east = np.asarray(g.x).reshape(-1)[idx] > 0.5
        assert east.any() and not east.all()
        bc_idx, bc_mask = dict(g.bc_idx), dict(g.bc_mask)
        for tag, sel in ((BC_WALL, idx[~east]), (BC_OUT, idx[east])):
            bc_idx[tag] = jnp.asarray(sel.astype(np.int32))
            bc_mask[tag] = jnp.ones(sel.size, dtype=bool)
        return g.replace(bc_idx=bc_idx, bc_mask=bc_mask)

    def state(self, depth=1.0):
        eta = 0.05 * np.exp(-4.0 * (self.x ** 2 + self.y ** 2))
        return (depth + eta, 0.02 * eta + 0.01, -0.01 * eta,
                0.5 + 0.3 * eta)

    def both(self, s, phys=None, **kw):
        """RHS on both sides; keyword arrays are converted per side."""
        phys = dict(g=9.81) if phys is None else phys
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        tkw = {k: T(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jphys = jsw.SWPhysics(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v for k, v in phys.items()})
        tphys = SWPhysics(**{k: T(v) if isinstance(v, np.ndarray) else v
                             for k, v in phys.items()})
        want = JR.sw2d_curved_rhs(self.jctx, self.jcub, self.jgauss,
                                  JR.SWStateTracer(*map(jnp.asarray, s)),
                                  0.3, jphys, **jkw)
        got = TR.sw2d_curved_rhs(self.ctx, self.cub, self.gauss,
                                 TR.SWStateTracer(*map(T, s)), 0.3, tphys,
                                 **tkw)
        return got, want


@pytest.fixture(scope="module")
def disk():
    return Pair("disk")


def close(got, want, atol=1e-12):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("geom", ["disk", "box"])
def test_flat_bottom_rhs_matches_jax(geom):
    p = Pair(geom)
    got, want = p.both(p.state())
    close(got, want)
    assert float(got.h.abs().max()) > 1e-4  # something moves


def test_drag_and_coriolis_match_jax(disk):
    got, want = disk.both(disk.state(), dict(g=9.81, cd=2e-3, f_cor=1e-1))
    close(got, want)
    flat, _ = disk.both(disk.state())
    assert float((got.hu - flat.hu).abs().max()) > 1e-6


def test_bed_slope_matches_jax(disk):
    zx, zy = 0.1 * np.cos(disk.x), 0.05 * np.sin(2.0 * disk.y)
    got, want = disk.both(disk.state(), zx=zx, zy=zy)
    close(got, want)
    flat, _ = disk.both(disk.state())
    np.testing.assert_allclose((got.hu - flat.hu).numpy(),
                               -9.81 * disk.state()[0] * zx, atol=1e-12)


def test_tidal_open_boundary_matches_jax():
    p = Pair("disk", open_east=True)
    tide = lambda t: 1.2 + 0.1 * np.cos(2.0 * t)
    got, want = p.both(p.state(), tidal_forcing=tide)
    close(got, want)
    walls, _ = p.both(p.state())
    assert float((got.h - walls.h).abs().max()) > 1e-3


def test_wetdry_rhs_and_step_match_jax(disk):
    # a sloping bed that dries out toward x = 1; water column floored
    h_floor = 1e-3
    H = 0.4 - 0.6 * disk.x
    s = list(disk.state())
    s[0] = np.maximum(H + 0.02 * np.exp(-4.0 * (disk.x ** 2 + disk.y ** 2)),
                      h_floor)
    wet = s[0] > 5 * h_floor
    s[1], s[2] = s[1] * wet, s[2] * wet
    assert (s[0] <= h_floor).any() and (s[0] > 0.3).any()
    phys = dict(g=9.81, cd=1e-3, H=H)
    kw = dict(zx=0.6 * np.ones_like(H), zy=np.zeros_like(H), wetdry=True,
              h_floor=h_floor)
    got, want = disk.both(tuple(s), phys, **kw)
    close(got, want)
    assert all(bool(torch.isfinite(f).all()) for f in got)

    jphys = jsw.SWPhysics(g=9.81, cd=1e-3, H=jnp.asarray(H))
    tphys = SWPhysics(g=9.81, cd=1e-3, H=T(H))
    for use_filter in (False, True):
        want = JR.ssprk2_step_curved_wetdry(
            disk.jctx, disk.jcub, disk.jgauss,
            JR.SWStateTracer(*map(jnp.asarray, s)), 0.0, 1e-3, jphys,
            zx=jnp.asarray(kw["zx"]), zy=jnp.asarray(kw["zy"]),
            h_floor=h_floor, use_filter=use_filter)
        got = TR.ssprk2_step_curved_wetdry(
            disk.ctx, disk.cub, disk.gauss, TR.SWStateTracer(*map(T, s)),
            0.0, 1e-3, tphys, zx=T(kw["zx"]), zy=T(kw["zy"]),
            h_floor=h_floor, use_filter=use_filter)
        close(got, want)
        assert float(got.h.min()) > 0.0


def test_lake_at_rest_and_batching(disk):
    one = np.ones_like(disk.x)
    got, want = disk.both((one, 0 * one, 0 * one, 0.5 * one))
    close(got, want)
    for f in got:
        assert float(f.abs().max()) < 1e-12
    # leading batch axes: each scenario equals its unbatched RHS
    s = disk.state()
    batch = TR.SWStateTracer(*(torch.stack([T(f), T(f) * 1.1]) for f in s))
    out = TR.sw2d_curved_rhs(disk.ctx, disk.cub, disk.gauss, batch, 0.0,
                             SWPhysics(g=9.81, cd=1e-3))
    single, _ = disk.both(s, dict(g=9.81, cd=1e-3))
    for b, u in zip(out, single):
        assert b.shape == (2,) + u.shape
        np.testing.assert_allclose(b[0].numpy(), u.numpy(), rtol=0,
                                   atol=1e-14)


def test_mpc_cost_with_rhs_fn_matches_jax(disk):
    """``MPCProblem.rhs_fn`` with the four-field state: the port's
    ``mpc_cost`` (batched natively) against the JAX one per scenario."""
    weights = dict(dt=2e-3, horizon=2, steps_per_control=2, q_eta=0.3,
                   q_terminal=1.0, r_control=1e-3)
    jphys, tphys = jsw.SWPhysics(g=9.81), SWPhysics(g=9.81)
    jprob = JMPCProblem(ctx=disk.jctx, phys=jphys, **weights,
                        rhs_fn=lambda s, t: JR.sw2d_curved_rhs(
                            disk.jctx, disk.jcub, disk.jgauss, s, t, jphys))
    prob = MPCProblem(ctx=disk.ctx, phys=tphys, **weights,
                      rhs_fn=lambda s, t: TR.sw2d_curved_rhs(
                          disk.ctx, disk.cub, disk.gauss, s, t, tphys))
    bump = np.exp(-8.0 * (disk.x ** 2 + disk.y ** 2))
    jforce = lambda c, u, s, t: (jnp.zeros_like(s.h), u[0] * bump, u[1] * bump)
    tb = T(bump)
    tforce = lambda c, u, s, t: (torch.zeros_like(s.h),
                                 u[..., 0, None, None] * tb,
                                 u[..., 1, None, None] * tb)
    B = 2
    s = disk.state()
    ctrls = 0.5 * np.random.default_rng(3).standard_normal((B, 2, 2))
    tgt = np.stack([1e-3 * np.exp(-5.0 * ((disk.x - o) ** 2 + disk.y ** 2))
                    for o in (-0.1, 0.2)])
    want = [float(j_mpc_cost(jprob, JR.SWStateTracer(*map(jnp.asarray, s)),
                             jnp.asarray(ctrls[b]), jnp.asarray(tgt[b]),
                             jforce, H_rest=1.0)) for b in range(B)]
    batch = TR.SWStateTracer(*(T(f).expand(B, *f.shape) for f in s))
    got = mpc_cost(prob, batch, T(ctrls), T(tgt), tforce, H_rest=1.0)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11)
