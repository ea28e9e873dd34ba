"""Wetting and drying in the port, on the CPU in float64, against the JAX
package:

 - ``ops/limiters.py`` function by function (``minmod``,
   ``surface_reconstruction``, ``positivity_preserving_limiter`` with and
   without quadrature weights): 1e-13;
 - ``sw2d_rhs_wetdry`` and both schemes of ``ssprk2_step_wetdry`` on a
   sloping beach with a dry region: 1e-13 (relative where the value is above
   one);
 - the blocked rollout's wet/dry branch (plain version of the kernel), five
   steps, against the JAX blocked kernel in interpret mode and against the
   port's own ``ssprk2_step_wetdry(scheme="midpoint")``: 1e-11;
 - the blocked path has no adjoint for a wet/dry operator set and says so.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.ops import limiters as jlim
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_blocked as JB
from blitzdg_tpu.ops import sw2d_wetdry as jwd
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.ops import limiters as tlim
from blitzdg_tpu_torch.ops import sw2d as tsw
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.ops import sw2d_wetdry as twd

TOL = 1e-13
H_FLOOR = 1e-3
F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


def test_minmod_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 500))
    a[:20], b[20:40] = 0.0, 0.0  # zeros and equal pairs take the zero branch
    a[40:60] = b[40:60]
    _close([tlim.minmod(_t(a), _t(b))], [jlim.minmod(jnp.asarray(a),
                                                    jnp.asarray(b))], 0.0)


def test_surface_reconstruction_matches_jax():
    rng = np.random.default_rng(1)
    n = 600
    hM, hP = rng.uniform(0.0, 0.02, (2, n))  # around the floor
    hM[:100], hP[50:150] = 0.0, 0.0
    zM, zP = rng.uniform(-0.01, 0.01, (2, n))
    zP[200:300] = zM[200:300]  # continuous bed
    etaM, etaP = hM + zM, hP + zP
    want = jlim.surface_reconstruction(*(jnp.asarray(v) for v in
                                         (etaM, hM, etaP, hP)), H_FLOOR)
    got = tlim.surface_reconstruction(_t(etaM), _t(hM), _t(etaP), _t(hP),
                                      H_FLOOR)
    _close(got, want)
    assert float(torch.stack(got).min()) >= H_FLOOR


@pytest.mark.parametrize("weighted", [False, True])
def test_positivity_limiter_matches_jax(weighted):
    rng = np.random.default_rng(2)
    K, n_p = 40, 6
    h = rng.uniform(-0.01, 0.05, (3, K, n_p))
    h[:, :5] = 10.0 + rng.standard_normal((3, 5, n_p))  # wet: untouched
    h[:, 5:8] = 0.0  # all-dry elements: zero denominator
    hu, hv = rng.standard_normal((2, 3, K, n_p))
    w = rng.uniform(0.5, 1.5, n_p) if weighted else None
    want = jlim.positivity_preserving_limiter(
        jnp.asarray(h), jnp.asarray(hu), jnp.asarray(hv), H_FLOOR,
        None if w is None else jnp.asarray(w))
    got = tlim.positivity_preserving_limiter(
        _t(h), _t(hu), _t(hv), H_FLOOR, None if w is None else _t(w))
    _close(got, want)
    assert torch.equal(got[0][:, :5], _t(h)[:, :5])
    if not weighted:  # the arithmetic mean is kept
        np.testing.assert_allclose(got[0].mean(-1).numpy(), h.mean(-1),
                                   atol=1e-15)


class Beach:
    """Sloping beach H = 1 - 1.5 x on the unit box, dry beyond x = 2/3, on
    both sides in float64; drag, no well-balanced star flux."""

    def __init__(self, cells=(4, 4), n_order=2):
        mesh = j_box_triangles(*cells, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
        self.jc = jc = j_build(n_order, mesh)
        x = np.asarray(jc.x)
        self.H = H = 1.0 - 1.5 * x
        self.phys_np = dict(g=9.81, cd=1e-3, H=H, Hx=-1.5 * np.ones_like(H),
                            Hy=np.zeros_like(H), well_balanced=False)
        self.jphys = jsw.SWPhysics(**{
            k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in self.phys_np.items()})
        arrays, static = jax_arrays(jc)
        self.arrays, self.static = arrays, static
        self.tc = convert.context_from_numpy(arrays, static, device="cpu",
                                             dtype=F64)
        self.tphys = convert.physics_from_numpy(**self.phys_np, device="cpu",
                                                dtype=F64)

    def state(self, B=2, seed=4):
        """A disturbed surface and a current over the wet part, floor depth
        over the dry part."""
        rng = np.random.default_rng(seed)
        x, y = np.asarray(self.jc.x), np.asarray(self.jc.y)
        wave = 0.05 * np.exp(-30.0 * ((x - 0.45) ** 2 + (y - 0.5) ** 2))
        h = np.stack([np.maximum(self.H + (1.0 + b) * wave, H_FLOOR)
                      for b in range(B)])
        wet = h > 5.0 * H_FLOOR
        hu = wet * h * (0.3 + 0.05 * rng.standard_normal(h.shape))
        hv = wet * h * 0.1 * rng.standard_normal(h.shape)
        return h, hu, hv


@pytest.fixture(scope="module")
def beach():
    return Beach()


def test_beach_has_a_dry_region_and_a_wet_one(beach):
    h, _, _ = beach.state()
    assert (h <= H_FLOOR).any() and (h > 0.5).any()


def test_rhs_wetdry_matches_jax(beach):
    s = beach.state()
    want = jax.vmap(lambda one: jwd.sw2d_rhs_wetdry(
        beach.jc, one, 0.0, beach.jphys, H_FLOOR))(
            jsw.SWState(*map(jnp.asarray, s)))
    got = twd.sw2d_rhs_wetdry(beach.tc, tsw.SWState(*map(_t, s)), 0.0,
                              beach.tphys, H_FLOOR)
    _close(got, want)
    with pytest.raises(ValueError):  # no bathymetry
        twd.sw2d_rhs_wetdry(beach.tc, tsw.SWState(*map(_t, s)), 0.0,
                            tsw.SWPhysics(g=9.81))


@pytest.mark.parametrize("scheme", ["heun", "midpoint"])
def test_ssprk2_step_wetdry_matches_jax(beach, scheme):
    s = beach.state()
    dt = 2e-4
    want = jax.vmap(lambda one: jwd.ssprk2_step_wetdry(
        beach.jc, one, 0.0, dt, beach.jphys, H_FLOOR, scheme=scheme))(
            jsw.SWState(*map(jnp.asarray, s)))
    got = twd.ssprk2_step_wetdry(beach.tc, tsw.SWState(*map(_t, s)), 0.0, dt,
                                 beach.tphys, H_FLOOR, scheme=scheme)
    _close(got, want)
    assert float(got.h.min()) >= H_FLOOR - 1e-15


@pytest.fixture(scope="module")
def beach_rollout(beach):
    """Five wet/dry steps of the port's blocked rollout (plain version)."""
    ops, meta = convert.blocked_step_ops_from_numpy(
        beach.arrays, beach.static, beach.phys_np, wetdry=True,
        h_floor=H_FLOOR, device="cpu", dtype=F64)
    s = beach.state()
    dt, n_steps = 2e-4, 5
    flat = lambda a: _t(a).reshape(a.shape[0], -1)
    out = TB.sw2d_rollout_blocked(ops, meta, *map(flat, s), None, dt,
                                  n_steps=n_steps)
    return ops, meta, s, dt, n_steps, out


def test_blocked_wetdry_rollout_matches_jax_blocked(beach, beach_rollout):
    _, meta, s, dt, n_steps, out = beach_rollout
    assert meta.wetdry and meta.has_bathy and not meta.wb
    jops, jmeta = JB.build_blocked_step_ops(
        beach.jc, beach.jphys, dtype=jnp.float64, wetdry=True,
        h_floor=H_FLOOR)
    packed = [JB.pack_state(jmeta, jnp.asarray(f)) for f in s]
    want = JB.sw2d_rollout_blocked(jops, jmeta, *packed, None, dt,
                                   n_steps=n_steps, interpret=True)
    for got, w in zip(out, want):
        w = np.asarray(JB.unpack_state(jmeta, w))
        np.testing.assert_allclose(got.numpy().reshape(w.shape), w, rtol=0,
                                   atol=1e-11)


def test_blocked_wetdry_rollout_matches_own_stepper(beach, beach_rollout):
    _, _, s, dt, n_steps, out = beach_rollout
    cur = tsw.SWState(*map(_t, s))
    for _ in range(n_steps):
        cur = twd.ssprk2_step_wetdry(beach.tc, cur, 0.0, dt, beach.tphys,
                                     H_FLOOR, scheme="midpoint")
    for got, want in zip(out, cur):
        np.testing.assert_allclose(got.numpy().reshape(want.shape),
                                   want.numpy(), rtol=0, atol=1e-11)
    # the limiter did its work: the state differs from the unlimited scheme
    assert float(out[0].min()) >= H_FLOOR - 1e-15


def test_blocked_wetdry_set_has_no_adjoint(beach_rollout):
    ops, meta, s, dt, _, _ = beach_rollout
    with pytest.raises(NotImplementedError):
        TB.make_rollout_blocked(ops, meta, dt, 1)
    traj = [torch.zeros(2, 3, meta.n_v, dtype=F64)] * 6
    with pytest.raises(NotImplementedError):
        TB.sw2d_rollout_bwd_blocked(ops, meta, *traj,
                                    torch.zeros(2, 2, 1, dtype=F64), dt, 1)
    with pytest.raises(ValueError):  # wet/dry without bathymetry
        arrays, static = jax_arrays(j_build(1, j_box_triangles(2, 2)))
        convert.blocked_step_ops_from_numpy(arrays, static, dict(g=9.81),
                                            wetdry=True, device="cpu",
                                            dtype=F64)
