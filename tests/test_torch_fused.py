"""The module that holds the port's kernels (``ops/sw2d_fused.py``), on the
CPU through the kernels' plain versions.

 - step and rollout against the JAX Pallas kernels in interpret mode
   (float32; flat atol 5e-6, coastal with t0=1.0 atol 2e-5: the tolerances
   the JAX package's own kernel tests use), compared on unpadded (B, K, Np);
 - the same plain versions in float64 against a rollout of the port's own
   ``sw2d_rhs`` (1e-12; the JAX rollout kernels keep float32 scratch, so
   float64 parity goes through the gather RHS);
 - the hand-derived adjoint against ``torch.autograd`` through the plain
   rollout (float64, relative 1e-9), flat and coastal, N=1 and N=2;
 - the ``autograd.Function`` against ``jax.grad`` through the JAX
   ``make_rollout`` (interpret, float32, max-abs relative < 1e-4);
 - the headline's exact rest start: gradient finite and within 1e-4 of
   ``jax.grad``.

The operator set of the port is built here from the JAX context's numpy
arrays (``convert.step_ops_from_numpy``), so these tests do not depend on
parity of the set-up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops.sw2d_dense import build_dense_trace_ops as j_dense
from blitzdg_tpu.ops.sw2d_pallas import (build_pallas_step_ops,
                                         make_rollout as j_make_rollout,
                                         pad_state, sw2d_step_pallas,
                                         unpad_state)
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mpc import coastal_box as cbx
from blitzdg_tpu_torch.ops import sw2d as tsw
from blitzdg_tpu_torch.ops import sw2d_fused as F
from blitzdg_tpu_torch.timestepping import ssprk2_step

DT = 2e-3
TIDE = (12.0, 0.5, 2.0, 10.0)  # h0, amp, omega, ramp_tau


def jax_mesh(cells, xlim=(-1.0, 1.0), retag=True):
    jm = j_box_triangles(*cells, xlim=xlim, ylim=xlim)
    if retag:
        cbx.retag_east_open(jm)  # duck-typed: same mesh fields
    return jm


class Case:
    """One mesh/physics pair built on both sides from the same numpy data."""

    def __init__(self, coastal: bool, n_order: int = 1, cells=(3, 3)):
        self.coastal = coastal
        xlim = (0.0, 1.0) if coastal else (-1.0, 1.0)
        jm = jax_mesh(cells, xlim, retag=coastal)
        kw = dict(filter_cutoff=0.9 * n_order, filter_order=n_order)
        self.jc = jc = j_build(n_order, jm, dtype=jnp.float32, **kw)
        # float64 arrays of the same discretization, for the port's
        # float64 operator sets
        jc64 = j_build(n_order, jm, dtype=jnp.float64, **kw)
        x, y = np.asarray(jc64.x), np.asarray(jc64.y)
        self.bump = np.exp(-8.0 * (x ** 2 + y ** 2))
        self.BU = np.stack([self.bump, 0 * self.bump])
        self.BV = np.stack([0 * self.bump, self.bump])
        if coastal:
            H = 10.0 + 3.0 * x + 1.0 * np.sin(2.0 * y)
            Hx, Hy = 3.0 * np.ones_like(H), 2.0 * np.cos(2.0 * y)
            self.tidal = TIDE
            pk = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy)
            self.jphys = jsw.SWPhysics(
                g=9.81, cd=2.5e-3, f_cor=1e-4,
                H=jnp.asarray(H, jnp.float32), Hx=jnp.asarray(Hx, jnp.float32),
                Hy=jnp.asarray(Hy, jnp.float32))
        else:
            H = 10.0 + 0.0 * x
            self.tidal = None
            pk = dict(g=9.81)
            self.jphys = jsw.SWPhysics(g=9.81)
        self.H, self.phys_kwargs = H, pk
        self.jops, self.jmeta = build_pallas_step_ops(
            jc, j_dense(jc), self.jphys, self.BU, self.BV, tidal=self.tidal)
        self.arrays32 = jax_arrays(jc)
        self.arrays64 = jax_arrays(jc64)

    def ops(self, dtype):
        arrays, static = (self.arrays64 if dtype == torch.float64
                          else self.arrays32)
        return convert.step_ops_from_numpy(
            arrays, static, self.phys_kwargs, self.BU, self.BV,
            tidal=self.tidal, device="cpu", dtype=dtype)

    def ctx_phys64(self):
        arrays, static = self.arrays64
        ctx = convert.context_from_numpy(arrays, static, device="cpu",
                                         dtype=torch.float64)
        phys = convert.physics_from_numpy(**self.phys_kwargs, device="cpu",
                                          dtype=torch.float64)
        return ctx, phys

    def state(self, B, seed=0, rough=0.1):
        """Generic state: rest + smooth bump + noise, uniform current."""
        rng = np.random.default_rng(seed)
        x, y = np.asarray(self.arrays64[0]["x"]), np.asarray(self.arrays64[0]["y"])
        h = (self.H + 0.2 * np.exp(-10.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2)))[None] \
            + rough * rng.standard_normal((B,) + self.H.shape)
        hu = 0.1 * h + rough * rng.standard_normal(h.shape)
        hv = -0.05 * h + rough * rng.standard_normal(h.shape)
        return h, hu, hv


@pytest.fixture(scope="module")
def flat():
    return Case(coastal=False)


@pytest.fixture(scope="module")
def coastal():
    return Case(coastal=True)


def _pick(request, name):
    return request.getfixturevalue(name)


def _jax_padded(case, s, ctrls):
    m = case.jmeta
    hp = pad_state(m, jnp.asarray(s[0], jnp.float32), 1.0)
    hup = pad_state(m, jnp.asarray(s[1], jnp.float32), 0.0)
    hvp = pad_state(m, jnp.asarray(s[2], jnp.float32), 0.0)
    pad = [(0, 0)] * (ctrls.ndim - 1) + [(0, m.cp - ctrls.shape[-1])]
    return hp, hup, hvp, jnp.pad(jnp.asarray(ctrls, jnp.float32), pad)


@pytest.mark.parametrize("name,atol,t0", [("flat", 5e-6, 0.0),
                                          ("coastal", 2e-5, 1.0)])
def test_step_plain_matches_pallas_interpret(request, name, atol, t0):
    case = _pick(request, name)
    B = 4
    s = case.state(B)
    ctrl = 0.3 * np.random.default_rng(3).standard_normal((B, 2))
    hp, hup, hvp, cp = _jax_padded(case, s, ctrl)
    ref = sw2d_step_pallas(case.jops, case.jmeta, hp, hup, hvp, cp, DT,
                           interpret=True, tile_b=B, t0=t0)
    ops, meta = case.ops(torch.float32)
    flat_s = [torch.as_tensor(a, dtype=torch.float32).reshape(B, -1) for a in s]
    got = F.sw2d_step_fused(ops, meta, *flat_s,
                            torch.as_tensor(ctrl, dtype=torch.float32), DT,
                            True, t0)
    for a, b in zip(got, ref):
        b = np.asarray(unpad_state(case.jmeta, b, meta.k_elem))
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name,atol,t0", [("flat", 5e-6, 0.0),
                                          ("coastal", 2e-5, 1.0)])
def test_rollout_plain_matches_pallas_interpret(request, name, atol, t0):
    case = _pick(request, name)
    B, H, SPC = 2, 2, 2
    s = case.state(B)
    ctrls = 0.3 * np.random.default_rng(5).standard_normal((B, H, 2))
    hp, hup, hvp, cp = _jax_padded(case, s, ctrls)
    rollout = j_make_rollout(case.jops, case.jmeta, DT, SPC, interpret=True,
                             tile_b=B, t0=t0)
    ref = rollout(hp, hup, hvp, cp)
    ops, meta = case.ops(torch.float32)
    flat_s = [torch.as_tensor(a, dtype=torch.float32).reshape(B, -1) for a in s]
    got = F.sw2d_rollout_fused(ops, meta, *flat_s,
                               torch.as_tensor(ctrls, dtype=torch.float32),
                               DT, SPC, True, t0)
    assert got[0].shape == (B, H * SPC + 1, meta.n_v)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :, :meta.n_v],
                                   rtol=0, atol=atol)


def _tidal_np(t):
    h0, amp, omega, tau = TIDE
    return h0 + amp * np.cos(omega * t) * min(t / tau, 1.0)


@pytest.mark.parametrize("name,t0", [("flat", 0.0), ("coastal", 1.0)])
def test_rollout_plain_float64_matches_gather_rhs(request, name, t0):
    """float64: plain step/rollout == SSP-RK2 over the port's own sw2d_rhs
    with the control forcing added, at 1e-12."""
    case = _pick(request, name)
    B, H, SPC = 3, 2, 2
    ops, meta = case.ops(torch.float64)
    ctx, phys = case.ctx_phys64()
    s = [torch.as_tensor(a) for a in case.state(B)]
    ctrls = torch.as_tensor(
        0.3 * np.random.default_rng(5).standard_normal((B, H, 2)))
    bump = torch.as_tensor(case.bump)
    tf = _tidal_np if case.coastal else None
    post = lambda f: tsw.apply_filter(ctx, f)

    st, t, ref = tsw.SWState(*s), t0, [tsw.SWState(*s)]
    for i in range(H * SPC):
        c = ctrls[:, i // SPC]

        def rhs(ss, tt):
            r = tsw.sw2d_rhs(ctx, ss, tt, phys, tidal_forcing=tf)
            return tsw.SWState(r.h, r.hu + c[:, 0, None, None] * bump,
                               r.hv + c[:, 1, None, None] * bump)

        st = ssprk2_step(rhs, st, t, DT, post_stage=post)
        t += DT
        ref.append(st)
    flat_s = [a.reshape(B, -1) for a in s]
    got = F.sw2d_rollout_plain(ops, meta, *flat_s, ctrls, DT, SPC, True, t0)
    for f in range(3):
        for i, r in enumerate(ref):
            np.testing.assert_allclose(got[f][:, i].numpy(),
                                       r[f].reshape(B, -1).numpy(),
                                       rtol=1e-12, atol=1e-12)
    one = F.sw2d_step_plain(ops, meta, *flat_s, ctrls[:, 0], DT, True, t0)
    for f in range(3):
        np.testing.assert_allclose(one[f].numpy(),
                                   ref[1][f].reshape(B, -1).numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("is_coastal", [False, True], ids=["flat", "coastal"])
@pytest.mark.parametrize("n_order", [1, 2], ids=["N1", "N2"])
def test_hand_adjoint_matches_autograd_float64(is_coastal, n_order):
    """sw2d_rollout_bwd_plain (hand-derived, no autograd) against
    torch.autograd through sw2d_rollout_plain, all four cotangents, with a
    random trajectory cotangent: relative 1e-9 in float64."""
    case = Case(is_coastal, n_order=n_order, cells=(2, 2))
    ops, meta = case.ops(torch.float64)
    B, H, SPC, t0 = 2, 2, 2, (1.0 if is_coastal else 0.0)
    rng = np.random.default_rng(11)
    x = [torch.as_tensor(a).reshape(B, -1).requires_grad_(True)
         for a in case.state(B, seed=2)]
    c = torch.as_tensor(0.3 * rng.standard_normal((B, H, 2))).requires_grad_(True)
    traj = F.sw2d_rollout_plain(ops, meta, *x, c, DT, SPC, True, t0)
    tb = [torch.as_tensor(rng.standard_normal(tuple(a.shape))) for a in traj]
    want = torch.autograd.grad(sum((a * b).sum() for a, b in zip(traj, tb)),
                               [*x, c])
    got = F.sw2d_rollout_bwd_fused(ops, meta, *[a.detach() for a in traj],
                                   *tb, c.detach(), DT, SPC, True, t0)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-9


def _loss_torch(case, rollout, x, c, H, SPC):
    th, thu, _ = rollout(*x, c)
    Hr = torch.as_tensor(case.H, dtype=torch.float32).reshape(1, -1)
    t = H * SPC
    return ((th[:, t] - Hr) ** 2).sum() + 0.1 * (thu[:, t] ** 2).sum()


def _loss_jax(case, rollout, H, SPC):
    m = case.jmeta
    vm = (jnp.arange(m.n_vp) < m.n_v).astype(jnp.float32)
    Hp = pad_state(m, jnp.asarray(case.H, jnp.float32)[None], 0.0)[0]

    def loss(h0, hu0, hv0, cs):
        hp = pad_state(m, h0, 1.0)
        hup = pad_state(m, hu0, 0.0)
        hvp = pad_state(m, hv0, 0.0)
        cpd = jnp.pad(cs, ((0, 0), (0, 0), (0, m.cp - 2)))
        th, thu, _ = rollout(hp, hup, hvp, cpd)
        t = H * SPC
        return (jnp.sum(vm * (th[:, t] - Hp) ** 2)
                + 0.1 * jnp.sum(vm * thu[:, t] ** 2))

    return loss


def _grad_pair(case, s, ctrls, H, SPC, t0):
    B = s[0].shape[0]
    jr = j_make_rollout(case.jops, case.jmeta, DT, SPC, interpret=True,
                        tile_b=B, t0=t0)
    js = [jnp.asarray(a, jnp.float32) for a in s]
    jl = _loss_jax(case, jr, H, SPC)
    v0 = float(jl(*js, jnp.asarray(ctrls, jnp.float32)))
    g0 = jax.grad(jl, argnums=(0, 1, 2, 3))(*js, jnp.asarray(ctrls, jnp.float32))

    ops, meta = case.ops(torch.float32)
    tr = F.make_rollout(ops, meta, DT, SPC, use_filter=True, t0=t0)
    x = [torch.as_tensor(a, dtype=torch.float32).reshape(B, -1)
         .requires_grad_(True) for a in s]
    c = torch.as_tensor(ctrls, dtype=torch.float32).requires_grad_(True)
    v1 = _loss_torch(case, tr, x, c, H, SPC)
    g1 = torch.autograd.grad(v1, [*x, c])
    return v0, g0, float(v1), g1


@pytest.mark.parametrize("name,t0", [("flat", 0.0), ("coastal", 1.0)])
def test_autograd_function_matches_jax_grad(request, name, t0):
    """Loss on the final state as in the JAX package's coastal kernel test;
    gradients w.r.t. (h0, hu0, hv0, controls), max-abs relative < 1e-4."""
    case = _pick(request, name)
    B, H, SPC = 2, 2, 2
    s = case.state(B, rough=0.0 if case.coastal else 0.05)
    ctrls = 0.3 * np.random.default_rng(5).standard_normal((B, H, 2))
    v0, g0, v1, g1 = _grad_pair(case, s, ctrls, H, SPC, t0)
    np.testing.assert_allclose(v1, v0, rtol=1e-4)
    for a, b in zip(g1, g0):
        a, b = a.numpy().reshape(-1), np.asarray(b).reshape(-1)
        assert np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30) < 1e-4


def test_headline_rest_start_gradient_matches_jax_grad():
    """The headline's exact start (h = H, no flow, zero controls, t0 = 0):
    every face has equal '-' and '+' speeds there, so the tie rules are in
    play. The gradient of the terminal tracking cost must be finite and
    within 1e-4 (relative to the max) of jax.grad through the JAX kernels."""
    B, Hn, SPC = 2, 2, 2
    jm = jax_mesh((4, 5))
    jc = j_build(1, jm, dtype=jnp.float32, filter_cutoff=0.9, filter_order=1)
    x, y = np.asarray(jc.x, np.float64), np.asarray(jc.y, np.float64)
    xmin, span = -1.0, 2.0
    H = 8.0 + 4.0 * (x - xmin) / span
    Hx, Hy = (4.0 / span) * np.ones_like(H), np.zeros_like(H)
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    BU, BV = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
    jphys = jsw.SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4,
                          H=jnp.asarray(H, jnp.float32),
                          Hx=jnp.asarray(Hx, jnp.float32),
                          Hy=jnp.asarray(Hy, jnp.float32))
    jops, jmeta = build_pallas_step_ops(jc, j_dense(jc), jphys, BU, BV,
                                        tidal=cbx.TIDAL)
    dt = 4.9e-3
    offs = np.linspace(-0.3, 0.3, B)
    tgt = 1e-3 * np.exp(-5.0 * ((x[None] - offs[:, None, None]) ** 2
                                + y[None] ** 2))
    h0 = np.broadcast_to(np.asarray(jphys.H), (B,) + H.shape)

    jr = j_make_rollout(jops, jmeta, dt, SPC, interpret=True, tile_b=B)
    vm = (jnp.arange(jmeta.n_vp) < jmeta.n_v).astype(jnp.float32)
    Hp = pad_state(jmeta, jphys.H[None], 0.0)
    tp = pad_state(jmeta, jnp.asarray(tgt, jnp.float32), 0.0)

    def jloss(h, cs):
        hp = pad_state(jmeta, h, 1.0)
        z = jnp.zeros_like(hp)
        cpd = jnp.pad(cs, ((0, 0), (0, 0), (0, jmeta.cp - 2)))
        th, _, _ = jr(hp, z, z, cpd)
        return jnp.sum(vm * (th[:, Hn * SPC] - Hp - tp) ** 2)

    g0 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h0, jnp.float32),
                                         jnp.zeros((B, Hn, 2), jnp.float32))

    arrays, static = jax_arrays(jc)
    ops, meta = convert.step_ops_from_numpy(
        arrays, static, dict(g=9.81, cd=2.5e-3, f_cor=1e-4,
                             H=np.asarray(jphys.H), Hx=Hx, Hy=Hy),
        BU, BV, tidal=cbx.TIDAL, device="cpu", dtype=torch.float32)
    tr = F.make_rollout(ops, meta, dt, SPC)
    h = torch.as_tensor(h0.copy(), dtype=torch.float32).reshape(B, -1) \
        .requires_grad_(True)
    c = torch.zeros((B, Hn, 2), dtype=torch.float32, requires_grad=True)
    z = torch.zeros_like(h)
    th, _, _ = tr(h, z, z, c)
    Hr = torch.as_tensor(np.asarray(jphys.H)).reshape(1, -1)
    tt = torch.as_tensor(tgt, dtype=torch.float32).reshape(B, -1)
    loss = ((th[:, Hn * SPC] - Hr - tt) ** 2).sum()
    g1 = torch.autograd.grad(loss, [h, c])
    gh = g1[0].numpy().reshape(B, -1)
    jh = np.asarray(g0[0]).reshape(B, -1)
    gc, jcg = g1[1].numpy(), np.asarray(g0[1])[..., :2]
    for a, b in ((gh, jh), (gc, jcg)):
        assert np.all(np.isfinite(a))
        assert np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30) < 1e-4


def test_wrappers_raise_on_wrong_inputs(flat):
    ops, meta = flat.ops(torch.float32)
    B = 2
    h = torch.full((B, meta.n_v), 10.0)
    z = torch.zeros_like(h)
    with pytest.raises(ValueError):
        F.sw2d_step_fused(ops, meta, h[:, :-1], z, z, torch.zeros(B, 2), DT)
    with pytest.raises(ValueError):
        F.sw2d_step_fused(ops, meta, h, z.double(), z, torch.zeros(B, 2), DT)
    with pytest.raises(ValueError):
        F.sw2d_rollout_fused(ops, meta, h, z, z, torch.zeros(B, 2, 3), DT, 2)
    traj = [torch.zeros(B, 4, meta.n_v)] * 6
    with pytest.raises(ValueError):
        F.sw2d_rollout_bwd_fused(ops, meta, *traj, torch.zeros(B, 2, 2), DT, 2)


def test_cpu_path_counts_no_launch(flat):
    """The launch counters move only where a kernel is launched."""
    ops, meta = flat.ops(torch.float32)
    before = (F.sw2d_step_fused.launches, F.sw2d_rollout_fused.launches,
              F.sw2d_rollout_bwd_fused.launches)
    h = torch.full((1, meta.n_v), 10.0)
    z = torch.zeros_like(h)
    F.sw2d_step_fused(ops, meta, h, z, z, torch.zeros(1, 2), DT)
    F.sw2d_rollout_fused(ops, meta, h, z, z, torch.zeros(1, 1, 2), DT, 1)
    assert before == (F.sw2d_step_fused.launches,
                      F.sw2d_rollout_fused.launches,
                      F.sw2d_rollout_bwd_fused.launches)
