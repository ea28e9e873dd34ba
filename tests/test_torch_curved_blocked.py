"""The curved path's kernel module (``ops/sw2d_curved_blocked.py``) on the
CPU, through the kernels' plain versions, against the JAX package's curved
Pallas kernels in interpret mode (float64), compared at the unpacked
(B, K, Np) boundary:

 - step, 3 steps, (box, affine) and (disk, general) x filter on/off, with
   drag and Coriolis: 1e-12;
 - rollout with per-block controls (2 steps per control): every stored
   trajectory row and the final fields 1e-12; the rollout's last row equals
   stepping; bed slope against the JAX kernel;
 - the hand adjoint (plain backward, no autograd) against ``torch.autograd``
   through the plain forward, with drag, Coriolis and bed slope, random
   cotangents on all four trajectories and ``None`` on three: 1e-9
   relative; the ``autograd.Function`` against ``jax.grad`` through the JAX
   ``make_curved_rollout_blocked(interpret=True)`` for states and controls:
   rtol 1e-9, atol 1e-14;
 - the rest start, where every speed ties: the speed's cotangent vanishes
   with the jumps, so the tie rules cannot show; against autograd 1e-9 and
   against ``jax.grad`` (whose face maximum splits ties unevenly);
 - the control cotangent is the product of the post-filter cotangent with
   the folded injectors; a wrapper refuses a ``use_filter`` other than the
   one the set was frozen with;
 - input checks, launch counters, work-unit size, and that a CUDA-only call
   raises here instead of taking the plain version.

The port's operator set is built from the JAX contexts' numpy arrays
(``convert.curved_blocked_ops_from_numpy``), so these tests do not depend on
parity of the set-up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_curved_blocked as JC

from torch_parity import jax_arrays, jax_curved_contexts, jax_fields

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC

F64 = torch.float64
DT = 2e-4


class Pair:
    """One curved discretization and physics on both sides, float64."""

    def __init__(self, geom="disk", phys=None, controls=True, bed=False,
                 use_filter=True, mass_mode="auto"):
        self.jctx, self.jcub, self.jgauss = jax_curved_contexts(geom)
        self.x, self.y = np.asarray(self.jctx.x), np.asarray(self.jctx.y)
        phys = dict(g=9.81) if phys is None else phys
        bump = np.exp(-8.0 * (self.x ** 2 + self.y ** 2))
        bu = np.stack([bump, 0 * bump]) if controls else None
        bv = np.stack([0 * bump, bump]) if controls else None
        zx = 0.1 * np.cos(self.x) if bed else None
        zy = 0.05 * np.sin(2.0 * self.y) if bed else None
        self.use_filter = use_filter
        self.jops, self.jmeta = JC.build_curved_blocked_ops(
            self.jctx, self.jcub, self.jgauss, jsw.SWPhysics(**phys),
            forcing_bu=bu, forcing_bv=bv, zx=zx, zy=zy, dtype=jnp.float64,
            mass_mode=mass_mode, use_filter=use_filter)
        arrays, static = jax_arrays(self.jctx)
        self.ops, self.meta = convert.curved_blocked_ops_from_numpy(
            arrays, static, jax_fields(self.jcub), jax_fields(self.jgauss),
            phys, bu, bv, zx, zy, mass_mode=mass_mode, use_filter=use_filter,
            device="cpu", dtype=F64)

    def pack(self, f):  # (B, K, Np) numpy -> JAX packed
        return JC.pack_curved(self.jmeta, jnp.asarray(f))

    def unpack(self, f):
        return np.asarray(JC.unpack_curved(self.jmeta, f))

    def flat(self, f):  # (B, K, Np) numpy -> (B, nV) torch
        return torch.as_tensor(np.asarray(f), dtype=F64).reshape(
            f.shape[0], -1)

    def close(self, got, want_packed, atol=1e-12):
        want = self.unpack(want_packed)
        np.testing.assert_allclose(got.detach().numpy().reshape(want.shape),
                                   want, rtol=0, atol=atol)

    def state(self, B=2):
        """Smooth and without symmetry, so that no two speeds tie."""
        eta = 0.05 * np.exp(-4.0 * ((self.x - 0.13) ** 2
                                    + (self.y + 0.07) ** 2))
        amp = (1.0 + 0.5 * np.arange(B))[:, None, None]
        return (1.0 + amp * eta, 0.02 * amp * eta + 0.01 * (1 + 0.3 * self.x),
                -0.01 * amp * eta + 0.004 * self.y, 0.5 + 0.3 * amp * eta)

    def rest(self, B=2):
        one = np.ones((B,) + self.x.shape)
        return one, 0 * one, 0 * one, 0 * one


@pytest.mark.parametrize("geom,mass_mode", [("box", "affine"),
                                            ("disk", "general")])
@pytest.mark.parametrize("use_filter", [True, False])
def test_step_matches_jax_kernel(geom, mass_mode, use_filter):
    p = Pair(geom, dict(g=9.81, cd=2e-3, f_cor=1e-4), controls=False,
             use_filter=use_filter, mass_mode=mass_mode)
    assert p.meta.mass_mode == p.jmeta.mass_mode == mass_mode
    s = p.state()
    want, got = [p.pack(f) for f in s], [p.flat(f) for f in s]
    for _ in range(3):
        want = JC.sw2d_curved_step_blocked(p.jops, p.jmeta, *want, None, DT,
                                           use_filter=use_filter,
                                           interpret=True)
        got = TC.sw2d_curved_step_blocked(p.ops, p.meta, *got, None, DT,
                                          use_filter=use_filter)
    assert len(got) == 4
    for g, w in zip(got, want):
        p.close(g, w)


@pytest.fixture(scope="module")
def disk():
    return Pair("disk")


def test_rollout_rows_match_jax_kernel_and_stepping(disk):
    p = disk
    s = p.state()
    spc, n_cs = 2, 3
    ctrls = 0.05 * np.random.default_rng(0).standard_normal((2, n_cs, 2))
    want = JC.sw2d_curved_rollout_blocked(
        p.jops, p.jmeta, *map(p.pack, s), jnp.asarray(ctrls), DT, spc=spc,
        store_traj=True, interpret=True)
    got = TC.sw2d_curved_rollout_blocked(
        p.ops, p.meta, *map(p.flat, s), torch.as_tensor(ctrls), DT, spc=spc,
        store_traj=True)
    assert len(got) == 8 and got[0].shape == (2, n_cs * spc + 1, p.meta.n_v)
    for g, w in zip(got, want):  # four trajectories, four final fields
        p.close(g, w)
    # without the trajectories: the same final fields, and equal to stepping
    final = TC.sw2d_curved_rollout_blocked(
        p.ops, p.meta, *map(p.flat, s), torch.as_tensor(ctrls), DT, spc=spc)
    S = tuple(map(p.flat, s))
    for t in range(n_cs * spc):
        S = TC.sw2d_curved_step_blocked(
            p.ops, p.meta, *S, torch.as_tensor(ctrls[:, t // spc]), DT)
    for f, g, st in zip(final, got[4:], S):
        assert torch.equal(f, g)
        np.testing.assert_allclose(st.numpy(), g.numpy(), rtol=0, atol=1e-14)
    # no controls: n_steps is required and used
    free = TC.sw2d_curved_rollout_blocked(p.ops, p.meta, *map(p.flat, s),
                                          None, DT, n_steps=2)
    want = JC.sw2d_curved_rollout_blocked(p.jops, p.jmeta, *map(p.pack, s),
                                          None, DT, n_steps=2, interpret=True)
    for g, w in zip(free, want):
        p.close(g, w)
    with pytest.raises(ValueError):
        TC.sw2d_curved_rollout_blocked(p.ops, p.meta, *map(p.flat, s), None,
                                       DT)


def test_bed_slope_step_matches_jax_kernel():
    p = Pair("disk", dict(g=9.81, cd=2e-3, f_cor=1e-2), bed=True)
    assert p.meta.has_bed
    s = p.state()
    c = 0.05 * np.random.default_rng(1).standard_normal((2, 2))
    want = JC.sw2d_curved_step_blocked(p.jops, p.jmeta, *map(p.pack, s),
                                       jnp.asarray(c), DT, interpret=True)
    got = TC.sw2d_curved_step_blocked(p.ops, p.meta, *map(p.flat, s),
                                      torch.as_tensor(c), DT)
    for g, w in zip(got, want):
        p.close(g, w)


def _autograd_reference(p, S, ctrls, tb, spc):
    """Gradients of sum <trajectory, cotangent> through the plain forward."""
    S = [f.clone().requires_grad_(True) for f in S]
    c = ctrls.clone().requires_grad_(True)
    traj = TC.sw2d_curved_rollout_blocked_plain(
        p.ops, p.meta, *S, c, DT, spc, None, p.use_filter, True)[:4]
    loss = sum((a * b).sum() for a, b in zip(traj, tb) if b is not None)
    grads = torch.autograd.grad(loss, S + [c], allow_unused=True)
    # nothing reads the tracer when only the depth has a cotangent
    return ([t.detach() for t in traj],
            [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, S + [c])])


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-300))


@pytest.mark.parametrize("case", ["disk_flat", "disk_sources_nofilter",
                                  "box_affine_sources"])
@pytest.mark.parametrize("depth_only", [False, True],
                         ids=["four_cotangents", "depth_only"])
def test_hand_adjoint_matches_autograd(case, depth_only):
    geom = "box" if case.startswith("box") else "disk"
    sources = "sources" in case
    p = Pair(geom, dict(g=9.81, cd=2e-3, f_cor=1e-1) if sources else None,
             bed=sources, use_filter="nofilter" not in case)
    spc, n_cs = 2, 2
    rng = np.random.default_rng(2)
    S = [p.flat(f) for f in p.state()]
    ctrls = torch.as_tensor(0.05 * rng.standard_normal((2, n_cs, 2)))
    tb = [torch.as_tensor(rng.standard_normal((2, n_cs * spc + 1,
                                               p.meta.n_v)))
          for _ in range(4)]
    if depth_only:
        tb = [tb[0], None, None, None]
    traj, want = _autograd_reference(p, S, ctrls, tb, spc)
    got = TC.sw2d_curved_rollout_bwd_blocked(p.ops, p.meta, traj, tb, ctrls,
                                             DT, spc, p.use_filter)
    assert len(got) == 5 and got[4].shape == ctrls.shape
    for g, w in zip(got, want):
        if float(w.abs().max()) > 0:
            assert _rel(g, w) < 1e-9
        else:
            assert float(g.abs().max()) == 0.0


def test_autograd_function_matches_jax_grad(disk):
    """All five gradients of a cost on the depth trajectory (as the MPC cost
    reads it) through the port's ``autograd.Function`` (three trajectories
    get ``None``) against ``jax.grad`` through the JAX kernels."""
    p = disk
    spc, n_cs = 2, 2
    rng = np.random.default_rng(4)
    s = p.state()
    ctrls = 0.05 * rng.standard_normal((2, n_cs, 2))
    w = rng.standard_normal((2, n_cs, p.jctx.k_elem, p.jctx.n_p))

    jroll = JC.make_curved_rollout_blocked(p.jops, p.jmeta, DT, spc,
                                           interpret=True)

    def jcost(h, hu, hv, hN, c):
        th, *_ = jroll(h, hu, hv, hN, c)
        return jnp.sum(th[:, spc::spc] * JC.pack_curved(p.jmeta,
                                                        jnp.asarray(w)))

    want = jax.grad(jcost, argnums=(0, 1, 2, 3, 4))(*map(p.pack, s),
                                                    jnp.asarray(ctrls))
    roll = TC.make_curved_rollout_blocked(p.ops, p.meta, DT, spc)
    S = [p.flat(f).requires_grad_(True) for f in s]
    c = torch.as_tensor(ctrls).requires_grad_(True)
    th, *_ = roll(*S, c)
    cost = (th[:, spc::spc] * torch.as_tensor(w).reshape(2, n_cs, -1)).sum()
    got = torch.autograd.grad(cost, S + [c])
    for g, jw in zip(got[:4], want[:4]):
        ref = p.unpack(jw)
        np.testing.assert_allclose(g.numpy().reshape(ref.shape), ref,
                                   rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-9,
                               atol=1e-14)


def test_rest_start_ties_carry_no_speed_cotangent(disk):
    """From rest every Gauss point of every face has the same speed on both
    sides: an 8-way tie of the face maximum and an M/P tie at each point.
    All jumps vanish with it, so the speed's cotangent does too, and how a
    tie is split cannot matter: the hand adjoint (even split), autograd and
    ``jax.grad`` through the JAX kernel (uneven roll-chain split) agree."""
    p = disk
    m, o = p.meta, p.ops
    spc, n_cs = 2, 2
    S = [p.flat(f) for f in p.rest()]
    N = [f.reshape(2, m.k_elem, m.n_p) for f in S]
    M, P = TC._gauss_values(o, m, N)
    spd = torch.maximum(TC._speed(M, m.g), TC._speed(P, m.g))
    assert float((spd - np.sqrt(9.81)).abs().max()) < 1e-14  # all tie
    assert max(float((a - b).abs().max()) for a, b in zip(M, P)) < 1e-15

    ctrls = torch.zeros((2, n_cs, 2), dtype=F64)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((2, n_cs * spc + 1, m.k_elem, m.n_p))
    tb = [torch.as_tensor(w).reshape(2, n_cs * spc + 1, -1), None, None, None]
    traj, want = _autograd_reference(p, S, ctrls, tb, spc)
    got = TC.sw2d_curved_rollout_bwd_blocked(o, m, traj, tb, ctrls, DT, spc)
    for g, a in zip(got, want):
        if float(a.abs().max()) > 0:
            assert _rel(g, a) < 1e-9
        else:  # the tracer's cotangent: nothing reads hN
            assert float(g.abs().max()) == 0.0

    jroll = JC.make_curved_rollout_blocked(p.jops, p.jmeta, DT, spc,
                                           interpret=True)
    jw = JC.pack_curved(p.jmeta, jnp.asarray(w))
    jgrad = jax.grad(lambda c: jnp.sum(jroll(*map(p.pack, p.rest()), c)[0]
                                       * jw))(jnp.zeros((2, n_cs, 2)))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(jgrad), rtol=1e-9,
                               atol=1e-14)


def test_control_cotangent_uses_the_post_filter_cotangent(disk):
    """One RHS: d/dc <W, R(S, c)> = <W, folded injectors>, whatever the
    filter does to the rest of the RHS; and the folded injectors are the
    injectors times filter^T."""
    p = disk
    m, o = p.meta, p.ops
    rng = np.random.default_rng(6)
    S = [p.flat(f) for f in p.state()]
    W = [torch.as_tensor(rng.standard_normal((2, m.n_v))) for _ in range(4)]
    _, cb = TC._curved_rhs_vjp_plain(o, m, S, W, True)
    want = torch.stack([W[1] @ o.BU[c] + W[2] @ o.BV[c] for c in range(2)], 1)
    np.testing.assert_allclose(cb.numpy(), want.numpy(), rtol=1e-13)
    raw = Pair("disk", use_filter=False)
    fold = (raw.ops.BU.reshape(2, m.k_elem, m.n_p) @ o.filt.T).reshape(2, -1)
    np.testing.assert_allclose(o.BU.numpy(), fold.numpy(), rtol=0, atol=1e-14)
    assert m.filter_folded and not raw.meta.filter_folded
    ctrl = torch.zeros((2, 2), dtype=F64)
    with pytest.raises(ValueError, match="use_filter"):
        TC.sw2d_curved_step_blocked(o, m, *S, ctrl, DT, use_filter=False)
    with pytest.raises(ValueError, match="use_filter"):
        TC.sw2d_curved_rollout_blocked(raw.ops, raw.meta, *S, ctrl[:, None],
                                       DT, use_filter=True)
    # without controls nothing is folded, so either setting is taken
    TC.sw2d_curved_step_blocked(o, m, *S, None, DT, use_filter=False)


def test_wrappers_check_their_inputs_and_count_only_kernel_launches(disk):
    p = disk
    m, o = p.meta, p.ops
    S = [p.flat(f) for f in p.state()]
    ctrls = torch.zeros((2, 2, 2), dtype=F64)
    before = [w.launches for w in (TC.sw2d_curved_step_blocked,
                                   TC.sw2d_curved_rollout_blocked,
                                   TC.sw2d_curved_rollout_bwd_blocked)]
    traj = TC.sw2d_curved_rollout_blocked(o, m, *S, ctrls, DT, spc=1,
                                          store_traj=True)[:4]
    with pytest.raises(ValueError):  # wrong field shape
        TC.sw2d_curved_step_blocked(o, m, S[0][:, :-1], *S[1:], None, DT)
    with pytest.raises(ValueError):  # wrong dtype of one field
        TC.sw2d_curved_step_blocked(o, m, S[0], S[1].float(), *S[2:], None, DT)
    with pytest.raises(ValueError):  # controls of the wrong width
        TC.sw2d_curved_rollout_blocked(o, m, *S, ctrls[..., :1], DT)
    with pytest.raises(ValueError):  # trajectory and controls disagree
        TC.sw2d_curved_rollout_bwd_blocked(o, m, traj, traj, ctrls, DT, 2)
    with pytest.raises(ValueError):  # three trajectories
        TC.sw2d_curved_rollout_bwd_blocked(o, m, traj[:3], traj, ctrls, DT, 1)
    after = [w.launches for w in (TC.sw2d_curved_step_blocked,
                                  TC.sw2d_curved_rollout_blocked,
                                  TC.sw2d_curved_rollout_bwd_blocked)]
    assert after == before  # plain versions do not count
    # work unit: elements x scenarios, one thread each; K=24 at B=2 is one
    # unit of every element and both scenarios
    assert TC.unit_shape(m, 2) == (24, 2, 64) and TC.n_units(m, 2) == 1
    assert m.n_tr == 3 * m.n_gauss and m.n_t == m.k_elem * m.n_tr
    # the packed buffers hold what the kernels' source unpacks, in order
    sizes = [getattr(o, k).numel() for k in TC._FORDER]
    assert o.fbuf.numel() == sum(sizes) and o.fbuf.dtype == torch.float32
    assert o.ibuf.numel() == 3 * m.n_t + 1
    off = sum(sizes[:TC._FORDER.index("GNX")])
    np.testing.assert_array_equal(o.fbuf[off:off + m.n_t].numpy(),
                                  o.GNX.float().numpy())
    ptr = o.ibuf[m.n_t:2 * m.n_t + 1].numpy()
    idx = o.ibuf[2 * m.n_t + 1:].numpy()
    mapP = o.ibuf[:m.n_t].numpy()
    assert ptr[0] == 0 and ptr[-1] == m.n_t
    for i in (0, 7, m.n_t - 1):  # the inverse map inverts the gather
        assert all(mapP[q] == i for q in idx[ptr[i]:ptr[i + 1]])


def test_cuda_tensors_never_reach_the_plain_version(disk):
    """Float64 states are refused by the kernel path; here that can only be
    shown on the meta device, which is not the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernels would launch")
    p = disk
    S = [torch.empty((2, p.meta.n_v), dtype=F64, device="meta")
         for _ in range(4)]
    with pytest.raises((TypeError, RuntimeError, NotImplementedError)):
        TC.sw2d_curved_step_blocked(p.ops, p.meta, *S, None, DT)
