"""The blocked path's kernel module (``ops/sw2d_blocked.py``) on the CPU,
through the kernels' plain versions, against the JAX package's blocked
Pallas kernels in interpret mode (float64), compared at the unpacked
(B, K, Np) boundary:

 - step and rollout, flat bottom, N = 1, 2, 3: 1e-12;
 - rollout with controls and 2 steps per control: 1e-12;
 - full coastal physics + sponge + tidal depth from t0 = 1.0, 3 steps:
   1e-12; lake at rest unchanged to 1e-11;
 - the hand adjoint (plain backward, no autograd) against ``torch.autograd``
   through the plain forward, flat and coastal with sponge: 1e-9 relative;
   the ``autograd.Function`` against ``jax.grad`` through the JAX
   ``make_rollout_blocked(interpret=True)`` on a smooth, tie-free state, all
   four gradients: 1e-10 absolute;
 - ``rcm_order`` gives the JAX package's permutation, and a step on the
   shuffled-then-reordered mesh agrees with the JAX kernel in its 'onehot'
   trace mode: 1e-12;
 - ``build_sponge_coefficient`` and ``matmul_flops_per_step``;
 - input checks, launch counters, and the library digest that covers shared
   headers.

The port's operator set is built from the JAX context's numpy arrays
(``convert.blocked_step_ops_from_numpy``), so these tests do not depend on
parity of the set-up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.mesh.gmsh import build_mesh as j_build_mesh
from blitzdg_tpu.ops import sw2d as jsw
from blitzdg_tpu.ops import sw2d_blocked as JB
from blitzdg_tpu.parallel.partition import rcm_order as j_rcm_order
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build
from blitzdg_tpu.utils import build_sponge_coefficient as j_sponge

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mesh.gmsh import build_mesh as t_build_mesh
from blitzdg_tpu_torch.ops import _build
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import rcm_order as t_rcm_order
from blitzdg_tpu_torch.utils import build_sponge_coefficient as t_sponge

TIDE = (12.0, 0.5, 2.0, 10.0)  # h0, amp, omega, ramp_tau
F64 = torch.float64


def retag_east(mesh, x_east):
    bc = np.asarray(mesh.bc_type).copy()
    for k in range(mesh.num_elements):
        for f in range(3):
            a, b = mesh.etov[k, f], mesh.etov[k, (f + 1) % 3]
            mx = 0.5 * (mesh.verts[a, 0] + mesh.verts[b, 0])
            if bc[k, f] > 0 and abs(mx - x_east) < 1e-12:
                bc[k, f] = BC_OUT
    mesh.set_bc_type(bc)


class Pair:
    """One discretization and physics on both sides, float64."""

    def __init__(self, jc, phys_np=None, bu=None, bv=None, tidal=None,
                 wetdry=False, h_floor=1e-3, trace_mode="auto"):
        self.jc = jc
        phys_np = dict(g=9.81) if phys_np is None else phys_np
        as_j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        self.jphys = jsw.SWPhysics(**{k: as_j(v) for k, v in phys_np.items()})
        self.jops, self.jmeta = JB.build_blocked_step_ops(
            jc, self.jphys, bu, bv, dtype=jnp.float64, tidal=tidal,
            wetdry=wetdry, h_floor=h_floor, trace_mode=trace_mode)
        arrays, static = jax_arrays(jc)
        self.ops, self.meta = convert.blocked_step_ops_from_numpy(
            arrays, static, phys_np, bu, bv, tidal=tidal, wetdry=wetdry,
            h_floor=h_floor, device="cpu", dtype=F64)
        self.x, self.y = np.asarray(jc.x), np.asarray(jc.y)

    def pack(self, f):  # (B, K, Np) numpy -> JAX packed
        return JB.pack_state(self.jmeta, jnp.asarray(f))

    def unpack(self, f):
        return np.asarray(JB.unpack_state(self.jmeta, f))

    def flat(self, f):  # (B, K, Np) numpy -> (B, nV) torch
        return torch.as_tensor(np.asarray(f), dtype=F64).reshape(f.shape[0], -1)

    def close(self, got, want_packed, atol):
        want = self.unpack(want_packed)
        np.testing.assert_allclose(got.detach().numpy().reshape(want.shape),
                                   want, rtol=0, atol=atol)


def bump_state(p, B=2, moving=True):
    h = 10.0 + np.exp(-10.0 * (p.x ** 2 + p.y ** 2))
    hs = np.stack([h + 0.05 * b for b in range(B)])
    hu = (0.2 - 0.1 * np.arange(B))[:, None, None] * hs if moving else 0 * hs
    hv = -0.1 * hs if moving else 0 * hs
    return hs, hu, hv


def injectors(p):
    bump = np.exp(-8.0 * (p.x ** 2 + p.y ** 2))
    return np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])


@pytest.mark.parametrize("cells,n_order", [((4, 4), 1), ((3, 3), 2),
                                           ((3, 4), 3)])
def test_step_and_rollout_flat_match_jax_blocked(cells, n_order):
    p = Pair(j_build(n_order, j_box_triangles(*cells)))
    s = bump_state(p)
    dt, n_steps = 1e-3, 3
    want = JB.sw2d_step_blocked(p.jops, p.jmeta, *map(p.pack, s), None, dt,
                                interpret=True)
    got = TB.sw2d_step_blocked(p.ops, p.meta, *map(p.flat, s), None, dt)
    for g, w in zip(got, want):
        p.close(g, w, 1e-12)

    want = JB.sw2d_rollout_blocked(p.jops, p.jmeta, *map(p.pack, s), None, dt,
                                   n_steps=n_steps, store_traj=True,
                                   interpret=True)
    got = TB.sw2d_rollout_blocked(p.ops, p.meta, *map(p.flat, s), None, dt,
                                  n_steps=n_steps, store_traj=True)
    assert got[0].shape == (2, n_steps + 1, p.meta.n_v)
    for g, w in zip(got, want):  # three trajectories, three final states
        p.close(g, w, 1e-12)
    final = TB.sw2d_rollout_blocked(p.ops, p.meta, *map(p.flat, s), None, dt,
                                    n_steps=n_steps)
    for g, w in zip(final, got[3:]):
        assert torch.equal(g, w)


def test_rollout_control_forcing_matches_jax_blocked():
    jc = j_build(1, j_box_triangles(4, 4))
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    bu, bv = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
    p = Pair(jc, bu=bu, bv=bv)
    s = bump_state(p, moving=False)
    ctrls = np.array([[[0.3, -0.2], [0.1, 0.4]], [[-0.1, 0.2], [0.5, 0.0]]])
    dt, spc = 1e-3, 2
    want = JB.sw2d_rollout_blocked(p.jops, p.jmeta, *map(p.pack, s),
                                   jnp.asarray(ctrls), dt, spc=spc,
                                   interpret=True)
    got = TB.sw2d_rollout_blocked(p.ops, p.meta, *map(p.flat, s),
                                  torch.as_tensor(ctrls), dt, spc=spc)
    for g, w in zip(got, want):
        p.close(g, w, 1e-12)
    # one step with a control: the step wrapper takes (B, n_ctrl)
    want = JB.sw2d_step_blocked(p.jops, p.jmeta, *map(p.pack, s),
                                jnp.asarray(ctrls[:, 0]), dt, interpret=True)
    got = TB.sw2d_step_blocked(p.ops, p.meta, *map(p.flat, s),
                               torch.as_tensor(ctrls[:, 0]), dt)
    for g, w in zip(got, want):
        p.close(g, w, 1e-12)


def coastal_pair(n_order=2, cells=(4, 4), with_controls=False):
    mesh = j_box_triangles(*cells, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    retag_east(mesh, 1.0)
    jc = j_build(n_order, mesh)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    H = 10.0 + 5.0 * x + 2.0 * np.sin(3.0 * y)
    Hx, Hy = 5.0 * np.ones_like(H), 6.0 * np.cos(3.0 * y)
    ob_mask = np.asarray(jc.bc_table)[:, :, None].repeat(
        jc.n_fp, 2).reshape(jc.k_elem, -1) == BC_OUT
    sponge = np.asarray(j_sponge(jc, ob_mask, width=0.3, strength=0.5))
    phys_np = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy,
                   sponge=sponge)
    bu = bv = None
    if with_controls:
        bump = np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
        bu, bv = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
    p = Pair(jc, phys_np, bu, bv, tidal=TIDE)
    p.H, p.ob_mask, p.sponge = H, ob_mask, sponge
    return p


def coastal_state(p, B=2):
    h = p.H + 0.3 * np.exp(-20.0 * ((p.x - 0.5) ** 2 + (p.y - 0.5) ** 2))
    hs = np.stack([h + 0.02 * b for b in range(B)])
    return hs, 0.1 * hs, -0.05 * hs


def test_full_coastal_sponge_tidal_matches_jax_blocked():
    p = coastal_pair()
    assert p.meta.wb and p.meta.has_bathy and p.meta.has_sponge
    assert p.meta.tidal == TIDE
    s = coastal_state(p)
    dt, n_steps, t0 = 2e-3, 3, 1.0
    want = JB.sw2d_rollout_blocked(p.jops, p.jmeta, *map(p.pack, s), None, dt,
                                   n_steps=n_steps, t0=t0, interpret=True)
    got = TB.sw2d_rollout_blocked(p.ops, p.meta, *map(p.flat, s), None, dt,
                                  n_steps=n_steps, t0=t0)
    for g, w in zip(got, want):
        p.close(g, w, 1e-12)


def test_sponge_coefficient_matches_jax():
    p = coastal_pair()
    arrays, static = jax_arrays(p.jc)
    ctx = convert.context_from_numpy(arrays, static, device="cpu", dtype=F64)
    got = t_sponge(ctx, p.ob_mask, width=0.3, strength=0.5)
    assert got.shape == (p.jc.k_elem, p.jc.n_p) and float(got.max()) > 0.0
    np.testing.assert_allclose(got.numpy(), p.sponge, rtol=0, atol=1e-15)
    none = t_sponge(ctx, np.zeros_like(p.ob_mask), width=0.3)
    assert float(none.abs().max()) == 0.0


def test_lake_at_rest_stays_at_rest():
    jc = j_build(2, j_box_triangles(3, 3))
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    H = 10.0 + 4.0 * x + 2.0 * y
    p = Pair(jc, dict(g=9.81, H=H, Hx=4.0 * np.ones_like(H),
                      Hy=2.0 * np.ones_like(H)))
    h = p.flat(H[None])
    z = torch.zeros_like(h)
    out = TB.sw2d_step_blocked(p.ops, p.meta, h, z, z, None, 1e-3)
    for got, want in zip(out, (h, z, z)):
        assert float((got - want).abs().max()) < 1e-11


@pytest.mark.parametrize("which", ["flat", "coastal_sponge"])
def test_hand_adjoint_matches_autograd_float64(which):
    """sw2d_rollout_bwd_blocked (plain backward, hand-derived) against
    torch.autograd through the plain forward, all four cotangents, random
    trajectory cotangent: relative 1e-9."""
    if which == "flat":
        jc = j_build(2, j_box_triangles(2, 3))
        x, y = np.asarray(jc.x), np.asarray(jc.y)
        bump = np.exp(-8.0 * (x ** 2 + y ** 2))
        p = Pair(jc, bu=np.stack([bump, 0 * bump]),
                 bv=np.stack([0 * bump, bump]))
        s, t0 = bump_state(p), 0.0
    else:
        p = coastal_pair(n_order=2, cells=(2, 2), with_controls=True)
        s, t0 = coastal_state(p), 1.0
    rng = np.random.default_rng(11)
    noise = lambda a: a + 0.05 * rng.standard_normal(a.shape)
    x0 = [p.flat(noise(a)).requires_grad_(True) for a in s]
    c = torch.as_tensor(0.3 * rng.standard_normal((2, 2, 2))).requires_grad_(True)
    dt, spc = 2e-3, 2
    traj = TB.sw2d_rollout_blocked_plain(p.ops, p.meta, *x0, c, dt, spc,
                                         t0=t0, store_traj=True)[:3]
    tb = [torch.as_tensor(rng.standard_normal(tuple(a.shape))) for a in traj]
    want = torch.autograd.grad(sum((a * b).sum() for a, b in zip(traj, tb)),
                               [*x0, c])
    got = TB.sw2d_rollout_bwd_blocked(p.ops, p.meta,
                                      *[a.detach() for a in traj], *tb,
                                      c.detach(), dt, spc, t0)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-9


def test_autograd_function_matches_jax_grad():
    """Mirror of the JAX package's blocked adjoint test: a cost mixing stage
    and terminal terms, gradients w.r.t. the initial state and the controls,
    through make_rollout_blocked on both sides; smooth state, no ties."""
    jc = j_build(1, j_box_triangles(4, 4))
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    p = Pair(jc, bu=np.stack([bump, 0 * bump]), bv=np.stack([0 * bump, bump]))
    dt, spc, n_cs = 1e-3, 2, 2
    n_steps = spc * n_cs
    s = [a[:1] for a in bump_state(p)]
    ctrls = np.array([[[0.3, -0.2], [0.1, 0.4]]])
    target = 10.0 + 0.01 * bump

    jr = JB.make_rollout_blocked(p.jops, p.jmeta, dt, spc, interpret=True)
    tgt_p = p.pack(target[None])

    def jloss(h0, hu0, hv0, cs):
        th, thu, _ = jr(*(JB.pack_state(p.jmeta, f) for f in (h0, hu0, hv0)),
                        cs)
        cost = 0.0
        for t in range(n_steps):
            cost = cost + 1e-3 * jnp.sum((th[:, t] - tgt_p) ** 2)
        return (cost + jnp.sum((th[:, -1] - tgt_p) ** 2)
                + jnp.sum(thu[:, -1] ** 2))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in s), jnp.asarray(ctrls))

    tr = TB.make_rollout_blocked(p.ops, p.meta, dt, spc)
    x0 = [p.flat(a).requires_grad_(True) for a in s]
    c = torch.as_tensor(ctrls).requires_grad_(True)
    th, thu, _ = tr(*x0, c)
    tgt = p.flat(target[None])
    val = (1e-3 * ((th[:, :n_steps] - tgt[:, None]) ** 2).sum()
           + ((th[:, -1] - tgt) ** 2).sum() + (thu[:, -1] ** 2).sum())
    grads = torch.autograd.grad(val, [*x0, c])
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-12)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy().reshape(np.shape(jg)),
                                   np.asarray(jg), rtol=0, atol=1e-10)


def shuffled_verts_etov(cells=(4, 4), seed=3):
    mesh = j_box_triangles(*cells)
    perm = np.random.default_rng(seed).permutation(mesh.num_elements)
    return np.asarray(mesh.verts), np.asarray(mesh.etov)[perm]


def test_rcm_order_matches_jax_and_step_matches_onehot_kernel():
    verts, etov = shuffled_verts_etov()
    jm, jperm = j_rcm_order(j_build_mesh(verts, etov))
    tm, tperm = t_rcm_order(t_build_mesh(verts, etov))
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tm.etov, jm.etov)
    np.testing.assert_array_equal(tm.bc_type, jm.bc_type)
    assert sorted(tperm.tolist()) == list(range(len(tperm)))

    p = Pair(j_build(1, jm), trace_mode="onehot")
    assert p.jmeta.trace_mode == "onehot"
    s = bump_state(p, B=1)
    want = JB.sw2d_step_blocked(p.jops, p.jmeta, *map(p.pack, s), None, 1e-3,
                                interpret=True)
    got = TB.sw2d_step_blocked(p.ops, p.meta, *map(p.flat, s), None, 1e-3)
    for g, w in zip(got, want):
        p.close(g, w, 1e-12)


def test_matmul_flops_per_step_counts_the_ports_products():
    jc = j_build(3, j_box_triangles(2, 2))
    p = Pair(jc)
    K, n_p, n_tr = 8, 10, 12
    per_rhs = 4 * n_p * n_p * K * 5 + 2 * n_p * n_tr * K * 3
    assert TB.matmul_flops_per_step(p.meta, use_filter=False) == 2.0 * per_rhs
    assert (TB.matmul_flops_per_step(p.meta)
            == 2.0 * (per_rhs + 2 * n_p * n_p * K * 3))
    # the JAX count adds the trace-extraction product, which is a gather here
    jax_count = JB.matmul_flops_per_step(p.jmeta._replace(fold=False))
    assert jax_count - TB.matmul_flops_per_step(p.meta) == \
        2.0 * 2 * n_tr * n_p * K * 3


def test_chunking_and_operator_set_extend_the_dense_one():
    from blitzdg_tpu_torch.ops.sw2d_fused import FusedStepMeta, FusedStepOps

    p = coastal_pair()
    assert isinstance(p.ops, FusedStepOps) and TB.BlockedMeta is FusedStepMeta
    n_v = p.meta.n_v
    assert p.ops.H.shape == (n_v,) and p.ops.SPNG.shape == (n_v,)
    # H and SPNG ride at the end of the packed float buffer
    np.testing.assert_allclose(p.ops.fbuf[-n_v:].numpy(),
                               p.ops.SPNG.float().numpy())
    np.testing.assert_allclose(p.ops.fbuf[-2 * n_v:-n_v].numpy(),
                               p.ops.H.float().numpy())
    # the forward kernels are planned as a kind of the q launcher, numbered
    # in the wrapper as in the source (the plans of each kind:
    # test_torch_blocked_kernel_shim.py)
    src = (_build.CSRC / "sw2d_blocked.cu").read_text()
    enum = src[src.index("enum { Q_STAGE"):].split("}")[0][len("enum {"):]
    kinds = {k.strip(): int(v) for k, v in
             (e.split("=") for e in enum.split(","))}
    assert kinds == {"Q_STAGE": TB._STAGE, "Q_STEP": TB._RDMA,
                     "Q_STAGE_BWD": TB._STAGE_BWD,
                     "Q_ROLLOUT_BWD": TB._ROLLOUT_BWD,
                     "Q_ROLLOUT": TB._ROLLOUT, "Q_STEP_PEER": TB._RDMA_PEER,
                     "Q_STAGE_PEER": TB._STAGE_PEER,
                     "Q_STAGE_BWD_PEER": TB._STAGE_BWD_PEER}


def test_wrappers_raise_on_wrong_inputs():
    p = Pair(j_build(1, j_box_triangles(2, 2)))
    B, dt = 2, 1e-3
    h = torch.full((B, p.meta.n_v), 10.0, dtype=F64)
    z = torch.zeros_like(h)
    with pytest.raises(ValueError):
        TB.sw2d_step_blocked(p.ops, p.meta, h[:, :-1], z, z, None, dt)
    with pytest.raises(ValueError):
        TB.sw2d_step_blocked(p.ops, p.meta, h, z.float(), z, None, dt)
    with pytest.raises(ValueError):
        TB.sw2d_step_blocked(p.ops, p.meta, h, z, z, torch.zeros(B, 3), dt)
    with pytest.raises(ValueError):  # no controls and no step count
        TB.sw2d_rollout_blocked(p.ops, p.meta, h, z, z, None, dt)
    with pytest.raises(ValueError):
        TB.sw2d_rollout_blocked(p.ops, p.meta, h, z, z, None, dt, n_steps=0)
    traj = [torch.zeros(B, 4, p.meta.n_v, dtype=F64)] * 6
    with pytest.raises(ValueError):  # 4 states against 2 x 2 steps
        TB.sw2d_rollout_bwd_blocked(p.ops, p.meta, *traj,
                                    torch.zeros(B, 2, 1, dtype=F64), dt, 2)


def test_cpu_path_counts_no_launch():
    """The launch counters move only where a kernel is launched."""
    p = Pair(j_build(1, j_box_triangles(2, 2)))
    wrappers = (TB.sw2d_step_blocked, TB.sw2d_rollout_blocked,
                TB.sw2d_rollout_bwd_blocked)
    before = [w.launches for w in wrappers]
    h = torch.full((1, p.meta.n_v), 10.0, dtype=F64)
    z = torch.zeros_like(h)
    c = torch.zeros(1, 1, 1, dtype=F64)
    TB.sw2d_step_blocked(p.ops, p.meta, h, z, z, None, 1e-3)
    traj = TB.sw2d_rollout_blocked(p.ops, p.meta, h, z, z, c, 1e-3,
                                   store_traj=True)[:3]
    TB.sw2d_rollout_bwd_blocked(p.ops, p.meta, *traj, *traj, c, 1e-3, 1)
    assert before == [w.launches for w in wrappers]


def test_library_digest_covers_shared_headers(tmp_path):
    """A header shared by two sources must rename both libraries when it
    changes, so that a stale library is never loaded."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    d1 = _build._digest(tmp_path)
    assert d1 == _build._digest(tmp_path)
    (tmp_path / "common.cuh").write_text("// v2\n")
    d2 = _build._digest(tmp_path)
    assert d2 != d1
    (tmp_path / "extra.h").write_text("\n")
    assert _build._digest(tmp_path) != d2
    # the package's own sources: one digest, carried by every library's name
    names = {_build._target(s).name for s in _build.CSRC.glob("*.cu")}
    assert names == {f"lib{n}-{_build._digest()}.so"
                     for n in ("sw2d_dense", "sw2d_blocked", "sw2d_curved",
                               "peer")}
    assert (_build.CSRC / "sw2d_common.cuh").exists()
