"""The one-launch sharded step (``make_sharded_blocked_step_rdma`` over
``sw2d_step_rdma_blocked``, its plain version on the CPU) in float64:

 - against the JAX package's ``make_sharded_blocked_step_rdma`` (the kernel
   that moves the inter-stage halo by remote DMA), run in interpret mode with
   race detection under ``shard_map``, over 3 steps at one scenario: on
   ``box_triangles(8, 8)`` flat at N = 1 on 8 shards (the JAX package's own
   case), and coastal at N = 2 on 4 shards (bathymetry, well-balancing,
   drag, Coriolis, sponge, tidal depth on the open east side from t0 =
   0.02, controls); on quadrilaterals, ``partition_mesh(box_quads(2, 2),
   4)`` coastal at N = 4 (the order at which the port's step runs its
   eight-lane instance on the card: one element a shard, two of its faces
   cut, three ring offsets; bathymetry, drag, Coriolis, sponge, tidal
   depth on the open east side from t0 = 1, controls). States and send
   buffers at the unpacked (K_loc, Np) boundary: 1e-12;
 - against the port's fused sharded step (two stages, the exchange between)
   at B = 2: the same bits, as both are the plain stage composition;
 - one shard (no ring offsets): the inter-stage receive buffer is zeros;
 - the input checks and the launch counter.

Each JAX reference runs once per module (a fixture): the interpret-mode
kernels under ``shard_map`` are the cost of this file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh, PartitionSpec as P

from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mesh import box_quads as j_box_quads
from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.ops.sw2d import SWPhysics as JPhys
from blitzdg_tpu.parallel import partition_mesh as j_partition_mesh
from blitzdg_tpu.parallel.blocked_shard import (
    build_sharded_blocked as j_build_sharded, initial_send_buffer as j_isb,
    make_sharded_blocked_step_rdma as j_rdma, pack_local)
from blitzdg_tpu.specgrid.quad import build_quad_context as j_build_quad
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build
from blitzdg_tpu.utils import build_sponge_coefficient as j_sponge

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mesh import box_quads
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import RingExchange
from blitzdg_tpu_torch.parallel import blocked_shard as BS

N_STEPS, DT = 3, 5e-4
F64 = torch.float64

# (kind, N, shards)
CASES = [("flat", 1, 8), ("coastal", 2, 4), ("quads_coastal", 4, 4)]


def _quad_case(n_order: int, S: int):
    """The quadrilateral case (as ``_case``): ``box_quads(2, 2)``, its east
    side open (the port's ``retag_east_open``, which walks four faces,
    copied into the JAX mesh), partitioned into S shards; the coastal
    physics of ``tests/test_torch_quad.py``'s sharded quad cases."""
    tm = box_quads(2, 2)
    retag_east_open(tm)
    jm = j_box_quads(2, 2)
    jm.set_bc_type(tm.bc_type.copy())
    jm, _, _ = j_partition_mesh(jm, S)
    jc = j_build_quad(n_order, jm, filter_cutoff=0.9 * n_order,
                      filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    H = 10.0 + 2.0 * x + np.sin(2.0 * y)
    ob = np.asarray(jc.bc_table)[:, :, None].repeat(jc.n_fp, 2).reshape(
        jc.k_elem, -1) == BC_OUT
    phys_np = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H,
                   Hx=2.0 * np.ones_like(H), Hy=2.0 * np.cos(2.0 * y),
                   sponge=np.asarray(j_sponge(jc, ob, width=0.3,
                                              strength=0.5)))
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    kw = dict(forcing_bu=np.stack([bump, 0 * bump]),
              forcing_bv=np.stack([0 * bump, bump]),
              tidal=(12.0, 0.5, 2.0, 10.0))
    eta = np.exp(-8.0 * ((x - 0.2) ** 2 + (y + 0.3) ** 2))
    cs = 0.3 * np.random.default_rng(13).standard_normal((N_STEPS, 2))
    return jc, phys_np, kw, 1.0, cs, ((H + 0.3 * eta)[None],
                                      (0.1 * eta + 0.02 * x)[None],
                                      (0.05 * eta - 0.01 * y)[None])


def _case(kind: str, n_order: int, S: int):
    """JAX context, physics arrays, set-up keywords, stage-time origin,
    controls and the one-scenario initial state of one case."""
    if kind == "quads_coastal":
        return _quad_case(n_order, S)
    m = j_box(8, 8, xlim=(0.0, 1.0), ylim=(0.0, 1.0)) if kind == "coastal" \
        else j_box(8, 8)
    if kind == "coastal":
        retag_east_open(m)  # duck-typed: the JAX mesh has the same fields
    jm, _, _ = j_partition_mesh(m, S)
    jc = j_build(n_order, jm, filter_cutoff=0.9 * n_order,
                 filter_order=1 if n_order == 1 else 4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    kw, t0, cs = {}, 0.0, None
    if kind == "coastal":
        H = 10.0 + 0.5 * x + 0.3 * np.sin(2.0 * y)
        Hx, Hy = (np.asarray(a) for a in jc.grad(jnp.asarray(H)))
        phys_np = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy,
                       sponge=0.2 * np.exp(-10.0 * (x - 1.0) ** 2))
        bump = np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
        kw.update(tidal=(10.4, 0.3, 2.0, 0.01),
                  forcing_bu=np.stack([bump, 0 * bump]),
                  forcing_bv=np.stack([0 * bump, bump]))
        t0 = 0.02
        cs = 0.3 * np.random.default_rng(5).standard_normal((N_STEPS, 2))
        h0 = H + 0.2 * bump
    else:
        phys_np = dict(g=9.81)
        h0 = 10.0 + np.exp(-8.0 * (x ** 2 + y ** 2))
    eta = h0 - h0.min()
    return jc, phys_np, kw, t0, cs, (h0[None], 0.1 * eta[None],
                                     0.05 * eta[None])


def _jax_run(jc, phys_np, kw, t0, cs, state, S):
    """N_STEPS steps of the JAX one-launch step under shard_map, the remote
    DMAs simulated with race detection on; returns the (S, 1, K_loc*Np)
    states and the (S, 1, L, 3) send buffer."""
    jphys = JPhys(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in phys_np.items()})
    sb = j_build_sharded(jc, jphys, S, dtype=jnp.float64, **kw)
    meta, k_loc = sb.meta, sb.k_loc
    step = j_rdma(sb, DT, interpret=pltpu.InterpretParams(detect_races=True))
    el_mesh = Mesh(np.array(jax.devices()[:S]), ("element",))
    packed = tuple(jnp.concatenate([
        pack_local(meta, jnp.asarray(f[0][s * k_loc:(s + 1) * k_loc]))
        for s in range(S)], axis=0) for f in state)
    op_specs = jax.tree.map(lambda a: P("element", *([None] * (a.ndim - 1))),
                            sb.ops)
    st, bs = P("element", None, None, None), P("element", None, None)
    ctrls = jnp.zeros((N_STEPS, 1)) if cs is None else jnp.asarray(cs)

    def roll(ops_l, cs_l, *pk):
        sb0 = j_isb(sb, ops_l, tuple(pk))

        def body(carry, c):
            st_, tt = carry
            ctrl = None if cs is None else c
            return (step(ops_l, st_, tt, ctrl=ctrl), tt + DT), None

        ((out, sbuf), _), _ = jax.lax.scan(body, ((tuple(pk), sb0), t0),
                                           cs_l)
        return (*out, sbuf)

    fn = jax.jit(jax.shard_map(roll, mesh=el_mesh,
                               in_specs=(op_specs, P()) + (st,) * 3,
                               out_specs=(st,) * 3 + (bs,), check_vma=False))
    out = fn(sb.ops, ctrls, *packed)
    states = []
    for o in out[:3]:
        a = np.asarray(o)  # (S, p, NP, M)
        a = a.transpose(0, 1, 3, 2).reshape(S, meta.Kp, meta.NP)
        states.append(a[:, :k_loc, :meta.n_p].reshape(S, 1, -1))
    L = out[3].shape[-2]
    return tuple(states), np.asarray(out[3]).reshape(S, 1, L, 3)


@pytest.fixture(scope="module")
def runs():
    """Per case: the port's sharded set, its inputs and the JAX results."""
    out = {}
    for kind, n, S in CASES:
        jc, phys_np, kw, t0, cs, state = _case(kind, n, S)
        sb = convert.sharded_blocked_from_numpy(
            *jax_arrays(jc), phys_np, S, device="cpu", dtype=F64, **kw)
        out[kind] = (sb, t0, cs, state, _jax_run(jc, phys_np, kw, t0, cs,
                                                 state, S))
    return out


def _port_run(sb, make_step, t0, cs, state):
    S = sb.n_shards
    st = tuple(BS.split_shards(torch.as_tensor(f), S) for f in state)
    step = make_step(sb, DT)
    carry, t = (st, BS.initial_send_buffer(sb, st)), t0
    for i in range(N_STEPS):
        carry = step(carry, t, None if cs is None else torch.as_tensor(cs[i]))
        t += DT
    return carry


@pytest.mark.parametrize("kind", [c[0] for c in CASES])
def test_rdma_step_matches_jax(runs, kind):
    sb, t0, cs, state, (j_states, j_sbuf) = runs[kind]
    if kind != "flat":
        m = sb.meta
        assert (m.wb and m.has_bathy and m.has_sponge and m.cd and m.f_cor
                and m.tidal is not None and m.n_ctrl == 2
                and bool(sb.ops.obc.any()))
        if kind == "quads_coastal":
            assert m.n_faces == 4 and m.n_p == 25 and m.k_elem == 1
            assert len(sb.plan.offs) == 3
            assert int((sb.ops.vmapP >= m.n_v).sum()) > 0  # cut faces
    else:
        assert len(sb.plan.offs) >= 4 and bool(
            (sb.plan.pflip.astype(bool)
             & (sb.plan.psrc >= sb.plan.psrc.shape[1])).any())
    got, sbuf = _port_run(sb, BS.make_sharded_blocked_step_rdma, t0, cs,
                          state)
    for g, want, name in zip(got, j_states, ("h", "hu", "hv")):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-12,
                                   err_msg=f"{kind} {name}")
    np.testing.assert_allclose(sbuf.numpy(), j_sbuf, atol=1e-12)


@pytest.mark.parametrize("kind", [c[0] for c in CASES])
def test_rdma_step_equals_fused_step(runs, kind):
    """At two scenarios (the second a perturbed copy of the first) the
    one-launch step gives the fused step's bits."""
    sb, t0, cs, state, _ = runs[kind]
    state2 = tuple(np.concatenate([f, f * (1.0 + 0.01 * i)])
                   for i, f in enumerate(state))
    a = _port_run(sb, BS.make_sharded_blocked_step_rdma, t0, cs, state2)
    b = _port_run(sb, BS.make_sharded_blocked_step_fused, t0, cs, state2)
    assert a[0][0].shape[1] == 2
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(x, y)


def test_rdma_step_one_shard():
    """One shard: no ring offsets, one empty slot, a zero inter-stage
    receive buffer; the step equals the unsharded blocked step."""
    ctx = convert.context_from_numpy(*jax_arrays(_case("flat", 2, 1)[0]),
                                     device="cpu", dtype=F64)
    phys = convert.physics_from_numpy(device="cpu", dtype=F64)
    one = BS.build_sharded_blocked(ctx, phys, 1, dtype=F64, device="cpu")
    assert one.plan.offs == () and tuple(one.ops.send.shape) == (1, 1)
    ex = RingExchange(one.plan, one.meta.n_fp, device="cpu")
    assert torch.equal(ex(torch.ones(1, 2, 1, 3, dtype=F64)),
                       torch.zeros(1, 2, 1, 3, dtype=F64))
    rng = np.random.default_rng(3)
    st = tuple(torch.as_tensor(a + rng.standard_normal((1, 2, one.meta.n_v))
                               * 0.1) for a in (10.0, 0.0, 0.0))
    rb = torch.zeros(1, 2, 1, 3, dtype=F64)
    *got, sb_out = TB.sw2d_step_rdma_blocked(one.ops, one.meta, st, rb, DT,
                                             ex)
    assert torch.equal(sb_out, torch.zeros_like(sb_out))
    ops, meta = TB.build_blocked_step_ops(ctx, phys, dtype=F64, device="cpu")
    want = TB.sw2d_step_blocked_plain(ops, meta, *(f[0] for f in st), None,
                                      DT)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), w.numpy(), atol=1e-12)


def test_rdma_wrappers_check_inputs_and_count(runs):
    sb = runs["coastal"][0]
    ops, meta = sb.ops, sb.meta
    ex = RingExchange(sb.plan, meta.n_fp, device="cpu")
    S, L = ops.send.shape
    st = tuple(torch.full((S, 2, meta.n_v), v, dtype=F64)
               for v in (10.0, 0.0, 0.0))
    rb = torch.zeros(S, 2, L, 3, dtype=F64)
    rb[..., 0] = 10.0
    before = TB.sw2d_step_rdma_blocked.launches
    out = TB.sw2d_step_rdma_blocked(ops, meta, st, rb, DT, ex, 0.0,
                                    torch.zeros(2, dtype=F64))
    assert len(out) == 4 and tuple(out[3].shape) == (S, 2, L, 3)
    assert TB.sw2d_step_rdma_blocked.launches == before  # the plain version
    with pytest.raises(ValueError):
        TB.sw2d_step_rdma_blocked(ops, meta, st, rb[:, :, :-1], DT, ex)
    with pytest.raises(ValueError):
        TB.sw2d_step_rdma_blocked(ops, meta, (st[0][:, :1],) + st[1:], rb,
                                  DT, ex)
    with pytest.raises(ValueError):
        TB.sw2d_step_rdma_blocked(ops, meta, st, rb, DT, ex, 0.0,
                                  torch.zeros(3, dtype=F64))
    # a ring of another set, or the process-group transport, is refused
    flat = runs["flat"][0]
    for ring in (RingExchange(flat.plan, flat.meta.n_fp, device="cpu"),
                 RingExchange(sb.plan, meta.n_fp, group=object())):
        with pytest.raises(ValueError):
            TB.sw2d_step_rdma_blocked(ops, meta, st, rb, DT, ring)
    with pytest.raises(TypeError):
        TB.sw2d_step_rdma_blocked(TB.BlockedOps(**{
            k: v for k, v in vars(ops).items() if k != "send"}), meta, st,
            rb, DT, ex)
    # with a process group a rank holds one shard (its own): a set of every
    # shard is refused (the transport itself: test_torch_sharded_rdma_dist)
    with pytest.raises(ValueError, match="one shard a rank"):
        BS.make_sharded_blocked_step_rdma(sb, DT, group=object())
    wet = convert.sharded_blocked_from_numpy(
        *jax_arrays(_case("coastal", 1, 4)[0]),
        dict(g=9.81, H=np.ones((128, 3)), Hx=np.zeros((128, 3)),
             Hy=np.zeros((128, 3))), 4, wetdry=True, device="cpu", dtype=F64)
    wet_ex = RingExchange(wet.plan, wet.meta.n_fp, device="cpu")
    with pytest.raises(NotImplementedError):
        BS.make_sharded_blocked_step_rdma(wet, DT)
    with pytest.raises(NotImplementedError):
        TB.sw2d_step_rdma_blocked(wet.ops, wet.meta, st, rb, DT, wet_ex)
    with pytest.raises(NotImplementedError):
        TB.sw2d_step_rdma_blocked_plain(wet.ops, wet.meta, st, rb, DT,
                                        wet_ex)
