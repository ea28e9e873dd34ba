"""The element-sharded blocked path (``parallel/blocked_shard.py``, the stage
kernels' plain versions in ``ops/sw2d_blocked.py``) on the CPU, in float64,
against the JAX package on ``box_triangles(8, 8)`` partitioned into 4 shards:

 - the fused sharded step over 3 steps, at N = 1 and N = 2, against the JAX
   package's ``make_sharded_blocked_step_fused`` run in interpret mode under
   ``shard_map`` over 4 of the 8 virtual devices, compared at the unpacked
   (K_loc, Np) boundary: flat; coastal (bathymetry, well-balancing, drag,
   Coriolis, sponge, tidal depth on the open east side from t0 = 0.02);
   controls; wet/dry: 1e-12, the send buffers too;
 - the same step against the port's unsharded blocked rollout
   (``sw2d_rollout_blocked_plain``) on the same partitioned mesh: 1e-12;
 - the stacked ring exchange against the plan, and its backward as the
   reverse exchange; the one-shard plan's zero receive buffer;
 - the wrappers' input checks and launch counters.

Each JAX reference runs once per module (a fixture): the interpret-mode
kernels under ``shard_map`` are the cost of this file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.ops.sw2d import SWPhysics as JPhys
from blitzdg_tpu.parallel import partition_mesh as j_partition_mesh
from blitzdg_tpu.parallel.blocked_shard import (
    build_sharded_blocked as j_build_sharded, initial_send_buffer as j_isb,
    make_sharded_blocked_step_fused as j_fused, pack_local)
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import blocked_shard as BS
from blitzdg_tpu_torch.parallel.halo import RingExchange, ring_exchange

S, B, N_STEPS, DT = 4, 2, 3, 5e-4
F64 = torch.float64


def _mesh(coastal: bool):
    if not coastal:
        return j_box(8, 8)
    m = j_box(8, 8, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    bc = np.asarray(m.bc_type).copy()
    for k in range(m.num_elements):
        for f in range(3):
            a, b = m.etov[k, f], m.etov[k, (f + 1) % 3]
            if bc[k, f] > 0 and abs(0.5 * (m.verts[a, 0] + m.verts[b, 0])
                                    - 1.0) < 1e-12:
                bc[k, f] = BC_OUT
    m.set_bc_type(bc)
    return m


def _unpack(meta, packed, k_loc):
    """JAX (S*B, p, NP, M) shard fields -> (S, B, K_loc*Np) numpy."""
    a = np.asarray(packed)
    out = a.transpose(0, 1, 3, 2).reshape(a.shape[0], meta.Kp, meta.NP)
    out = out[:, :k_loc, :meta.n_p].reshape(S, B, -1)
    return out


def _case(kind: str, n_order: int):
    """JAX context and physics, the port's sharded set built from them, the
    initial state, controls and stage-time origin of one case."""
    coastal = kind in ("coastal", "wetdry")
    jm, _, _ = j_partition_mesh(_mesh(coastal), S)
    jc = j_build(n_order, jm, filter_cutoff=0.9 * n_order, filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    rng = np.random.default_rng(11)
    kw, phys_np, t0, cs = {}, {}, 0.0, None
    if kind == "coastal":
        H = 10.0 + 0.5 * x + 0.3 * np.sin(2.0 * y)
        Hx, Hy = (np.asarray(a) for a in jc.grad(jnp.asarray(H)))
        sponge = 0.2 * np.exp(-10.0 * (x - 1.0) ** 2)
        phys_np = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy,
                       sponge=sponge)
        kw["tidal"] = (10.4, 0.3, 2.0, 0.01)
        t0 = 0.02
        h0 = H + 0.2 * np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    elif kind == "wetdry":
        H = 1.0 - 1.5 * x
        phys_np = dict(g=9.81, cd=1e-3, H=H, Hx=-1.5 * np.ones_like(H),
                       Hy=np.zeros_like(H), well_balanced=False)
        kw.update(wetdry=True, h_floor=1e-3)
        h0 = np.maximum(H, 1e-3) + 0.1 * np.exp(
            -8.0 * ((x - 0.3) ** 2 + (y - 0.5) ** 2))
    else:
        phys_np = dict(g=9.81)
        h0 = 10.0 + np.exp(-8.0 * (x ** 2 + y ** 2))
    if kind == "control":
        bump = np.exp(-8.0 * (x ** 2 + y ** 2))
        kw.update(forcing_bu=np.stack([bump, 0 * bump]),
                  forcing_bv=np.stack([0 * bump, bump]))
        cs = 0.3 * rng.standard_normal((N_STEPS, 2))
    # two scenarios: the second a scaled perturbation of the first
    hs = np.stack([h0, h0 + 0.01 * (h0 - h0.mean()) * (kind != "wetdry")])
    hus = np.stack([0.05 * (h0 - h0.min()), 0.02 * (h0 - h0.min())])
    hvs = np.stack([np.zeros_like(h0), 0.01 * (h0 - h0.min())])
    return jm, jc, phys_np, kw, t0, cs, (hs, hus, hvs)


def _jax_run(jc, phys_np, kw, t0, cs, state):
    jphys = JPhys(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in phys_np.items()})
    sb = j_build_sharded(jc, jphys, S, dtype=jnp.float64, **kw)
    meta, k_loc = sb.meta, sb.k_loc
    step = j_fused(sb, DT, interpret=True)
    el_mesh = Mesh(np.array(jax.devices()[:S]), ("element",))
    packed = tuple(jnp.concatenate([
        jnp.concatenate([pack_local(meta, f[b][s * k_loc:(s + 1) * k_loc])
                         for b in range(B)], axis=0)
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
        return (*out, sbuf, sb0)

    fn = jax.jit(jax.shard_map(roll, mesh=el_mesh,
                               in_specs=(op_specs, P()) + (st,) * 3,
                               out_specs=(st,) * 3 + (bs, bs),
                               check_vma=False))
    out = fn(sb.ops, ctrls, *packed)
    states = tuple(_unpack(meta, o, k_loc) for o in out[:3])
    L = out[3].shape[-2]
    return (states, np.asarray(out[3]).reshape(S, B, L, 3),
            np.asarray(out[4]).reshape(S, B, L, 3))


CASES = [("flat", 1), ("flat", 2), ("coastal", 1), ("control", 2),
         ("wetdry", 1)]


@pytest.fixture(scope="module")
def runs():
    """Per case: the port's sharded set, its inputs and the JAX results."""
    out = {}
    for kind, n in CASES:
        jm, jc, phys_np, kw, t0, cs, state = _case(kind, n)
        arrays, static = jax_arrays(jc)
        sb = convert.sharded_blocked_from_numpy(
            arrays, static, phys_np, S, device="cpu", dtype=F64, **kw)
        ref = _jax_run(jc, phys_np, kw, t0, cs, state)
        out[(kind, n)] = (jc, phys_np, kw, sb, t0, cs, state, ref)
    return out


def _port_run(sb, t0, cs, state):
    st = tuple(BS.split_shards(torch.as_tensor(f), S) for f in state)
    sbuf0 = BS.initial_send_buffer(sb, st)
    step = BS.make_sharded_blocked_step_fused(sb, DT)
    carry, t = (st, sbuf0), t0
    for i in range(N_STEPS):
        carry = step(carry, t, None if cs is None else torch.as_tensor(cs[i]))
        t += DT
    return carry, sbuf0


@pytest.mark.parametrize("kind,n_order", CASES)
def test_sharded_step_matches_jax(runs, kind, n_order):
    jc, phys_np, kw, sb, t0, cs, state, (j_states, j_sbuf, j_sb0) = \
        runs[(kind, n_order)]
    assert sb.meta.n_ctrl == (2 if kind == "control" else 1)
    assert sb.meta.wetdry == (kind == "wetdry")
    if kind == "coastal":
        assert (sb.meta.wb and sb.meta.has_bathy and sb.meta.has_sponge
                and sb.meta.tidal is not None and bool(sb.ops.obc.any()))
    (got, sbuf), sbuf0 = _port_run(sb, t0, cs, state)
    np.testing.assert_allclose(sbuf0.numpy(), j_sb0, atol=1e-12)
    for g, want, name in zip(got, j_states, ("h", "hu", "hv")):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-12,
                                   err_msg=f"{kind} N={n_order} {name}")
    np.testing.assert_allclose(sbuf.numpy(), j_sbuf, atol=1e-12)


@pytest.mark.parametrize("kind,n_order", CASES)
def test_sharded_step_matches_unsharded_blocked(runs, kind, n_order):
    """The sharded step equals the unsharded blocked rollout on the same
    partitioned mesh (the same physics, one operator set)."""
    jc, phys_np, kw, sb, t0, cs, state, _ = runs[(kind, n_order)]
    arrays, static = jax_arrays(jc)
    ops, meta = convert.blocked_step_ops_from_numpy(
        arrays, static, phys_np, device="cpu", dtype=F64, **kw)
    (got, _), _ = _port_run(sb, t0, cs, state)
    ctrls = None if cs is None else torch.as_tensor(cs)[None].expand(B, -1, -1)
    ref = TB.sw2d_rollout_blocked_plain(
        ops, meta, *(torch.as_tensor(f).reshape(B, -1) for f in state),
        ctrls, DT, 1, n_steps=N_STEPS, t0=t0)
    for g, want in zip(got, ref):
        np.testing.assert_allclose(BS.join_shards(g).numpy(), want.numpy(),
                                   atol=1e-12)


def test_stacked_exchange_follows_the_plan(runs):
    """Receive chunk d of shard s is send chunk d of shard (s - offs[d]) mod
    S; the backward is the reverse exchange; one shard receives zeros."""
    sb = runs[("flat", 2)][3]
    plan = sb.plan
    ex = RingExchange(plan, sb.meta.n_fp, device="cpu")
    L = sb.ops.send.shape[1]
    chunk = plan.max_send * sb.meta.n_fp
    buf = torch.randn(S, B, L, 3, dtype=F64, requires_grad=True)
    rb = ring_exchange(buf, ex)
    for s in range(S):
        for di, d in enumerate(plan.offs):
            part = slice(di * chunk, (di + 1) * chunk)
            assert torch.equal(rb[s, :, part], buf[(s - d) % S, :, part])
    w = torch.randn_like(rb)
    (g,) = torch.autograd.grad((rb * w).sum(), buf)
    for s in range(S):
        for di, d in enumerate(plan.offs):
            part = slice(di * chunk, (di + 1) * chunk)
            assert torch.equal(g[s, :, part], w[(s + d) % S, :, part])
    one = BS.build_sharded_blocked(
        convert.context_from_numpy(*jax_arrays(runs[("flat", 1)][0]),
                                   device="cpu", dtype=F64),
        convert.physics_from_numpy(device="cpu", dtype=F64), 1, dtype=F64,
        device="cpu")
    assert one.plan.offs == () and tuple(one.ops.send.shape) == (1, 1)
    assert int(one.ops.send[0, 0]) == -1
    z = ring_exchange(torch.ones(1, B, 1, 3, dtype=F64),
                      RingExchange(one.plan, one.meta.n_fp, device="cpu"))
    assert torch.equal(z, torch.zeros_like(z))


def test_stage_wrappers_check_inputs_and_count(runs):
    sb = runs[("control", 2)][3]
    ops, meta = sb.ops, sb.meta
    L = ops.send.shape[1]
    st = tuple(torch.full((S, B, meta.n_v), v, dtype=F64)
               for v in (10.0, 0.0, 0.0))
    rb = torch.zeros(S, B, L, 3, dtype=F64)
    rb[..., 0] = 10.0
    before = (TB.sw2d_stage_blocked.launches,
              TB.sw2d_stage_bwd_blocked_v2.launches)
    out = TB.sw2d_stage_blocked(ops, meta, st, st, rb, DT, 0.0,
                                torch.zeros(2, dtype=F64))
    assert len(out) == 4 and tuple(out[3].shape) == (S, B, L, 3)
    g = TB.sw2d_stage_bwd_blocked_v2(ops, meta, st, rb, st, rb, DT, 0.0,
                                     torch.zeros(2, dtype=F64))
    assert tuple(g[7].shape) == (S, B, 2)
    assert TB.sw2d_stage_bwd_blocked_v2(ops, meta, st, rb, st, rb, DT)[7] is None
    # the plain versions ran: no launch was counted
    assert (TB.sw2d_stage_blocked.launches,
            TB.sw2d_stage_bwd_blocked_v2.launches) == before
    with pytest.raises(ValueError):
        TB.sw2d_stage_blocked(ops, meta, st, st, rb[:, :, :-1], DT)
    with pytest.raises(ValueError):
        TB.sw2d_stage_blocked(ops, meta, st, st, rb, DT, 0.0,
                              torch.zeros(3, dtype=F64))
    with pytest.raises(TypeError):
        TB.sw2d_stage_blocked(TB.BlockedOps(**{
            k: v for k, v in vars(ops).items() if k != "send"}), meta, st,
            st, rb, DT)
    wet = runs[("wetdry", 1)][3]
    with pytest.raises(NotImplementedError):
        TB.sw2d_stage_bwd_blocked_v2(
            wet.ops, wet.meta, st[:1] * 3, rb, st, rb, DT)
    with pytest.raises(NotImplementedError):
        BS.make_sharded_blocked_step_diff(wet, DT)
