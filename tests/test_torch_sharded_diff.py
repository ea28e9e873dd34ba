"""Gradients of the element-sharded path on the CPU, in float64:

 - the plain stage backward (``sw2d_stage_bwd_blocked_v2_plain``, the hand
   adjoint) against ``torch.autograd`` through the plain stage, every
   cotangent (base, input, receive buffer, controls): 1e-9 relative, on a
   flat and a coastal set (bathymetry, drag, Coriolis, tidal depth), with
   and without the sponge, at N = 1 and N = 2;
 - the state and control gradients of a cost through 3 steps of the
   differentiable sharded step (stacked transport, plain versions) against
   ``jax.grad`` through the JAX package's ``make_sharded_blocked_step_diff``
   (interpret mode, ``shard_map`` over 4 virtual devices, one scenario:
   the JAX backward's control cotangent holds for B = 1 only, ROADMAP C21):
   1e-9 relative, at N = 1 on a coastal set with controls (bathymetry,
   well-balancing, drag, Coriolis, sponge, tidal depth);
 - the control gradient summed over scenarios: B copies of one scenario
   give B times its gradient.

The JAX gradient is computed once per module (a fixture): it is the cost
of this file.
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
    make_sharded_blocked_step_diff as j_diff, pack_local, unpack_local)
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.ops import sw2d_blocked as TB
from blitzdg_tpu_torch.parallel import blocked_shard as BS

S, N_STEPS, DT = 4, 3, 5e-4
F64 = torch.float64


def _setup(kind: str, n_order: int = 1):
    """JAX context, physics fields, the keyword arguments of the sharded
    set and the stage-time origin."""
    m = j_box(8, 8, xlim=(0.0, 1.0), ylim=(0.0, 1.0))
    if kind == "coastal":
        bc = np.asarray(m.bc_type).copy()
        for k in range(m.num_elements):
            for f in range(3):
                a, b = m.etov[k, f], m.etov[k, (f + 1) % 3]
                if bc[k, f] > 0 and abs(0.5 * (m.verts[a, 0]
                                               + m.verts[b, 0]) - 1.0) < 1e-12:
                    bc[k, f] = BC_OUT
        m.set_bc_type(bc)
    jm, _, _ = j_partition_mesh(m, S)
    jc = j_build(n_order, jm, filter_cutoff=0.9 * n_order, filter_order=4)
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    bump = np.exp(-8.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    kw = dict(forcing_bu=np.stack([bump, 0 * bump]),
              forcing_bv=np.stack([0 * bump, bump]))
    if kind == "coastal":
        H = 10.0 + 0.5 * x + 0.3 * np.sin(2.0 * y)
        Hx, Hy = (np.asarray(a) for a in jc.grad(jnp.asarray(H)))
        phys = dict(g=9.81, cd=2.5e-3, f_cor=1e-4, H=H, Hx=Hx, Hy=Hy,
                    sponge=0.2 * np.exp(-10.0 * (x - 1.0) ** 2))
        kw["tidal"] = (10.4, 0.3, 2.0, 0.01)
        return jc, phys, kw, 0.02, H
    return jc, dict(g=9.81), kw, 0.0, 10.0 + 0 * x


def _state(jc, H):
    """A smooth state without face-maximum ties: h, hu, hv (K, Np)."""
    x, y = np.asarray(jc.x), np.asarray(jc.y)
    eta = np.exp(-8.0 * ((x - 0.4) ** 2 + (y - 0.6) ** 2))
    return (H + 0.3 * eta, 0.1 * eta + 0.02 * x, 0.05 * eta - 0.01 * y)


def _jax_grads(jc, phys_np, kw, t0, state, cs, tgt):
    jphys = JPhys(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in phys_np.items()})
    sb = j_build_sharded(jc, jphys, S, dtype=jnp.float64, **kw)
    meta, k_loc = sb.meta, sb.k_loc
    step = j_diff(sb, DT, interpret=True)
    el_mesh = Mesh(np.array(jax.devices()[:S]), ("element",))
    pk = lambda f: jnp.concatenate([pack_local(meta, f[s * k_loc:(s + 1)
                                                       * k_loc])
                                    for s in range(S)], axis=0)
    vm = sb.ops.vmask[0][None]
    op_specs = jax.tree.map(lambda a: P("element", *([None] * (a.ndim - 1))),
                            sb.ops)
    st = P("element", None, None, None)

    def loss_local(ops_l, c_all, h_l, hu_l, hv_l, tgt_l):
        p3 = (h_l, hu_l, hv_l)
        sb0 = j_isb(sb, ops_l, p3)

        def body(carry, c):
            st_, tt = carry
            return (step(ops_l, st_, tt, ctrl=c), tt + DT), None

        (((out, _), _), _) = jax.lax.scan(body, ((p3, sb0), t0), c_all)
        loc = (jnp.sum(vm * (out[0] - tgt_l) ** 2)
               + 0.1 * jnp.sum(vm * out[1] ** 2) + jnp.sum(vm * out[2]))
        return jax.lax.psum(loc, "element")

    def total(h_pk, c_all, hu_pk, hv_pk, tgt_pk):
        fn = jax.shard_map(loss_local, mesh=el_mesh,
                           in_specs=(op_specs, P()) + (st,) * 4,
                           out_specs=P(), check_vma=False)
        return fn(sb.ops, c_all, h_pk, hu_pk, hv_pk, tgt_pk)

    args = (pk(state[0]), jnp.asarray(cs), pk(state[1]), pk(state[2]),
            pk(tgt))
    v, (gh, gc) = jax.value_and_grad(total, argnums=(0, 1))(*args)
    gh = np.concatenate([np.asarray(unpack_local(meta, gh[s:s + 1]))
                         for s in range(S)], axis=0)
    return float(v), gh.reshape(S, 1, -1), np.asarray(gc)


def _problem(kind: str):
    """The port's sharded set and the cost's inputs for one case."""
    jc, phys_np, kw, t0, H = _setup(kind)
    cs = 0.3 * np.random.default_rng(3).standard_normal((N_STEPS, 2))
    tgt = H + 0.1 * np.exp(-8.0 * (np.asarray(jc.x) ** 2))
    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(arrays, static, phys_np, S,
                                            device="cpu", dtype=F64, **kw)
    return jc, phys_np, kw, sb, t0, _state(jc, H), cs, tgt


@pytest.fixture(scope="module")
def coastal():
    jc, phys_np, kw, sb, t0, state, cs, tgt = _problem("coastal")
    return (sb, t0, state, cs, tgt,
            _jax_grads(jc, phys_np, kw, t0, state, cs, tgt))


def _port_loss(sb, t0, h0, rest, cs, tgt, batch=1):
    """The JAX test's cost through the port's differentiable step."""
    split = lambda f: BS.split_shards(
        torch.as_tensor(f).reshape(1, -1).expand(batch, -1), S)
    st = (h0, split(rest[0]), split(rest[1]))
    step = BS.make_sharded_blocked_step_diff(sb, DT)
    carry, t = (st, BS.initial_send_buffer(sb, st)), t0
    for i in range(N_STEPS):
        carry = step(carry, t, cs[i])
        t += DT
    h, hu, hv = carry[0]
    return (((h - split(tgt)) ** 2).sum() + 0.1 * (hu ** 2).sum()
            + hv.sum())


def test_diff_step_gradients_match_jax(coastal):
    sb, t0, state, cs, tgt, (v_ref, gh_ref, gc_ref) = coastal
    assert sb.meta.has_sponge and sb.meta.tidal is not None
    h0 = BS.split_shards(torch.as_tensor(state[0]).reshape(1, -1), S)
    h0.requires_grad_(True)
    c = torch.as_tensor(cs).requires_grad_(True)
    loss = _port_loss(sb, t0, h0, state[1:], c, tgt)
    np.testing.assert_allclose(loss.item(), v_ref, rtol=1e-12)
    gh, gc = torch.autograd.grad(loss, (h0, c))
    np.testing.assert_allclose(gh.numpy(), gh_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(gh_ref).max())
    np.testing.assert_allclose(gc.numpy(), gc_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(gc_ref).max())


def test_control_gradient_sums_over_scenarios():
    """B copies of one scenario: the shared control's gradient is B times
    the one-scenario gradient (the JAX backward cannot take B > 1)."""
    _, _, _, sb, t0, state, cs, tgt = _problem("flat")
    gcs = []
    for batch in (1, 3):
        h0 = BS.split_shards(torch.as_tensor(state[0]).reshape(1, -1)
                             .expand(batch, -1), S)
        c = torch.as_tensor(cs).requires_grad_(True)
        loss = _port_loss(sb, t0, h0, state[1:], c, tgt, batch=batch)
        gcs.append(torch.autograd.grad(loss, c)[0])
    np.testing.assert_allclose(gcs[1].numpy(), 3.0 * gcs[0].numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("kind,n_order,sponge",
                         [("flat", 1, False), ("flat", 2, False),
                          ("coastal", 1, True), ("coastal", 2, False),
                          ("coastal", 2, True)])
def test_stage_adjoint_matches_autograd(kind, n_order, sponge):
    jc, phys_np, kw, _, H = _setup(kind, n_order)
    arrays, static = jax_arrays(jc)
    sb = convert.sharded_blocked_from_numpy(arrays, static, phys_np, S,
                                            device="cpu", dtype=F64, **kw)
    ops, meta = sb.ops, sb.meta
    rng = np.random.default_rng(n_order)
    B, nv, L = 2, meta.n_v, ops.send.shape[1]
    g = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    Hs = BS.split_shards(torch.as_tensor(H).reshape(1, -1), S)
    base = (Hs + 0.1 * g(S, B, nv), 0.1 * g(S, B, nv), 0.1 * g(S, B, nv))
    cur = (Hs + 0.1 * g(S, B, nv), 0.1 * g(S, B, nv), 0.1 * g(S, B, nv))
    rb = 0.1 * g(S, B, L, 3)
    rb[..., 0] += 10.0
    ctrl = g(2)
    args = [a.clone().requires_grad_(True) for a in (*base, *cur, rb, ctrl)]
    c_dt, t = 0.7e-3, 0.3
    out = TB.sw2d_stage_blocked_plain(ops, meta, tuple(args[:3]),
                                      tuple(args[3:6]), args[6], c_dt, t,
                                      args[7], True, sponge)
    cots = [g(*o.shape) for o in out]
    want = torch.autograd.grad(out, args, cots)
    got = TB.sw2d_stage_bwd_blocked_v2_plain(ops, meta, cur, rb,
                                             tuple(cots[:3]), cots[3], c_dt, t,
                                             ctrl, True, sponge)
    got = (*got[:7], got[7].sum(dim=(0, 1)))
    for a, b, name in zip(got, want, ("base_h", "base_hu", "base_hv", "h",
                                      "hu", "hv", "rb", "ctrl")):
        scale = float(b.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-9 * scale, err_msg=name)
