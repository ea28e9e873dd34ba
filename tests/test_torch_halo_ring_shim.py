"""The halo ring (``parallel.HaloRing``: the element-sharded plain-tensor
path one shard a rank) over its kernels (``ops/csrc/peer.cu``: the face-row
exchange, its reverse, the sum and the maximum over ranks) compiled for the
CPU with ``g++`` behind the shim of ``test_torch_blocked_kernel_shim.py``,
as ``test_torch_peer_stage_shim.py`` builds it: S ranks as S host threads
over each other's host memory (``HaloRing.over_regions``), their launches
running at once and meeting only through their flags (their threads meet
before each launch: ``meet=``, which ranks on threads of their own need).

 - the exchange and its reverse bit-equal to the stacked roll of each
   offset's rows over the shard axis, over several epochs, at S=2, S=3
   (offset 1 alone) and S=4 (offsets 1, 2, 3), in float32, float64 and
   bfloat16 (padded to whole words), one to four fields, rows Nfp and NG
   wide;
 - the sum and the maximum the same bits on every rank, those of
   ``rank_order_sum`` and ``rank_order_max`` (the maximum equal to
   ``torch.amax`` over the stacked parts), in float32 and float64, with a
   NaN on one rank and a vector longer than a slot;
 - a buffer larger than the ring's slots raises; a rank that never
   launches makes its peers' launches trap, an error and not a hang;
 - the whole path in float64, ranks as threads: ``halo_sw2d_rhs`` (flat,
   coastal, a bfloat16 halo) against the JAX function under ``shard_map``
   and the port's stacked transport, its gradient through the reverse
   exchange against the stacked autograd gradient, the 10-step coastal
   rollout with ``halo_sw2d_timestep`` (every step's dt the stacked run's
   bits on every rank), the curved RHS on the Gauss plan, and CG and GMRES
   on ``halo_poisson2d_op`` (iterations and flags the stacked run's, x
   within 1e-10 of it, the same bits on every rank), with the launches
   of each kernel counted.
"""
import ctypes
import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_halo import (ATOL, _coastal, _j_halo_rhs, _partitioned,
                             _physics, _split)
from test_torch_peer_stage_shim import (_on_threads, _plan, lib,  # noqa: F401
                                        shim_lib)

from blitzdg_tpu.context import BC_OUT
from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.ops import sw2d as jsw

from blitzdg_tpu_torch import parallel as TP
from blitzdg_tpu_torch.ops.sw2d import SWState
from blitzdg_tpu_torch.parallel import peer as PR
from blitzdg_tpu_torch.parallel.halo import _stacked, _stacked_source
from blitzdg_tpu_torch.solvers import cg, gmres
from blitzdg_tpu_torch.solvers.krylov import CONV_MAXITS, CONV_SUCCESS
from blitzdg_tpu_torch.timestepping import ssprk2_step

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
S4 = 4  # ranks of the path's cases


def _rings(plan, slot_bytes, timeout_s=30.0, meet=True):
    """The S ranks' halo rings over zeroed host regions of this process
    (the regions returned too: the caller keeps them alive); with ``meet``
    their threads meet before each ring launch (a barrier of S, for ranks
    on threads of their own; without, one thread launches)."""
    S = plan.n_shards
    lay = PR.ring_region_layout(slot_bytes, len(plan.offs), S)
    regions = [torch.zeros(lay["bytes"], dtype=torch.uint8) for _ in range(S)]
    bases = {r: g.data_ptr() for r, g in enumerate(regions)}
    barrier = threading.Barrier(S) if meet else None
    rings = [PR.HaloRing.over_regions(plan, slot_bytes, r, bases, "cpu",
                                      timeout_s, barrier) for r in range(S)]
    return rings, regions


def _stacked_roll(bufs: torch.Tensor, offs, sign: int) -> torch.Tensor:
    """The plain version: (S, n_off, ...) send buffers of every rank, chunk
    i rolled by sign * offs[i] over the shard axis."""
    return torch.stack([torch.roll(bufs[:, i], sign * d, 0)
                        for i, d in enumerate(offs)], dim=1)


EXCHANGE_CASES = {
    "S2_offset1": (2, (1,)),
    "S3_offset1_alone": (3, (1,)),
    "S4_offsets123": (4, (1, 2, 3)),
}
# (fields, row width) of the epochs: Nfp of N=2 triangles, NG of N=3 Gauss
# faces; with three rows an offset an odd count of bfloat16 values pads
EPOCH_SHAPES = ((1, 3), (2, 5), (3, 3), (4, 5))


@pytest.mark.parametrize("dtype", [F32, F64, BF16], ids=str)
@pytest.mark.parametrize("name", list(EXCHANGE_CASES))
def test_halo_exchange_and_reverse_match_the_stacked_roll(lib, name, dtype):
    """Each rank's receive buffer of each forward exchange, and of each
    reverse one after them, bit-equal to its row of the stacked roll of
    every rank's buffer; one launch a call; the flags read the last epoch
    of each use (the GO flags one ahead)."""
    S, offs = EXCHANGE_CASES[name]
    plan = _plan(S, offs)
    n_off = len(offs)
    rings, _ = _rings(plan, PR.halo_slot_bytes(plan, 5, 4, dtype))
    g = torch.Generator().manual_seed(S)
    make = lambda nF, w: torch.randn((S, n_off, nF, plan.max_send, w),
                                     generator=g, dtype=F64).to(dtype)
    fwd = [make(*sh) for sh in EPOCH_SHAPES]
    rev = [make(*sh) for sh in EPOCH_SHAPES]
    n0 = (PR.peer_halo_exchange.launches,
          PR.peer_halo_exchange_reverse.launches)

    def rank(r):
        got = [PR.peer_halo_exchange(rings[r], f[r].contiguous())
               for f in fwd]
        got += [PR.peer_halo_exchange_reverse(rings[r], f[r].contiguous())
                for f in rev]
        return got

    out, errors = _on_threads(S, rank)
    assert errors == [None] * S
    want = ([_stacked_roll(f, offs, 1) for f in fwd]
            + [_stacked_roll(f, offs, -1) for f in rev])
    for r in range(S):
        for k, w in enumerate(want):
            assert out[r][k].dtype == dtype
            assert torch.equal(out[r][k].view(torch.int16 if dtype == BF16
                                              else dtype),
                               w[r].view(torch.int16 if dtype == BF16
                                         else dtype)), (r, k)
    E = len(EPOCH_SHAPES)
    for ring in rings:
        assert ring.flags.tolist()[:4 * n_off] == [E + 1, E] * 2 * n_off
        assert ring.epochs == {"forward": E, "reverse": E, "sum": 0}
    assert (PR.peer_halo_exchange.launches - n0[0],
            PR.peer_halo_exchange_reverse.launches - n0[1]) == (S * E, S * E)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == F32 else torch.int64)


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("S", [2, 4])
def test_sum_and_max_are_the_rank_order_ones_on_every_rank(lib, S, dtype):
    """Vectors of 1, 16 and 300 values (300 longer than a slot of
    ``SUM_BYTES``: two or three launches), then a vector with a NaN on rank
    1 alone: every rank's sum and maximum have the same bits, those of the
    rank-order sum and maximum; the maximum equals ``torch.amax`` over the
    stacked parts in value, and the NaN reaches every rank in both."""
    rings, _ = _rings(_plan(S, (1,) if S == 2 else (1, 2, 3)), 64)
    g = torch.Generator().manual_seed(20 + S)
    lens = (1, 16, 300)
    xs = [(torch.randn((S, n), generator=g, dtype=F64)
           * 10.0 ** torch.randint(-3, 4, (S, n), generator=g)).to(dtype)
          for n in lens]
    nan = torch.randn((S, 5), generator=g, dtype=F64).to(dtype)
    nan[1, 2] = float("nan")
    xs.append(nan)
    n0 = (PR.peer_rank_sum.launches, PR.peer_rank_max.launches)
    out, errors = _on_threads(S, lambda r: [
        (PR.peer_rank_sum(rings[r], x[r].contiguous()),
         PR.peer_rank_max(rings[r], x[r].contiguous())) for x in xs])
    assert errors == [None] * S
    for k, x in enumerate(xs):
        s_want = PR.rank_order_sum(list(x))
        m_want = PR.rank_order_max(list(x))
        torch.testing.assert_close(m_want, torch.amax(x, dim=0), rtol=0,
                                   atol=0, equal_nan=True)
        for r in range(S):
            s_got, m_got = out[r][k]
            assert torch.equal(_bits(s_got), _bits(s_want)), (r, k)
            assert torch.equal(_bits(m_got), _bits(m_want)), (r, k)
    assert bool(torch.isnan(out[S - 1][-1][0][2]))
    assert bool(torch.isnan(out[0][-1][1][2]))
    per = sum(-(-n * x.element_size() // PR.SUM_BYTES)
              for n, x in zip(lens + (5,), xs))
    assert rings[0].epochs["sum"] == 2 * per
    assert (PR.peer_rank_sum.launches - n0[0],
            PR.peer_rank_max.launches - n0[1]) == (S * per, S * per)


def test_a_buffer_over_capacity_raises(lib):
    """A face-row buffer larger than the ring's slots raises before any
    launch (nothing is truncated), and so does a type the exchange does not
    move; the ring's epochs do not move."""
    plan = _plan(2, (1,))
    rings, _ = _rings(plan, PR.halo_slot_bytes(plan, 3, 2, F32))
    fits = torch.zeros((1, 2, plan.max_send, 3))
    big = torch.zeros((1, 8, plan.max_send, 3))  # over the rounded 256 B
    with pytest.raises(ValueError, match="slots hold"):
        PR.peer_halo_exchange(rings[0], big)
    with pytest.raises(ValueError, match="slots hold"):
        PR.peer_halo_exchange_reverse(rings[0], big.double())
    with pytest.raises(ValueError, match="the ring moves"):
        PR.peer_halo_exchange(rings[0], fits.to(torch.float16))
    with pytest.raises(ValueError, match="the ring moves"):
        PR.peer_rank_max(rings[0], torch.zeros(3, dtype=BF16))
    with pytest.raises(ValueError, match="ring offsets"):
        PR.peer_halo_exchange(rings[0], torch.zeros((2, 2, 3, 3)))
    assert rings[0].epochs == {"forward": 0, "reverse": 0, "sum": 0}


@pytest.mark.parametrize("what", ["exchange", "reverse", "max"])
def test_a_lost_peer_traps(lib, what):
    """S=2 with rank 1 absent: rank 0's launch waits for rank 1's part,
    which never comes; past the ring's bound (0.3 s) it traps, which fails
    the launch: an error, not a hang. (Rank 0's thread alone launches: no
    meeting.)"""
    plan = _plan(2, (1,))
    rings, _ = _rings(plan, PR.halo_slot_bytes(plan, 3, 1, F64),
                      timeout_s=0.3, meet=False)
    x = torch.ones((1, 1, plan.max_send, 3), dtype=F64)
    call = {"exchange": PR.peer_halo_exchange,
            "reverse": PR.peer_halo_exchange_reverse,
            "max": lambda ring, t: PR.peer_rank_max(ring, t.reshape(-1))}
    out, errors = _on_threads(2, lambda r: call[what](rings[r], x),
                              missing=(1,), join_s=60.0)
    assert out == [None, None] and errors[1] is None
    assert isinstance(errors[0], RuntimeError)
    assert ("peer_rank_max" if what == "max" else "peer_stage_exchange") \
        in str(errors[0])


# ---------------------------------------------------------------------------
# The element-sharded path one shard a rank, float64
# ---------------------------------------------------------------------------

def _open_east(m0):
    """``m0`` with its east side (x = 1) an open boundary."""
    mids = 0.5 * (m0.verts[m0.etov][:, :, 0]
                  + m0.verts[m0.etov[:, [1, 2, 0]]][:, :, 0])
    bc = m0.bc_type.copy()
    bc[(bc > 0) & (np.abs(mids - 1.0) < 1e-6)] = BC_OUT
    m0.set_bc_type(bc)
    return m0


@pytest.fixture(scope="module")
def coastal_pair():
    return _partitioned(_open_east(j_box(4, 8)), n=S4)


@pytest.fixture(scope="module")
def wall_pair():
    return _partitioned(j_box(4, 8), n=S4)


class Ranks:
    """The S ranks of a pair's plan: each rank's shard context, tables and
    halo ring (over host regions of this process, sized for four float64
    fields of Nfp-wide rows)."""

    def __init__(self, p):
        self.rings, self._regions = _rings(
            p.plan, PR.halo_slot_bytes(p.plan, p.tc.n_fp, 4, F64))
        self.tables = [TP.halo_tables(p.plan, device="cpu", rank=r)
                       for r in range(S4)]
        self.sc = [TP.shard_context(p.tc, S4, r) for r in range(S4)]

    def run(self, fn, join_s=240.0):
        """``fn(r, ring)`` on a thread a rank; the ranks' results."""
        out, errors = _on_threads(S4, lambda r: fn(r, self.rings[r]),
                                  join_s=join_s)
        assert errors == [None] * S4
        return out


def _rank_phys(sphys, r):
    """Rank r's block of stacked physics (its fields' shard r)."""
    return dataclasses.replace(sphys, **{
        f.name: getattr(sphys, f.name)[r:r + 1]
        for f in dataclasses.fields(sphys)
        if isinstance(getattr(sphys, f.name), torch.Tensor)})


@pytest.mark.parametrize("kind", ["flat", "coastal", "coastal_bf16"])
def test_rhs_one_shard_a_rank_matches_jax_and_stacked(lib, coastal_pair,
                                                       kind):
    """``halo_sw2d_rhs`` on four ranks (the box of ``test_torch_halo.py``
    in 4 shards, N=2, an open east side): each rank's RHS, and the '+' face
    rows of its exchange, bit-equal to its shard of the stacked transport's
    (the same arithmetic on the same traces), and within 1e-11 of the JAX
    function under ``shard_map``; with a bfloat16 halo both packages cast
    the shipped buffer alone. One exchange launch a rank and RHS."""
    p = coastal_pair
    rng = np.random.default_rng(1)
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    phys_np = dict(g=9.81) if kind == "flat" else _coastal(p, rng)
    H = phys_np.get("H", 10.0)
    eta = 0.1 * np.exp(-5.0 * (x ** 2 + y ** 2))
    s_np = (H + eta, 0.3 * (H + eta), -0.2 * (H + eta))
    jphys, _, sphys = _physics(phys_np, S4)
    flat = kind == "flat"
    hd = BF16 if kind.endswith("bf16") else None
    forcing = None if flat else (lambda t: 12.0 + 0.5 * np.cos(0.3 * t))
    want = _j_halo_rhs(p, jsw.SWState(*map(jnp.asarray, s_np)), jphys,
                       None if flat else
                       (lambda t: 12.0 + 0.5 * jnp.cos(0.3 * t)),
                       jnp.bfloat16 if hd else None)
    st = SWState(*(_split(f, S4) for f in s_np))
    ref = TP.halo_sw2d_rhs(p.sc, st, 0.3, sphys, p.tables, p.plan,
                           tidal_forcing=forcing, halo_dtype=hd)
    fm = p.tc.fmask.reshape(-1)
    rows = torch.stack([f[..., fm] for f in st]).reshape(3, S4, -1, p.tc.n_fp)
    ref_rows = TP.halo_face_rows(rows, p.tables, p.plan, halo_dtype=hd)
    R = Ranks(p)
    n0 = PR.peer_halo_exchange.launches

    def rank(r, ring):
        mine = SWState(*(f[r:r + 1] for f in st))
        out = TP.halo_sw2d_rhs(R.sc[r], mine, 0.3, _rank_phys(sphys, r),
                               R.tables[r], p.plan, tidal_forcing=forcing,
                               halo_dtype=hd, ring=ring)
        fr = TP.halo_face_rows(rows[:, r:r + 1], R.tables[r], p.plan,
                               halo_dtype=hd, ring=ring)
        return out, fr

    out = R.run(rank)
    for r in range(S4):
        got, fr = out[r]
        assert torch.equal(fr, ref_rows[:, r:r + 1]), r
        for g, w, s in zip(got, want, ref):
            assert torch.equal(g, s[r:r + 1]), r
            np.testing.assert_allclose(
                g[0].numpy(), np.asarray(w).reshape(S4, -1, p.tc.n_p)[r],
                rtol=0, atol=ATOL)
    assert PR.peer_halo_exchange.launches - n0 == 2 * S4


def test_rhs_gradient_through_the_reverse_exchange(lib, coastal_pair):
    """The gradient of each rank's part of a random linear functional of
    the RHS (coastal physics) with respect to its state shard, by autograd
    through the exchange (its backward: the reverse exchange kernel), equal
    to its shard of the stacked autograd gradient of the whole functional,
    to 1e-11 of its largest entry; one reverse launch a rank."""
    p = coastal_pair
    rng = np.random.default_rng(5)
    phys_np = _coastal(p, rng)
    _, _, sphys = _physics(phys_np, S4)
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    eta = 0.1 * np.exp(-5.0 * (x ** 2 + y ** 2))
    H = phys_np["H"]
    s_np = (H + eta, 0.3 * H + eta, -0.2 * H + eta)
    w = [_split(rng.standard_normal(x.shape), S4) for _ in range(3)]
    st = [_split(f, S4).requires_grad_() for f in s_np]
    out = TP.halo_sw2d_rhs(p.sc, SWState(*st), 0.3, sphys, p.tables, p.plan)
    sum((o * wi).sum() for o, wi in zip(out, w)).backward()
    R = Ranks(p)
    n0 = PR.peer_halo_exchange_reverse.launches

    def rank(r, ring):
        mine = [_split(f, S4)[r:r + 1].requires_grad_() for f in s_np]
        o = TP.halo_sw2d_rhs(R.sc[r], SWState(*mine), 0.3,
                             _rank_phys(sphys, r), R.tables[r], p.plan,
                             ring=ring)
        loss = sum((a * wi[r:r + 1]).sum() for a, wi in zip(o, w))
        return torch.autograd.grad(loss, mine)

    got = R.run(rank)
    for r in range(S4):
        for g, a in zip(got[r], st):
            ref = a.grad[r:r + 1]
            np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-11 * float(a.grad.abs().max()))
    assert PR.peer_halo_exchange_reverse.launches - n0 == S4


def test_coastal_rollout_with_adaptive_dt(lib, coastal_pair):
    """10 SSP-RK2 steps with the halo RHS (coastal physics, tidal forcing)
    and ``halo_sw2d_timestep`` on four ranks: every step's dt has the bits
    of the stacked run's on every rank (the maximum over ranks through
    ``peer_rank_max``), and the end state is its shard of the stacked
    run's to 1e-11."""
    p = coastal_pair
    phys_np = _coastal(p, np.random.default_rng(3))
    _, _, sphys = _physics(phys_np, S4)
    x, y = np.asarray(p.jc.x), np.asarray(p.jc.y)
    eta = 0.1 * np.exp(-5.0 * (x ** 2 + y ** 2))
    s0 = SWState(*(_split(f, S4) for f in (phys_np["H"] + eta, 0.05 * eta,
                                            0.0 * eta)))
    forcing = lambda t: 12.0 + 0.5 * torch.cos(torch.as_tensor(0.3 * t))
    n_steps = 10

    def roll(sc, st, phys, tables, ring=None):
        t, dts = torch.zeros((), dtype=F64), []
        for _ in range(n_steps):
            dt = TP.halo_sw2d_timestep(sc, st, 9.81, 0.3, ring=ring)
            st = ssprk2_step(lambda a, tt: TP.halo_sw2d_rhs(
                sc, a, tt, phys, tables, p.plan, tidal_forcing=forcing,
                ring=ring), st, t, dt)
            t = t + dt
            dts.append(dt)
        return st, dts

    ref, ref_dts = roll(p.sc, s0, sphys, p.tables)
    R = Ranks(p)
    n0 = PR.peer_rank_max.launches
    out = R.run(lambda r, ring: roll(
        R.sc[r], SWState(*(f[r:r + 1] for f in s0)), _rank_phys(sphys, r),
        R.tables[r], ring))
    for r in range(S4):
        st, dts = out[r]
        assert [d.item() for d in dts] == [d.item() for d in ref_dts], r
        for g, w in zip(st, ref):
            np.testing.assert_allclose(g.numpy(), w[r:r + 1].numpy(), rtol=0,
                                       atol=ATOL)
    assert PR.peer_rank_max.launches - n0 == S4 * n_steps


def test_curved_rhs_on_the_gauss_plan(lib):
    """``halo_sw2d_curved_rhs`` on four ranks (the Gordon-Hall disk of
    ``test_torch_halo.py``, N=3, in 4 shards, an open eastern arc, drag and
    Coriolis): the Gauss traces through the halo ring of the Gauss plan (NG
    wide, four fields), each rank's RHS within 1e-11 of its shard of the
    stacked transport's."""
    from blitzdg_tpu.mesh import disk_triangles
    from blitzdg_tpu.mesh.curved import (circle_projection,
                                         gordon_hall_deform,
                                         snap_boundary_vertices)
    from blitzdg_tpu.parallel import partition_mesh
    from blitzdg_tpu.specgrid.cubature import (build_cubature_context,
                                               build_gauss_face_context)
    from blitzdg_tpu.specgrid.triangle import build_triangle_context as jb
    from torch_parity import jax_arrays, jax_fields

    from blitzdg_tpu_torch import convert
    from blitzdg_tpu_torch.ops.sw2d import SWPhysics
    from blitzdg_tpu_torch.ops.sw2d_curved import SWStateTracer

    N = 3
    mesh0 = disk_triangles(4, radius=1.0)
    bc = np.asarray(mesh0.bc_type).copy()
    mids = 0.5 * (mesh0.verts[mesh0.etov]
                  + mesh0.verts[np.roll(mesh0.etov, -1, axis=1)])
    bc[(bc > 0) & (mids[:, :, 0] > 0.7)] = BC_OUT
    mesh0.set_bc_type(bc)
    mesh, _, _ = partition_mesh(mesh0, S4)
    proj = circle_projection(0.0, 0.0, 1.0)
    faces = snap_boundary_vertices(mesh, proj, tol=0.3)
    ctx0 = jb(N, mesh, dtype=None)
    x2, y2, _ = gordon_hall_deform(N, mesh, ctx0.x, ctx0.y, faces, proj)
    jc = jb(N, mesh, coords=(x2, y2))
    arrays, static = jax_arrays(jc)
    tc = convert.context_from_numpy(arrays, static, device="cpu", dtype=F64)
    tcub = convert.cubature_from_numpy(
        jax_fields(build_cubature_context(N, mesh, x2, y2, ctx0.V)),
        device="cpu", dtype=F64)
    tg = convert.gauss_from_numpy(
        jax_fields(build_gauss_face_context(N, mesh, x2, y2, ctx0.V)),
        device="cpu", dtype=F64)
    phys = SWPhysics(g=9.81, cd=2.5e-3, f_cor=1e-4)
    eta = 0.05 * torch.exp(-5.0 * ((tc.x - 0.2) ** 2 + tc.y ** 2))
    st = SWStateTracer(*(f.reshape(S4, -1, tc.n_p) for f in
                         (1.0 + eta, 0.02 * eta, -0.01 * eta, eta)))
    forcing = lambda t: 1.0 + 0.05 * np.cos(0.3 * t)
    plan = TP.build_gauss_halo_plan(tg, S4)
    assert plan.offs
    sh = [TP.shard_context(c, S4) for c in (tc, tcub, tg)]
    ref = TP.halo_sw2d_curved_rhs(*sh, st, 0.37, phys,
                                  TP.halo_tables(plan, device="cpu"), plan,
                                  tidal_forcing=forcing)
    rings, _ = _rings(plan, PR.halo_slot_bytes(plan, tg.n_gauss, 4, F64))

    def rank(r):
        ctxs = [TP.shard_context(c, S4, r) for c in (tc, tcub, tg)]
        return TP.halo_sw2d_curved_rhs(
            *ctxs, SWStateTracer(*(f[r:r + 1] for f in st)), 0.37, phys,
            TP.halo_tables(plan, device="cpu", rank=r), plan,
            tidal_forcing=forcing, ring=rings[r])

    out, errors = _on_threads(S4, rank, join_s=240.0)
    assert errors == [None] * S4
    for r in range(S4):
        for g, w in zip(out[r], ref):
            np.testing.assert_allclose(g.numpy(), w[r:r + 1].numpy(),
                                       rtol=0, atol=ATOL)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_krylov_on_the_halo_laplacian(lib, wall_pair, solver):
    """On the walled box of ``test_torch_halo.py`` in 4 shards (N=2): CG on
    the symmetrized halo Laplacian (tol 1e-10, as there; it converges in
    some 30 iterations), and GMRES(10) on the halo Laplacian for 2 cycles
    (tol 1e-12: it stops at its cycle limit, a decision no rounding moves;
    the shim's launches are slow, some ms each, and a cycle of 10 takes 55
    dots), four ranks, float64, every dot a local sum
    and ``peer_rank_sum`` (rank order), the stagnation test a count summed
    in float64: the iterations and the flag of the stacked solve, x within
    1e-10 of it; the flag, the iterations and the relative residual the
    same bits on every rank. Launches: two exchanges a matvec, sums as the
    ranks' dots."""
    from blitzdg_tpu_torch.ops.poisson import apply_mass

    p = wall_pair
    tau = float((p.tc.n_order + 1) ** 2 * p.tc.fscale.max())
    uex = torch.sin(np.pi * p.tc.x) * torch.sin(np.pi * p.tc.y)
    f = -2.0 * np.pi ** 2 * uex
    sym = solver == "cg"
    if sym:
        b, sign = _split(-apply_mass(p.tc, f).numpy(), S4), -1.0
        kw, solve = dict(tol=1e-10, maxiter=4000), cg
    else:
        b, sign = _split(f.numpy(), S4), 1.0
        kw, solve = dict(tol=1e-12, restart=10, maxiter=2), gmres
    ref = solve(lambda v: sign * TP.halo_poisson2d_op(
        p.sc, v.reshape(b.shape), tau, p.tables, p.plan,
        symmetrize=sym).reshape(-1), b.reshape(-1), **kw)
    R = Ranks(p)
    counters = (PR.peer_halo_exchange, PR.peer_rank_sum)
    n0 = [c.launches for c in counters]

    def rank(r, ring):
        br = b[r:r + 1]
        matvec = lambda v: sign * TP.halo_poisson2d_op(
            R.sc[r], v.reshape(br.shape), tau, R.tables[r], p.plan,
            symmetrize=sym, ring=ring).reshape(-1)
        return solve(matvec, br.reshape(-1), ring=ring, **kw)

    out = R.run(rank)
    assert int(ref.flag) == (CONV_SUCCESS if sym else CONV_MAXITS)
    assert int(ref.iters) == (int(ref.iters) if sym else 2) > 1
    for r in range(S4):
        res = out[r]
        assert (int(res.flag), int(res.iters)) == (int(ref.flag),
                                                   int(ref.iters)), r
        assert torch.equal(res.relres, out[0].relres)
        assert torch.equal(res.iters, out[0].iters)
        np.testing.assert_allclose(res.x.numpy(),
                                   ref.x.reshape(S4, -1)[r].numpy(), rtol=0,
                                   atol=1e-10)
    launched = [c.launches - n for c, n in zip(counters, n0)]
    assert launched[0] > 0 and launched[0] % (2 * S4) == 0
    assert launched[1] > 0 and launched[1] % S4 == 0


# ---------------------------------------------------------------------------
# Many epochs back to back, a rank ahead, and the ordering points of each
# block's path
# ---------------------------------------------------------------------------

ROUNDS = 8  # rounds of the back-to-back case: an exchange, its reverse, a
# sum and a maximum each


@pytest.mark.parametrize("delayed", [0, 3])
def test_many_epochs_back_to_back_with_a_delayed_rank(lib, delayed):
    """S=4 (offsets 1, 2, 3), ROUNDS rounds of a float32 face-row exchange,
    its reverse, a float64 sum and a float32 maximum, back to back, one
    rank sleeping before a call now and then (a different time each): its
    peers' launches wait at its flags, every exchange and reverse is
    bit-equal to the stacked roll, every sum and maximum has the same bits
    on every rank, those of the rank-order ones; the flags read the last
    epoch of each use."""
    S, offs = 4, (1, 2, 3)
    plan = _plan(S, offs)
    rings, _ = _rings(plan, PR.halo_slot_bytes(plan, 5, 3, F32))
    g = torch.Generator().manual_seed(30 + delayed)
    bufs = [torch.randn((S, 3, 3, plan.max_send, 5), generator=g)
            for _ in range(2 * ROUNDS)]
    xs = [(torch.randn((S, 7), generator=g, dtype=F64)
           * 10.0 ** torch.randint(-3, 4, (S, 7), generator=g))
          for _ in range(ROUNDS)]
    waits = torch.rand((ROUNDS, 4), generator=g) * 0.02

    def rank(r):
        got = []
        for k in range(ROUNDS):
            calls = ((PR.peer_halo_exchange, bufs[2 * k][r]),
                     (PR.peer_halo_exchange_reverse, bufs[2 * k + 1][r]),
                     (PR.peer_rank_sum, xs[k][r]),
                     (PR.peer_rank_max, xs[k][r].float()))
            for j, (fn, x) in enumerate(calls):
                if r == delayed and (k + j) % 3 == 0:
                    time.sleep(float(waits[k, j]))
                got.append(fn(rings[r], x.contiguous()))
        return got

    out, errors = _on_threads(S, rank)
    assert errors == [None] * S
    for k in range(ROUNDS):
        want = (_stacked_roll(bufs[2 * k], offs, 1),
                _stacked_roll(bufs[2 * k + 1], offs, -1),
                PR.rank_order_sum(list(xs[k])),
                PR.rank_order_max(list(xs[k].float())))
        for r in range(S):
            got = out[r][4 * k:4 * k + 4]
            assert torch.equal(got[0], want[0][r]), (r, k)
            assert torch.equal(got[1], want[1][r]), (r, k)
            assert torch.equal(_bits(got[2]), _bits(want[2])), (r, k)
            assert torch.equal(_bits(got[3]), _bits(want[3])), (r, k)
    E, n_off = ROUNDS, len(offs)
    for ring in rings:
        f = ring.flags.tolist()
        assert f[:4 * n_off] == [E + 1, E] * 2 * n_off
        # SIN and SGO of every rank at the last reduction's epoch (SGO set
        # at each reduction's start, for the parts of the one before)
        assert f[4 * n_off:] == [2 * E] * 2 * S
        assert ring.epochs == {"forward": E, "reverse": E, "sum": 2 * E}


def test_a_rank_ahead_keeps_every_reductions_bits(lib):
    """S=4, rank 0 making its 24 reductions (sums and maxima, float32 and
    float64) back to back with no delay while ranks 1-3 sleep before each
    call: rank 0 enters each reduction first, and its part of a reduction
    reaches a peer's slot only once that peer has started the same
    reduction (its launch before, which read the slot, has ended: the
    release of the slots at a launch's start, with no fence). Every
    result has the rank-order bits on every rank."""
    S = 4
    rings, _ = _rings(_plan(S, (1, 2, 3)), 64)
    g = torch.Generator().manual_seed(41)
    n = 24
    dts = [F32 if k % 3 else F64 for k in range(n)]
    xs = [(torch.randn((S, 5), generator=g, dtype=F64)
           * 10.0 ** torch.randint(-3, 4, (S, 5), generator=g)).to(dts[k])
          for k in range(n)]
    waits = torch.rand((S, n), generator=g) * 0.01
    op = lambda k: PR.peer_rank_sum if k % 2 == 0 else PR.peer_rank_max

    def rank(r):
        got = []
        for k in range(n):
            if r > 0:
                time.sleep(float(waits[r, k]))
            got.append(op(k)(rings[r], xs[k][r].contiguous()))
        return got

    out, errors = _on_threads(S, rank)
    assert errors == [None] * S
    for k in range(n):
        plain = PR.rank_order_sum if k % 2 == 0 else PR.rank_order_max
        want = plain(list(xs[k]))
        for r in range(S):
            assert torch.equal(_bits(out[r][k]), _bits(want)), (r, k)


def _orders(lib, run):
    """``run()`` with the shim's log of ordering points on: each block of
    each launch (blocks of its launch, the system fences and release stores
    of its threads)."""
    flag = ctypes.c_int.in_dll(lib, "shim_log_orders")
    lib.shim_orders_clear()
    flag.value = 1
    try:
        run()
    finally:
        flag.value = 0
    n = lib.shim_orders_read(None, 0)
    buf = (ctypes.c_uint * (3 * n))()
    lib.shim_orders_read(buf, n)
    lib.shim_orders_clear()
    return [(buf[3 * i], buf[3 * i + 2]) for i in range(n)]


ORDER_KERNELS = ["halo_exchange", "halo_exchange_reverse", "stage_exchange",
                 "stage_exchange_reverse", "sum", "max", "ring_exchange"]


@pytest.mark.parametrize("what", ORDER_KERNELS)
def test_one_system_fence_on_each_blocks_path(lib, what):
    """The ring kernels' ordering points, counted on the shim (each system
    fence and each release store at system scope of a block's threads; the
    flags after a fence are relaxed stores): every block of an exchange (a
    send block and a receive block a ring offset: 2 n_off blocks; the
    step-boundary exchange a send block an offset) and the reduction's one
    block has exactly one, where a fence in every thread and a release, a
    fence of its own, in each phase were four in series. S=4, offsets 1, 2,
    3, every rank one call; the results their plain versions'."""
    S, offs = 4, (1, 2, 3)
    plan = _plan(S, offs)
    n_off = len(offs)
    g = torch.Generator().manual_seed(50)
    if what.startswith("halo"):
        rings, _ = _rings(plan, PR.halo_slot_bytes(plan, 3, 2, F32))
        x = torch.randn((S, n_off, 2, plan.max_send, 3), generator=g)
        fn, sign = ((PR.peer_halo_exchange, 1) if what == "halo_exchange"
                    else (PR.peer_halo_exchange_reverse, -1))
        want = _stacked_roll(x, offs, sign)
    elif what.startswith("stage"):
        from test_torch_peer_stage_shim import _rings as stage_rings

        rings, _ = stage_rings(plan, 2, 1)
        x = torch.randn((S, 1, rings[0].n_slots, 3), generator=g)
        rev = what.endswith("reverse")
        fn = (PR.peer_stage_exchange_reverse if rev
              else PR.peer_stage_exchange)
        src = torch.as_tensor(_stacked_source(plan, plan.max_send * 2,
                                              -1 if rev else 1))
        want = _stacked(x.reshape(S, 1, -1, 3), src)
        x = x.reshape(S, 1, 1, -1, 3)
    elif what == "ring_exchange":
        lay = PR.region_layout(1, PR._n_slots(plan, 2), n_off)
        regions = [torch.zeros(lay["bytes"], dtype=torch.uint8)
                   for _ in range(S)]
        bases = {r: t.data_ptr() for r, t in enumerate(regions)}
        rings = [PR.PeerRing.over_regions(plan, 2, 1, r, bases, "cpu", 30.0)
                 for r in range(S)]
        x = torch.randn((S, 1, 1, rings[0].n_slots, 3), generator=g)
        fn = lambda ring, t: ring._exchange(t)
        src = torch.as_tensor(_stacked_source(plan, plan.max_send * 2, 1))
    else:
        rings, _ = _rings(plan, 64)
        x = torch.randn((S, 6), generator=g)
        fn = PR.peer_rank_sum if what == "sum" else PR.peer_rank_max
        want = (PR.rank_order_sum if what == "sum"
                else PR.rank_order_max)(list(x))
    got = {}

    def run():
        out, errors = _on_threads(S, lambda r: fn(rings[r], x[r].contiguous()))
        assert errors == [None] * S
        got["out"] = out

    log = _orders(lib, run)
    blocks = 1 if what in ("sum", "max") else (
        n_off if what == "ring_exchange" else 2 * n_off)
    assert log == [(blocks, 1)] * (S * blocks)
    for r in range(S):
        if what == "ring_exchange":
            w = _stacked(x.reshape(S, 1, -1, 3), src)[r:r + 1]
            assert torch.equal(rings[r].rbb, w), r
        elif what in ("sum", "max"):
            assert torch.equal(got["out"][r], want), r
        else:
            assert torch.equal(got["out"][r].reshape(want[r].shape),
                               want[r]), r
