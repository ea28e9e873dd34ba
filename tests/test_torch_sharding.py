"""Sharded contexts and the (scenario, element) layout of the port
(``parallel/sharding.py``, ``parallel.make_global_mesh``,
``parallel.pad_elements``) against the JAX package's, CPU, float64.

The three field sets are the JAX frozensets; ``shard_context``'s blocks are
the slices that the JAX ``shard_context`` places on each of the 8 virtual
devices, for the nodal, cubature and Gauss-face contexts, with the GLOBAL
boundary lists replicated; ``make_device_mesh`` describes the stacked
layout; ``make_global_mesh`` in one process over a gloo group of one rank
(mirroring ``test_distributed_init_single_host_degenerate``);
``pad_elements`` is a guard that points to ``pad_context``."""
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from blitzdg_tpu import parallel as JP
from blitzdg_tpu.mesh import box_triangles as j_box

from torch_parity import jax_arrays, jax_curved_contexts, jax_fields

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch import parallel as TP
from blitzdg_tpu_torch.mesh import box_triangles

F64 = torch.float64
S = 8


def test_field_sets_are_the_jax_frozensets():
    from blitzdg_tpu.parallel import sharding as JS

    assert TP.ELEMENT_SHARDED_FIELDS == JS.ELEMENT_SHARDED_FIELDS
    assert TP.CUBATURE_SHARDED_FIELDS == JS.CUBATURE_SHARDED_FIELDS
    assert TP.GAUSS_SHARDED_FIELDS == JS.GAUSS_SHARDED_FIELDS
    for s in (TP.ELEMENT_SHARDED_FIELDS, TP.CUBATURE_SHARDED_FIELDS,
              TP.GAUSS_SHARDED_FIELDS):
        assert isinstance(s, frozenset)


def _same_blocks(jctx, tctx, tsh, names, jspecs, tspecs):
    """Each field of the port's sharded context against the JAX array: per
    shard its slice where the JAX spec shards it, the whole array where it
    replicates it."""
    for name in tspecs:
        jv, tv = getattr(jctx, name), getattr(tsh, name)
        if isinstance(tv, torch.Tensor) and tv.dim() >= 1:
            js = getattr(jspecs, name)
            assert (js != P()) == (tspecs[name] == "element") == (
                name in names), name
        if tspecs[name] == "element":
            a = np.asarray(jv)
            rows = a.shape[0] // S
            assert tuple(tv.shape) == (S, rows, *a.shape[1:]), name
            for s in range(S):
                np.testing.assert_array_equal(
                    tv[s].numpy(), a[s * rows:(s + 1) * rows], err_msg=name)
        elif isinstance(tv, torch.Tensor):
            assert tv is getattr(tctx, name), name


def test_shard_context_blocks_are_the_jax_slices():
    mesh, _, _ = JP.partition_mesh(j_box(4, 8), S)
    from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

    jc = j_build(2, mesh)
    jsh = JP.shard_context(jc, JP.make_device_mesh(1, S))
    arrays, static = jax_arrays(jc)
    tc = convert.context_from_numpy(arrays, static, device="cpu", dtype=F64)
    tsh = TP.shard_context(tc, TP.make_device_mesh(1, S))
    assert tsh.x.device == tc.x.device
    assert tsh.k_elem == tc.k_elem // S and tc.k_elem == jsh.k_elem
    specs = TP.context_shard_specs(tc)
    _same_blocks(jsh, tc, tsh, TP.ELEMENT_SHARDED_FIELDS,
                 JP.context_shard_specs(jc), specs)
    assert specs["bc_maps"] is None and specs["Dr"] is None
    for tag, idx in tc.bc_maps.idx.items():
        assert tsh.bc_maps.idx[tag] is idx
        np.testing.assert_array_equal(np.asarray(jsh.bc_maps.idx[tag]),
                                      idx.numpy())
    # one rank's block: (1, K/S, ...)
    for rank in (0, 5):
        one = TP.shard_context(tc, S, rank=rank)
        assert tuple(one.x.shape) == (1, tc.k_elem // S, tc.n_p)
        assert torch.equal(one.nx[0], tsh.nx[rank])
        assert one.Dr is tc.Dr


def test_shard_context_of_the_curved_contexts():
    """The cubature and Gauss-face contexts of the small curved disk over 2
    shards: the per-element fields' blocks, the maps and boundary lists
    global."""
    jc, jcub, jg = jax_curved_contexts("disk", 2)
    n = 2
    K = jc.k_elem
    assert K % n == 0
    tcub = convert.cubature_from_numpy(jax_fields(jcub), device="cpu",
                                       dtype=F64)
    tg = convert.gauss_from_numpy(jax_fields(jg), device="cpu", dtype=F64)
    for jx, tx, names, jspec, tspec in (
            (jcub, tcub, TP.CUBATURE_SHARDED_FIELDS,
             JP.cubature_shard_specs(jcub), TP.cubature_shard_specs(tcub)),
            (jg, tg, TP.GAUSS_SHARDED_FIELDS, JP.gauss_shard_specs(jg),
             TP.gauss_shard_specs(tg))):
        sh = TP.shard_context(tx, n)
        for name, spec in tspec.items():
            v = getattr(sh, name)
            if spec == "element":
                assert name in names
                a = np.asarray(getattr(jx, name))
                np.testing.assert_array_equal(
                    v.reshape(-1, *v.shape[2:]).numpy(), a)
                assert v.shape[:2] == (n, K // n)
                assert getattr(jspec, name) != P()
            else:
                assert v is getattr(tx, name)
    assert TP.shard_context(tg, n).bc_idx is tg.bc_idx


def test_make_device_mesh_describes_the_stacked_layout():
    m = TP.make_device_mesh(2, 4)
    assert m.axis_names == ("scenario", "element") and m.shape == (2, 4)
    jm = JP.make_device_mesh(2, 4)
    assert m.axis_names == jm.axis_names and m.shape == jm.devices.shape
    with pytest.raises(ValueError):
        TP.make_device_mesh(0, 4)


def test_make_global_mesh_single_process():
    """One process: ``distributed_init`` without arguments joins nothing,
    and ``make_global_mesh`` refuses to run without a process group; over a
    gloo group of one rank it lays out a (1, 1) (scenario, element) mesh
    whose element group carries collectives and a halo RHS."""
    import torch.distributed as dist

    from blitzdg_tpu_torch.ops.sw2d import SWPhysics, SWState, sw2d_rhs
    from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

    info = TP.distributed_init()
    assert info["n_processes"] == 1 and info["process_id"] == 0
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed_init"):
        TP.make_global_mesh()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    TP.distributed_init(f"tcp://localhost:{port}", 1, 0, backend="gloo")
    try:
        mesh = TP.make_global_mesh(n_scenario=1)
        assert mesh.mesh_dim_names == ("scenario", "element")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError):
            TP.make_global_mesh(2, 2)
        grp = mesh.get_group("element")
        x = torch.arange(6.0)
        dist.all_reduce(x, group=grp)
        assert torch.equal(x, torch.arange(6.0))
        ctx = build_triangle_context(1, box_triangles(2, 2), dtype=F64,
                                     device="cpu")
        plan = TP.build_halo_plan(ctx, 1)
        h = 10.0 + torch.exp(-3.0 * (ctx.x ** 2 + ctx.y ** 2))
        st = SWState(h, 0.2 * h, -0.1 * h)
        got = TP.halo_sw2d_rhs(TP.shard_context(ctx, mesh),
                               SWState(*(f[None] for f in st)), 0.0,
                               SWPhysics(g=9.81),
                               TP.halo_tables(plan, "cpu", rank=0), plan,
                               group=grp)
        for g, w in zip(got, sw2d_rhs(ctx, st, 0.0, SWPhysics(g=9.81))):
            np.testing.assert_allclose(g[0].numpy(), w.numpy(), rtol=0,
                                       atol=1e-12)
    finally:
        dist.destroy_process_group()


def test_pad_elements_is_a_guard():
    from blitzdg_tpu.parallel.partition import pad_elements as j_pad

    m = box_triangles(3, 5)  # K = 30
    assert TP.pad_elements(m, 5) is m
    with pytest.raises(ValueError, match="pad_context") as e:
        TP.pad_elements(m, 8)
    with pytest.raises(ValueError) as je:
        j_pad(j_box(3, 5), 8)
    assert str(e.value) == str(je.value)
