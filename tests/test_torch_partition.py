"""The partitioners and the halo plan (``parallel/partition.py``,
``parallel/halo.py``, host numpy) against the JAX package's: the element
order, part ids, block sizes and face cuts are identical, and so are the
padded context of an unequal partition and every array of the halo plan.
"""
import dataclasses

import numpy as np
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box
from blitzdg_tpu.parallel import halo as JH
from blitzdg_tpu.parallel import partition as JP
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mesh import box_triangles as t_box
from blitzdg_tpu_torch.parallel import halo as TH
from blitzdg_tpu_torch.parallel import partition as TP

MESHES = [((8, 8), 4), ((8, 8), 8), ((4, 5), 3), ((6, 6), 2)]


def _centroids(mesh):
    return mesh.verts[mesh.etov].mean(axis=1)


@pytest.mark.parametrize("cells,parts", MESHES)
def test_partitioners_match_jax(cells, parts):
    jm, tm = j_box(*cells), t_box(*cells)
    np.testing.assert_array_equal(tm.etoe, jm.etoe)
    np.testing.assert_array_equal(
        TP.rcb_partition(_centroids(tm), parts),
        JP.rcb_partition(_centroids(jm), parts))
    pg = TP.graph_partition(tm.etoe, parts)
    np.testing.assert_array_equal(pg, JP.graph_partition(jm.etoe, parts))
    assert TP.partition_cut(tm.etoe, pg) == JP.partition_cut(jm.etoe, pg)
    for method in ("auto", "graph", "rcb"):
        np.testing.assert_array_equal(
            TP.compute_partition(tm, parts, method),
            JP.compute_partition(jm, parts, method))
        np.testing.assert_array_equal(
            TP.partition_block_sizes(tm, parts, method),
            JP.partition_block_sizes(jm, parts, method))
    np.testing.assert_array_equal(TP.rcb_block_sizes(tm, parts),
                                  JP.rcb_block_sizes(jm, parts))
    (tnew, tperm, tkp), (jnew, jperm, jkp) = (TP.partition_mesh(tm, parts),
                                              JP.partition_mesh(jm, parts))
    np.testing.assert_array_equal(tperm, jperm)
    assert tkp == jkp
    for name in ("verts", "etov", "etoe", "etof", "bc_type"):
        np.testing.assert_array_equal(getattr(tnew, name),
                                      getattr(jnew, name))
    with pytest.raises(ValueError):
        TP.compute_partition(tm, parts, "metis")


def test_disconnected_subgraph_is_split_by_components():
    """Two separate strips: the spectral bisection assigns whole components
    (the JAX package's branch for a disconnected block)."""
    jm = j_box(8, 2)
    keep = np.concatenate([np.arange(0, 8), np.arange(24, 32)])
    etoe = jm.etoe[keep]
    remap = -np.ones(jm.num_elements, dtype=int)
    remap[keep] = np.arange(keep.size)
    etoe = remap[etoe]
    own = np.arange(keep.size)[:, None]
    etoe = np.where(etoe < 0, own, etoe)
    for parts in (2, 3, 4):
        np.testing.assert_array_equal(TP.graph_partition(etoe, parts),
                                      JP.graph_partition(etoe, parts))


def _field(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return None if v is None else np.asarray(v)


def test_pad_context_matches_jax():
    """An unequal partition (K = 40 into 3 blocks) padded with ghosts: every
    field of the padded context and the real-element mask are the JAX
    package's."""
    jm, _, _ = JP.partition_mesh(j_box(4, 5), 3)
    sizes = JP.partition_block_sizes(j_box(4, 5), 3)
    assert len(set(sizes.tolist())) > 1
    jc = j_build(2, jm, filter_cutoff=1.8, filter_order=4)
    arrays, static = jax_arrays(jc)
    tc = convert.context_from_numpy(arrays, static, device="cpu",
                                    dtype=torch.float64)
    jp, jreal = JP.pad_context(jc, sizes)
    tp, treal = TP.pad_context(tc, sizes)
    np.testing.assert_array_equal(treal, jreal)
    assert tp.k_elem == jp.k_elem == 3 * int(sizes.max())
    for f in dataclasses.fields(tp):
        got, want = getattr(tp, f.name), getattr(jp, f.name)
        if f.name == "bc_maps":
            for tag in want.idx:
                np.testing.assert_array_equal(_field(got.idx[tag]),
                                              np.asarray(want.idx[tag]))
                np.testing.assert_array_equal(_field(got.mask[tag]),
                                              np.asarray(want.mask[tag]))
        elif isinstance(want, int):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(_field(got), _field(want),
                                          err_msg=f.name)
    # equal blocks: nothing to pad
    same, real = TP.pad_context(tc, [tc.k_elem])
    assert same is tc and real.all()
    with pytest.raises(ValueError):
        TP.pad_context(tc, [1, 2])
    # the halo plan of the padded context: ghosts send and receive nothing
    jplan, tplan = JH.build_halo_plan(jp, 3), TH.build_halo_plan(tp, 3)
    for name in ("send_idx", "psrc", "pflip"):
        np.testing.assert_array_equal(getattr(tplan, name),
                                      np.asarray(getattr(jplan, name)))


@pytest.mark.parametrize("cells,parts,n_order", [((8, 8), 4, 1),
                                                 ((8, 8), 4, 2),
                                                 ((8, 8), 8, 1),
                                                 ((4, 5), 1, 2)])
def test_halo_plan_matches_jax(cells, parts, n_order):
    jm = JP.partition_mesh(j_box(*cells), parts)[0] if parts > 1 else \
        j_box(*cells)
    jc = j_build(n_order, jm)
    arrays, static = jax_arrays(jc)
    tc = convert.context_from_numpy(arrays, static, device="cpu",
                                    dtype=torch.float64)
    jplan, tplan = JH.build_halo_plan(jc, parts), TH.build_halo_plan(tc, parts)
    carried = convert.halo_plan_from_numpy(
        jplan.send_idx, jplan.psrc, jplan.pflip, jplan.offs, jplan.n_shards,
        jplan.max_send)
    for plan in (tplan, carried):
        for name in ("send_idx", "psrc", "pflip"):
            np.testing.assert_array_equal(getattr(plan, name),
                                          np.asarray(getattr(jplan, name)))
        assert plan.offs == jplan.offs
        assert (plan.n_shards, plan.max_send) == (jplan.n_shards,
                                                  jplan.max_send)
    for a, b in zip(TH.halo_tables(tplan, device="cpu"),
                    JH.halo_tables(jplan)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if parts == 1:
        assert tplan.offs == ()
    with pytest.raises(ValueError):
        TH.build_halo_plan(tc, 7)
