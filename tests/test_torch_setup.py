"""Set-up parity of the PyTorch port with the JAX package (CPU, float64).

Every array of ``build_triangle_context`` must match the JAX context at
1e-13 and every integer map exactly, on the headline mesh
(``box_triangles(4, 5)``, N=1, east boundary retagged BC_OUT) and on
``box_triangles(6, 6)`` at N=3; ``build_dense_trace_ops`` must match
exactly. Also the numpy carry-over of a JAX context (``convert.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blitzdg_tpu.context as jctx_mod
from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.ops.sw2d_dense import build_dense_trace_ops as j_dense
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import STATIC, jax_arrays

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.context import BC_TAGS
from blitzdg_tpu_torch.mesh import box_triangles
from blitzdg_tpu_torch.mpc.coastal_box import retag_east_open
from blitzdg_tpu_torch.ops.sw2d_dense import build_dense_trace_ops
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

CASES = {"headline_4x5_N1": ((4, 5), 1, True), "box_6x6_N3": ((6, 6), 3, False)}
INDEX = ("fmask", "vmapM", "vmapP", "mapP", "mapB", "maskB", "vmapB",
         "bc_table", "gather_ids", "scatter_ids", "face_nbr", "face_flip")


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    cells, n_order, retag = CASES[request.param]
    jm, tm = j_box_triangles(*cells), box_triangles(*cells)
    if retag:
        retag_east_open(tm)
        jm.set_bc_type(tm.bc_type.copy())
    kw = dict(filter_cutoff=0.9 * n_order, filter_order=n_order)
    jc = j_build(n_order, jm, dtype=jnp.float64, **kw)
    tc = build_triangle_context(n_order, tm, dtype=torch.float64,
                                device="cpu", **kw)
    return jm, tm, jc, tc


def test_mesh_tables_match(pair):
    jm, tm, _, _ = pair
    for name in ("verts", "etov", "etoe", "etof", "bc_type"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


def test_context_arrays_match(pair):
    _, _, jc, tc = pair
    jd = jctx_mod.asdict(jc)
    for name in STATIC:
        assert getattr(tc, name) == jd[name]
    checked = 0
    for name, jv in jd.items():
        if name in STATIC or name == "bc_maps":
            continue
        tv = getattr(tc, name)
        if name in INDEX:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), name)
        else:
            assert tv.dtype == torch.float64
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                       atol=1e-13, err_msg=name)
        checked += 1
    assert checked >= 30


def test_bc_maps_match(pair):
    _, _, jc, tc = pair
    for tag in BC_TAGS:
        np.testing.assert_array_equal(tc.bc_maps.idx[tag].numpy(),
                                      np.asarray(jc.bc_maps.idx[tag]))
        np.testing.assert_array_equal(tc.bc_maps.mask[tag].numpy(),
                                      np.asarray(jc.bc_maps.mask[tag]))


def test_surface_trace_matches(pair):
    _, _, jc, tc = pair
    u = np.random.default_rng(0).standard_normal((2, jc.k_elem, jc.n_p))
    jM, jP = jc.surface_trace(jnp.asarray(u))
    tM, tP = tc.surface_trace(torch.as_tensor(u))
    np.testing.assert_array_equal(tM.numpy(), np.asarray(jM))
    np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))


def test_dense_trace_ops_match(pair):
    _, _, jc, tc = pair
    jo, to = j_dense(jc), build_dense_trace_ops(tc)
    for name in jo._fields:
        np.testing.assert_array_equal(getattr(to, name).numpy(),
                                      np.asarray(getattr(jo, name)), name)


def test_context_from_numpy_round_trip(pair):
    _, _, jc, tc = pair
    arrays, static = jax_arrays(jc)
    cc = convert.context_from_numpy(arrays, static, device="cpu",
                                    dtype=torch.float64)
    for f in ("Dr", "lift", "filter", "rx", "nx", "fscale", "J", "Vinv"):
        np.testing.assert_allclose(getattr(cc, f).numpy(),
                                   getattr(tc, f).numpy(), rtol=0, atol=1e-13)
    for f in ("vmapM", "vmapP", "mapP", "bc_table"):
        assert torch.equal(getattr(cc, f), getattr(tc, f))
    for tag in BC_TAGS:
        assert torch.equal(cc.bc_maps.idx[tag], tc.bc_maps.idx[tag])
        assert torch.equal(cc.bc_maps.mask[tag], tc.bc_maps.mask[tag])
