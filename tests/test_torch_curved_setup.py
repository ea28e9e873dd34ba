"""Set-up of the curved path: the port against the JAX package on the CPU in
float64.

 - ``disk_triangles``: mesh tables equal;
 - ``snap_boundary_vertices`` / ``gordon_hall_deform`` / ``circle_projection``
   / ``boundary_loops`` / ``spline_boundary_projection``: equal to 1e-13;
 - ``make_periodic``: the three maps equal;
 - ``build_cubature_context`` / ``build_gauss_face_context``: every array at
   1e-13 (the per-element mass inverses relative to their size), every
   integer map exactly;
 - cubature rules integrate monomials exactly to their order; the deformed
   disk's area is closer to pi than the straight-sided one's;
 - ``convert``: the JAX contexts as numpy give the port's own contexts and
   the same curved operator set.
"""
import dataclasses

import numpy as np
import pytest
import torch

from blitzdg_tpu.mesh import box_triangles as j_box_triangles
from blitzdg_tpu.mesh import curved as JCV
from blitzdg_tpu.mesh import disk_triangles as j_disk_triangles
from blitzdg_tpu.mesh.periodic import make_periodic as j_make_periodic
from blitzdg_tpu.specgrid import cubature as JCU
from blitzdg_tpu.specgrid.triangle import build_triangle_context as j_build

from torch_parity import jax_arrays, jax_curved_contexts, jax_fields

from blitzdg_tpu_torch import convert
from blitzdg_tpu_torch.mesh import box_triangles, disk_triangles
from blitzdg_tpu_torch.mesh import curved as TCV
from blitzdg_tpu_torch.mesh.periodic import make_periodic
from blitzdg_tpu_torch.ops import sw2d_curved_blocked as TC
from blitzdg_tpu_torch.ops.sw2d import SWPhysics
from blitzdg_tpu_torch.specgrid import cubature as TCU
from blitzdg_tpu_torch.specgrid.triangle import build_triangle_context

F64 = torch.float64
TABLES = ("verts", "etov", "etoe", "etof", "bc_type")


@pytest.mark.parametrize("rings", [1, 2, 4])
def test_disk_triangles_matches_jax(rings):
    jm, tm = j_disk_triangles(rings, radius=1.5), disk_triangles(rings, 1.5)
    assert tm.num_elements == 6 * rings ** 2
    for name in TABLES:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


def _deformed(mod, mesh, build, n_order, tol):
    proj = mod.circle_projection(0.0, 0.0, 1.0)
    faces = mod.snap_boundary_vertices(mesh, proj, tol=tol)
    c0 = build(n_order, mesh)
    x0, y0 = np.asarray(c0.x), np.asarray(c0.y)
    x, y, els = mod.gordon_hall_deform(n_order, mesh, x0, y0, faces, proj)
    return faces, np.asarray(c0.V), (x0, y0), (x, y), els


@pytest.fixture(scope="module", params=[(2, 2), (3, 3)],
                ids=["rings2_N2", "rings3_N3"])
def disk(request):
    """The deformed disk on both sides, each with its own mesh and code."""
    rings, n_order = request.param
    jm, tm = j_disk_triangles(rings), disk_triangles(rings)
    j = _deformed(JCV, jm, lambda n, m: j_build(n, m, dtype=None), n_order,
                  0.3)
    t = _deformed(TCV, tm, lambda n, m: build_triangle_context(
        n, m, dtype=F64, device="cpu"), n_order, 0.3)
    return n_order, jm, tm, j, t


def test_snap_and_gordon_hall_match_jax(disk):
    _, jm, tm, j, t = disk
    assert t[0] == j[0] and len(t[0]) > 0  # the curved faces
    np.testing.assert_allclose(tm.verts, jm.verts, rtol=0, atol=1e-13)
    for a, b in zip(t[3], j[3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
    np.testing.assert_array_equal(t[4], j[4])
    # boundary vertices lie on the circle; interior nodes moved
    bnd = np.unique([tm.etov[k, [f, (f + 1) % 3]] for k, f in t[0]])
    np.testing.assert_allclose(np.hypot(*tm.verts[bnd].T), 1.0, atol=1e-14)
    assert np.abs(t[3][0] - t[2][0]).max() > 1e-3


def test_deformation_improves_the_disk_area(disk):
    n_order, _, tm, _, t = disk
    V = t[1]
    area = lambda xy: float(TCU.build_cubature_context(
        n_order, tm, *xy, V, device="cpu").W.sum())
    straight, curved = area(t[2]), area(t[3])
    assert abs(curved - np.pi) < 0.05 * abs(straight - np.pi)


def test_cubature_and_gauss_contexts_match_jax(disk):
    n_order, jm, tm, j, t = disk
    jc = JCU.build_cubature_context(n_order, jm, *j[3], j[1])
    tc = TCU.build_cubature_context(n_order, tm, *t[3], t[1], device="cpu")
    assert tc.n_cub == jc.n_cub
    checked = 0
    for f in dataclasses.fields(tc):
        if f.name == "n_cub":
            continue
        want = np.asarray(getattr(jc, f.name))
        np.testing.assert_allclose(getattr(tc, f.name).numpy(), want, rtol=0,
                                   atol=1e-13 * max(1.0, np.abs(want).max()))
        checked += 1
    assert checked == 17
    jg = JCU.build_gauss_face_context(n_order, jm, *j[3], j[1])
    tg = TCU.build_gauss_face_context(n_order, tm, *t[3], t[1], device="cpu")
    assert tg.n_gauss == jg.n_gauss == 2 * (n_order + 1)
    for f in dataclasses.fields(tg):
        got, want = getattr(tg, f.name), getattr(jg, f.name)
        if f.name == "n_gauss":
            continue
        if isinstance(got, dict):
            assert set(got) == set(want)
            for tag in got:
                np.testing.assert_array_equal(got[tag].numpy(),
                                              np.asarray(want[tag]))
        elif f.name in ("mapM", "mapP"):
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=1e-13)
    # interior Gauss points pair up, boundary points map to themselves
    mP = tg.mapP.reshape(-1)
    assert torch.equal(mP[mP], tg.mapM.reshape(-1))
    assert tc.to("cpu").V.device.type == "cpu" and tg.to("cpu").n_gauss


@pytest.mark.parametrize("order", [2, 4, 6, 9, 12, 15])
def test_cubature_rules_are_exact_to_their_order(order):
    jr = JCU.triangle_cubature(order)
    tr = TCU.triangle_cubature(order)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)
    for rule in (tr, TCU.duffy_cubature(order)):
        r, s, w = rule
        assert (w > 0).all()
        for i in range(order + 1):
            for k in range(order + 1 - i):
                # integral of x^i y^k over the unit triangle, mapped from
                # the reference triangle (x = (1+r)/2, y = (1+s)/2, J = 1/4)
                from math import factorial as fac
                exact = fac(i) * fac(k) / fac(i + k + 2)
                got = 0.25 * np.sum(w * ((1 + r) / 2) ** i * ((1 + s) / 2) ** k)
                assert abs(got - exact) < 1e-13
    assert TCU.triangle_cubature(12)[0].size == 34  # the compact rule


def test_make_periodic_matches_jax():
    n_order = 2
    jc = j_build(n_order, j_box_triangles(3, 3))
    tc = build_triangle_context(n_order, box_triangles(3, 3), dtype=F64,
                                device="cpu")
    names = ("x", "y", "vmapM", "vmapP", "mapP")
    ja = {n: np.asarray(getattr(jc, n)) for n in names}
    ta = {n: getattr(tc, n).numpy() for n in names}
    want = j_make_periodic(ja, "x", -1.0, 1.0)
    got = make_periodic(ta, "x", -1.0, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the west and east sides now see each other: fewer boundary nodes
    assert (got[1] == got[0]).sum() < (ta["vmapP"] == ta["vmapM"]).sum()


def test_boundary_loops_and_spline_projection_match_jax():
    jm, tm = j_disk_triangles(3), disk_triangles(3)
    jl, tl = JCV.boundary_loops(jm), TCV.boundary_loops(tm)
    assert len(tl) == len(jl) == 1
    np.testing.assert_array_equal(tl[0], jl[0])
    assert tl[0][0] == tl[0][-1]  # closed
    pts = tm.verts[tl[0][:-1]]
    jp = JCV.spline_boundary_projection(pts)
    tp = TCV.spline_boundary_projection(pts)
    for q in ((0.9, 0.1), (-0.5, 0.8), (0.0, -1.1)):
        np.testing.assert_allclose(tp(*q), jp(*q), rtol=0, atol=1e-13)
        assert abs(np.hypot(*tp(*q)) - 1.0) < 2e-2  # near the circle
    assert TCV.circle_projection(1.0, 2.0, 3.0)(1.0, 2.0) == (4.0, 2.0)


@pytest.mark.parametrize("geom", ["disk", "box"])
def test_convert_gives_the_ports_own_contexts_and_operator_set(geom):
    jctx, jcub, jgauss = jax_curved_contexts(geom)
    cub = convert.cubature_from_numpy(jax_fields(jcub), device="cpu",
                                      dtype=F64)
    gauss = convert.gauss_from_numpy(jax_fields(jgauss), device="cpu",
                                     dtype=F64)
    assert isinstance(cub, TCU.CubatureContext2D) and cub.n_cub == jcub.n_cub
    assert isinstance(gauss, TCU.GaussFaceContext2D)
    assert gauss.mapP.dtype == torch.int64 and gauss.bc_mask[3].dtype == torch.bool
    np.testing.assert_array_equal(cub.MMinv.numpy(), np.asarray(jcub.MMinv))

    arrays, static = jax_arrays(jctx)
    x, y = np.asarray(jctx.x), np.asarray(jctx.y)
    bump = np.exp(-8.0 * (x ** 2 + y ** 2))
    bu, bv = np.stack([bump, 0 * bump]), np.stack([0 * bump, bump])
    kw = dict(zx=0.1 * np.cos(x), zy=0.2 * np.sin(y), dtype=F64, device="cpu")
    ops, meta = convert.curved_blocked_ops_from_numpy(
        arrays, static, jax_fields(jcub), jax_fields(jgauss),
        dict(g=9.81, cd=2e-3, f_cor=1e-4), bu, bv, **kw)
    ctx = convert.context_from_numpy(arrays, static, device="cpu", dtype=F64)
    own, own_meta = TC.build_curved_blocked_ops(
        ctx, cub, gauss, SWPhysics(g=9.81, cd=2e-3, f_cor=1e-4), bu, bv, **kw)
    assert meta == own_meta and meta.has_bed and meta.n_ctrl == 2
    assert meta.mass_mode == ("general" if geom == "disk" else "affine")
    for f in dataclasses.fields(ops):
        assert torch.equal(getattr(ops, f.name), getattr(own, f.name)), f.name
    assert ops.fbuf.dtype == torch.float32 and ops.ibuf.dtype == torch.int32
    assert inspect_default(convert.curved_blocked_ops_from_numpy) == "cuda"
    assert inspect_default(convert.cubature_from_numpy) == "cuda"
    assert inspect_default(convert.gauss_from_numpy) == "cuda"


def inspect_default(fn):
    import inspect
    return inspect.signature(fn).parameters["device"].default


def test_mass_modes_agree_on_a_straight_mesh_and_affine_refuses_curved():
    jctx, jcub, jgauss = jax_curved_contexts("box")
    arrays, static = jax_arrays(jctx)
    build = lambda mode, c=jcub: convert.curved_blocked_ops_from_numpy(
        arrays, static, jax_fields(c), jax_fields(jgauss), dict(g=9.81),
        mass_mode=mode, dtype=F64, device="cpu")
    (oa, ma), (og, mg) = build("affine"), build("general")
    assert (ma.mass_mode, mg.mass_mode) == ("affine", "general")
    assert og.MINV.shape == (ma.k_elem, ma.n_p, ma.n_p) and oa.MINV.numel() == 0
    rng = np.random.default_rng(0)
    S = tuple(torch.as_tensor(v + 0.01 * rng.standard_normal((2, ma.n_v)))
              for v in (1.0, 0.0, 0.0, 0.5))
    for a, b in zip(TC.sw2d_curved_step_blocked(oa, ma, *S, None, 1e-3),
                    TC.sw2d_curved_step_blocked(og, mg, *S, None, 1e-3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)
    dctx, dcub, dgauss = jax_curved_contexts("disk")
    darrays, dstatic = jax_arrays(dctx)
    with pytest.raises(ValueError, match="affine"):
        convert.curved_blocked_ops_from_numpy(
            darrays, dstatic, jax_fields(dcub), jax_fields(dgauss),
            dict(g=9.81), mass_mode="affine", device="cpu")
    with pytest.raises(ValueError, match="mass_mode"):
        build("lumped")
