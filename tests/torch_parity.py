"""Helpers shared by the port's parity tests (``test_torch_*.py``)."""
import numpy as np

import blitzdg_tpu.context as jctx_mod

STATIC = ("n_order", "n_p", "k_elem", "n_faces", "n_fp")


def jax_arrays(jc):
    """A JAX context's fields as numpy: the ``np.asarray`` side of
    ``blitzdg_tpu_torch.convert``. Returns (arrays, static)."""
    d = jctx_mod.asdict(jc)
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in d.items() if k not in STATIC and k != "bc_maps"}
    arrays["bc_maps"] = {
        "idx": {t: np.asarray(v) for t, v in jc.bc_maps.idx.items()},
        "mask": {t: np.asarray(v) for t, v in jc.bc_maps.mask.items()}}
    return arrays, {k: d[k] for k in STATIC}


def jax_fields(ctx) -> dict:
    """The fields of a JAX cubature or Gauss-face context as numpy (ints stay
    ints, per-tag dicts become ``{tag: array}``): what
    ``convert.cubature_from_numpy`` / ``gauss_from_numpy`` take."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(ctx):
        v = getattr(ctx, f.name)
        if isinstance(v, dict):
            out[f.name] = {t: np.asarray(a) for t, a in v.items()}
        elif isinstance(v, int):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def jax_curved_contexts(geom: str, n_order: int = 2):
    """The JAX package's nodal, cubature and Gauss-face contexts (float64)
    on the small curved test geometries: 'disk' (``disk_triangles(2)``,
    boundary snapped to the unit circle, Gordon-Hall deformed: per-element
    mass matrices) or 'box' (``box_triangles(3, 4)``, straight: affine)."""
    from blitzdg_tpu.mesh import box_triangles, disk_triangles
    from blitzdg_tpu.mesh.curved import (circle_projection,
                                         gordon_hall_deform,
                                         snap_boundary_vertices)
    from blitzdg_tpu.specgrid.cubature import (build_cubature_context,
                                               build_gauss_face_context)
    from blitzdg_tpu.specgrid.triangle import build_triangle_context

    kw = dict(filter_cutoff=0.9 * n_order, filter_order=4)
    if geom == "box":
        mesh = box_triangles(3, 4)
        ctx = build_triangle_context(n_order, mesh, **kw)
        x, y, V = np.asarray(ctx.x), np.asarray(ctx.y), np.asarray(ctx.V)
    else:
        mesh = disk_triangles(2, radius=1.0)
        proj = circle_projection(0.0, 0.0, 1.0)
        faces = snap_boundary_vertices(mesh, proj, tol=0.3)
        c0 = build_triangle_context(n_order, mesh, dtype=None)
        x, y, _ = gordon_hall_deform(n_order, mesh, c0.x, c0.y, faces, proj)
        V = c0.V
        ctx = build_triangle_context(n_order, mesh, coords=(x, y), **kw)
    cub = build_cubature_context(n_order, mesh, x, y, V)
    gauss = build_gauss_face_context(n_order, mesh, x, y, V)
    return ctx, cub, gauss
