"""The curved disk, reference side: ``disk_triangles`` snapped onto the
circle and deformed by Gordon-Hall blending, the weak form with cubature
and Gauss faces, a passive tracer, walls, the modal filter, two Gaussian
momentum injectors (``configs/*.json`` with ``"reference": "curved_disk"``)."""
from __future__ import annotations

import torch

from .dg.cubature import build_cubature_context, build_gauss_face_context
from .dg.curved import (circle_projection, gordon_hall_deform,
                        snap_boundary_vertices)
from .dg.generators import disk_triangles
from .dg.sw2d import SWPhysics, apply_filter
from .dg.sw2d_curved import SWStateTracer, sw2d_curved_rhs
from .dg.triangle import build_triangle_context
from .models import Model, cfl_dt, quadrature_weights


def build(cfg: dict) -> Model:
    mesh_cfg, ph, filt = cfg["mesh"], cfg["physics"], cfg["filter"]
    n = mesh_cfg["N"]
    mesh = disk_triangles(mesh_cfg["rings"], radius=mesh_cfg["radius"])
    proj = circle_projection(0.0, 0.0, mesh_cfg["radius"])
    curved_faces = snap_boundary_vertices(mesh, proj,
                                          tol=mesh_cfg["snap_tol"])
    straight = build_triangle_context(n, mesh, dtype=torch.float64,
                                      device="cpu")
    V = straight.V.numpy()
    xs, ys, _ = gordon_hall_deform(n, mesh, straight.x.numpy(),
                                   straight.y.numpy(), curved_faces, proj)
    ctx = build_triangle_context(
        n, mesh, coords=(xs, ys), filter_cutoff=filt["cutoff"],
        filter_order=filt["order"], dtype=torch.float64, device="cpu")
    cub = build_cubature_context(n, mesh, xs, ys, V,
                                 order=mesh_cfg["cubature_order"],
                                 dtype=torch.float64, device="cpu")
    gauss = build_gauss_face_context(n, mesh, xs, ys, V,
                                     n_gauss=mesh_cfg["gauss_per_face"],
                                     dtype=torch.float64, device="cpu")
    dt = cfl_dt(ctx, ph["g"], ph["h_cfl"], cfg["cfl"])
    phys = SWPhysics(g=ph["g"])

    def rhs(parts, state, t):
        return tuple(sw2d_curved_rhs(parts["ctx"], parts["cub"],
                                     parts["gauss"], SWStateTracer(*state), t,
                                     parts["phys"]))

    h_rest = torch.full_like(ctx.x, ph["h_rest"])
    zero = torch.zeros_like(h_rest)
    bump = torch.exp(-cfg["injector"]["width"] * (ctx.x ** 2 + ctx.y ** 2))
    return Model(
        fields=("h", "hu", "hv", "hN"), x=ctx.x, y=ctx.y,
        rest=(h_rest, zero, zero, zero), H_rest=h_rest,
        wj=quadrature_weights(ctx), bump=bump, dt=dt,
        parts={"ctx": ctx, "cub": cub, "gauss": gauss, "phys": phys},
        rhs=rhs, filt=lambda parts, f: apply_filter(parts["ctx"], f),
        **cfg["weights"])
