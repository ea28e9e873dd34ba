"""The coastal box, reference side: ``box_triangles`` with the east faces
open, shelf bathymetry, drag, Coriolis, the tide on the open faces, the
modal filter, two Gaussian momentum injectors (``configs/*.json`` with
``"reference": "coastal_box"``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from .dg.context import BC_OUT
from .dg.generators import box_triangles
from .dg.sw2d import SWPhysics, apply_filter, sw2d_rhs
from .dg.triangle import build_triangle_context
from .models import Model, cfl_dt, quadrature_weights


def _retag_east_open(mesh) -> None:
    """Boundary faces whose midpoint lies on x = max x become BC_OUT."""
    xmax = float(mesh.verts[:, 0].max())
    bc = np.asarray(mesh.bc_type).copy()
    a = mesh.verts[mesh.etov, 0]
    b = mesh.verts[np.roll(mesh.etov, -1, axis=1), 0]
    east = np.abs(0.5 * (a + b) - xmax) < 1e-9 * max(1.0, abs(xmax))
    bc[(bc > 0) & east] = BC_OUT
    mesh.set_bc_type(bc)


def build(cfg: dict) -> Model:
    mesh_cfg, ph = cfg["mesh"], cfg["physics"]
    n = mesh_cfg["N"]
    mesh = box_triangles(*mesh_cfg["cells"])
    _retag_east_open(mesh)
    filt = cfg["filter"]
    ctx = build_triangle_context(
        n, mesh, dtype=torch.float64, device="cpu",
        filter_cutoff=filt["cutoff"], filter_order=filt["order"])
    tid = ph["tidal"]
    dt = cfl_dt(ctx, ph["g"], tid["h0"] + 2.0 * tid["amp"], cfg["cfl"])
    x = ctx.x
    xmin, xmax = float(mesh.verts[:, 0].min()), float(mesh.verts[:, 0].max())
    span = xmax - xmin
    shelf = ph["shelf"]
    H = shelf["west"] + (shelf["east"] - shelf["west"]) * (x - xmin) / span
    phys = SWPhysics(g=ph["g"], cd=ph["drag"], f_cor=ph["coriolis"], H=H,
                     Hx=torch.full_like(H, (shelf["east"] - shelf["west"])
                                        / span),
                     Hy=torch.zeros_like(H))

    def tidal(t):
        ramp = min(t / tid["ramp_tau"], 1.0) if tid["ramp_tau"] > 0 else 1.0
        return tid["h0"] + tid["amp"] * math.cos(tid["omega"] * t) * ramp

    def rhs(parts, state, t):
        return tuple(sw2d_rhs(parts["ctx"], state, t, parts["phys"],
                              tidal_forcing=tidal))

    bump = torch.exp(-cfg["injector"]["width"] * (x ** 2 + ctx.y ** 2))
    zero = torch.zeros_like(H)
    return Model(
        fields=("h", "hu", "hv"), x=x, y=ctx.y, rest=(H, zero, zero),
        H_rest=H, wj=quadrature_weights(ctx), bump=bump, dt=dt,
        parts={"ctx": ctx, "phys": phys}, rhs=rhs,
        filt=lambda parts, f: apply_filter(parts["ctx"], f),
        **cfg["weights"])
