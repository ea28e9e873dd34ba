"""The shapes the counts read, taken from the reference's own mesh."""
from __future__ import annotations

from ..reference.dg.context import BC_WALL
from .sw2d import CurvedShape, DenseShape


def shape_of(model, cfg: dict):
    """``DenseShape`` or ``CurvedShape`` of a reference model."""
    ctx, ph = model.parts["ctx"], cfg["physics"]
    n_ctrl = cfg["injector"]["controls"]
    if "cub" in model.parts:
        return CurvedShape(
            k_elem=ctx.k_elem, n_p=ctx.n_p, n_cub=model.parts["cub"].n_cub,
            n_gauss=model.parts["gauss"].n_gauss, n_faces=ctx.n_faces,
            n_v=ctx.k_elem * ctx.n_p, n_ctrl=n_ctrl,
            cd=ph.get("drag", 0.0), f_cor=ph.get("coriolis", 0.0),
            has_bed=False)
    phys = model.parts["phys"]
    n_t = ctx.k_elem * ctx.n_faces * ctx.n_fp
    return DenseShape(
        n_p=ctx.n_p, n_faces=ctx.n_faces, n_fp=ctx.n_fp,
        n_v=ctx.k_elem * ctx.n_p, n_t=n_t,
        n_wall=int(ctx.bc_maps.mask[BC_WALL].sum()), n_ctrl=n_ctrl,
        wb=phys.H is not None and phys.well_balanced,
        has_bathy=phys.Hx is not None, tidal="tidal" in ph,
        cd=ph.get("drag", 0.0), f_cor=ph.get("coriolis", 0.0))
