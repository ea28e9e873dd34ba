"""Operations and bytes of the shallow-water rollout kernels, from shapes.

Frozen copies of ``chip_smoke.py``'s ``rhs_flops``, ``vjp_flops``,
``curved_rhs_flops``, ``curved_vjp_flops`` and of the byte counts of its
``check_case`` and ``check_curved_case`` at commit dfe7828: float32
operations of the functions the kernels compute, each add, multiply,
division, square root and maximum counted once and a multiply-add of a
per-element product twice; each input byte read once and each output byte
written once. ``DenseShape`` and ``CurvedShape`` carry what the formulas
read; ``reference.geometry`` fills them from the benchmark's own mesh.
"""
from __future__ import annotations

from typing import NamedTuple


class DenseShape(NamedTuple):
    """Nodal triangles, strong form (the dense kernels' operator set)."""

    n_p: int
    n_faces: int
    n_fp: int
    n_v: int  # K * Np
    n_t: int  # K * Nfaces * Nfp
    n_wall: int  # trace nodes on walls
    n_ctrl: int
    wb: bool  # well-balanced traces
    has_bathy: bool
    tidal: bool
    cd: float
    f_cor: float


class CurvedShape(NamedTuple):
    """Curved weak form with cubature and Gauss faces (four fields)."""

    k_elem: int
    n_p: int
    n_cub: int
    n_gauss: int
    n_faces: int
    n_v: int
    n_ctrl: int
    cd: float
    f_cor: float
    has_bed: bool

    @property
    def n_tr(self) -> int:
        return self.n_faces * self.n_gauss


def rhs_flops(m: DenseShape, use_filter: bool = True) -> float:
    """One strong-form RHS of one scenario."""
    np_, ntr = m.n_p, m.n_faces * m.n_fp
    if m.wb:
        # velocities 4, star depths 7, correction 5, two flux_uv 26,
        # speeds 15, jumps 3, three dflux 24 + correction 5, fscale 3
        trace = 4 + 7 + 5 + 26 + 15 + 3 + 24 + 5 + 3
    else:
        # velocities 4, two conservative fluxes 24, speeds 15, jumps 3,
        # three dflux 24, fscale 3
        trace = 4 + 24 + 15 + 3 + 24 + 3
    trace += (m.n_fp - 1) + (3 if m.tidal else 0)
    # volume flux 12, Dr/Ds on five fields 20 Np, metric combine 24,
    # lift 6 Ntr, filter 6 Np, stage axpy 6
    vol = 12 + 20 * np_ + 24 + 6 * ntr + 6 + 4 * m.n_ctrl
    vol += 6 * np_ if use_filter else 0
    vol += (5 if m.has_bathy else 0) + (12 if m.cd else 0)
    vol += 4 if m.f_cor else 0
    return trace * m.n_t + 8 * m.n_wall + vol * m.n_v


def vjp_flops(m: DenseShape, use_filter: bool = True) -> float:
    """One application of the RHS adjoint, the trace recompute included."""
    np_ = m.n_p
    # recompute 36, lift^T 6 Np + 3, speed cotangent 6 + face 3 Nfp + 9,
    # flux cotangents 15, two flux adjoints 64, two speed adjoints 32,
    # velocity adjoints 14, star/tidal 3, gather transpose 6
    trace = 36 + 6 * np_ + 3 + 6 + 3 * m.n_fp + 9 + 15 + 64 + 32 + 14 + 3 + 6
    trace += 20 if m.wb else 0
    # filter^T 6 Np + 3, control cotangent, div^T 18 Np, flux adjoint 25,
    # sources, lambda update 6
    vol = 3 + 4 * m.n_ctrl + 18 * np_ + 25 + 6
    vol += 6 * np_ if use_filter else 0
    vol += (5 if m.has_bathy else 0) + (30 if m.cd else 0)
    vol += 4 if m.f_cor else 0
    return trace * m.n_t + 10 * m.n_wall + vol * m.n_v


def dense_rollout(m: DenseShape, B: int, n_cs: int, spc: int):
    """(bytes, operations) of one forward rollout launch: the start state
    and the controls in, the stored trajectory out."""
    n_steps = n_cs * spc
    byts = 4.0 * (3 * B * m.n_v + B * n_cs * m.n_ctrl
                  + 3 * B * (n_steps + 1) * m.n_v)
    return byts, B * n_steps * 2 * rhs_flops(m)


def dense_rollout_bwd(m: DenseShape, B: int, n_cs: int, spc: int):
    """(bytes, operations) of one adjoint rollout launch: the trajectory
    and its cotangents in, the state and control cotangents out."""
    n_steps = n_cs * spc
    byts = 4.0 * (6 * B * (n_steps + 1) * m.n_v + 2 * B * n_cs * m.n_ctrl
                  + 3 * B * m.n_v)
    return byts, B * n_steps * (rhs_flops(m) + 2 * vjp_flops(m))


def curved_rhs_flops(m: CurvedShape, use_filter: bool = True) -> float:
    """One curved RHS of one scenario; the '+' trace is a fetch of the
    neighbour's interpolated value."""
    np_, nc, nt = m.n_p, m.n_cub, m.n_tr
    fma = 3 * nc * np_ + 2 * nt * np_ + np_ * np_
    fma += np_ * np_ if use_filter else 0
    # cubature point: fluxes 14, four weighted pairs 24
    # Gauss point: two flux sets 28, two speeds 18, central part 28, jumps 4,
    # weighted flux 12; face: maximum over its NG points, NG-1
    # node: sources up to 20, control 4 n_ctrl, stage update 8
    point = (38 * nc + 90 * nt + (m.n_gauss - 1) * m.n_faces
             + (8 + 4 * m.n_ctrl + (20 if m.cd or m.f_cor else 0)
                + (6 if m.has_bed else 0)) * np_)
    return m.k_elem * (2.0 * 4 * fma + point)


def curved_vjp_flops(m: CurvedShape, use_filter: bool = True) -> float:
    """One application of the curved RHS adjoint, the recompute of cubature
    and Gauss values included."""
    np_, nc, nt = m.n_p, m.n_cub, m.n_tr
    # mass^T; Dr^T, Ds^T transposed, V and V^T; GI on the values, on the
    # cotangent, and transposed
    fma = np_ * np_ + 4 * nc * np_ + 3 * nt * np_
    fma += np_ * np_ if use_filter else 0
    # cubature point: weights 24, flux adjoint 36
    # Gauss point: two speeds 18, flux cotangents 16, speed cotangent 8, two
    # flux adjoints 72, speed part 8, two speed adjoints 24; face: the share
    # of the speed cotangent among its largest points, 3 NG
    # node: source adjoint up to 30, control 4 n_ctrl, lambda update 8
    point = (60 * nc + 146 * nt + 3 * nt
             + (8 + 4 * m.n_ctrl + (30 if m.cd or m.f_cor else 0)
                + (5 if m.has_bed else 0)) * np_)
    return m.k_elem * (2.0 * 4 * fma + point)


def curved_rollout(m: CurvedShape, B: int, n_cs: int, spc: int):
    """(bytes, operations) of one curved forward rollout launch with its
    trajectory stored."""
    n_steps = n_cs * spc
    byts = 4.0 * (4 * B * m.n_v + B * n_cs * m.n_ctrl
                  + 4 * B * (n_steps + 1) * m.n_v)
    return byts, B * n_steps * 2 * curved_rhs_flops(m)


def curved_rollout_bwd(m: CurvedShape, B: int, n_cs: int, spc: int,
                       n_tb: int = 1):
    """(bytes, operations) of one curved adjoint rollout launch with
    ``n_tb`` trajectory cotangents (the MPC cost gives the depth's
    alone)."""
    n_steps = n_cs * spc
    byts = 4.0 * ((4 + n_tb) * B * (n_steps + 1) * m.n_v
                  + 2 * B * n_cs * m.n_ctrl + 4 * B * m.n_v)
    return byts, B * n_steps * (curved_rhs_flops(m)
                                + 2 * curved_vjp_flops(m))


COUNTS = {"dense_rollout": dense_rollout,
          "dense_rollout_bwd": dense_rollout_bwd,
          "curved_rollout": curved_rollout,
          "curved_rollout_bwd": curved_rollout_bwd}
