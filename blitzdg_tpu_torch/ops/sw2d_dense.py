"""Dense-operator shallow-water RHS.

Counterpart of the JAX package's ``blitzdg_tpu/ops/sw2d_dense.py``: for
small meshes the interface trace extraction, *including the wall reflection
BC*, is a fixed LINEAR map of the state, compiled once into dense
(n_tr*K, Np*K) matrices. The wall reflection
huP = huM - 2 nx (nx huM + ny hvM) mixes the momentum components, so the
momentum '+' traces are a 2x2 block of operators.

The port keeps this module as the second oracle and for parity with the JAX
package; the fused CUDA kernels do NOT use these matrices (they gather
through ``vmapM``/``vmapP``, see ``ops/sw2d_fused.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import check_matmul_precision
from ..context import BC_OUT, BC_WALL, DGContext2D
from .sw2d import SWPhysics, SWState, _lf_flux_jumps, _volume_and_sources


class DenseTraceOps(NamedTuple):
    SM: torch.Tensor  # (n_trK, n_pK): '-' trace selection
    SP: torch.Tensor  # (n_trK, n_pK): '+' trace selection (h field)
    PPuu: torch.Tensor  # momentum '+' traces with wall reflection folded in
    PPuv: torch.Tensor
    PPvu: torch.Tensor
    PPvv: torch.Tensor


def build_dense_trace_ops(ctx: DGContext2D, dtype: torch.dtype | None = None,
                          device=None) -> DenseTraceOps:
    """Host-side (numpy float64), then placed on ``device`` (default: where
    the context lives) in ``dtype`` (default: the context's)."""
    K, n_p = ctx.k_elem, ctx.n_p
    n_tr = ctx.n_faces * ctx.n_fp
    nT, nV = K * n_tr, K * n_p
    vmapM = ctx.vmapM.reshape(-1).cpu().numpy()
    vmapP = ctx.vmapP.reshape(-1).cpu().numpy()
    nx = ctx.nx.reshape(-1).double().cpu().numpy()
    ny = ctx.ny.reshape(-1).double().cpu().numpy()

    SM = np.zeros((nT, nV))
    SP = np.zeros((nT, nV))
    SM[np.arange(nT), vmapM] = 1.0
    SP[np.arange(nT), vmapP] = 1.0

    wall = np.zeros(nT, dtype=bool)
    idx = ctx.bc_maps.idx[BC_WALL].cpu().numpy()
    msk = ctx.bc_maps.mask[BC_WALL].cpu().numpy()
    wall[idx[msk]] = True

    # wall rows: huP = (1 - 2 nx^2) huM - 2 nx ny hvM  (and symmetric for v)
    PPuu = SP.copy()
    PPvv = SP.copy()
    PPuv = np.zeros_like(SP)
    PPvu = np.zeros_like(SP)
    w = np.flatnonzero(wall)
    PPuu[w] = (1.0 - 2.0 * nx[w] ** 2)[:, None] * SM[w]
    PPuv[w] = (-2.0 * nx[w] * ny[w])[:, None] * SM[w]
    PPvu[w] = (-2.0 * nx[w] * ny[w])[:, None] * SM[w]
    PPvv[w] = (1.0 - 2.0 * ny[w] ** 2)[:, None] * SM[w]

    if dtype is None:
        dtype = ctx.x.dtype
    if device is None:
        device = ctx.x.device
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return DenseTraceOps(SM=to(SM), SP=to(SP), PPuu=to(PPuu), PPuv=to(PPuv),
                         PPvu=to(PPvu), PPvv=to(PPvv))


def sw2d_rhs_dense(
    ctx: DGContext2D,
    ops: DenseTraceOps,
    state: SWState,
    t,
    phys: SWPhysics,
    tidal_forcing=None,
) -> SWState:
    """Shallow-water RHS with dense trace operators and full coastal
    physics: wall reflection in the trace operators, optional tidal BC_OUT
    forcing, well-balanced star fluxes when phys.H is present,
    bed-slope/drag/Coriolis.

    State fields: (..., K, Np); trace extraction is (..., n_pK) @ OP.T.
    """
    K, n_tr = ctx.k_elem, ctx.n_faces * ctx.n_fp
    h, hu, hv = state
    lead = h.shape[:-2]
    check_matmul_precision(h)

    hf = h.reshape(*lead, -1)
    huf = hu.reshape(*lead, -1)
    hvf = hv.reshape(*lead, -1)

    hM = hf @ ops.SM.T
    hP = hf @ ops.SP.T
    huM = huf @ ops.SM.T
    hvM = hvf @ ops.SM.T
    huP = huf @ ops.PPuu.T + hvf @ ops.PPuv.T
    hvP = huf @ ops.PPvu.T + hvf @ ops.PPvv.T

    nxf = ctx.nx.reshape(-1)
    nyf = ctx.ny.reshape(-1)

    if tidal_forcing is not None:
        # prescribe total depth on BC_OUT trace nodes (sw2d_rhs analog)
        obc = torch.zeros((K * n_tr,), dtype=hP.dtype, device=hP.device)
        ob_idx = ctx.bc_maps.idx[BC_OUT][ctx.bc_maps.mask[BC_OUT]]
        obc[ob_idx] = 1.0
        h_bc = torch.as_tensor(tidal_forcing(t), dtype=hP.dtype,
                               device=hP.device)
        hP = hP + obc * (h_bc - hP)

    HMt = HPt = None
    if phys.H is not None and phys.well_balanced:
        Hflat = phys.H.reshape(-1)
        HMt = Hflat[ctx.vmapM.reshape(-1)]
        HPt = Hflat[ctx.vmapP.reshape(-1)]

    d1, d2, d3 = _lf_flux_jumps(
        phys.g, ctx.n_fp, nxf, nyf, hM, hP, huM, huP, hvM, hvP, HMt, HPt
    )
    return _volume_and_sources(ctx, phys, h, hu, hv, d1, d2, d3)
