"""State carried across from the JAX package, as numpy arrays.

The functions here take numpy only (this module imports nothing of JAX): a
caller that has a JAX context does the ``np.asarray(...)`` on its side. With
them a test can hand the JAX package's own set-up to the port's kernels'
module, so that parity of the kernels does not depend on parity of the
set-up, which is tested on its own.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import BCMaps, DGContext2D
from .ops.sw2d import SWPhysics
from .ops.sw2d_blocked import BlockedMeta, BlockedOps, build_blocked_step_ops
from .ops.sw2d_fused import FusedStepMeta, FusedStepOps, build_fused_step_ops

_STATIC = ("n_order", "n_p", "k_elem", "n_faces", "n_fp")
_INDEX = ("fmask", "vmapM", "vmapP", "mapP", "mapB", "vmapB", "bc_table",
          "gather_ids", "scatter_ids", "face_nbr")
_BOOL = ("maskB", "face_flip")


def context_from_numpy(arrays: dict, static: dict, device="cuda",
                       dtype: torch.dtype = torch.float32) -> DGContext2D:
    """Build the port's context from the JAX context's fields.

    ``arrays``: field name -> numpy array for every array field of the JAX
    ``DGContext2D`` (what its ``asdict`` gives, each through ``np.asarray``),
    with ``bc_maps`` given as ``{"idx": {tag: array}, "mask": {tag: array}}``.
    ``static``: the five integers n_order, n_p, k_elem, n_faces, n_fp.
    """
    fields = {k: int(static[k]) for k in _STATIC}
    for name, a in arrays.items():
        if name in _STATIC:
            continue
        if name == "bc_maps":
            fields[name] = BCMaps(
                idx={int(t): torch.as_tensor(np.asarray(v, dtype=np.int64),
                                             device=device)
                     for t, v in a["idx"].items()},
                mask={int(t): torch.as_tensor(np.asarray(v, dtype=bool),
                                              device=device)
                      for t, v in a["mask"].items()})
        elif a is None:
            fields[name] = None
        elif name in _INDEX:
            fields[name] = torch.as_tensor(np.asarray(a, dtype=np.int64),
                                           device=device)
        elif name in _BOOL:
            fields[name] = torch.as_tensor(np.asarray(a, dtype=bool),
                                           device=device)
        else:
            fields[name] = torch.as_tensor(np.asarray(a, dtype=np.float64),
                                           dtype=dtype, device=device)
    return DGContext2D(**fields)


def physics_from_numpy(g: float = 9.81, cd: float = 0.0, f_cor: float = 0.0,
                       H=None, Hx=None, Hy=None, sponge=None,
                       well_balanced: bool = True, device="cuda",
                       dtype: torch.dtype = torch.float32) -> SWPhysics:
    """Build the port's ``SWPhysics`` from scalars and numpy fields."""
    to = lambda a: None if a is None else torch.as_tensor(
        np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    return SWPhysics(g=float(g), cd=float(cd), f_cor=float(f_cor), H=to(H),
                     Hx=to(Hx), Hy=to(Hy), sponge=to(sponge),
                     well_balanced=bool(well_balanced))


def step_ops_from_numpy(ctx_arrays: dict, ctx_static: dict, phys_arrays: dict,
                        forcing_bu=None, forcing_bv=None, tidal=None,
                        device="cuda", dtype: torch.dtype = torch.float32
                        ) -> tuple[FusedStepOps, FusedStepMeta]:
    """Build the fused kernels' operator set from the JAX context's and
    physics' fields (``phys_arrays``: keyword arguments of
    ``physics_from_numpy``). The operators are formed in float64 from the
    given arrays and then stored in ``dtype``."""
    ctx, phys = _host_float64(ctx_arrays, ctx_static, phys_arrays)
    return build_fused_step_ops(ctx, phys, forcing_bu, forcing_bv,
                                dtype=dtype, tidal=tidal, device=device)


def _host_float64(ctx_arrays: dict, ctx_static: dict, phys_arrays: dict):
    ctx = context_from_numpy(ctx_arrays, ctx_static, device="cpu",
                             dtype=torch.float64)
    phys = physics_from_numpy(**phys_arrays, device="cpu",
                              dtype=torch.float64)
    return ctx, phys


def blocked_step_ops_from_numpy(ctx_arrays: dict, ctx_static: dict,
                                phys_arrays: dict, forcing_bu=None,
                                forcing_bv=None, tidal=None,
                                wetdry: bool = False, h_floor: float = 1e-3,
                                device="cuda",
                                dtype: torch.dtype = torch.float32
                                ) -> tuple[BlockedOps, BlockedMeta]:
    """As ``step_ops_from_numpy``, for the blocked kernels' operator set:
    ``phys_arrays`` may carry ``sponge``, and ``wetdry``/``h_floor`` switch
    the wet/dry branch on."""
    ctx, phys = _host_float64(ctx_arrays, ctx_static, phys_arrays)
    return build_blocked_step_ops(ctx, phys, forcing_bu, forcing_bv,
                                  dtype=dtype, tidal=tidal, wetdry=wetdry,
                                  h_floor=h_floor, device=device)
