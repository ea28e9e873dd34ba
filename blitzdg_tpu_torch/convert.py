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

from .context import BCMaps, DGContext1D, DGContext2D
from .ops.sw2d import SWPhysics
from .ops.sw2d_blocked import BlockedMeta, BlockedOps, build_blocked_step_ops
from .ops.sw2d_curved_blocked import (CurvedBlockedMeta, CurvedBlockedOps,
                                      build_curved_blocked_ops)
from .ops.sw2d_fused import FusedStepMeta, FusedStepOps, build_fused_step_ops
from .parallel.blocked_shard import ShardedBlocked, build_sharded_blocked
from .parallel.halo import HaloPlan
from .specgrid.cubature import CubatureContext2D, GaussFaceContext2D

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


_STATIC_1D = ("n_order", "n_p", "k_elem", "n_faces", "n_fp", "mapI", "mapO",
              "vmapI", "vmapO")
_INDEX_1D = ("vmapM", "vmapP", "mapP", "fmask")


def context1d_from_numpy(arrays: dict, device="cuda",
                         dtype: torch.dtype = torch.float32) -> DGContext1D:
    """Build the port's 1D context from the JAX ``DGContext1D``'s fields:
    ``arrays`` maps every field name to its value (the integers as ints,
    each array through ``np.asarray``)."""
    fields = {}
    for name, a in arrays.items():
        if name in _STATIC_1D:
            fields[name] = int(a)
        elif name in _INDEX_1D:
            fields[name] = torch.as_tensor(np.array(a, dtype=np.int64),
                                           device=device)
        else:
            fields[name] = torch.as_tensor(np.array(a, dtype=np.float64),
                                           dtype=dtype, device=device)
    return DGContext1D(**fields)


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


def _fields_from_numpy(cls, arrays: dict, static: str, device, dtype):
    """A frozen context ``cls`` from its fields as numpy: ``static`` names
    the integer field, index and boolean arrays keep their kind, every other
    array goes to ``dtype``."""
    fields = {static: int(arrays[static])}
    for name, a in arrays.items():
        if name == static:
            continue
        if isinstance(a, dict):  # per-tag boundary lists
            kind = bool if name == "bc_mask" else np.int64
            fields[name] = {int(t): torch.as_tensor(np.asarray(v, dtype=kind),
                                                    device=device)
                            for t, v in a.items()}
        elif name in ("mapM", "mapP"):
            fields[name] = torch.as_tensor(np.asarray(a, dtype=np.int64),
                                           device=device)
        else:
            fields[name] = torch.as_tensor(np.asarray(a, dtype=np.float64),
                                           dtype=dtype, device=device)
    return cls(**fields)


def cubature_from_numpy(arrays: dict, device="cuda",
                        dtype: torch.dtype = torch.float32
                        ) -> CubatureContext2D:
    """The port's cubature context from the fields of the JAX package's
    ``CubatureContext2D``, each through ``np.asarray`` (``n_cub`` as int)."""
    return _fields_from_numpy(CubatureContext2D, arrays, "n_cub", device,
                              dtype)


def gauss_from_numpy(arrays: dict, device="cuda",
                     dtype: torch.dtype = torch.float32
                     ) -> GaussFaceContext2D:
    """The port's Gauss face context from the fields of the JAX package's
    ``GaussFaceContext2D`` (``bc_idx``/``bc_mask`` as ``{tag: array}``)."""
    return _fields_from_numpy(GaussFaceContext2D, arrays, "n_gauss", device,
                              dtype)


def curved_blocked_ops_from_numpy(ctx_arrays: dict, ctx_static: dict,
                                  cub_arrays: dict, gauss_arrays: dict,
                                  phys_arrays: dict, forcing_bu=None,
                                  forcing_bv=None, zx=None, zy=None,
                                  mass_mode: str = "auto",
                                  use_filter: bool = True, device="cuda",
                                  dtype: torch.dtype = torch.float32
                                  ) -> tuple[CurvedBlockedOps,
                                             CurvedBlockedMeta]:
    """The curved kernels' operator set from the JAX contexts' fields. The
    operators are formed in float64 from the given arrays and then stored in
    ``dtype``."""
    ctx, phys = _host_float64(ctx_arrays, ctx_static, phys_arrays)
    cub = cubature_from_numpy(cub_arrays, device="cpu", dtype=torch.float64)
    gauss = gauss_from_numpy(gauss_arrays, device="cpu", dtype=torch.float64)
    return build_curved_blocked_ops(ctx, cub, gauss, phys, forcing_bu,
                                    forcing_bv, zx, zy, dtype=dtype,
                                    mass_mode=mass_mode,
                                    use_filter=use_filter, device=device)


def halo_plan_from_numpy(send_idx, psrc, pflip, offs, n_shards: int,
                         max_send: int) -> HaloPlan:
    """The port's ``HaloPlan`` from the JAX package's plan fields."""
    return HaloPlan(send_idx=np.asarray(send_idx, dtype=np.int32),
                    psrc=np.asarray(psrc, dtype=np.int32),
                    pflip=np.asarray(pflip, dtype=bool),
                    offs=tuple(int(d) for d in offs), n_shards=int(n_shards),
                    max_send=int(max_send))


def sharded_blocked_from_numpy(ctx_arrays: dict, ctx_static: dict,
                               phys_arrays: dict, n_shards: int,
                               forcing_bu=None, forcing_bv=None, tidal=None,
                               wetdry: bool = False, h_floor: float = 1e-3,
                               device="cuda",
                               dtype: torch.dtype = torch.float32
                               ) -> ShardedBlocked:
    """The sharded path's per-shard operator sets from the JAX context's and
    physics' fields (a context on a partitioned mesh, as the JAX package's
    ``build_sharded_blocked`` takes it). The operators are formed in float64
    from the given arrays and then stored in ``dtype``."""
    ctx, phys = _host_float64(ctx_arrays, ctx_static, phys_arrays)
    return build_sharded_blocked(ctx, phys, n_shards, dtype=dtype,
                                 tidal=tidal, wetdry=wetdry, h_floor=h_floor,
                                 forcing_bu=forcing_bu, forcing_bv=forcing_bv,
                                 device=device)
