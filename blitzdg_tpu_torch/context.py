"""Device-resident DG contexts: frozen dataclasses of static-shaped tensors.

Counterpart of the JAX package's ``blitzdg_tpu/context.py`` (BC constants,
``BCMaps``, ``DGContext1D`` and ``DGContext2D`` with ``surface_trace``,
``face_trace_structure``). Layout is element-major as there:
per-node fields are ``(K, Np)``, per-face-node fields ``(K, Nfaces*Nfp)``,
reference-element operators ``(Np, Np)`` / ``(Np, Nfaces*Nfp)``.

All index maps are precomputed on the host:
 - ``vmapM``/``vmapP``: flat indices into a flattened ``(K*Np,)`` volume
   field, shaped ``(K, Nfaces*Nfp)``: the interface trace-exchange pattern.
 - ``mapP``: flat indices into the flattened ``(K*Nfaces*Nfp,)`` trace array.
 - Boundary-condition node lists are fixed-size padded index arrays + masks.

Index tensors are ``int64`` (what ``torch`` indexing takes); the fused
kernels convert the two they need to ``int32`` once, when their operator
set is frozen.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

# Boundary-condition tags (same values as the JAX package).
BC_NONE = 0
BC_IN = 1
BC_OUT = 2
BC_WALL = 3
BC_FAR = 4
BC_CYL = 5
BC_DIRICHLET = 6
BC_NEUMAN = 7
BC_SLIP = 8
BC_TAGS = (BC_IN, BC_OUT, BC_WALL, BC_FAR, BC_CYL, BC_DIRICHLET, BC_NEUMAN, BC_SLIP)


def _tree_to(obj: Any, device) -> Any:
    """Move every tensor of a (nested) dataclass/dict/tuple to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: _tree_to(getattr(obj, f.name), device)
                    for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _tree_to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return type(obj)(*(_tree_to(v, device) for v in obj))
    return obj


@dataclass(frozen=True)
class BCMaps:
    """Padded per-tag boundary face-node index sets.

    ``idx[tag]`` is a fixed-length int64 tensor of flat trace indices (into
    ``(K*Nfaces*Nfp,)``), padded with 0; ``mask[tag]`` marks valid entries.
    """

    idx: dict[int, torch.Tensor]
    mask: dict[int, torch.Tensor]

    @staticmethod
    def from_bc_table(bc_face: np.ndarray, nfp: int, device="cuda") -> "BCMaps":
        """bc_face: (K, Nfaces) int tag table; expands to face-node lists."""
        K, Nfaces = bc_face.shape
        idx = {}
        mask = {}
        for tag in BC_TAGS:
            faces = np.argwhere(bc_face == tag)  # (n, 2) rows (k, f)
            flat = (
                (faces[:, 0] * Nfaces + faces[:, 1])[:, None] * nfp
                + np.arange(nfp)[None, :]
            ).ravel()
            n = flat.size
            size = max(1, n)
            pad_idx = np.zeros((size,), dtype=np.int64)
            pad_idx[:n] = flat
            m = np.zeros((size,), dtype=bool)
            m[:n] = True
            idx[tag] = torch.as_tensor(pad_idx, device=device)
            mask[tag] = torch.as_tensor(m, device=device)
        return BCMaps(idx=idx, mask=mask)

    def to(self, device) -> "BCMaps":
        return _tree_to(self, device)


@dataclass(frozen=True)
class DGContext1D:
    """Frozen 1D discretization (line segments, LGL nodes)."""

    n_order: int
    n_p: int
    k_elem: int
    n_faces: int  # == 2
    n_fp: int  # == 1

    # reference-element operators (Np, Np) / (Np, Nfaces*Nfp)
    r: torch.Tensor
    V: torch.Tensor
    Vinv: torch.Tensor
    Dr: torch.Tensor
    lift: torch.Tensor

    # per-element geometry, element-major (K, Np) / (K, Nfaces*Nfp)
    x: torch.Tensor
    J: torch.Tensor
    rx: torch.Tensor
    nx: torch.Tensor
    fscale: torch.Tensor

    # index maps
    vmapM: torch.Tensor  # (K, Nfaces*Nfp) flat into (K*Np,)
    vmapP: torch.Tensor
    mapP: torch.Tensor  # (K, Nfaces*Nfp) flat into (K*Nfaces*Nfp,) traces
    fmask: torch.Tensor  # (Nfaces*Nfp,) face-node ids
    # inflow/outflow endpoints (flat trace indices / flat volume indices)
    mapI: int
    mapO: int
    vmapI: int
    vmapO: int

    def to(self, device) -> "DGContext1D":
        return _tree_to(self, device)

    def surface_trace(self, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Interior and exterior traces of a (..., K, Np) field, flattened
        over the last two axes."""
        fM = u[..., self.fmask.reshape(-1)].reshape(*u.shape[:-2], -1)
        fP = fM[..., self.mapP.reshape(-1)]
        return fM, fP


@dataclass(frozen=True)
class DGContext2D:
    """Frozen 2D discretization (triangles)."""

    n_order: int
    n_p: int
    k_elem: int
    n_faces: int
    n_fp: int

    # reference-element operators
    r: torch.Tensor
    s: torch.Tensor
    V: torch.Tensor
    Vinv: torch.Tensor
    Dr: torch.Tensor
    Ds: torch.Tensor
    Drw: torch.Tensor
    Dsw: torch.Tensor
    lift: torch.Tensor  # (Np, Nfaces*Nfp)
    filter: torch.Tensor  # (Np, Np); identity unless a cutoff was given
    fmask: torch.Tensor  # (Nfaces, Nfp) node ids on each face

    # per-element geometry (K, Np)
    x: torch.Tensor
    y: torch.Tensor
    J: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor

    # per-face-node geometry (K, Nfaces*Nfp)
    nx: torch.Tensor
    ny: torch.Tensor
    fscale: torch.Tensor
    sJ: torch.Tensor

    # index maps
    vmapM: torch.Tensor  # (K, Nfaces*Nfp) flat into (K*Np,)
    vmapP: torch.Tensor
    mapP: torch.Tensor  # (K, Nfaces*Nfp) flat into (K*Nfaces*Nfp,) traces
    mapB: torch.Tensor  # padded boundary trace indices
    maskB: torch.Tensor
    vmapB: torch.Tensor
    bc_maps: BCMaps
    bc_table: torch.Tensor  # (K, Nfaces) raw face tag table

    # SEM assembly (gather/scatter over unique global nodes)
    gather_ids: torch.Tensor
    scatter_ids: torch.Tensor

    # face-granular decomposition of mapP (see face_trace_structure); kept
    # for field parity with the JAX context. ``surface_trace`` here always
    # takes the flat node-level gather: it is the fast form on a GPU.
    face_nbr: torch.Tensor | None = None  # (K*Nfaces,)
    face_flip: torch.Tensor | None = None  # (K*Nfaces,) bool

    def to(self, device) -> "DGContext2D":
        return _tree_to(self, device)

    def surface_trace(self, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Interior ('-') and exterior ('+') traces of a (..., K, Np) field,
        flattened over the last two axes. Equal, bit for bit, to the JAX
        context's face-granular form: both select the same entries."""
        flat = u.reshape(*u.shape[:-2], -1)
        fM = flat[..., self.vmapM.reshape(-1)]
        fP = fM[..., self.mapP.reshape(-1)]
        return fM, fP

    def grad(self, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Nodal gradient of a (K, Np) field via the chain rule."""
        from .config import check_matmul_precision

        check_matmul_precision(u)
        ur = u @ self.Dr.T
        us = u @ self.Ds.T
        return self.rx * ur + self.sx * us, self.ry * ur + self.sy * us


def face_trace_structure(mapP, n_fp: int):
    """Decompose a node-level '+'-trace map into face granularity.

    Returns (face_nbr (F,) int32, face_flip (F,) bool) such that
    mapP.reshape(F, n_fp)[i] == face_nbr[i]*n_fp + (n_fp-1 .. 0 if flip
    else 0 .. n_fp-1), or None if any face's map is not a single
    forward/reversed run of one neighbor face. Host-side (numpy).
    """
    rows = np.asarray(mapP).reshape(-1, n_fp)
    face_of = rows // n_fp
    if not (face_of == face_of[:, :1]).all():
        return None
    within = rows % n_fp
    fwd = (within == np.arange(n_fp)).all(axis=1)
    rev = (within == np.arange(n_fp)[::-1]).all(axis=1)
    if n_fp == 1:
        rev = np.zeros_like(fwd)
    if not (fwd | rev).all():
        return None
    return face_of[:, 0].astype(np.int32), rev


def asdict(ctx: Any) -> dict:
    """Shallow dict view of a context (debug/IO convenience)."""
    return {f.name: getattr(ctx, f.name) for f in dataclasses.fields(ctx)}
