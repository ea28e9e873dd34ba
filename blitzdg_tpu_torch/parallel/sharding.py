"""Element-sharded contexts and the (scenario, element) layout.

Counterpart of the JAX package's ``blitzdg_tpu/parallel/sharding.py``
(``ELEMENT_SHARDED_FIELDS``, ``CUBATURE_SHARDED_FIELDS``,
``GAUSS_SHARDED_FIELDS``, ``make_device_mesh``, ``context_shard_specs``,
``cubature_shard_specs``, ``gauss_shard_specs``, ``shard_context``).

The JAX package places a context's per-element arrays with
``PartitionSpec('element')`` on a device mesh and hands the blocks to
``shard_map``. The port has no device mesh of its own: the element shards
are a stacked set on one card (every per-element field gets a leading shard
axis, ``(S, K/S, ...)``), or one block a rank of a ``torch.distributed``
process group (``(1, K/S, ...)``, through ``make_global_mesh``'s element
group). The halo functions (``parallel/halo.py``) take either.

The element axis must be partitioned contiguously first (``partition_mesh``,
``pad_context``), so that block s of every field is shard s's elements.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar

import torch

# Context fields with a leading element (K) axis, which shard over the
# element axis. Everything else (reference-element operators, the GLOBAL
# index lists: bc_maps, mapB/vmapB, gather/scatter ids, face_nbr/face_flip;
# static metadata) is replicated. An explicit allowlist, NOT a shape rule: a
# padded boundary index list can have length K by chance (box 4x4 at N=1:
# 32 wall trace nodes, 32 elements), and a shape rule would split it over
# the shards, so that each applied only a part of the boundary conditions.
ELEMENT_SHARDED_FIELDS = frozenset({
    "x", "J", "rx", "nx", "fscale",                  # 1D + 2D shared
    "y", "ry", "sx", "sy", "ny", "sJ",               # 2D volume/face geometry
    "vmapM", "vmapP", "mapP", "bc_table",            # per-element index maps
})

# The per-element arrays of the cubature and Gauss-face contexts; their
# reference-element operators (V, Dr, Ds, interp, the quadrature nodes)
# replicate, and their maps and boundary lists stay GLOBAL (the halo
# functions localize them).
CUBATURE_SHARDED_FIELDS = frozenset({
    "x", "y", "J", "rx", "ry", "sx", "sy", "W", "MM", "MMchol", "MMinv",
})
GAUSS_SHARDED_FIELDS = frozenset({"x", "y", "nx", "ny", "sJ", "W"})


@dataclass(frozen=True)
class StackedMesh:
    """The (scenario, element) layout of one device: ``n_element`` element
    shards stacked on a leading axis of each per-element field (the stacked
    transport) and ``n_scenario`` scenario groups, which the port's batched
    functions carry as a batch axis. It places nothing: ``shard_context``
    keeps each field on the device it was built on."""

    axis_names: ClassVar[tuple] = ("scenario", "element")
    n_scenario: int
    n_element: int

    @property
    def shape(self) -> tuple:
        return (self.n_scenario, self.n_element)


def make_device_mesh(n_scenario: int = 1, n_element: int = 1) -> StackedMesh:
    """The (scenario, element) layout on one device (the stacked
    transport). Across processes: ``parallel.make_global_mesh``."""
    if n_scenario < 1 or n_element < 1:
        raise ValueError("mesh axes must be at least 1")
    return StackedMesh(n_scenario, n_element)


def _specs(ctx, names) -> dict:
    """Field name -> "element" (sharded on the leading axis) or None
    (replicated)."""
    out = {}
    for f in dataclasses.fields(ctx):
        a = getattr(ctx, f.name)
        out[f.name] = ("element" if f.name in names
                       and isinstance(a, torch.Tensor) and a.dim() >= 1
                       else None)
    return out


def context_shard_specs(ctx) -> dict:
    """Which fields of a DG context shard over the element axis: "element"
    for every ``ELEMENT_SHARDED_FIELDS`` tensor, None (replicated) for the
    rest, ``bc_maps`` included."""
    return _specs(ctx, ELEMENT_SHARDED_FIELDS)


def cubature_shard_specs(cub) -> dict:
    """``context_shard_specs`` of a ``CubatureContext2D``."""
    return _specs(cub, CUBATURE_SHARDED_FIELDS)


def gauss_shard_specs(gauss) -> dict:
    """``context_shard_specs`` of a ``GaussFaceContext2D``: the per-node
    geometry shards; ``interp`` and the GLOBAL maps and boundary lists
    replicate."""
    return _specs(gauss, GAUSS_SHARDED_FIELDS)


def _n_element(mesh) -> int:
    if isinstance(mesh, int):
        return mesh
    if isinstance(mesh, StackedMesh):
        return mesh.n_element
    return mesh.size(mesh.mesh_dim_names.index("element"))  # a DeviceMesh


def shard_context(ctx, mesh, rank: int | None = None):
    """The element shards of a context (a ``DGContext2D``, a
    ``CubatureContext2D`` or a ``GaussFaceContext2D``): each per-element
    field (its ``*_shard_specs``) as (S, K/S, ...), every other field
    replicated. ``mesh``: the number of element shards S, a
    ``make_device_mesh`` layout or a ``make_global_mesh`` device mesh.
    With ``rank`` (the element shard held here; on a device mesh, this
    process's element coordinate by default) the fields are that shard's
    block alone, (1, K/S, ...). A ``DGContext2D``'s ``k_elem`` becomes
    K/S: the shard's element count, which the port's operators read."""
    from ..specgrid.cubature import CubatureContext2D, GaussFaceContext2D

    S = _n_element(mesh)
    if rank is None and not isinstance(mesh, (int, StackedMesh)):
        rank = mesh.get_local_rank("element")
    names = (CUBATURE_SHARDED_FIELDS if isinstance(ctx, CubatureContext2D)
             else GAUSS_SHARDED_FIELDS if isinstance(ctx, GaussFaceContext2D)
             else ELEMENT_SHARDED_FIELDS)
    fields = {}
    for name, spec in _specs(ctx, names).items():
        a = getattr(ctx, name)
        if spec is not None:
            if a.shape[0] % S:
                raise ValueError(f"{name}: {a.shape[0]} rows are not "
                                 f"divisible by {S} shards")
            a = a.reshape(S, a.shape[0] // S, *a.shape[1:])
            if rank is not None:
                a = a[rank:rank + 1]
        fields[name] = a
    if "k_elem" in fields:
        if fields["k_elem"] % S:
            raise ValueError(f"K={fields['k_elem']} is not divisible by {S}")
        fields["k_elem"] //= S
    return dataclasses.replace(ctx, **fields)
