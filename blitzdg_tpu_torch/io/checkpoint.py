"""Checkpoint/resume for long simulations and MPC runs.

Counterpart of the JAX package's ``blitzdg_tpu/io/checkpoint.py``: any
pytree of tensors (solver state, control sequences, optimizer state) and
Python scalars round-trips through a single ``.npz`` file with structure
metadata, its pytree the one of ``torch.utils._pytree`` (tuples, lists,
dicts, NamedTuples). The file layout is the JAX package's: ``leaf_<i>``
arrays and a ``__meta__`` JSON record (treedef string, leaf count, shapes,
dtypes, step, t, extra).

Restores are VALIDATED: the stored treedef string, leaf count, and every
leaf's shape (and dtype unless ``strict_dtype=False``) must match the
template; a mismatched template raises instead of silently mis-assigning
leaves. A torch treedef string is not a JAX one, so a checkpoint written by
the JAX package does not restore here (and is not meant to).
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.utils._pytree as pytree

from .csv import _host


def _dtype_of(leaf):
    """The numpy dtype a template leaf stands for, or None (no dtype)."""
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    if hasattr(leaf, "dtype"):
        return np.asarray(leaf).dtype
    return None


def _shape_of(leaf) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def save_checkpoint(path: str, state, step: int = 0, t: float = 0.0,
                    meta: dict | None = None) -> None:
    leaves, treedef = pytree.tree_flatten(state)
    host = [_host(l) for l in leaves]
    payload = {f"leaf_{i}": a for i, a in enumerate(host)}
    payload["__meta__"] = np.frombuffer(
        json.dumps(
            {
                "treedef": str(treedef),
                "n_leaves": len(leaves),
                "shapes": [list(a.shape) for a in host],
                "dtypes": [str(a.dtype) for a in host],
                "step": step,
                "t": t,
                "extra": meta or {},
            }
        ).encode(),
        dtype=np.uint8,
    )
    np.savez(path, **payload)


def _restore_leaf(stored: np.ndarray, want):
    """A stored array as the template leaf's kind: a tensor on the
    template's device in its dtype, a Python scalar of its type, else the
    array."""
    if isinstance(want, torch.Tensor):
        return torch.as_tensor(stored, dtype=want.dtype, device=want.device)
    if isinstance(want, (bool, int, float)):
        return type(want)(stored.item())
    return stored


def restore_checkpoint(path: str, like, strict_dtype: bool = True):
    """Restore into the structure of ``like`` (a template pytree with the
    same layout). Returns (state, step, t, extra).

    Validates structure before assigning: treedef string, leaf count, and
    per-leaf shape (and dtype unless ``strict_dtype=False``) must match the
    template; raises ValueError with the first mismatch otherwise. Restored
    tensors go to the template leaf's device and dtype.
    """
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    leaves_like, treedef = pytree.tree_flatten(like)

    n_stored = meta.get("n_leaves", len(leaves_like))
    if n_stored != len(leaves_like):
        raise ValueError(
            f"checkpoint has {n_stored} leaves, template has "
            f"{len(leaves_like)}")
    if meta.get("treedef") is not None and meta["treedef"] != str(treedef):
        raise ValueError(
            "checkpoint treedef does not match template:\n"
            f"  stored:   {meta['treedef']}\n"
            f"  template: {treedef}")

    leaves = [data[f"leaf_{i}"] for i in range(n_stored)]
    for i, (got, want) in enumerate(zip(leaves, leaves_like)):
        if tuple(got.shape) != _shape_of(want):
            raise ValueError(
                f"leaf {i}: stored shape {tuple(got.shape)} != template "
                f"shape {_shape_of(want)}")
        want_dtype = _dtype_of(want)
        if strict_dtype and want_dtype is not None and got.dtype != want_dtype:
            raise ValueError(
                f"leaf {i}: stored dtype {got.dtype} != template dtype "
                f"{want_dtype}")
    state = pytree.tree_unflatten(
        [_restore_leaf(a, w) for a, w in zip(leaves, leaves_like)], treedef)
    return state, meta["step"], meta["t"], meta["extra"]
