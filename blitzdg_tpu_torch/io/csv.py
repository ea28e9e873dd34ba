"""Whitespace-delimited field files (host numpy).

Counterpart of the JAX package's ``blitzdg_tpu/io/csv.py``: the field
writer (filenames ``field%07d.dat``, space-delimited values), the field and
matrix readers and the nodal depth loader. ``write_field`` also takes a
tensor on either device."""
from __future__ import annotations

import os

import numpy as np


def generate_file_name(base: str, index: int) -> str:
    return f"{base}{index:07d}.dat"


def _host(field) -> np.ndarray:
    """A numpy view of an array or of a tensor on either device."""
    if hasattr(field, "detach"):
        return field.detach().cpu().numpy()
    return np.asarray(field)


def write_field(path: str, field, delimiter: str = " ") -> None:
    np.savetxt(path, _host(field), delimiter=delimiter, fmt="%.17g")


def read_field(path: str) -> np.ndarray:
    return np.loadtxt(path)


def write_fields_to_files(fields: dict, index: int, out_dir: str = ".") -> list[str]:
    paths = []
    for name, data in fields.items():
        p = os.path.join(out_dir, generate_file_name(name, index))
        write_field(p, data)
        paths.append(p)
    return paths


def read_depth_data(path: str, k_elem: int, n_p: int,
                    clip_min: float = 150.0) -> np.ndarray:
    """Bathymetry loader for sw2d's ``.oct`` nodal depth files: one depth
    value per row, filled element-major with the node index fastest, depths
    shallower than ``clip_min`` metres clipped up to ``clip_min``. Returns H
    (K, Np) as float64 numpy. All Np*K entries run through the clip, so
    missing trailing values become ``clip_min``, not 0 (depth 0 would be
    degenerate for sw2d: zero wave speed, division by h)."""
    vals = []
    with open(path) as f:
        for line in f:
            toks = line.replace(",", " ").split()
            if toks:
                vals.append(float(toks[0]))
    H = np.zeros(k_elem * n_p)
    n = min(len(vals), H.size)
    H[:n] = vals[:n]
    H = np.maximum(H, clip_min)
    return H.reshape(k_elem, n_p)


def csvread(path: str, dtype=float) -> np.ndarray:
    """Whitespace/comma-delimited matrix loader: blank lines are skipped;
    ragged rows raise ValueError."""
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            toks = line.replace(",", " ").split()
            if not toks:
                continue
            rows.append((ln, toks))
    if not rows:
        return np.zeros((0, 0), dtype=dtype)
    ncol = len(rows[0][1])
    for ln, toks in rows:
        if len(toks) != ncol:
            raise ValueError(
                f"{path}:{ln}: expected {ncol} columns, got {len(toks)}"
            )
    return np.array([[dtype(t) for t in toks] for _, toks in rows])
