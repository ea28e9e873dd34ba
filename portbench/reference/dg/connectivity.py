"""Frozen copy of ``blitzdg_tpu_torch/mesh/connectivity.py`` at commit dfe7828,
trimmed to what the reference uses.

Face connectivity and boundary-tag matching for unstructured meshes.

Host-side setup (numpy only). Counterpart of the JAX package's
``blitzdg_tpu/mesh/connectivity.py``, kept as an own copy because the port
imports nothing of that package. Each face's vertex pair is sorted into a
key and key-equal faces are matched: O(K log K), no sparse algebra.

Local face ordering convention (same as the reference / Hesthaven-Warburton):
face f of an element connects local vertices (f, (f+1) mod Nfaces).
"""
from __future__ import annotations

import numpy as np


def face_vertices(etov: np.ndarray) -> np.ndarray:
    """(K, Nfaces, 2) vertex ids of each local face."""
    K, Nf = etov.shape
    nxt = np.roll(np.arange(Nf), -1)
    return np.stack([etov, etov[:, nxt]], axis=-1)


def build_connectivity(etov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """EToE/EToF: for each (element, face), the neighbor element and its
    local face id; boundary faces are self-referential."""
    K, Nf = etov.shape
    fv = face_vertices(etov).reshape(K * Nf, 2)
    key = np.sort(fv, axis=1)

    order = np.lexsort((key[:, 1], key[:, 0]))
    sk = key[order]
    etoe = np.repeat(np.arange(K, dtype=np.int32), Nf)
    etof = np.tile(np.arange(Nf, dtype=np.int32), K)

    same = np.all(sk[:-1] == sk[1:], axis=1)
    a = order[:-1][same]  # first face of each matched pair
    b = order[1:][same]  # second face
    etoe_out = etoe.copy()
    etof_out = etof.copy()
    etoe_out[a], etof_out[a] = etoe[b], etof[b]
    etoe_out[b], etof_out[b] = etoe[a], etof[a]
    return etoe_out.reshape(K, Nf), etof_out.reshape(K, Nf)
