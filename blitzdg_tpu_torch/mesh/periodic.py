"""Periodic boundary identification.

Host-side numpy. Counterpart of the JAX package's
``blitzdg_tpu/mesh/periodic.py`` (own copy). Rewrites vmapP/mapP so traces
on one periodic side read from the matching nodes on the opposite side.
Matching is by the transverse coordinate with a translation along the
periodic axis.
"""
from __future__ import annotations

import numpy as np


def make_periodic(ctx_arrays: dict, axis: str, lo: float, hi: float, tol: float = 1e-6):
    """Return updated (vmapM, vmapP, mapP) with periodic identification.

    ``ctx_arrays`` needs: x, y (K, Np) numpy, vmapM, vmapP, mapP
    (K, Nfaces*Nfp). Boundary trace nodes with coordinate == lo are matched
    to those at hi (and vice versa) by the other coordinate.
    """
    x = np.asarray(ctx_arrays["x"]).reshape(-1)
    y = np.asarray(ctx_arrays["y"]).reshape(-1)
    vmapM = np.array(ctx_arrays["vmapM"])
    vmapP = np.array(ctx_arrays["vmapP"])
    mapP = np.array(ctx_arrays["mapP"])
    shape = vmapM.shape
    vmapM_f = vmapM.reshape(-1)
    vmapP_f = vmapP.reshape(-1)
    mapP_f = mapP.reshape(-1)

    c = x if axis == "x" else y  # periodic coordinate
    d = y if axis == "x" else x  # transverse coordinate
    span = hi - lo

    boundary = np.flatnonzero(vmapP_f == vmapM_f)
    vb = vmapM_f[boundary]
    on_lo = boundary[np.abs(c[vb] - lo) < tol]
    on_hi = boundary[np.abs(c[vb] - hi) < tol]

    def match(src_traces, dst_traces):
        """For each src trace, the dst trace with same transverse coord."""
        sv = vmapM_f[src_traces]
        dv = vmapM_f[dst_traces]
        dd = np.abs(d[sv][:, None] - d[dv][None, :])
        j = np.argmin(dd, axis=1)
        ok = dd[np.arange(len(sv)), j] < tol * max(1.0, abs(span))
        return j, ok

    j_lo, ok_lo = match(on_lo, on_hi)
    j_hi, ok_hi = match(on_hi, on_lo)

    vmapP_f[on_lo[ok_lo]] = vmapM_f[on_hi[j_lo[ok_lo]]]
    mapP_f[on_lo[ok_lo]] = on_hi[j_lo[ok_lo]]
    vmapP_f[on_hi[ok_hi]] = vmapM_f[on_lo[j_hi[ok_hi]]]
    mapP_f[on_hi[ok_hi]] = on_lo[j_hi[ok_hi]]

    return vmapM_f.reshape(shape), vmapP_f.reshape(shape), mapP_f.reshape(shape)
