"""Helpers shared by the port's parity tests (``test_torch_*.py``)."""
import numpy as np

import blitzdg_tpu.context as jctx_mod

STATIC = ("n_order", "n_p", "k_elem", "n_faces", "n_fp")


def jax_arrays(jc):
    """A JAX context's fields as numpy: the ``np.asarray`` side of
    ``blitzdg_tpu_torch.convert``. Returns (arrays, static)."""
    d = jctx_mod.asdict(jc)
    arrays = {k: (None if v is None else np.asarray(v))
              for k, v in d.items() if k not in STATIC and k != "bc_maps"}
    arrays["bc_maps"] = {
        "idx": {t: np.asarray(v) for t, v in jc.bc_maps.idx.items()},
        "mask": {t: np.asarray(v) for t, v in jc.bc_maps.mask.items()}}
    return arrays, {k: d[k] for k in STATIC}
