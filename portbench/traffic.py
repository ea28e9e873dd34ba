"""The one generator of every cell's requests.

A cell's ``load`` (its workload file) fixes the sizes; the seed fixes
everything else. Before the window the generator makes a pool of
``pool`` batches on the device, in a few large calls from one
``torch.Generator``: each scenario starts from the configuration's rest
state with a Gaussian bump of seeded height and place on the depth, a
seeded uniform current in the momenta (and a seeded bump in a tracer, where
the state carries one), and tracks a Gaussian elevation target of seeded
amplitude and centre. Request i takes batch i mod pool, so every seed
gives the same sizes and the same work.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Batch(NamedTuple):
    state: tuple  # (B, K, Np) per field
    targets: torch.Tensor  # (B, K, Np) elevation to track


def _uniform(gen, lo_hi, shape, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float64)


def make_pool(load: dict, model, seed: int, device) -> list[Batch]:
    """``load["pool"]`` batches of ``load["batch"]`` scenarios in float32 on
    ``device``; ``model`` gives the nodes and the rest state (float64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    P, B = load["pool"], load["batch"]
    st, tg = load["state"], load["target"]
    x = model.x.to(device, torch.float64)
    y = model.y.to(device, torch.float64)
    rest = [r.to(device, torch.float64) for r in model.rest]
    n = (P, B, 1, 1)

    def bump(amp, cx, cy, width):
        return amp * torch.exp(-width * ((x - cx) ** 2 + (y - cy) ** 2))

    centre = lambda r: _uniform(gen, r, n, device)
    h = rest[0] + bump(_uniform(gen, st["elevation"], n, device),
                       centre(st["centre"]), centre(st["centre"]),
                       st["width"])
    fields = [h, _uniform(gen, st["current"], n, device) * h,
              _uniform(gen, st["current"], n, device) * h]
    if len(rest) == 4:
        fields.append(rest[3] + bump(_uniform(gen, st["tracer"], n, device),
                                     centre(st["centre"]),
                                     centre(st["centre"]), st["width"]))
    targets = bump(_uniform(gen, tg["amp"], n, device),
                   centre(tg["centre_x"]), centre(tg["centre_y"]),
                   tg["width"])
    f32 = lambda t: t.to(torch.float32).contiguous()
    return [Batch(tuple(f32(f[p]) for f in fields), f32(targets[p]))
            for p in range(P)]


SAMPLE_TABLE = 4096  # rows of the table; request i takes row i mod this


def sample_table(load: dict, seed: int) -> np.ndarray:
    """The scenarios whose answers are kept, a row a request: ``per_request``
    of them, drawn from the seed, (SAMPLE_TABLE, per_request)."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    B, k = load["batch"], load["sample"]["per_request"]
    return np.stack([np.sort(rng.choice(B, k, replace=False))
                     for _ in range(SAMPLE_TABLE)])


def checked(load: dict, seed: int, n_kept: int) -> np.ndarray:
    """Which of ``n_kept`` kept answers the reference checks: ``checked``
    of them (or all), drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 2])
    k = min(n_kept, load["sample"]["checked"])
    return np.sort(rng.choice(n_kept, k, replace=False))
