"""Observability and robustness utilities.

Counterpart of the JAX package's ``blitzdg_tpu/utils.py``:
 - ``trace`` / ``annotate``: ``torch.profiler`` wrappers (a trace of host
   and device activity written as a Chrome trace; a named region);
 - ``StepTimer``: wall-clock per-chunk timing that synchronizes the
   result's device before it reads the clock;
 - ``instability_guard``: the blow-up predicate (max > 1e8 or non-finite)
   as a tensor, so a loop can test it without a host round trip;
 - ``checked_update``: freeze-on-blowup state update;
 - ``build_sponge_coefficient``: the sponge-layer relaxation coefficient.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.utils._pytree as pytree


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed code (host and, where there is one, the CUDA
    device) and write a Chrome trace (``trace.json``, viewable in Perfetto
    or chrome://tracing) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for profiler timelines (decorator/context)."""
    return torch.profiler.record_function(name)


def _block_until_ready(result) -> None:
    """Wait for the devices of every tensor in ``result`` (a pytree)."""
    devices = {t.device for t in pytree.tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock timing of chunks of work (blocks on the device)."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self, result_to_block=None):
        """Time the enclosed code; ``result_to_block`` (a tensor or pytree
        of tensors, filled in by the code) is waited for before the clock
        is read."""
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            _block_until_ready(result_to_block)
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))

    def summary(self) -> str:
        if not self.times:
            return "no samples"
        return (
            f"n={len(self.times)} mean={self.mean * 1e3:.3f}ms "
            f"min={min(self.times) * 1e3:.3f}ms max={max(self.times) * 1e3:.3f}ms"
        )


def instability_guard(*fields, threshold: float = 1e8) -> torch.Tensor:
    """True (a bool tensor) when any field is non-finite or exceeds the
    blow-up threshold."""
    bad = None
    for f in fields:
        m = torch.max(torch.abs(f))
        b = ~torch.isfinite(m) | (m > threshold)
        bad = b if bad is None else bad | b
    return torch.tensor(False) if bad is None else bad


def checked_update(new_state, old_state, threshold: float = 1e8):
    """Return new_state unless it blew up, else keep old_state (and the
    flag). Keeps a loop total: the host can inspect the flag after it."""
    leaves = pytree.tree_leaves(new_state)
    bad = instability_guard(*leaves, threshold=threshold)
    out = pytree.tree_map(lambda n, o: torch.where(bad, o, n), new_state,
                          old_state)
    return out, bad


def build_sponge_coefficient(ctx, open_boundary_mask, width: float,
                             strength: float = 1.0) -> torch.Tensor:
    """Sponge-layer relaxation coefficient: quadratic ramp within ``width``
    of the open-boundary nodes (vectorized distance to the node set).

    open_boundary_mask: boolean (K, Nfaces*Nfp) marking open face nodes.
    Returns a (K, Np) coefficient in [0, strength], on ``ctx.x``'s device
    and in its dtype.
    """
    x = ctx.x.detach().double().cpu().numpy()
    y = ctx.y.detach().double().cpu().numpy()
    vm = ctx.vmapM.reshape(-1).cpu().numpy()
    mask = np.asarray(open_boundary_mask).reshape(-1)
    if not mask.any():
        return torch.zeros_like(ctx.x)
    ob = vm[mask]
    xo = x.reshape(-1)[ob]
    yo = y.reshape(-1)[ob]
    d = np.sqrt(
        (x.reshape(-1)[:, None] - xo[None, :]) ** 2
        + (y.reshape(-1)[:, None] - yo[None, :]) ** 2
    ).min(axis=1)
    ramp = np.clip(1.0 - d / width, 0.0, 1.0) ** 2
    return torch.as_tensor(strength * ramp.reshape(x.shape),
                           dtype=ctx.x.dtype, device=ctx.x.device)
