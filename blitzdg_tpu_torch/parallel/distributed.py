"""Multi-process initialization.

Counterpart of the JAX package's ``blitzdg_tpu/parallel/distributed.py``
(``distributed_init``). The JAX package wires hosts together with
``jax.distributed``; here one process per shard joins a ``torch.distributed``
process group, and the sharded path's process-group transport
(``parallel/halo.py``) runs over it. NCCL carries CUDA tensors, gloo CPU
tensors. NCCL refuses two ranks on one card, so on a machine with one card
the sharded path runs its stacked transport instead (all shards on the card).

``make_global_mesh`` has no counterpart yet: the port has no device mesh of
(scenario, element) axes; a process group of element shards is what the
sharded path uses.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None) -> dict:
    """Join the default process group (idempotent).

    Called with no arguments outside a multi-process job, it joins nothing
    and only reports the local view, so library code can call it
    unconditionally. ``init_method`` is an address such as
    ``tcp://localhost:29500``; ``backend`` defaults to NCCL when CUDA is
    available and gloo otherwise.

    Returns {n_processes, process_id, n_devices_global, n_devices_local}.
    """
    multi = init_method is not None or (world_size is not None
                                        and world_size > 1)
    if multi and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    n_local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if dist.is_initialized():
        n_proc, pid = dist.get_world_size(), dist.get_rank()
    else:
        n_proc, pid = 1, 0
    return {"n_processes": n_proc, "process_id": pid,
            "n_devices_global": n_local * n_proc, "n_devices_local": n_local}
