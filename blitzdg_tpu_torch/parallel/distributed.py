"""Multi-process initialization and the (scenario, element) device mesh
across processes.

Counterpart of the JAX package's ``blitzdg_tpu/parallel/distributed.py``
(``distributed_init``, ``make_global_mesh``). The JAX package wires hosts
together with ``jax.distributed``; here one process per shard joins a
``torch.distributed`` process group, and the sharded path's process-group
transport (``parallel/halo.py``) runs over it. NCCL carries CUDA tensors,
gloo CPU tensors. NCCL refuses two ranks on one card, so on a machine with
one card the sharded path runs its stacked transport instead (all shards on
the card, ``parallel.make_device_mesh``).

``make_global_mesh`` lays the ranks of the process group out as a
(scenario, element) ``DeviceMesh``; its element group is the ``group=`` of
the halo functions, the sharded steps and ``cg``/``gmres``.
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


def make_global_mesh(n_scenario: int = 1, n_element: int | None = None):
    """(scenario, element) ``torch.distributed.device_mesh.DeviceMesh`` over
    every rank of the initialised process group (``distributed_init``).

    The element axis runs fastest, so an element group holds consecutive
    ranks: within a host where ``n_element`` is at most its ranks, so that
    the halo traffic of every RK stage stays on the host's links, while the
    scenario axis (no collective a step) is the one that crosses hosts.
    ``mesh.get_group("element")`` is the process group of this rank's
    element shards. Its device type follows the backend: "cuda" on NCCL,
    else "cpu".
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh needs an initialised process "
                           "group: call distributed_init(...) first")
    n = dist.get_world_size()
    if n_element is None:
        n_element = n // n_scenario
    if n_scenario * n_element != n:
        raise ValueError(f"a ({n_scenario}, {n_element}) mesh does not hold "
                         f"the {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_scenario, n_element),
                            mesh_dim_names=("scenario", "element"))
