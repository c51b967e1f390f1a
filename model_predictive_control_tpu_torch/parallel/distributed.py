"""Multi-process execution: the process group, the global mesh and global
batches (port of ``parallel/distributed.py``).

One process per device. Every process runs the same program; after
:func:`initialize` the default group spans them, and :func:`global_mesh`
puts the ranks on a ``(data × model)`` mesh with the processes in rank order
on the outer data axis, so that the scenario batch crosses hosts and the
optional model axis stays between neighbouring ranks. A launcher such as
``torchrun --nproc-per-node=G`` exports what :func:`initialize` reads.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device
from .mesh import _backend_for, _group_device, batch_sharding, data_slice, make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    backend: str | None = None,
) -> bool:
    """Start the default process group where a multi-process run is
    configured; a no-op returning ``False`` for one process.

    The arguments default from torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (or ``coordinator_address`` as ``host:port``),
    ``WORLD_SIZE``, ``RANK``. On the card (``device`` ``None`` or CUDA) each
    process takes ``cuda:LOCAL_RANK`` and NCCL; gloo only where the caller
    passes ``device="cpu"`` or names ``backend="gloo"``. Returns ``True``
    when running multi-process (also where the group already exists)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    backend = backend or _backend_for(device.type)
    dist.init_process_group(
        backend,
        init_method=coordinator_address if "://" in coordinator_address
        else f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, device_id=_group_device(backend),
    )
    return True


def global_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """``(data × model)`` mesh over every rank of the default group, ranks
    in order with the data axis outermost (one rank, and no group, makes a
    one-rank mesh as :func:`.mesh.make_mesh` does)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel != 0:
        raise ValueError(f"{n} global ranks not divisible by model_parallel={model_parallel}")
    return make_mesh(n, model_parallel, device=device)


def process_batch_slice(global_batch: int, mesh: DeviceMesh | None = None) -> tuple[int, int]:
    """This process's half-open scenario range ``[lo, hi)`` of a global
    batch: by its data coordinate on ``mesh`` (ranks that differ only on the
    model axis share a range), else by rank over the whole world. The batch
    must split evenly, so that every process runs the same program shape."""
    if mesh is not None:
        return data_slice(mesh, global_batch)
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n_proc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n_proc} processes")
    per = global_batch // n_proc
    pid = dist.get_rank() if dist.is_initialized() else 0
    return pid * per, (pid + 1) * per


def make_global_batch(host_local, mesh: DeviceMesh):
    """This process's scenario slice ``(B_local, ...)`` as its shard of one
    global DTensor, sharded over the data axis and replicated over the model
    axis (the JAX package's ``make_array_from_process_local_data``)."""
    from torch.distributed.tensor import DTensor

    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    local = torch.as_tensor(host_local, device=device)
    return DTensor.from_local(local, mesh, batch_sharding(mesh), run_check=False)


def scaling_efficiency(solves_per_s: float, n_chips: int, per_chip_base: float):
    """Scaling efficiency against a measured one-device baseline."""
    return solves_per_s / (n_chips * per_chip_base)

