"""Device meshes for scenario-sharded batched MPC (port of ``parallel/mesh.py``).

One process per device, ``torch.distributed`` between them (NCCL on the
card, gloo on the CPU). A mesh is a 2-D
:class:`torch.distributed.device_mesh.DeviceMesh` over ranks, with the dims
named as the JAX package names its mesh axes:

- ``"data"``: the scenario batch. Each data coordinate holds a contiguous
  slice of the global batch and solves it on its own device; the closed-loop
  solves need no traffic between devices, only the results are gathered;
- ``"model"``: the constraint rows of the QP (:mod:`.tensor_parallel`): the
  ADMM iterates ``(z, y)`` and bounds ``(l, u)`` are split over rows, and
  ``A_sᵀ(ρz − y)`` is summed over the model group once an iteration.

The JAX ``NamedSharding`` placements are DTensor placements here
(:func:`batch_sharding`, :func:`batch_constraint_sharding`,
:func:`replicated`). :func:`shard_rows` and :func:`gather_rows` are the two
operations every mesh path uses: this rank's slice of a global batch, and the
gather of the slices back to the global batch along the scenario axis (axis
1 of time-major arrays such as ``(steps + 1, B, nx)`` states).

A collective on a gloo group takes CPU tensors: CUDA tensors are staged
through the host for it (:func:`_on_backend`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _group_device(backend: str):
    """The ``device_id`` that binds an NCCL group to this process's card
    (none for gloo)."""
    if backend != "nccl":
        return None
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(
    n_devices: int | None = None, model_parallel: int = 1, device=None
) -> DeviceMesh:
    """A 2-D ``(data × model)`` mesh over the first ``n_devices`` ranks
    (all of them when ``None``), on ``device``'s type (the card when
    ``None``). Every rank of the world calls it; a rank outside the mesh gets
    ``get_coordinate() is None``.

    Without a process group, a one-rank mesh starts a world-1 group on a
    private store (NCCL on the card, gloo on the CPU): the caller ends it
    with ``torch.distributed.destroy_process_group()``."""
    device_type = resolve_device(device).type
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices, have {world} ranks; launch one process per "
            "device (torchrun --nproc-per-node=N) or spawn the ranks "
            "(parallel.dryrun.run_ranks)"
        )
    if n_devices % model_parallel != 0:
        raise ValueError("n_devices must be divisible by model_parallel")
    if not dist.is_initialized():
        backend = _backend_for(device_type)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                device_id=_group_device(backend))
    grid = torch.arange(n_devices).reshape(n_devices // model_parallel, model_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: DeviceMesh) -> list:
    """Scenario-batch arrays: leading axis over data, replicated over model."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Replicate()]


def batch_constraint_sharding(mesh: DeviceMesh) -> list:
    """``(B, m)`` ADMM iterates: batch over data, constraint rows over model."""
    from torch.distributed.tensor import Shard

    return [Shard(0), Shard(1)]


def replicated(mesh: DeviceMesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate(), Replicate()]


def _coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return coord[0], coord[1]


def data_slice(mesh: DeviceMesh, batch: int) -> tuple[int, int]:
    """This rank's half-open ``[lo, hi)`` of a global batch of ``batch``
    scenarios, by its data coordinate; the batch must split evenly."""
    n = mesh.shape[0]
    if batch % n != 0:
        raise ValueError(f"batch {batch} not divisible by the data axis {n}")
    per = batch // n
    d, _ = _coordinate(mesh)
    return d * per, (d + 1) * per


def shard_rows(mesh: DeviceMesh, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of the global batch ``t`` along the
    scenario axis ``axis``."""
    lo, hi = data_slice(mesh, t.shape[axis])
    return t.narrow(axis, lo, hi - lo)


def _on_backend(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend can take it: gloo's collectives run
    on the host, so a CUDA tensor goes through a host copy there."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def all_gather_cat(t: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """The pieces of every rank of ``group``, in rank order, joined along
    ``axis`` (bool tensors travel as uint8); ``t`` itself on a one-rank
    group."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    wire = _on_backend(t.to(torch.uint8) if t.dtype == torch.bool else t, group).contiguous()
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=axis).to(t.device)
    return out.bool() if t.dtype == torch.bool else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor on ``t``'s device)."""
    wire = _on_backend(t, group).clone()
    dist.all_reduce(wire, group=group)
    return wire.to(t.device)


def gather_rows(mesh: DeviceMesh, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The global batch from every data coordinate's slice ``t``, joined
    along the scenario axis ``axis``."""
    return all_gather_cat(t, mesh.get_group(DATA_AXIS), axis)


def gather_tree(mesh: DeviceMesh, tree, axis: int = 0):
    """:func:`gather_rows` on every tensor of a pytree (tuples, lists, dicts)."""
    return tree_map(lambda t: gather_rows(mesh, t, axis) if torch.is_tensor(t) else t, tree)


def gather_result(mesh: DeviceMesh, res):
    """A :class:`..control.batch_loop.BatchSimResult` of this rank's slice
    gathered to the global batch: the time-major states, inputs and logs
    along axis 1, the batch-first final carry along axis 0."""
    return dataclasses.replace(
        res,
        states=gather_rows(mesh, res.states, 1),
        inputs=gather_rows(mesh, res.inputs, 1),
        logs=gather_tree(mesh, res.logs, 1),
        final_carry=gather_tree(mesh, res.final_carry, 0),
    )


def shard_policy(policy, mesh: DeviceMesh):
    """A batched policy on the global batch that solves this rank's rows.

    The returned ``(x_batch, t, carry) -> (u0, carry, aux)`` takes the global
    ``x_batch (B, nx)`` on every rank, runs ``policy`` on this rank's data
    slice on its own device, and gathers ``u0`` and every ``aux`` entry over
    the data axis, so that every rank returns the global ones. The carry
    (warm starts) stays with its rank: it returns this rank's rows, and
    takes either those or the global carry, whose rows it slices. On a
    one-rank data axis there is nothing to split or gather, and ``policy``
    itself is returned."""
    if mesh.shape[0] == 1:
        return policy
    group = mesh.get_group(DATA_AXIS)
    gather = lambda a: all_gather_cat(a, group) if torch.is_tensor(a) else a

    def fn(x_batch, t, carry):
        B = x_batch.shape[0]
        lo, hi = data_slice(mesh, B)
        rows = lambda a: a[lo:hi] if torch.is_tensor(a) and a.ndim > 0 and a.shape[0] == B else a
        u0, carry, aux = policy(x_batch[lo:hi], t, tree_map(rows, carry))
        return gather(u0), carry, tree_map(gather, aux)

    if hasattr(policy, "initial_carry"):
        fn.initial_carry = policy.initial_carry
    return fn


def shard_fields(mesh: DeviceMesh, params):
    """A parameter dataclass with each per-scenario field (a tensor with a
    scenario axis) cut to this rank's slice; scalar fields unchanged."""
    updates = {
        f.name: shard_rows(mesh, getattr(params, f.name))
        for f in dataclasses.fields(params)
        if torch.is_tensor(getattr(params, f.name)) and getattr(params, f.name).ndim > 0
    }
    return dataclasses.replace(params, **updates)
