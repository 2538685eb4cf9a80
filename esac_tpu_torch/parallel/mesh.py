"""The ("data", "expert") mesh over ``torch.distributed`` ranks
(counterpart of ``esac_tpu/parallel/mesh.py``).

Axis convention as in the JAX package: data-parallel frames on the outer
axis, expert shards on the inner one, so a rank's expert group is a run of
adjacent ranks.  Ranks take the place of the JAX package's devices (on the
CPU, of its virtual host devices): every rank drives one device, named
explicitly when the process group is initialized
(:func:`~esac_tpu_torch.parallel.multihost.initialize_multihost`), and
``ensure_virtual_devices`` has no counterpart -- a CPU mesh of N "devices"
is N gloo ranks.

:func:`make_mesh` returns a ``torch.distributed.device_mesh.DeviceMesh``
whose dims are named ("data", "expert"); :func:`expert_sharding` and
:func:`batch_sharding` stand in for the JAX package's ``NamedSharding``
helpers: they return this rank's slice of an expert-stacked tensor, and
this rank's frames.  The mesh's device type follows the backend -- "cuda"
under NCCL, "cpu" under gloo (also when gloo carries CUDA tensors of ranks
that share one card) -- and only names where DTensors would live; the
sharded functions take their tensors' device from the caller.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "expert")


def make_mesh(n_data: int = 1, n_expert: int | None = None) -> DeviceMesh:
    """Build the ("data", "expert") mesh over every rank of the
    initialized world (rank r at data row r // n_expert, expert column
    r % n_expert).  Raises ``ValueError`` when n_data x n_expert is not
    the world size, with the JAX package's text."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.initialize_multihost first")
    n_dev = dist.get_world_size()
    if n_expert is None:
        n_expert = n_dev // n_data
    if n_data * n_expert != n_dev:
        raise ValueError(f"mesh {n_data}x{n_expert} != device count {n_dev}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n_dev).reshape(n_data, n_expert),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (JAX: ``mesh.shape[axis]``)."""
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (JAX: ``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's ranks along ``axis``."""
    return mesh.get_group(axis)


def _slice(x: torch.Tensor, dim: int, n: int, i: int, what: str) -> torch.Tensor:
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what} axis of size {size} not divisible by {n} shards")
    return x.narrow(dim, i * (size // n), size // n)


def expert_sharding(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of the expert-stacked ``x`` along ``dim`` (JAX:
    ``NamedSharding(mesh, P("expert"))``): rows ``[e * m, (e + 1) * m)``
    for expert column e and m = size / n_expert.  A view."""
    return _slice(x, dim, axis_size(mesh, "expert"), axis_index(mesh, "expert"), "expert")


def batch_sharding(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's frames of the frame-stacked ``x`` along ``dim`` (JAX:
    ``NamedSharding(mesh, P("data"))``).  A view."""
    return _slice(x, dim, axis_size(mesh, "data"), axis_index(mesh, "data"), "frame")
