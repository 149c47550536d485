"""The device mesh and batch placement (port of ``detr_tensorflow_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, with the JAX package's axis names: ``"data"`` (DDP:
each rank a slice of the batch, gradients all-reduced), ``"model"``
(Megatron tensor parallelism, ``parallel/tp.py``) and ``"stage"`` (pipeline
stages, ``parallel/pp.py``). One rank is one device
here, where a JAX process may drive several; so a mesh's size is the
world size, and ``make_mesh`` needs ``multihost.initialize`` first (at
world size 1 too, where the group has one rank).

The mesh's device type follows the backend: ``cuda`` under NCCL, ``cpu``
under Gloo, also when Gloo joins ranks sharing one card (the mesh only
names the process groups; tensors stay where the model put them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(num_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              axis_sizes: Optional[Tuple[int, ...]] = None) -> DeviceMesh:
    """A mesh over the first ``num_devices`` ranks (all of them by
    default): 1-D data parallel, ``axis_names=("stage",)`` for a pipeline,
    or two axes such as ``("data", "model")``, ``("data", "stage")`` or
    ``("stage", "model")`` with ``axis_sizes``. Rank r sits at row-major
    coordinates, so the last axis's groups are runs of consecutive ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call multihost.initialize first")
    world = dist.get_world_size()
    num_devices = world if num_devices is None else int(num_devices)
    if num_devices != world:
        raise ValueError(f"a mesh of {num_devices} ranks in a world of {world}: one rank is "
                         "one device, so the mesh spans the world")
    if axis_sizes is None:
        axis_sizes = (num_devices,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names) or math.prod(axis_sizes) != num_devices:
        raise ValueError(f"axis sizes {axis_sizes} for axes {tuple(axis_names)} do not make "
                         f"{num_devices} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, axis_sizes, mesh_dim_names=tuple(axis_names))


def axis(mesh: Optional[DeviceMesh], name: str):
    """(process group, this rank's index, size) of ``mesh``'s axis ``name``
    (a group of one rank at size 1); (None, 0, 1) without a mesh or
    without that axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.get_local_rank(name), mesh.size(dim)


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data"):
    """DTensor placements of a batch: dim 0 split over ``axis_name``,
    replicated over the other axes (JAX ``NamedSharding(mesh, P(axis))``)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n == axis_name else Replicate() for n in mesh.mesh_dim_names]


def replicated_sharding(mesh: DeviceMesh):
    """DTensor placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def shard_batch(batch, mesh: Optional[DeviceMesh], axis_name: str = "data"):
    """This rank's rows of a global host batch (a dict of arrays or
    tensors, the same on every rank): the contiguous slice along dim 0 that
    ``multihost.process_shard`` gives its index on ``axis_name``. Raises
    ValueError unless every leading dimension divides evenly."""
    _, index, size = axis(mesh, axis_name)
    if size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % size:
            raise ValueError(f"batch key {k!r}: {n} rows do not split evenly over {size} ranks")
        per = n // size
        out[k] = v[index * per:(index + 1) * per]
    return out


def replicate(module: torch.nn.Module, mesh: Optional[DeviceMesh]) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (a broadcast over the
    whole mesh, one flat tensor a dtype). Returns ``module``."""
    if mesh is None or dist.get_world_size() == 1:
        return module
    tensors = [t for t in list(module.parameters()) + list(module.buffers())]
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
    return module
