"""Meshes over an initialised ``torch.distributed`` world.

Counterpart of ``repro/launch/mesh.py``.  The reference's meshes name JAX
devices; here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of a world the caller has started, one process per rank.  Nothing
here starts a process group: ``torchrun --nproc-per-node N`` starts N ranks
with the environment ``torch.distributed.init_process_group()`` reads, and
each rank calls it (NCCL for CUDA) before :func:`make_host_mesh`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


PRODUCTION_MESHES = {  # multi_pod -> (shape, axis names), the reference's
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh over an initialised world of exactly
    its size: ``(16, 16)`` ``("data", "model")`` over 256 ranks, or
    ``(2, 16, 16)`` ``("pod", "data", "model")`` over 512.  Rank ``r`` sits at
    the row-major coordinate of ``r``, so ``model`` is the fastest axis (on
    8-card nodes a ``model`` group of 16 spans two nodes).  Any other world
    raises.  ``device_type`` is ``"cuda"`` unless the caller names ``"cpu"``
    (the dry run's fake world)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = PRODUCTION_MESHES[bool(multi_pod)]
    n = 1
    for d in shape:
        n *= d
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs an initialised world of {n} ranks")
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} takes a world of {n} ranks, "
                         f"not {dist.get_world_size()}")
    if device_type != "cpu":
        device_type = resolve_device(device_type).type
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ``(data, model)`` mesh over every rank of the initialised world:
    ``world // model`` rows of ``model`` ranks.  ``device_type`` is
    ``"cuda"`` unless the caller names ``"cpu"``; ``"cuda"`` raises without
    CUDA.  Raises when no process group is initialised."""
    device_type = resolve_device(device_type).type
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start the ranks with "
            "`torchrun --nproc-per-node N` (or set MASTER_ADDR, MASTER_PORT, RANK "
            "and WORLD_SIZE) and call torch.distributed.init_process_group() "
            "in each before make_host_mesh"
        )
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} is not a multiple of model={model}")
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))
