"""Device meshes over the default process group.

Nothing here touches process-group state at import.  The meshes are
``torch.distributed.device_mesh.DeviceMesh`` objects whose dims are named as
the reference's mesh axes: (16, 16) ``("data", "model")`` single-pod, (2, 16,
16) ``("pod", "data", "model")`` multi-pod.  The caller starts the process
group (``torchrun``, or ``init_process_group`` with an explicit address, or
the dry run's fake group of 256 or 512 ranks); a mesh whose size differs from
the group's raises.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    """"cuda" for an NCCL group, else "cpu" (gloo, and the fake group whose
    tensors are meta tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, names: tuple) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a started process group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} ranks, the process "
                         f"group has {world}")
    return DeviceMesh(_device_type(), torch.arange(world).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(model_axis: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over the ranks of the process group, with
    ``model_axis`` of them on the model axis (tests, one card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a started process group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the {n} ranks of the process group")
    return _mesh((n // model_axis, model_axis), ("data", "model"))


def mesh_chips(mesh) -> int:
    from repro_torch.models.sharding import mesh_axes

    return math.prod(mesh_axes(mesh).values())


@contextlib.contextmanager
def process_group(device=None):
    """The default process group for a launcher: the one already started, or
    ``torchrun``'s (its ``RANK``/``WORLD_SIZE``/``MASTER_*`` environment), or
    else one rank of its own (an in-memory store; NCCL on the card, gloo on
    the CPU).  A group this context started is destroyed on exit."""
    if dist.is_initialized():
        yield
        return
    dev = torch.device("cuda" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if dev.type == "cuda":  # the rank's card, before NCCL starts
            torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
