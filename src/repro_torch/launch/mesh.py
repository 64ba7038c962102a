"""Production meshes (the port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; "pod" is the outer data-parallel axis whose
gradient hop crosses between pods (and is where ``optim.compress``
applies).

A FUNCTION, not a module-level constant: importing this module touches no
process group.  ``make_production_mesh`` builds a ``DeviceMesh`` over the
running process group (``torchrun`` starts one rank a device), and raises,
naming the world size it needs, in a world of any other size.
"""
from __future__ import annotations

import math

import torch

from repro_torch.parallel.sharding import mesh_axes

__all__ = ["make_production_mesh", "production_shape", "dp_size",
           "model_axis_size"]


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the running process group (one
    rank a device of ``device_type``)."""
    shape, axes = production_shape(multi_pod=multi_pod)
    need = math.prod(shape)
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"the production mesh {shape} over {axes} needs a world of "
            f"{need} ranks; this one has {world} (start one rank a device "
            f"with torchrun --nproc-per-node ... --nnodes ...)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def dp_size(mesh) -> int:
    mesh = mesh_axes(mesh)
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def model_axis_size(mesh) -> int:
    return mesh_axes(mesh).shape["model"]
