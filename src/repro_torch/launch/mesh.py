"""Meshes over `torch.distributed`, the port of the reference's
`launch/mesh.py`.

Each builds a `DeviceMesh` with named dims over the process group the
caller initialized (`torch.distributed.init_process_group`, with its
address, world size and rank given): its device type is the backend's,
"cuda" under NCCL and "cpu" under gloo.  Functions, not module-level
constants, so importing this module touches no process group.
"""
from __future__ import annotations

from typing import Tuple

from ..core.fault_tolerance import elastic_mesh_plan

_DEVICE_TYPE = {"nccl": "cuda", "gloo": "cpu"}


def device_type() -> str:
    """The mesh device type of the initialized default process group."""
    import torch.distributed as dist
    backend = str(dist.get_backend())
    if backend not in _DEVICE_TYPE:
        raise ValueError(f"backend {backend!r}: a mesh takes "
                         f"{sorted(_DEVICE_TYPE)}")
    return _DEVICE_TYPE[backend]


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, dim names) of the production mesh.  Single pod: 16x16 =
    256 ranks (data, model).  Multi-pod: 2x16x16 = 512 ranks (pod, data,
    model)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over a world of 256 (or 512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type(), shape, mesh_dim_names=axes)


def make_mesh_for(devices: int, model_parallel: int, pods: int = 1):
    """Elastic mesh for whatever devices survive (see
    core.fault_tolerance.elastic_mesh_plan): (data, model), or (pod,
    data, model) over several pods; `devices` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = elastic_mesh_plan(devices, model_parallel, pods)
    axes = ("pod", "data", "model")[-len(shape):]
    return init_device_mesh(device_type(), shape, mesh_dim_names=axes)
