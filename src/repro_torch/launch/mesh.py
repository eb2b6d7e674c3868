"""Device meshes over the default process group.

The counterpart of ``repro.launch.mesh``: the same shapes and dimension
names.  These are functions, never module-level constants: importing this
module starts no process group, and each function needs the default group
already initialized (``torch.distributed.init_process_group`` with the
backend of ``multipod.BACKENDS[device_type]``, or a fake group for a
shape-only mesh).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 devices per pod; the multi-pod mesh adds a leading pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(world size / model_parallel, model_parallel) over ``data``/``model``."""
    n = dist.get_world_size()
    data = max(n // model_parallel, 1)
    return init_device_mesh(device_type, (data, model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_devices(mesh) -> int:
    return math.prod(mesh.shape)
