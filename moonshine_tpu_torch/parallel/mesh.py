"""(data, model) device meshes over a ``torch.distributed`` process group.

Counterpart of the JAX package's ``parallel/mesh.py``: a mesh with a
``data`` axis (utterance batches, data parallelism) and a ``model`` axis
innermost (tensor parallelism; here the heads of the encoder attention).
JAX builds one mesh over every device of a single controller.  PyTorch runs
one process per rank, so the port's mesh is a ``DeviceMesh`` over the
default process group (``parallel.distributed.initialize``), and each
process holds the tensors of its own rank.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int | None = None, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the default process group.

    ``data=None`` takes every rank left after ``model``; ``data * model``
    must equal the world size.  A single process with no process group gets
    a world-1 group first (``initialize``), since a ``DeviceMesh`` needs one.
    """
    if not dist.is_initialized():
        from .distributed import initialize

        initialize(device=device_type)
    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"world size {world} not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs data * model == the world size, which is {world}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(data=1, model=1, device_type=device_type)


def replicated(mesh: DeviceMesh) -> list:
    """Placements of a tensor every rank holds whole."""
    return [Replicate()] * mesh.ndim


def data_sharding(mesh: DeviceMesh) -> list:
    """Placements of a batch whose leading axis is split over ``data`` and
    replicated over ``model``."""
    return [Shard(0) if name == DATA_AXIS else Replicate() for name in mesh.mesh_dim_names]
