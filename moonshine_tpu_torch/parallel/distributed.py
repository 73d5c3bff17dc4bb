"""Process-group bring-up and cross-rank utilities.

Counterpart of the JAX package's ``parallel/distributed.py``.  JAX's
``initialize`` is a no-op in a single process, since its mesh needs no
process group; a PyTorch ``DeviceMesh`` does, so here a single process gets
a group of one.  ``host_local_batch_to_global`` rebuilds a whole batch from
every rank's rows, and ``all_reduce_metrics`` sums counts over the ranks.
"""

from __future__ import annotations

import os
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_map_only

from ..core.device import resolve_device
from .mesh import DATA_AXIS, data_sharding, make_mesh


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Bring up the default process group: NCCL for ``cuda``, gloo for the
    CPU.  Does nothing if one is up already.

    ``world_size`` and ``rank`` default from the standard environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun`` sets them),
    and then to a single process.  A single process with no ``init_method``
    and no ``MASTER_ADDR`` meets its group through an in-process store;
    otherwise ``init_method`` (``file://...``, ``tcp://host:port``) or
    ``env://``.  On ``cuda`` the rank's card becomes the current device and
    NCCL is brought up at once, so a failure raises here.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    kw: dict[str, Any] = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            world_size=world_size, rank=rank, **kw)


def global_mesh(model: int = 1, device_type: str = "cuda"):
    """(data, model) mesh over every rank of the job."""
    return make_mesh(data=None, model=model, device_type=device_type)


def host_local_batch_to_global(mesh, batch: Any) -> Any:
    """The whole batch from every rank's rows: each tensor of ``batch`` holds
    this rank's rows (leading axis, as ``shard_batch`` gives them), and the
    ``data`` group all-gathers them in rank order; ranks of one ``model``
    group hold the same rows and are not gathered twice."""
    placements = data_sharding(mesh)
    return tree_map_only(
        torch.Tensor,
        lambda x: DTensor.from_local(x.contiguous(), mesh, placements).full_tensor(), batch)


def all_reduce_metrics(metrics: dict[str, Any], mesh=None) -> dict[str, float]:
    """Sum scalar metrics (WER error counts, audio seconds...) over the
    ranks: over ``mesh``'s ``data`` group when given (each data shard once),
    else over every rank.  Without a process group: plain floats."""
    if not dist.is_initialized():
        return {k: float(v) for k, v in metrics.items()}
    group = None if mesh is None else mesh.get_group(DATA_AXIS)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(vec, group=group)
    return {k: float(x) for k, x in zip(keys, vec.tolist())}
