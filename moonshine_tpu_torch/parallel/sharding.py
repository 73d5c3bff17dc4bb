"""Batch sharding over a (data, model) mesh.

Counterpart of the batch half of the JAX package's ``parallel/sharding.py``:
a batch's leading axis is split over ``data`` and replicated over
``model``.  Its parameter half (``param_pspecs``, ``shard_params``: the
Megatron split of attention and MLP weights over ``model`` and the
vocab-sharded embedding) needs no model code under GSPMD, but in PyTorch it
needs row- and column-parallel dense layers with all-reduces and a
vocab-sharded tied embedding; it is not ported yet (ROADMAP queue 1).
Here parameters stay replicated on every rank.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils._pytree import tree_map_only

from .mesh import DATA_AXIS


def batch_pspec(rank: int) -> tuple:
    """The layout of a rank-``rank`` batch, one axis name (or None) per
    tensor axis: the leading axis over ``data``."""
    return (DATA_AXIS,) + (None,) * (rank - 1)


def shard_batch(mesh, batch: Any) -> Any:
    """This rank's rows of every tensor in ``batch``: block ``d`` of the
    leading axis, where ``d`` is the rank's ``data`` coordinate."""
    n_data = mesh.shape[mesh.mesh_dim_names.index(DATA_AXIS)]
    d = mesh.get_local_rank(DATA_AXIS)

    def take(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} not divisible by the data axis {n_data}")
        n = x.shape[0] // n_data
        return x[d * n:(d + 1) * n]

    return tree_map_only(torch.Tensor, take, batch)
