"""Parameter and batch sharding over a (data, model) mesh.

Counterpart of the JAX package's ``parallel/sharding.py``.  Tensor
parallelism follows the Megatron pattern on the named axes: attention
q/k/v and the MLP's fc1 split their *output* features over ``model`` (each
rank computes a subset of the heads), o and fc2 split their *input*
features (an all-reduce before the bias and the residual), and the tied
embedding splits its vocabulary, so the logits product is model-parallel
too.  Everything else (norms, the conv frontend) is replicated.  A batch's
leading axis is split over ``data`` and replicated over ``model``.

The rules are JAX's, read on the port's tree (``named_parameters`` names)
and in its ``[out, in]`` layout, with no stacked layer axis.  Under GSPMD a
split needs no model code; here ``shard_params`` keeps this rank's blocks
and marks the holders, and ``models/moonshine.py`` computes the split with
the collectives of ``parallel/tensor_parallel.py``.  Two placements follow
from that arithmetic and are not JAX choices: the encoder's pair-swapped
rotary copies of q and k (``q_swapped``, ``k_swapped``; not in JAX's
training tree) split as q and k do, and the decoder's SwiGLU fc1 gives a
rank the same block of both of its halves, so that each rank's gate meets
its own half.  With ``model=1`` every block is the whole tensor and the
same code runs over a group of one.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_map_only

from .mesh import DATA_AXIS, MODEL_AXIS
from .tensor_parallel import ModelParallel

_COLUMN = ("q", "k", "v", "q_swapped", "k_swapped")


def param_pspec(name: str, ndim: int) -> tuple:
    """The layout of the parameter ``name`` (a ``named_parameters`` name of
    ``models.moonshine.Moonshine``): one axis name or None per tensor axis,
    ``()`` where it is replicated."""
    keys = name.split(".")
    last = keys[-1]
    weight = last in ("weight", "w_q")
    if "embed" in keys:
        return (MODEL_AXIS, None)  # vocab-sharded
    in_attn = any(k in keys for k in ("attn", "self_attn", "cross_attn"))
    if in_attn:
        if any(k in keys for k in _COLUMN):
            return (MODEL_AXIS, None) if weight else (MODEL_AXIS,)
        if "o" in keys:
            return (None, MODEL_AXIS) if weight else (None,) * ndim
    if "mlp" in keys:
        if "fc1" in keys:
            return (MODEL_AXIS, None) if weight else (MODEL_AXIS,)
        if "fc2" in keys:
            return (None, MODEL_AXIS) if weight else (None,) * ndim
    return ()


def param_pspecs(model: nn.Module) -> dict[str, tuple]:
    """``{name: layout}`` for every parameter of ``model``."""
    return {name: param_pspec(name, p.dim()) for name, p in model.named_parameters()}


def _paired_halves(name: str) -> bool:
    """The decoder's SwiGLU fc1, whose output is [hidden half, gate half]."""
    return name.startswith("decoder.") and ".mlp.fc1." in name


def shard_tensor(name: str, x: torch.Tensor, spec: tuple, rank: int, size: int) -> torch.Tensor:
    """Block ``rank`` of ``size`` of ``x`` along its ``model`` axis (the whole
    tensor where ``spec`` names none); a copy."""
    if MODEL_AXIS not in spec:
        return x.detach().clone()
    axis = spec.index(MODEL_AXIS)
    n = x.shape[axis]
    parts = 2 if _paired_halves(name) else 1
    if n % (parts * size):
        raise ValueError(f"{name}: {n} features along axis {axis} not divisible into "
                         f"{parts * size} blocks")
    x = x.detach().unflatten(axis, (parts, size, n // (parts * size)))
    return x.select(axis + 1, rank).flatten(axis, axis + 1).contiguous().clone()


def model_parallel(mesh) -> ModelParallel:
    """The mesh's ``model`` group and this rank's place in it."""
    group = mesh.get_group(MODEL_AXIS)
    return ModelParallel(group, dist.get_rank(group), dist.get_world_size(group))


def shard_params(mesh, model: nn.Module) -> nn.Module:
    """A copy of ``model`` (``models.moonshine.Moonshine``) holding this
    rank's blocks per the rules above, its attention, MLP and decoder
    holders marked for the split.  Exec-quantized (w8a8) layers are not
    split: their per-row activation scales would need the whole row."""
    from ..models import moonshine as mm

    tp = model_parallel(mesh)
    out = copy.deepcopy(model)
    for name, p in list(out.named_parameters()):
        if name.endswith(("w_q", "w_scale")):
            raise ValueError(f"{name}: shard_params splits float weights only, not w8a8 layers")
        *path, leaf = name.split(".")
        holder = out.get_submodule(".".join(path))
        block = shard_tensor(name, p, param_pspec(name, p.dim()), tp.rank, tp.size)
        setattr(holder, leaf, nn.Parameter(block, requires_grad=p.requires_grad))
    for m in out.modules():
        if isinstance(m, (mm.Attention, mm.Mlp, mm.Decoder)):
            m.tp = tp
    return out


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
