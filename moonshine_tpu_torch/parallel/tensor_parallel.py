"""The collectives of Megatron tensor parallelism, with their gradients.

Under GSPMD the JAX package needs no model code for its weight split
(``parallel/sharding.py``): XLA inserts the collectives.  PyTorch runs one
process per rank, so the port's layer functions call these at the places
XLA puts them, over the ``model`` group of a mesh (``ModelParallel``):

- ``copy_to_model``: at the entry of a column-parallel block (q, k, v and
  fc1 split by output features; the vocabulary-sharded logits).  Identity
  forward; the backward all-reduces the input's gradient, since every rank
  computed a part of it from its own columns.
- ``reduce_from_model``: after a row-parallel product (o and fc2 split by
  input features; the vocabulary-sharded lookup).  All-reduce forward,
  identity backward.
- ``gather_from_model``: the vocabulary-sharded logits.  All-gather of the
  last axis forward; the backward keeps this rank's block of the gradient.

Each is a ``torch.autograd.Function``; where autograd records nothing
(decoding under ``inference_mode``) ``apply`` just runs its forward.
``tp=None`` (an unsharded model) makes each the identity; a group of one
runs the same collectives as a larger one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class ModelParallel(NamedTuple):
    """The ``model`` group of a mesh and this rank's place in it."""

    group: object  # a torch.distributed ProcessGroup
    rank: int
    size: int


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.width, ctx.rank = x.shape[-1], rank
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        w, r = ctx.width, ctx.rank
        return grad[..., r * w:(r + 1) * w].contiguous(), None, None


def copy_to_model(x: torch.Tensor, tp: ModelParallel | None) -> torch.Tensor:
    if tp is None:
        return x
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelParallel | None) -> torch.Tensor:
    """The sum of ``x`` over the ``model`` group."""
    if tp is None:
        return x
    return _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: ModelParallel | None) -> torch.Tensor:
    """Every rank's block of the last axis, in rank order."""
    if tp is None:
        return x
    return _GatherFromModel.apply(x, tp.group, tp.rank)
