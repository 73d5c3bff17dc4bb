"""Interleaved partial rotary position embeddings, in PyTorch.

Counterpart of the JAX package's ``ops/rotary.py``: GPT-NeoX-style
*interleaved* pairs (2i, 2i+1) over the first ``rotary_dim`` channels of
each head, pass-through for the rest (partial_rotary_factor 0.9), tables in
float32 whatever the activation dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.layers import Dense


def rotary_tables(positions: torch.Tensor, rotary_dim: int,
                  theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., rotary_dim // 2] (float32) for integer positions."""
    half = rotary_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) * 2.0 / rotary_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def fullwidth_tables(cos: torch.Tensor, sin: torch.Tensor,
                     head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel C/S tables of width ``head_dim`` (float32).

    C[2i] = C[2i+1] = cos_i;  S[2i] = -sin_i, S[2i+1] = +sin_i; pass-through
    channels get C=1, S=0, so ``rot(x) = x * C + pair_swap(x) * S``.
    """
    # Interleaved by stacking, not from a host-made sign table: a tensor
    # built on the host and copied to the card would synchronise the stream.
    c2 = torch.stack([cos, cos], dim=-1).flatten(-2)
    s2 = torch.stack([-sin, sin], dim=-1).flatten(-2)
    rot = c2.shape[-1]
    if rot < head_dim:
        c2 = torch.nn.functional.pad(c2, (0, head_dim - rot), value=1.0)
        s2 = torch.nn.functional.pad(s2, (0, head_dim - rot), value=0.0)
    return c2, s2


def pair_swap_perm(head_dim: int, half: int, heads: int = 1) -> np.ndarray:
    """Channel permutation swapping 2i <-> 2i+1 (i < half) in each of
    ``heads`` blocks; channels >= 2*half map to themselves."""
    perm = np.arange(head_dim)
    idx = np.arange(half)
    perm[2 * idx] = 2 * idx + 1
    perm[2 * idx + 1] = 2 * idx
    return (perm[None, :] + head_dim * np.arange(heads)[:, None]).reshape(-1)


def swap_dense_params(p: Dense, perm: np.ndarray) -> Dense:
    """Permute a dense layer's OUTPUT channels: y' = y[..., perm].  Exact:
    a gather of weight rows, no arithmetic.  A quantized layer has its
    ``w_q`` rows and ``w_scale`` permuted, as the JAX package's ``permute``
    does, so rotary preparation and quantization commute."""
    idx = torch.as_tensor(perm, device=(p.w_q if p.quantized else p.weight).device)
    bias = None if p.bias is None else p.bias[idx]
    if p.quantized:
        return Dense(None, bias, w_q=p.w_q[idx], w_scale=p.w_scale[idx])
    return Dense(p.weight[idx], bias)


def apply_rotary_fullwidth(
    x: torch.Tensor,       # [..., S, H*head_dim]: heads not split
    x_swap: torch.Tensor,  # pair-swapped projection of the same input
    cos: torch.Tensor,     # [S, half] (or broadcastable)
    sin: torch.Tensor,
    head_dim: int,
    heads: int,
) -> torch.Tensor:
    """Rotary on the pre-head-split [..., S, D] projection, with the pair
    swap folded into the projection weights (``swap_dense_params``)."""
    c2, s2 = fullwidth_tables(cos, sin, head_dim)
    cb = c2.repeat(*((1,) * (c2.dim() - 1)), heads).to(x.dtype)
    sb = s2.repeat(*((1,) * (s2.dim() - 1)), heads).to(x.dtype)
    return x * cb + x_swap * sb


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved rotation of the leading rotary channels of x.

    x: [..., S, H, head_dim], cos/sin: [S, half] or broadcastable
    [..., S, half].  The JAX version forms the pair swap as a product with a
    0/1 matrix; here it is a reshape and flip of the rotary channels, which
    gives the same values.
    """
    rot = 2 * cos.shape[-1]
    c2, s2 = fullwidth_tables(cos, sin, x.shape[-1])
    c2 = c2.unsqueeze(-2).to(x.dtype)
    s2 = s2.unsqueeze(-2).to(x.dtype)
    swapped = x[..., :rot].unflatten(-1, (rot // 2, 2)).flip(-1).flatten(-2)
    return x * c2 + torch.cat([swapped, x[..., rot:]], dim=-1) * s2
