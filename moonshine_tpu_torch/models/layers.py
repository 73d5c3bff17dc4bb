"""Layer primitives and parameter initializers, in PyTorch.

Counterpart of the JAX package's ``models/layers.py``.  Parameters live in
small ``nn.Module`` holders in PyTorch's own layouts: a dense layer keeps
``weight [out, in]`` (``nn.Linear``'s layout, where the JAX package keeps
``w [in, out]``), a convolution ``weight [out, in, k]`` (``nn.Conv1d``'s,
where JAX keeps ``WIO [k, in, out]``) and a norm ``weight``/``bias``.  The
functions below take those holders and compute what their JAX namesakes
compute, with the same dtypes at the same places; ``weights.py`` converts
between the two layouts.  A dense layer quantized for execution
(``quant.quantize_tree_exec``) holds ``w_q`` (int8, ``[out, in]``) and
``w_scale`` (float32, ``[out]``) in place of ``weight``, and ``dense`` runs
it as the JAX package's w8a8 branch does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _param(x: torch.Tensor | None) -> nn.Parameter | None:
    return None if x is None else nn.Parameter(x, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ weight.T + bias``; ``weight`` is ``[out, in]``.

    Quantized form (``weight`` None): ``w_q`` int8 ``[out, in]`` and
    ``w_scale`` float32 ``[out]``, one scale per output channel."""

    def __init__(self, weight: torch.Tensor | None, bias: torch.Tensor | None = None, *,
                 w_q: torch.Tensor | None = None, w_scale: torch.Tensor | None = None):
        super().__init__()
        if (weight is None) == (w_q is None) or (w_q is None) != (w_scale is None):
            raise ValueError("a Dense holds either weight, or w_q and w_scale")
        self.weight = _param(weight)
        self.w_q = _param(w_q)
        self.w_scale = _param(w_scale)
        self.bias = _param(bias)

    @property
    def quantized(self) -> bool:
        return self.w_q is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


class Conv1d(nn.Module):
    """Valid strided convolution; ``weight`` is ``[out, in, k]``."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.weight = _param(weight)
        self.bias = _param(bias)


class Norm(nn.Module):
    """Scale (``weight``) and optional shift (``bias``) of a normalisation."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.weight = _param(weight)
        self.bias = _param(bias)


# -- initializers ----------------------------------------------------------

def _uniform(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-scale, scale, generator=generator)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, bias: bool = True,
               scale: float | None = None) -> Dense:
    if scale is None:
        scale = (1.0 / in_dim) ** 0.5
    return Dense(_uniform(generator, (out_dim, in_dim), scale),
                 torch.zeros(out_dim) if bias else None)


def conv1d_init(generator: torch.Generator, k: int, in_ch: int, out_ch: int,
                bias: bool = True) -> Conv1d:
    scale = (1.0 / (in_ch * k)) ** 0.5
    return Conv1d(_uniform(generator, (out_ch, in_ch, k), scale),
                  torch.zeros(out_ch) if bias else None)


def norm_init(dim: int, bias: bool = False) -> Norm:
    return Norm(torch.ones(dim), torch.zeros(dim) if bias else None)


# -- apply ----------------------------------------------------------------

def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """Float dense layer in the input's dtype; the bias is added after the
    product is rounded, as the JAX version does.  A quantized layer takes
    the w8a8 path (``dense_w8a8``)."""
    if p.quantized:
        return dense_w8a8(p, x)
    y = F.linear(x, p.weight.to(x.dtype))
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


_INV_127 = 1.0 / 127.0  # rounded to float32 where it multiplies a float32 tensor


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 activations: one float32 scale per row,
    ``max(amax, 1e-12) / 127``, and ``round(x / scale)`` (half to even)
    clipped to +-127, with the bits of the JAX package's compiled program.
    XLA turns the division by the constant 127 into a product with its
    float32 reciprocal, so the scale is computed so here too; ``x /
    scale`` stays a float32 division there and here (a product with a
    reciprocal would move values at ties)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = torch.clamp(amax, min=1e-12) * _INV_127
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return x_q, s_x


# torch._int_mm's CUDA rules (cuBLASLt's int8 product): more than 16 rows,
# and both the contraction and the output width multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q [..., in] @ w_q[out, in].T`` in exact int32, through
    ``torch._int_mm`` on every device.  Where a shape breaks its CUDA rules
    (the B=1 decode gives one row), rows, the contraction and the output
    width are padded with zeros, which is exact: each output row's int32
    sum depends on its own row only, and zero terms add nothing.  No shape
    falls back to a float product.  cuBLASLt's int8 product takes the
    activations row-major and the weight column-major (``w_q.t()`` of the
    ``[out, in]`` weight): activations that arrive in another layout (the
    encoder's first input is a transposed view) are copied row-major."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    a = x_q.reshape(-1, k).contiguous()
    m, n = a.shape[0], w_q.shape[0]
    pad_m = max(_INT_MM_MIN_ROWS - m, 0)
    pad_k = -k % _INT_MM_ALIGN
    pad_n = -n % _INT_MM_ALIGN
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    b = F.pad(w_q, (0, pad_k, 0, pad_n)) if pad_k or pad_n else w_q
    acc = torch._int_mm(a, b.t())
    if pad_m or pad_n:
        acc = acc[:m, :n]
    return acc.reshape(*lead, n)


def dense_w8a8(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 x per-channel int8 weight product: the JAX
    package's ``_dense_w8a8``.  int8 activations (``quantize_rows``), an
    exact int32 accumulator (``int8_matmul``), then ``* s_x * w_scale`` and
    the bias in float32, cast to the input's dtype."""
    x_q, s_x = quantize_rows(x)
    acc = int8_matmul(x_q, p.w_q)
    y = acc.float() * s_x * p.w_scale
    if p.bias is not None:
        y = y + p.bias
    return y.to(x.dtype)


def conv1d(p: Conv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Valid strided conv.  x: [B, N, C_in] -> [B, T, C_out]."""
    y = F.conv1d(x.transpose(1, 2), p.weight.to(x.dtype), stride=stride).transpose(1, 2)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def layer_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32; no bias unless
    present."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.weight
    if p.bias is not None:
        y = y + p.bias
    return y.to(x.dtype)


def group_norm_all(p: Norm, x: torch.Tensor, mask: torch.Tensor | None,
                   eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with a single group over [T, C] per sample.

    x: [B, T, C].  mask: optional [B, T] validity mask; when given, the
    statistics cover only valid frames.  One-pass statistics
    (var = E[x²] − mean², clamped at 0), as in the JAX version.
    """
    xf = x.float()
    if mask is None:
        denom = float(x.shape[1] * x.shape[2])
        s1 = xf.sum(dim=(1, 2), keepdim=True)
        s2 = xf.square().sum(dim=(1, 2), keepdim=True)
    else:
        m = mask.float()[:, :, None]
        denom = torch.clamp(m.sum(dim=(1, 2), keepdim=True) * x.shape[-1], min=1.0)
        xm = xf * m
        s1 = xm.sum(dim=(1, 2), keepdim=True)
        s2 = (xm * xf).sum(dim=(1, 2), keepdim=True)
    mean = s1 / denom
    var = torch.clamp(s2 / denom - mean.square(), min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.weight + p.bias
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU; bf16/fp16 inputs compute in float32 and round once."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.gelu(x.float()).to(x.dtype)
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


ACTIVATIONS = {"gelu": gelu, "silu": silu, "tanh": torch.tanh, "relu": torch.relu}
