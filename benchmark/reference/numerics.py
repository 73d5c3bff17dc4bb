"""Plain numerics shared by the reference models: products in a stated
precision, layer norm, interleaved rotary embeddings and the int8 KV
quantization of the configurations that state it.

The reference computes in float32 with TF32 off.  ``Products`` puts every
product's operands through the rounding of a lower precision to make the
control of ``correct`` (the reference computed one precision below the
configuration's): ``"tf32"`` rounds each float32 operand to TF32's 10-bit
mantissa, ``"fp8"`` scales each operand tensor to float8 e4m3's range by
its largest magnitude and rounds it there.  Products accumulate in float32
in every mode.

Imports nothing of moonshine_tpu_torch: these follow the published
architecture, not the port's code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9
FP8_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF  # to nearest, 13 low mantissa bits dropped
    return rounded.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    """Matrix products and convolutions of the reference, in ``mode``:
    "float32" (as written), "tf32" or "fp8" (the controls)."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32":
            return _round_tf32(x)
        if self.mode == "fp8":
            return _round_fp8(x)
        return x.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
        """x @ w.T (+ b), w [out, in]."""
        y = torch.matmul(self.r(x), self.r(w).t())
        return y if b is None else y + b

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int):
        """x [B, C_in, N] -> [B, C_out, T], valid padding."""
        return F.conv1d(self.r(x), self.r(w), b, stride=stride)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * w
    return y if b is None else y + b


def rotary(x: torch.Tensor, positions: torch.Tensor, rotary_dim: int, theta: float):
    """Interleaved (GPT-NeoX pairs 2i, 2i+1) rotation of the first
    ``rotary_dim`` channels of each head.  x [..., S, H, hd], positions [S]."""
    half = rotary_dim // 2
    inv_freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device)
                               * 2.0 / rotary_dim)
    ang = positions.float()[:, None] * inv_freq  # [S, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]  # [S, 1, half]
    xr = x[..., :rotary_dim].unflatten(-1, (half, 2))
    a, b = xr[..., 0], xr[..., 1]
    out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(-2)
    return torch.cat([out, x[..., rotary_dim:]], dim=-1)


def int8_columns(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization with one scale per key position and
    head (largest |value| over the head's channels / 127, round half to
    even), returned dequantized.  x [..., T, H, hd]."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def attention(p: Products, q, k, v, key_mask=None, causal: bool = False):
    """Softmax attention in float32.  q [S, H, hd], k/v [T, H, hd];
    ``key_mask`` [T] bool (True = attend); ``causal``: query i sees keys
    <= i."""
    hd = q.shape[-1]
    logits = p.matmul(q.transpose(0, 1), k.permute(1, 2, 0)) * hd ** -0.5  # [H, S, T]
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[None, None, :], NEG_INF)
    if causal:
        s, t = logits.shape[-2:]
        cm = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        logits = logits.masked_fill(~cm[None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return p.matmul(w, v.transpose(0, 1)).transpose(0, 1)  # [S, H, hd]
