"""Plain reference of Moonshine (the non-streaming encoder-decoder), one
clip at a time, in float32.

Written from the published architecture (the HF ``MoonshineForConditional
Generation``): a frontend of three valid convolutions over the raw 16 kHz
waveform (127 taps at stride 64 without bias, tanh, a one-group GroupNorm;
7 at stride 3 and GELU; 3 at stride 2 and GELU), a pre-LN encoder of
rotary self-attention and a GELU MLP, and a pre-LN decoder of rotary
causal self-attention, cross-attention over the encoder's output without
rotary, and a SwiGLU MLP whose first product gives (value, gate) halves,
with the output projection tied to the embedding.  Rotary takes the first
``int(head_dim * partial_rotary_factor)`` channels (rounded down to even)
of each head, in interleaved pairs.

``kv_int8``: the configurations that cache keys and values in int8 (one
scale per position and head) see them so here too.

Weights come as a dict of tensors under the state-dict names the
benchmark draws (``portbench/weights.py``); the reference reads nothing
else of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .numerics import Products, attention, int8_columns, layer_norm, rotary


def _rotary_dim(arch: dict) -> int:
    hd = arch["hidden_size"] // arch["encoder_heads"]
    dim = int(hd * arch["partial_rotary_factor"])
    return dim - dim % 2


@torch.no_grad()
def encode(w: dict, arch: dict, audio: torch.Tensor, p: Products) -> torch.Tensor:
    """audio [N] float32 (valid samples only) -> memory [T, D]."""
    eps = arch["layer_norm_eps"]
    s1, s2, s3 = arch["conv_strides"]
    x = torch.tanh(p.conv1d(audio[None, None].float(), w["frontend.conv1.weight"], None, s1))
    x = x[0].t()  # [T1, D]
    mean = x.mean()
    var = (x - mean).square().mean()
    x = (x - mean) * torch.rsqrt(var + 1e-5) * w["frontend.gn.weight"] + w["frontend.gn.bias"]
    x = F.gelu(p.conv1d(x.t()[None], w["frontend.conv2.weight"], w["frontend.conv2.bias"], s2))
    x = F.gelu(p.conv1d(x, w["frontend.conv3.weight"], w["frontend.conv3.bias"], s3))
    h = x[0].t()  # [T, D]
    t = h.shape[0]
    heads, hd = arch["encoder_heads"], arch["hidden_size"] // arch["encoder_heads"]
    pos = torch.arange(t, device=h.device)
    rd = _rotary_dim(arch)
    for i in range(arch["encoder_layers"]):
        pre = f"encoder.layers.{i}."
        x = layer_norm(h, w[pre + "ln1.weight"], None, eps)
        q = p.linear(x, w[pre + "attn.q.weight"]).view(t, heads, hd)
        k = p.linear(x, w[pre + "attn.k.weight"]).view(t, heads, hd)
        v = p.linear(x, w[pre + "attn.v.weight"]).view(t, heads, hd)
        q, k = rotary(q, pos, rd, arch["rope_theta"]), rotary(k, pos, rd, arch["rope_theta"])
        o = attention(p, q, k, v).reshape(t, -1)
        h = h + p.linear(o, w[pre + "attn.o.weight"])
        x = layer_norm(h, w[pre + "ln2.weight"], None, eps)
        x = F.gelu(p.linear(x, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"]))
        h = h + p.linear(x, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"])
    return layer_norm(h, w["encoder.norm.weight"], None, eps)


def decoder_dims(arch: dict) -> dict:
    heads = arch["decoder_heads"]
    return {"layers": arch["decoder_layers"], "heads": heads,
            "head_dim": arch["hidden_size"] // heads, "rotary_dim": _rotary_dim(arch),
            "theta": arch["rope_theta"], "eps": arch["layer_norm_eps"]}


@torch.no_grad()
def forced_logits(w: dict, dims: dict, memory: torch.Tensor, tokens: torch.Tensor,
                  p: Products, kv_int8: bool) -> torch.Tensor:
    """Decoder logits [S, V] over ``tokens`` [S] (the start token first)
    attending to ``memory`` [T, D]: row i scores the token after
    ``tokens[i]``.  ``dims``: layers, heads, head_dim, rotary_dim, theta,
    eps (``decoder_dims``)."""
    eps, heads, hd = dims["eps"], dims["heads"], dims["head_dim"]
    s = tokens.shape[0]
    pos = torch.arange(s, device=memory.device)
    kv = int8_columns if kv_int8 else (lambda x: x)
    h = w["decoder.embed"][tokens]
    for i in range(dims["layers"]):
        pre = f"decoder.layers.{i}."
        x = layer_norm(h, w[pre + "ln1.weight"], None, eps)
        q = rotary(p.linear(x, w[pre + "self_attn.q.weight"]).view(s, heads, hd), pos,
                   dims["rotary_dim"], dims["theta"])
        k = rotary(p.linear(x, w[pre + "self_attn.k.weight"]).view(s, heads, hd), pos,
                   dims["rotary_dim"], dims["theta"])
        v = p.linear(x, w[pre + "self_attn.v.weight"]).view(s, heads, hd)
        o = attention(p, q, kv(k), kv(v), causal=True).reshape(s, -1)
        h = h + p.linear(o, w[pre + "self_attn.o.weight"])
        x = layer_norm(h, w[pre + "ln2.weight"], None, eps)
        q = p.linear(x, w[pre + "cross_attn.q.weight"]).view(s, heads, hd)
        t = memory.shape[0]
        k = p.linear(memory, w[pre + "cross_attn.k.weight"]).view(t, heads, hd)
        v = p.linear(memory, w[pre + "cross_attn.v.weight"]).view(t, heads, hd)
        o = attention(p, q, kv(k), kv(v)).reshape(s, -1)
        h = h + p.linear(o, w[pre + "cross_attn.o.weight"])
        x = layer_norm(h, w[pre + "ln3.weight"], None, eps)
        val, gate = p.linear(x, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"]).chunk(2, -1)
        h = h + p.linear(F.silu(gate) * val, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"])
    h = layer_norm(h, w["decoder.norm.weight"], None, eps)
    return p.linear(h, w["decoder.embed"])
