"""Plain reference of Canary-Qwen-2.5B (https://huggingface.co/nvidia/canary-qwen-2.5b:
Canary-1B-Flash's FastConformer encoder, a modality adapter, a projection
and Qwen3-1.7B), one clip at a time, in float32 with TF32 off.

Written from the published architecture, not from the program: the
encoder is ``reference/canary.py``'s (NeMo's modules); the adapter is
FastConformer layers of the encoder's widths (``adapter.<i>.``, the same
equations, no subsampling); the projection ``x W^T + b`` to the LLM's
width; the LLM is Qwen3's decoder (``Qwen3DecoderLayer``): RMSNorm with a
plain gain (w * x / sqrt(mean(x^2) + eps)), q, k and v without biases,
each head's q and k RMS-normalised over its 128 channels, then rotated by
RoPE in NeoX halves (x cos + rotate_half(x) sin, inv_freq_j =
theta^(-2j/hd)) at positions 0, 1, 2, ...; softmax attention with a causal
mask, q head i reading K/V head i // (H / H_kv); Wo; RMSNorm and the SwiGLU
feed-forward W_down(silu(W_gate m) * W_up m); a final RMSNorm and the head
tied to the embedding.  The prompt is E[prefix] ++ the clip's audio
embeddings ++ E[suffix], the tokens after it.  The clip runs alone at its
own length, with no cache: nothing is masked or padded.

``kv_int8``: the configurations that cache keys and values in int8 see
them so here too, from the first position after the prompt on: the prompt
attends over its own keys and values as computed (the program's prefill),
every later position over all of them quantized (``numerics.int8_columns``
of each key after its rotation).  Weights come as a dict of tensors under
the state-dict names the benchmark draws (``portbench/weights.py``): the
LLM's q, k and v are the rows of ``qkv.weight`` (q, then k, then v), its
gate and up those of ``gate_up.weight`` (gate first).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import canary as enc
from .numerics import NEG_INF, Products, int8_columns, layer_norm


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotate(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NeoX RoPE over every channel of each head: x [S, H, hd], positions [S]."""
    hd = x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[:, None] * inv_freq  # [S, hd/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(p: Products, q, k, v, first: int) -> torch.Tensor:
    """Causal softmax attention of queries at positions first .. first+S-1
    (q [S, H, hd]) over keys 0 .. T-1 (k, v [T, H_kv, hd]); q head i reads
    K/V head i // (H / H_kv).  Returns [S, H, hd]."""
    s, h, hd = q.shape
    t, hk = k.shape[0], k.shape[1]
    k = k.repeat_interleave(h // hk, dim=1)
    v = v.repeat_interleave(h // hk, dim=1)
    logits = p.matmul(q.transpose(0, 1), k.permute(1, 2, 0)) * hd ** -0.5  # [H, S, T]
    rows = first + torch.arange(s, device=q.device)
    seen = torch.arange(t, device=q.device)[None, :] <= rows[:, None]
    weights = torch.softmax(logits.masked_fill(~seen[None], NEG_INF), dim=-1)
    return p.matmul(weights, v.transpose(0, 1)).transpose(0, 1)


def _conformer_layer(w: dict, arch: dict, pre: str, x: torch.Tensor, p: Products) -> torch.Tensor:
    eps = arch["layer_norm_eps"]

    def ln(name, y):
        return layer_norm(y, w[name + ".weight"], w[name + ".bias"], eps)

    x = x + 0.5 * enc._ffn(w, pre + "ff1.", ln(pre + "ff1_norm", x), p)
    x = x + enc._rel_attention(w, pre + "attn.", ln(pre + "attn_norm", x), arch, p)
    x = x + enc._conv_module(w, pre + "conv.", ln(pre + "conv_norm", x), arch, p)
    x = x + 0.5 * enc._ffn(w, pre + "ff2.", ln(pre + "ff2_norm", x), p)
    return ln(pre + "out_norm", x)


@torch.no_grad()
def audio_embeddings(w: dict, arch: dict, audio: torch.Tensor, p: Products) -> torch.Tensor:
    """audio [N] float32 (the clip's samples) -> [F, llm width]: the encoder's
    memory through the adapter and the projection."""
    x = enc.encode(w, arch, audio, p)
    with enc.float32_products():
        for i in range(arch["adapter_layers"]):
            x = _conformer_layer(w, arch, f"adapter.{i}.", x, p)
        return p.linear(x, w["project.weight"], w["project.bias"])


@torch.no_grad()
def forced_logits(w: dict, arch: dict, audio_emb: torch.Tensor, tokens: torch.Tensor,
                  p: Products, kv_int8: bool) -> torch.Tensor:
    """The LLM's logits [1 + S, V] over the prompt (E[prefix] ++ ``audio_emb``
    [F, D] ++ E[suffix]) and ``tokens`` [S] after it: row 0 at the prompt's
    last position, row i + 1 at token i's, each scoring the token after."""
    eps, theta = arch["rms_norm_eps"], arch["rope_theta"]
    nh, nk, hd = arch["llm_heads"], arch["llm_kv_heads"], arch["llm_head_dim"]
    dev = audio_emb.device
    embed = w["decoder.embed"]
    prefix = torch.tensor(arch["prompt_prefix_ids"], device=dev)
    suffix = torch.tensor(arch["prompt_suffix_ids"], device=dev)
    x = torch.cat([embed[prefix], audio_emb.float(), embed[suffix], embed[tokens]])
    n_prompt = len(prefix) + audio_emb.shape[0] + len(suffix)
    n = x.shape[0]
    pos = torch.arange(n, device=dev)
    with enc.float32_products():
        for i in range(arch["llm_layers"]):
            pre = f"decoder.layers.{i}."
            q, k, v = p.linear(rms_norm(x, w[pre + "ln1.weight"], eps),
                               w[pre + "qkv.weight"]).split([nh * hd, nk * hd, nk * hd], -1)
            q = rotate(rms_norm(q.view(n, nh, hd), w[pre + "q_norm.weight"], eps), pos, theta)
            k = rotate(rms_norm(k.view(n, nk, hd), w[pre + "k_norm.weight"], eps), pos, theta)
            v = v.view(n, nk, hd)
            o = attention(p, q[:n_prompt], k[:n_prompt], v[:n_prompt], 0)
            if n > n_prompt:
                kq, vq = (int8_columns(k), int8_columns(v)) if kv_int8 else (k, v)
                o = torch.cat([o, attention(p, q[n_prompt:], kq, vq, n_prompt)])
            x = x + p.linear(o.reshape(n, nh * hd), w[pre + "o.weight"])
            gate, up = p.linear(rms_norm(x, w[pre + "ln2.weight"], eps),
                                w[pre + "gate_up.weight"]).chunk(2, -1)
            x = x + p.linear(F.silu(gate) * up, w[pre + "down.weight"])
        x = rms_norm(x[n_prompt - 1:], w["decoder.norm.weight"], eps)
        return p.linear(x, embed)
