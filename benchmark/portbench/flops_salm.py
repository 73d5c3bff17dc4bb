"""Operations and bytes from shapes for Canary-Qwen (``configs/canary_qwen_2_5b.json``):
the model FLOPs of a clip, and the least time of the LLM's prefill and of
each decode step, whatever implements them.

Model FLOPs count the model's own products (2 operations a
multiply-accumulate) for a clip's valid samples and the positions it
needed, not the padding a batch adds: the features, stem, encoder and
adapter (``flops_aed``'s arithmetic), the projection, and the LLM over the
clip's prompt (14 + F positions, F its valid frames) and the tokens fed
back, with causal attention (position p attends p + 1 keys) and the tied
head at each scored position (the prompt's last and each token's).
"""

from __future__ import annotations

from . import flops_aed
from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS

KV_SCALE_BYTES = 4  # one float32 scale a key column and head


def prompt_length(arch: dict, n_samples: int) -> int:
    """A clip's prompt: the prefix, its valid frames and the suffix."""
    return (len(arch["prompt_prefix_ids"]) + flops_aed.frames(arch, n_samples)[-1]
            + len(arch["prompt_suffix_ids"]))


def _layer_weights(arch: dict) -> int:
    """Parameters of one LLM layer's products."""
    d, hd, ff = arch["llm_hidden_size"], arch["llm_head_dim"], arch["llm_intermediate_size"]
    qkv = d * (arch["llm_heads"] + 2 * arch["llm_kv_heads"]) * hd
    return qkv + arch["llm_heads"] * hd * d + 3 * d * ff


def llm_flops(arch: dict, positions: int, first: int = 0) -> int:
    """The LLM's layers at ``positions`` positions from ``first`` on (position
    p attends to p + 1 keys), without the head."""
    dense = 2 * _layer_weights(arch) * positions
    keys = sum(p + 1 for p in range(first, first + positions))
    attn = 2 * 2 * arch["llm_heads"] * arch["llm_head_dim"] * keys
    return arch["llm_layers"] * (dense + attn)


def head_flops(arch: dict) -> int:
    return 2 * arch["llm_hidden_size"] * arch["vocab_size"]


def encode_flops(arch: dict, n_samples: int) -> int:
    """Features, stem, encoder, adapter and projection of one clip."""
    t = flops_aed.frames(arch, n_samples)[-1]
    adapter = (flops_aed.encode_flops(dict(arch, encoder_layers=arch["adapter_layers"]), n_samples)
               - flops_aed.encode_flops(dict(arch, encoder_layers=0), n_samples))
    return (flops_aed.encode_flops(arch, n_samples) + adapter
            + 2 * t * arch["d_model"] * arch["llm_hidden_size"])


def decode_flops(arch: dict, n_samples: int, forwards: int) -> int:
    """The prompt and ``forwards`` - 1 tokens fed back, each of the
    ``forwards`` scored positions through the head."""
    positions = prompt_length(arch, n_samples) + forwards - 1
    return llm_flops(arch, positions) + forwards * head_flops(arch)


def weight_bytes(arch: dict, elt_bytes: int) -> int:
    """The LLM's layers and its tied table, read once."""
    return (arch["llm_layers"] * _layer_weights(arch)
            + arch["vocab_size"] * arch["llm_hidden_size"]) * elt_bytes


def _kv_column_bytes(arch: dict) -> int:
    """One position's int8 K and V and their scales, over every layer."""
    return arch["llm_layers"] * 2 * arch["llm_kv_heads"] * (arch["llm_head_dim"] + KV_SCALE_BYTES)


def prefill_bound(arch: dict, lengths: list[int], elt_bytes: int) -> dict:
    """The least time of the prompts of clips whose prompts are ``lengths``
    long, each row alone: the 28 layers' products and causal attention over
    its own positions and the head at its last, at the bf16 peak; against
    the weights read once, the prompts' embeddings read and their K/V
    written once, at the HBM rate."""
    flops = sum(llm_flops(arch, n) + head_flops(arch) for n in lengths)
    moved = (weight_bytes(arch, elt_bytes)
             + sum(lengths) * (arch["llm_hidden_size"] * elt_bytes + _kv_column_bytes(arch)))
    t_flops, t_bytes = flops / PEAK_FLOPS["bfloat16"], moved / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": moved, "bound_s": max(t_flops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def step_bound(arch: dict, lengths: list[int], step: int, elt_bytes: int) -> dict:
    """The least time of decode step ``step`` (1: the first token fed back)
    of a batch whose prompts are ``lengths`` long: the weights of the layers
    and the head read once, each row's int8 K/V and scales up to and with
    its new column read once, the new K/V written once, at the HBM rate."""
    rows = len(lengths)
    moved = (weight_bytes(arch, elt_bytes)
             + sum(n + step for n in lengths) * _kv_column_bytes(arch)
             + rows * _kv_column_bytes(arch))
    return {"bytes": moved, "bound_s": moved / HBM_BYTES_PER_S}


def steps_bound_s(arch: dict, lengths: list[int], steps: int, elt_bytes: int) -> float:
    """Decode steps 1 .. steps - 1 (a decode of ``steps`` decoder calls, the
    prompt's the first), summed."""
    return sum(step_bound(arch, lengths, k, elt_bytes)["bound_s"] for k in range(1, steps))
