"""Gemma3-style text encoder for semantic embeddings, in PyTorch.

Counterpart of the JAX package's ``models/gemma.py`` (EmbeddingGemma-300m:
768-dim vectors, vocabulary 262,144, mean pooling, task prefixes,
Matryoshka truncation), with the published safetensors importing through
``weights.import_hf_gemma3_text``:

- RMSNorm computed in float32 with the zero-centred ``(1 + w)`` gain, on
  the hidden states and per head on q and k
- GQA attention (kv heads repeated), every ``global_layer_interval``-th
  layer full, the rest a symmetric sliding window ``|q - k| < window``,
  each with its own rotary base; the rotary is the half-split (NeoX) form
  over the whole head, not the interleaved pairs of ``ops/rotary.py``
- GeGLU MLP with the tanh-approximate GELU, embeddings scaled by
  sqrt(hidden)
- bidirectional attention for embeddings (``causal=False``), causal for
  the comparison with ``Gemma3TextModel``

Attention is the JAX einsums: float32 logits, masked positions set to
-1e9 (a fully masked row gets uniform weights where a boolean-masked
SDPA would give NaN), a float32 softmax.  The layers are kept in an
``nn.ModuleList`` where JAX stacks them for ``lax.scan``, so each layer's
rotary base and mask are chosen in Python.

``GemmaEmbedder`` applies the reference's prefixes, pads each text to a
sequence bucket, mean-pools over valid tokens, L2-normalises, and returns
a numpy vector (the agent's embedding cache keeps host vectors).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from .layers import Dense, Norm, dense, dense_init

QUERY_PREFIX = "task: search result | query: "
DOCUMENT_PREFIX = "title: none | text: "


@dataclass(frozen=True)
class GemmaTextConfig:
    vocab_size: int = 262144
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_layers: int = 24
    num_heads: int = 3
    num_kv_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 1_000_000.0
    rope_local_base_freq: float = 10_000.0
    sliding_window: int = 512
    # every Nth layer is full attention, the rest sliding
    global_layer_interval: int = 6
    query_pre_attn_scalar: float = 256.0
    rms_norm_eps: float = 1e-6
    bos_token_id: int = 2
    eos_token_id: int = 1
    pad_token_id: int = 0
    max_seq_length: int = 2048
    # Embedding head (sentence-transformers dense stack): 768 -> 3072 -> 768
    embedding_dim: int = 768
    projection_hidden: int = 3072

    def layer_is_global(self, i: int) -> bool:
        return (i + 1) % self.global_layer_interval == 0


class GemmaLayer(nn.Module):
    """One decoder layer's holders: the four norms around attention and
    MLP (``Norm`` weights in the ``(1 + w)`` convention), q/k/v/o, the per
    head ``q_norm``/``k_norm``, and the gate/up/down MLP."""

    def __init__(self, input_norm: Norm, q: Dense, k: Dense, v: Dense, o: Dense,
                 q_norm: Norm, k_norm: Norm, post_attn_norm: Norm, pre_ffw_norm: Norm,
                 gate: Dense, up: Dense, down: Dense, post_ffw_norm: Norm):
        super().__init__()
        self.input_norm, self.q, self.k, self.v, self.o = input_norm, q, k, v, o
        self.q_norm, self.k_norm = q_norm, k_norm
        self.post_attn_norm, self.pre_ffw_norm = post_attn_norm, pre_ffw_norm
        self.gate, self.up, self.down, self.post_ffw_norm = gate, up, down, post_ffw_norm


class Gemma(nn.Module):
    """The token embedding ``embed [vocab, hidden]``, the layers, the final
    norm and the optional projection head ``proj1``, ``proj2`` (absent when
    imported from a text model without the sentence-transformers head)."""

    def __init__(self, embed: torch.Tensor, layers: list[GemmaLayer], final_norm: Norm,
                 proj1: Dense | None = None, proj2: Dense | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.proj1, self.proj2 = proj1, proj2


def _zeros_norm(dim: int) -> Norm:
    return Norm(torch.zeros(dim))


def init_params(cfg: GemmaTextConfig, generator: torch.Generator, device=None) -> Gemma:
    """Random weights from ``generator`` on ``device`` (CUDA unless named),
    drawn as the JAX initializer draws them: the embedding N(0, 0.02²),
    dense layers uniform in +-1/sqrt(in), every norm gain zero (a ``1 +
    w`` gain of one)."""
    d, hd = cfg.hidden_size, cfg.head_dim
    embed = torch.randn((cfg.vocab_size, d), generator=generator) * 0.02

    def layer() -> GemmaLayer:
        return GemmaLayer(
            _zeros_norm(d),
            dense_init(generator, d, cfg.num_heads * hd, bias=False),
            dense_init(generator, d, cfg.num_kv_heads * hd, bias=False),
            dense_init(generator, d, cfg.num_kv_heads * hd, bias=False),
            dense_init(generator, cfg.num_heads * hd, d, bias=False),
            _zeros_norm(hd), _zeros_norm(hd), _zeros_norm(d), _zeros_norm(d),
            dense_init(generator, d, cfg.intermediate_size, bias=False),
            dense_init(generator, d, cfg.intermediate_size, bias=False),
            dense_init(generator, cfg.intermediate_size, d, bias=False),
            _zeros_norm(d))

    layers = [layer() for _ in range(cfg.num_layers)]
    model = Gemma(embed, layers, _zeros_norm(d),
                  dense_init(generator, d, cfg.projection_hidden, bias=False),
                  dense_init(generator, cfg.projection_hidden, cfg.embedding_dim, bias=False))
    return model.to(resolve_device(device))


def _rms_norm(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p.weight.float())).to(x.dtype)


def _rope_tables(s: int, hd: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [S, 1, hd / 2] (float32) of the half-split rotary."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) * 2.0 / hd))
    angles = torch.arange(s, device=device).float()[:, None] * freqs
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split (NeoX, non-interleaved) rotation of x [B, S, H, hd]."""
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer_apply(cfg: GemmaTextConfig, h: torch.Tensor, lp: GemmaLayer, mask: torch.Tensor,
                 rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    b, s, _ = h.shape
    eps = cfg.rms_norm_eps
    x = _rms_norm(lp.input_norm, h, eps)
    q = dense(lp.q, x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = dense(lp.k, x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = dense(lp.v, x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = _rope(_rms_norm(lp.q_norm, q, eps), *rope)
    k = _rope(_rms_norm(lp.k_norm, k, eps), *rope)
    rep = cfg.num_heads // cfg.num_kv_heads
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = cfg.query_pre_attn_scalar ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask, -1e9)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhst,bthd->bshd", w, v)
    attn = _rms_norm(lp.post_attn_norm, dense(lp.o, o.reshape(b, s, -1)), eps)
    h = h + attn
    x = _rms_norm(lp.pre_ffw_norm, h, eps)
    gate = F.gelu(dense(lp.gate, x), approximate="tanh")
    mlp = _rms_norm(lp.post_ffw_norm, dense(lp.down, gate * dense(lp.up, x)), eps)
    return h + mlp


@torch.inference_mode()
def encode_tokens(model: Gemma, cfg: GemmaTextConfig, tokens: torch.Tensor,
                  token_mask: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Token ids [B, S] (valid where ``token_mask``) -> [B, S, hidden]
    contextual states."""
    s = tokens.shape[1]
    dev = tokens.device
    h = model.embed[tokens.long()] * float(np.sqrt(np.float32(cfg.hidden_size)))
    pos = torch.arange(s, device=dev)
    base = token_mask.bool()[:, None, None, :]  # keys valid
    qpos, kpos = pos[:, None], pos[None, :]
    if causal:
        base = base & (kpos <= qpos)
    masks = {True: base, False: base & ((qpos - kpos).abs() < cfg.sliding_window)}
    ropes = {True: _rope_tables(s, cfg.head_dim, cfg.rope_theta, dev),
             False: _rope_tables(s, cfg.head_dim, cfg.rope_local_base_freq, dev)}
    for i, lp in enumerate(model.layers):
        is_global = cfg.layer_is_global(i)
        h = _layer_apply(cfg, h, lp, masks[is_global], ropes[is_global])
    return _rms_norm(model.final_norm, h, cfg.rms_norm_eps)


@torch.inference_mode()
def embed_tokens(model: Gemma, cfg: GemmaTextConfig, tokens: torch.Tensor,
                 token_mask: torch.Tensor) -> torch.Tensor:
    """Token ids -> [B, embedding_dim] L2-normalised sentence embeddings."""
    if model.proj1 is None or model.proj2 is None:
        raise KeyError("the model has no projection head (proj1, proj2)")
    h = encode_tokens(model, cfg, tokens, token_mask, causal=False)
    m = token_mask.to(h.dtype)[..., None]
    pooled = (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    e = dense(model.proj2, dense(model.proj1, pooled))
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)


# =========================================================================
# TextEmbedder facade
# =========================================================================

class GemmaEmbedder:
    """Text -> embedding with the reference's prefixes and pooling.

    ``device``: where the model runs (CUDA unless named); the model is
    moved there.  Vectors come back as float32 numpy arrays."""

    # Sequence-length buckets: one shape per bucket.
    _BUCKETS = [16, 32, 64, 128, 256, 512, 1024, 2048]

    def __init__(self, params: Gemma, cfg: GemmaTextConfig, tokenizer, device=None):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer

    def _tokenize(self, text: str) -> list[int]:
        # [bos] ids [eos], truncated to max_seq_length with EOS kept.
        ids = [self.cfg.bos_token_id] + self.tokenizer.text_to_tokens(text)
        ids = ids[: self.cfg.max_seq_length - 1]
        ids.append(self.cfg.eos_token_id)
        return ids

    def batch(self, text: str) -> tuple[np.ndarray, np.ndarray]:
        """The padded ``[1, bucket]`` tokens and mask ``get_embeddings``
        runs for ``text``."""
        ids = self._tokenize(text)
        bucket = next((b for b in self._BUCKETS if b >= len(ids)), self._BUCKETS[-1])
        ids = ids[:bucket]
        tokens = np.full((1, bucket), self.cfg.pad_token_id, np.int32)
        tokens[0, : len(ids)] = ids
        mask = np.zeros((1, bucket), bool)
        mask[0, : len(ids)] = True
        return tokens, mask

    def get_embeddings(self, text: str) -> np.ndarray:
        tokens, mask = self.batch(text)
        e = embed_tokens(self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
                         torch.from_numpy(mask).to(self.device))
        return e[0].float().cpu().numpy()

    def get_embeddings_with_prefix(self, text: str, prefix: str) -> np.ndarray:
        return self.get_embeddings(prefix + text)

    def get_query_embeddings(self, query: str) -> np.ndarray:
        return self.get_embeddings_with_prefix(query, QUERY_PREFIX)

    def get_document_embeddings(self, document: str) -> np.ndarray:
        return self.get_embeddings_with_prefix(document, DOCUMENT_PREFIX)

    def get_similarity(self, a, b) -> float:
        ea = self.get_embeddings(a) if isinstance(a, str) else np.asarray(a)
        eb = self.get_embeddings(b) if isinstance(b, str) else np.asarray(b)
        return cosine_similarity(ea, eb)

    @staticmethod
    def truncate_embedding(embedding: np.ndarray, target_dim: int) -> np.ndarray:
        """Matryoshka truncation + renormalize."""
        embedding = np.asarray(embedding)
        if target_dim <= 0 or target_dim >= embedding.shape[-1]:
            return embedding
        t = embedding[..., :target_dim]
        norm = np.linalg.norm(t, axis=-1, keepdims=True)
        return np.where(norm > 0, t / np.maximum(norm, 1e-12), t)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or a.size == 0:
        return 0.0
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom == 0.0:
        return 0.0
    return float(np.dot(a, b) / denom)


def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    """1 - similarity, scipy convention."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError("cosine distance: vectors must have the same length")
    return 1.0 - cosine_similarity(a, b)
