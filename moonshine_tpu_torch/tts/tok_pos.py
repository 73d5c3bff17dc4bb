"""Char-level tokenizer-POS tagger — the zh/ja text-frontend neural tier,
in PyTorch.

Counterpart of the JAX package's ``tts/tok_pos.py``.  The reference
segments Chinese/Japanese text into words with UPOS tags via ONNX
transformer helpers (reference: core/moonshine-tts/src/lang-specific/
chinese-tok-pos-onnx.h — a RoBERTa BIO tagger — and
japanese-tok-pos-onnx.h); this is a small char-level transformer encoder
with two classification heads — B/I word-boundary and UPOS — serving
``annotate(text) -> [(surface, upos)]`` with the reference helper's
contract.  Static ``[max_len]`` shapes: any line is one batch.

The blocks are ``tts/g2p_transformer``'s encoder blocks, as in JAX.  An
artifact is one safetensors file with the vocabulary, tags and config in
its ``__metadata__`` and the JAX tree's tensor names (``enc/0/qkv/w`` ...)
and layouts, so an artifact written by either package loads in the
other.  ``train/tok_pos.py`` trains it: ``forward`` records an autograd
graph when the parameters require gradients, and the inference entry
points, ``TokPosTagger.logits`` and ``annotate``, run under
``torch.inference_mode``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..models.layers import Dense, Norm, dense, dense_init, layer_norm, norm_init
from .g2p_transformer import G2PBlock, _block_init, _enc_block

PAD, UNK = 0, 1


class TokPosConfig(NamedTuple):
    dim: int = 128
    layers: int = 2
    heads: int = 4
    max_len: int = 192


class TokPosModel(nn.Module):
    """``embed``, ``pos``, the ``enc`` blocks, ``ln_f`` and the two heads
    ``head_bio`` and ``head_pos``."""

    def __init__(self, embed: torch.Tensor, pos: torch.Tensor, enc: list[G2PBlock],
                 ln_f: Norm, head_bio: Dense, head_pos: Dense):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.pos = nn.Parameter(pos, requires_grad=False)
        self.enc = nn.ModuleList(enc)
        self.ln_f, self.head_bio, self.head_pos = ln_f, head_bio, head_pos


def init_params(cfg: TokPosConfig, generator: torch.Generator, in_vocab_size: int,
                n_tags: int, device=None) -> TokPosModel:
    """Random weights from ``generator`` on ``device`` (CUDA unless named),
    with the JAX initializer's distributions."""
    model = TokPosModel(torch.randn((in_vocab_size, cfg.dim), generator=generator) * 0.02,
                        torch.randn((cfg.max_len, cfg.dim), generator=generator) * 0.02,
                        [_block_init(generator, cfg.dim, False) for _ in range(cfg.layers)],
                        norm_init(cfg.dim), dense_init(generator, cfg.dim, 2),
                        dense_init(generator, cfg.dim, n_tags))
    return model.to(resolve_device(device))


def forward(model: TokPosModel, cfg: TokPosConfig, src: torch.Tensor):
    """src [B, max_len] int -> (bio logits [B, L, 2], pos logits [B, L, T])."""
    valid = src != PAD
    x = F.embedding(src.long(), model.embed) + model.pos[None, : src.shape[1], :]
    mask = valid[:, None, None, :]
    for blk in model.enc:
        x = _enc_block(blk, x, cfg.heads, mask)
    x = layer_norm(model.ln_f, x)
    return dense(model.head_bio, x), dense(model.head_pos, x)


class TokPosTagger:
    """Tagger weights + vocab/tag tables, one self-describing artifact;
    the model runs on ``device`` (CUDA unless named)."""

    def __init__(self, cfg: TokPosConfig, params: TokPosModel,
                 char_vocab: list[str], tags: list[str], device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.char_vocab = list(char_vocab)
        self.tags = list(tags)
        self._char_map = {c: i + 2 for i, c in enumerate(self.char_vocab)}

    def encode(self, text: str) -> np.ndarray:
        ids = [self._char_map.get(c, UNK) for c in text[: self.cfg.max_len]]
        out = np.zeros(self.cfg.max_len, np.int32)
        out[: len(ids)] = ids
        return out

    @torch.inference_mode()
    def logits(self, text: str) -> tuple[torch.Tensor, torch.Tensor]:
        """(bio [1, L, 2], pos [1, L, T]) of a stripped line, on the device."""
        src = torch.from_numpy(self.encode(text.strip())[None, :]).to(self.device)
        return forward(self.params, self.cfg, src)

    @torch.inference_mode()
    def annotate(self, text: str) -> list[tuple[str, str]]:
        """-> one (surface, UPOS) per predicted word (reference:
        ChineseTokPosOnnx::annotate)."""
        text = text.strip()
        if not text:
            return []
        bio, pos = self.logits(text)
        n = min(len(text), self.cfg.max_len)
        is_b = (bio[0, :n].argmax(dim=-1) == 1).cpu().numpy()
        tag_ids = pos[0, :n].argmax(dim=-1).cpu().numpy()
        words: list[tuple[str, str]] = []
        start = 0
        for i in range(1, n):
            if is_b[i]:
                words.append((text[start:i], self.tags[int(tag_ids[start])]))
                start = i
        words.append((text[start:n], self.tags[int(tag_ids[start])]))
        return [w for w in words if w[0].strip()]

    def segment(self, text: str) -> list[str]:
        return [w for w, _ in self.annotate(text)]

    # -- persistence (same safetensors shape as G2PTransformer) -------------

    def save(self, path: str | Path) -> None:
        from .. import weights

        meta = {
            "char_vocab": json.dumps(self.char_vocab, ensure_ascii=False),
            "tags": json.dumps(self.tags, ensure_ascii=False),
            "config": json.dumps(self.cfg._asdict()),
        }
        flat = weights.flatten_tree(weights.tok_pos_params_to_numpy(self.params))
        weights.save_safetensors(path, flat, metadata=meta)

    @classmethod
    def load(cls, path: str | Path, device=None) -> "TokPosTagger":
        from .. import weights

        flat, meta = weights.load_safetensors_with_metadata(path)
        if "char_vocab" not in meta or "tags" not in meta:
            raise ValueError(f"{path}: not a TokPosTagger artifact")
        char_vocab = json.loads(meta["char_vocab"])
        tags = json.loads(meta["tags"])
        cfg = TokPosConfig(**json.loads(meta["config"]))
        target = init_params(cfg, torch.Generator().manual_seed(0), len(char_vocab) + 2,
                             len(tags), "cpu")
        tree = {}
        for name, leaf in weights.flatten_tree(weights.tok_pos_params_to_numpy(target)).items():
            arr = flat[name]
            if arr.shape != leaf.shape:
                raise ValueError(f"Shape mismatch for {name}")
            tree[name] = arr.astype(leaf.dtype)
        params = weights.tok_pos_params_from_jax_numpy(weights.unflatten_tree(tree), device)
        return cls(cfg, params, char_vocab, tags, device=device)
