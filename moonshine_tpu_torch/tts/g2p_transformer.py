"""Neural OOV G2P: a character -> IPA seq2seq transformer, in PyTorch.

Counterpart of the JAX package's ``tts/g2p_transformer.py``: a small
encoder-decoder transformer with static ``[max_word, max_ipa]`` shapes that
``GraphemeToPhonemizer(oov_model=...)`` consults for the words its lexicon
misses (lexicon entries stay exact).  The output vocabulary and the config
live in the safetensors file's ``__metadata__``, so a saved model is one
self-describing artifact; ``save`` and ``load`` read and write the JAX
package's tensor names (``enc/0/qkv/w`` ...) and layouts (dense kernels
``[in, out]``), so an artifact written by either package loads in the
other.  Training (the JAX package's ``train/g2p.py``) is not ported.

The GELU here is the tanh approximation (``jax.nn.gelu``'s default), not
the exact one of ``models/layers.gelu``.
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

# Input alphabet: lowercase word characters the engines tokenize.
_IN_CHARS = "abcdefghijklmnopqrstuvwxyz'-0123456789"
PAD, BOS, EOS, UNK = 0, 1, 2, 3
_IN_VOCAB = {c: i + 4 for i, c in enumerate(_IN_CHARS)}
IN_VOCAB_SIZE = len(_IN_CHARS) + 4


class G2PModelConfig(NamedTuple):
    dim: int = 128
    layers: int = 2
    heads: int = 4
    max_word: int = 28
    max_ipa: int = 40


def encode_word(word: str, max_word: int) -> np.ndarray:
    """word -> [max_word] int32 ids (BOS ... EOS PAD...)."""
    ids = [BOS] + [_IN_VOCAB.get(c, UNK) for c in word.lower()[: max_word - 2]] + [EOS]
    out = np.zeros(max_word, np.int32)
    out[: len(ids)] = ids
    return out


class G2PBlock(nn.Module):
    """One block: ``ln1``, fused ``qkv``, ``attn_out``, ``ln2``, ``fc1``,
    ``fc2``; a decoder block also ``ln_x``, ``x_q``, fused ``x_kv`` and
    ``x_out`` of its cross-attention."""

    def __init__(self, ln1: Norm, qkv: Dense, attn_out: Dense, ln2: Norm, fc1: Dense,
                 fc2: Dense, ln_x: Norm | None = None, x_q: Dense | None = None,
                 x_kv: Dense | None = None, x_out: Dense | None = None):
        super().__init__()
        self.ln1, self.qkv, self.attn_out, self.ln2, self.fc1, self.fc2 = (
            ln1, qkv, attn_out, ln2, fc1, fc2)
        self.ln_x, self.x_q, self.x_kv, self.x_out = ln_x, x_q, x_kv, x_out


class G2PModel(nn.Module):
    """Embeddings ``in_embed``, ``in_pos``, ``out_embed``, ``out_pos``, the
    ``enc`` and ``dec`` blocks, ``ln_f`` and the ``head``."""

    def __init__(self, in_embed: torch.Tensor, in_pos: torch.Tensor, out_embed: torch.Tensor,
                 out_pos: torch.Tensor, enc: list[G2PBlock], dec: list[G2PBlock], ln_f: Norm,
                 head: Dense):
        super().__init__()
        for name, t in (("in_embed", in_embed), ("in_pos", in_pos), ("out_embed", out_embed),
                        ("out_pos", out_pos)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        self.enc, self.dec = nn.ModuleList(enc), nn.ModuleList(dec)
        self.ln_f, self.head = ln_f, head


def _block_init(generator: torch.Generator, dim: int, cross: bool) -> G2PBlock:
    extra = {}
    blk = dict(ln1=norm_init(dim), qkv=dense_init(generator, dim, 3 * dim),
               attn_out=dense_init(generator, dim, dim), ln2=norm_init(dim),
               fc1=dense_init(generator, dim, 4 * dim), fc2=dense_init(generator, 4 * dim, dim))
    if cross:
        extra = dict(ln_x=norm_init(dim), x_q=dense_init(generator, dim, dim),
                     x_kv=dense_init(generator, dim, 2 * dim),
                     x_out=dense_init(generator, dim, dim))
    return G2PBlock(**blk, **extra)


def init_params(cfg: G2PModelConfig, generator: torch.Generator, out_vocab_size: int,
                in_vocab_size: int = IN_VOCAB_SIZE, device=None) -> G2PModel:
    """Random weights from ``generator`` on ``device`` (CUDA unless named),
    with the JAX initializer's distributions."""
    def normal(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    model = G2PModel(normal(in_vocab_size, cfg.dim), normal(cfg.max_word, cfg.dim),
                     normal(out_vocab_size, cfg.dim), normal(cfg.max_ipa, cfg.dim),
                     [_block_init(generator, cfg.dim, False) for _ in range(cfg.layers)],
                     [_block_init(generator, cfg.dim, True) for _ in range(cfg.layers)],
                     norm_init(cfg.dim), dense_init(generator, cfg.dim, out_vocab_size))
    return model.to(resolve_device(device))


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
         mask: torch.Tensor) -> torch.Tensor:
    b, tq, d = q.shape
    tk = k.shape[1]
    hd = d // heads
    q = q.reshape(b, tq, heads, hd).transpose(1, 2)
    k = k.reshape(b, tk, heads, hd).transpose(1, 2)
    v = v.reshape(b, tk, heads, hd).transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
    w = torch.softmax(logits.masked_fill(~mask, -1e9), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v)
    return o.transpose(1, 2).reshape(b, tq, d)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _enc_block(p: G2PBlock, x, heads, mask):
    h = layer_norm(p.ln1, x)
    q, k, v = dense(p.qkv, h).chunk(3, dim=-1)
    x = x + dense(p.attn_out, _mha(q, k, v, heads, mask))
    h = layer_norm(p.ln2, x)
    return x + dense(p.fc2, _gelu(dense(p.fc1, h)))


def _dec_block(p: G2PBlock, x, memory, heads, self_mask, cross_mask):
    h = layer_norm(p.ln1, x)
    q, k, v = dense(p.qkv, h).chunk(3, dim=-1)
    x = x + dense(p.attn_out, _mha(q, k, v, heads, self_mask))
    h = layer_norm(p.ln_x, x)
    xq = dense(p.x_q, h)
    xk, xv = dense(p.x_kv, memory).chunk(2, dim=-1)
    x = x + dense(p.x_out, _mha(xq, xk, xv, heads, cross_mask))
    h = layer_norm(p.ln2, x)
    return x + dense(p.fc2, _gelu(dense(p.fc1, h)))


@torch.inference_mode()
def encode(model: G2PModel, cfg: G2PModelConfig, src: torch.Tensor):
    """src [B, max_word] -> (memory [B, max_word, D], valid [B, max_word])."""
    valid = src != PAD
    x = model.in_embed[src.long()] + model.in_pos[None, :, :]
    mask = valid[:, None, None, :]
    for blk in model.enc:
        x = _enc_block(blk, x, cfg.heads, mask)
    return x, valid


@torch.inference_mode()
def decoder_logits(model: G2PModel, cfg: G2PModelConfig, memory: torch.Tensor,
                   mem_valid: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits [B, T, V] for target prefix ids [B, T]."""
    t = tgt.shape[1]
    x = model.out_embed[tgt.long()] + model.out_pos[None, :t, :]
    causal = torch.ones((t, t), dtype=torch.bool, device=tgt.device).tril()[None, None]
    self_mask = causal & (tgt != PAD)[:, None, None, :]
    cross_mask = mem_valid[:, None, None, :]
    for blk in model.dec:
        x = _dec_block(blk, x, memory, cfg.heads, self_mask, cross_mask)
    return dense(model.head, layer_norm(model.ln_f, x))


@torch.inference_mode()
def greedy(model: G2PModel, cfg: G2PModelConfig, src: torch.Tensor) -> torch.Tensor:
    """Batched greedy decode: src [B, max_word] -> out ids [B, max_ipa].

    Runs all ``max_ipa - 1`` steps as JAX's scan does, re-running the
    decoder over the whole prefix each step; a finished row writes PAD
    after its EOS.  ``argmax`` ties go to the first index, as in JAX."""
    b = src.shape[0]
    memory, mem_valid = encode(model, cfg, src)
    tokens = torch.zeros((b, cfg.max_ipa), dtype=torch.int32, device=src.device)
    tokens[:, 0] = BOS
    done = torch.zeros(b, dtype=torch.bool, device=src.device)
    for t in range(cfg.max_ipa - 1):
        logits = decoder_logits(model, cfg, memory, mem_valid, tokens)
        nxt = torch.argmax(logits[:, t, :], dim=-1).to(torch.int32)
        nxt = torch.where(done, PAD, nxt)
        tokens[:, t + 1] = nxt
        done = done | (nxt == EOS)
    return tokens


def artifact_shapes(cfg: G2PModelConfig, out_vocab_size: int,
                    in_vocab_size: int = IN_VOCAB_SIZE) -> dict[str, tuple[int, ...]]:
    """Every tensor name of an artifact (the JAX tree's paths) with its
    shape (the JAX tree's layouts)."""
    from .. import weights

    model = init_params(cfg, torch.Generator().manual_seed(0), out_vocab_size, in_vocab_size,
                        "cpu")
    return {k: v.shape for k, v in weights.flatten_tree(weights.g2p_params_to_numpy(model)).items()}


class G2PTransformer:
    """A trained char->IPA model + its output vocabulary, as one artifact.

    ``device``: where the model runs (CUDA unless named); the model is
    moved there."""

    def __init__(self, cfg: G2PModelConfig, params: G2PModel, out_vocab: list[str],
                 in_vocab: list[str] | None = None, device=None):
        """``in_vocab``: optional custom input alphabet (one codepoint per
        entry, id = index + 4 after the specials) for non-Latin scripts.
        None keeps the default Latin ``_IN_CHARS`` table."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.out_vocab = list(out_vocab)
        self.in_vocab = list(in_vocab) if in_vocab is not None else None
        self._in_map = (
            {c: i + 4 for i, c in enumerate(self.in_vocab)}
            if self.in_vocab is not None else None
        )
        self._id_to_sym = {i: s for i, s in enumerate(self.out_vocab)}
        self._sym_to_id = {s: i for i, s in enumerate(self.out_vocab)}

    @staticmethod
    def build_in_vocab(words) -> list[str]:
        """Input alphabet = every codepoint seen in the training surfaces."""
        return sorted({ch for w in words for ch in w})

    def encode_src(self, word: str) -> np.ndarray:
        """word -> [max_word] ids using the model's input alphabet."""
        if self._in_map is None:
            return encode_word(word, self.cfg.max_word)
        ids = [BOS] + [
            self._in_map.get(c, UNK) for c in word[: self.cfg.max_word - 2]
        ] + [EOS]
        out = np.zeros(self.cfg.max_word, np.int32)
        out[: len(ids)] = ids
        return out

    @property
    def in_vocab_size(self) -> int:
        return (len(self.in_vocab) + 4 if self.in_vocab is not None
                else IN_VOCAB_SIZE)

    # -- vocab ---------------------------------------------------------------

    @staticmethod
    def build_out_vocab(ipa_strings) -> list[str]:
        """Output symbols = specials + every codepoint seen in targets."""
        syms = sorted({ch for s in ipa_strings for ch in s})
        return ["<pad>", "<bos>", "<eos>", "<unk>"] + syms

    def encode_ipa(self, ipa: str) -> np.ndarray:
        ids = [BOS] + [
            self._sym_to_id.get(ch, UNK) for ch in ipa[: self.cfg.max_ipa - 2]
        ] + [EOS]
        out = np.zeros(self.cfg.max_ipa, np.int32)
        out[: len(ids)] = ids
        return out

    def decode_ids(self, ids: np.ndarray) -> str:
        out = []
        for i in np.asarray(ids):
            i = int(i)
            if i == EOS:
                break
            if i in (PAD, BOS, UNK):
                continue
            out.append(self._id_to_sym.get(i, ""))
        return "".join(out)

    # -- inference -------------------------------------------------------------

    def predict(self, word: str) -> str:
        return self.predict_batch([word])[0]

    def predict_batch(self, words: list[str]) -> list[str]:
        src = np.stack([self.encode_src(w) for w in words])
        out = greedy(self.params, self.cfg, torch.from_numpy(src).to(self.device))
        return [self.decode_ids(row[1:]) for row in out.cpu().numpy()]

    # -- persistence -----------------------------------------------------------

    def save(self, path: str | Path) -> None:
        from .. import weights

        meta = {
            "out_vocab": json.dumps(self.out_vocab, ensure_ascii=False),
            "config": json.dumps(self.cfg._asdict()),
        }
        if self.in_vocab is not None:
            meta["in_vocab"] = json.dumps(self.in_vocab, ensure_ascii=False)
        flat = weights.flatten_tree(weights.g2p_params_to_numpy(self.params))
        weights.save_safetensors(path, flat, metadata=meta)

    @classmethod
    def load(cls, path: str | Path, device=None) -> "G2PTransformer":
        from .. import weights

        flat, meta = weights.load_safetensors_with_metadata(path)
        if "out_vocab" not in meta or "config" not in meta:
            raise ValueError(f"{path}: not a G2PTransformer artifact (missing metadata)")
        out_vocab = json.loads(meta["out_vocab"])
        in_vocab = json.loads(meta["in_vocab"]) if "in_vocab" in meta else None
        cfg = G2PModelConfig(**json.loads(meta["config"]))
        in_size = len(in_vocab) + 4 if in_vocab is not None else IN_VOCAB_SIZE
        tree = {}
        for name, shape in artifact_shapes(cfg, len(out_vocab), in_size).items():
            if name not in flat:
                raise KeyError(f"G2P model missing tensor {name!r}")
            if flat[name].shape != shape:
                raise ValueError(f"Shape mismatch for {name}: {flat[name].shape} vs {shape}")
            tree[name] = flat[name].astype(np.float32)
        params = weights.g2p_params_from_jax_numpy(weights.unflatten_tree(tree), device)
        return cls(cfg, params, out_vocab, in_vocab, device=device)
