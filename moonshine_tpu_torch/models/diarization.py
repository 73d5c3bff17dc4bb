"""Diarization neural models, in PyTorch: segmentation and speaker embedding.

Counterpart of the JAX package's ``models/diarization.py``:

- ``Segmentation``: a 10 s analysis window -> per-frame *powerset*
  speaker-activity logits over up to 3 local speakers (classes: empty,
  {1}, {2}, {3}, {1,2}, {1,3}, {2,3}).  Two stride-2 convolutions over the
  log-mel (XLA's SAME padding), then a small bidirectional transformer
  (pre-norm, 4 heads, exact GELU), whose layers JAX stacks for
  ``lax.scan`` and the port keeps in an ``nn.ModuleList``.  Every window
  of an update runs as one batch.
- ``Embedding``: ECAPA-style speaker embedding -- log-mel, dilated
  convolutions with residuals, attentive statistics pooling with optional
  frame weights (one embedding per active local speaker of a window), a
  192-d L2-normalised vector.

Convolutions run channels-first (``[B, C, T]``) where JAX is ``NWC``; the
transformer and the pooling run ``[B, T, C]`` as JAX does.  The clustering
lives in ``pipeline/diarization.py``.  The forwards are differentiable
(``train/diarization.py``); the inference callers hold
``torch.inference_mode``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.mel import log_mel
from .layers import (
    Conv1d,
    Dense,
    Norm,
    conv_same,
    dense,
    dense_init,
    gelu,
    layer_norm,
    norm_init,
)
from .moonshine import Attention, EncoderLayer, Mlp

SAMPLE_RATE = 16000
WINDOW_SECONDS = 10.0
WINDOW_SAMPLES = int(WINDOW_SECONDS * SAMPLE_RATE)
N_MELS = 80
MEL_HOP = 160  # 100 fps
DOWNSAMPLE = 4  # -> 25 output frames/s
FRAMES_PER_SECOND = SAMPLE_RATE // MEL_HOP // DOWNSAMPLE
MAX_LOCAL_SPEAKERS = 3
# Powerset classes: subsets of {0,1,2} with |s| <= 2.
POWERSET: tuple[tuple[int, ...], ...] = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2))
EMBED_DIM = 192
SEGMENTATION_HEADS = 4


def powerset_to_multilabel() -> np.ndarray:
    """[n_classes, n_speakers] 0/1 mapping."""
    m = np.zeros((len(POWERSET), MAX_LOCAL_SPEAKERS), np.float32)
    for i, subset in enumerate(POWERSET):
        for s in subset:
            m[i, s] = 1.0
    return m


def _conv_init(generator: torch.Generator, k: int, cin: int, cout: int) -> Conv1d:
    scale = (1.0 / (cin * k)) ** 0.5
    w = torch.empty((cout, cin, k)).uniform_(-scale, scale, generator=generator)
    return Conv1d(w, torch.zeros(cout))


# -- segmentation ----------------------------------------------------------

class Segmentation(nn.Module):
    """Parameters: ``conv1``, ``conv2``, the transformer ``layers`` (each an
    ``EncoderLayer``'s holders: ``ln1``, ``attn`` q/k/v/o, ``ln2``, ``mlp``),
    the final ``norm`` and the powerset ``head``."""

    def __init__(self, conv1: Conv1d, conv2: Conv1d, layers: list[EncoderLayer], norm: Norm,
                 head: Dense):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2
        self.layers = nn.ModuleList(layers)
        self.norm, self.head = norm, head


def init_segmentation_params(generator: torch.Generator, dim: int = 128, depth: int = 2,
                             device=None) -> Segmentation:
    """Random weights from ``generator`` on ``device`` (CUDA unless named).
    As in the JAX initializer, a layer's q, k, v and o projections start
    equal (JAX draws all four from one key)."""
    def layer():
        qkvo = dense_init(generator, dim, dim, bias=False).weight.data
        attn = Attention(*(Dense(qkvo.clone()) for _ in range(4)))
        return EncoderLayer(norm_init(dim), attn, norm_init(dim),
                            Mlp(dense_init(generator, dim, dim * 4),
                                dense_init(generator, dim * 4, dim)))

    conv1 = _conv_init(generator, 5, N_MELS, dim)
    conv2 = _conv_init(generator, 5, dim, dim)
    head = dense_init(generator, dim, len(POWERSET))
    model = Segmentation(conv1, conv2, [layer() for _ in range(depth)], norm_init(dim), head)
    return model.to(resolve_device(device))


def _self_attention(attn: Attention, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Unmasked multi-head attention; float32 logits divided by sqrt(hd)
    after the product, as JAX computes them."""
    b, t, d = x.shape
    q = dense(attn.q, x).reshape(b, t, heads, -1)
    k = dense(attn.k, x).reshape(b, t, heads, -1)
    v = dense(attn.v, x).reshape(b, t, heads, -1)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1])
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", w, v)
    return dense(attn.o, o.reshape(b, t, d))


def segmentation_forward(model: Segmentation, audio: torch.Tensor) -> torch.Tensor:
    """[B, window_samples] -> [B, T, n_classes] powerset logits (T=25fps)."""
    mel = log_mel(audio, n_fft=400, hop=MEL_HOP, n_mels=N_MELS, center=True)
    h = torch.relu(conv_same(mel.transpose(1, 2), model.conv1, stride=2))
    h = torch.relu(conv_same(h, model.conv2, stride=2)).transpose(1, 2)  # [B, T, D]
    for lp in model.layers:
        h = h + _self_attention(lp.attn, layer_norm(lp.ln1, h), SEGMENTATION_HEADS)
        x2 = layer_norm(lp.ln2, h)
        h = h + dense(lp.mlp.fc2, gelu(dense(lp.mlp.fc1, x2)))
    return dense(model.head, layer_norm(model.norm, h))


@torch.inference_mode()
def segmentation_activations(model: Segmentation, audio: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, T, n_speakers] per-speaker activity probabilities
    (the powerset softmax folded through the multilabel map)."""
    probs = torch.softmax(segmentation_forward(model, audio), dim=-1)
    mapping = torch.from_numpy(powerset_to_multilabel()).to(probs.device)
    return torch.einsum("btc,cs->bts", probs, mapping)


# -- speaker embedding -----------------------------------------------------

class Embedding(nn.Module):
    """Parameters: ``conv1`` (k=5), ``conv2`` (k=3, dilation 2), ``conv3``
    (k=3, dilation 3), the pooling scores ``attn_pool`` and ``proj``."""

    def __init__(self, conv1: Conv1d, conv2: Conv1d, conv3: Conv1d, attn_pool: Dense,
                 proj: Dense):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = conv1, conv2, conv3
        self.attn_pool, self.proj = attn_pool, proj


def init_embedding_params(generator: torch.Generator, dim: int = 256,
                          device=None) -> Embedding:
    """Random weights from ``generator`` on ``device`` (CUDA unless named)."""
    model = Embedding(_conv_init(generator, 5, N_MELS, dim), _conv_init(generator, 3, dim, dim),
                      _conv_init(generator, 3, dim, dim), dense_init(generator, dim, 1),
                      dense_init(generator, dim * 2, EMBED_DIM))
    return model.to(resolve_device(device))


def embedding_forward(model: Embedding, audio: torch.Tensor,
                      frame_weights: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N] (+ optional per-mel-frame weights [B, T_mel]) -> [B, 192],
    L2-normalised.  A weight row of zeros pools nothing: its mean is 0, its
    std the floor sqrt(1e-9), as in JAX."""
    mel = log_mel(audio, n_fft=400, hop=MEL_HOP, n_mels=N_MELS, center=True)
    h = torch.relu(conv_same(mel.transpose(1, 2), model.conv1))
    h = torch.relu(conv_same(h, model.conv2, dilation=2)) + h
    h = torch.relu(conv_same(h, model.conv3, dilation=3)) + h
    h = h.transpose(1, 2)  # [B, T, D]

    # Attentive statistics pooling with optional external frame weights.
    scores = dense(model.attn_pool, h)[..., 0]  # [B, T]
    if frame_weights is not None:
        w = frame_weights[:, :scores.shape[1]]
        scores = torch.where(w > 0, scores, torch.full_like(scores, -1e9))
        att = torch.softmax(scores, dim=-1) * w
        att = att / torch.clamp(att.sum(-1, keepdim=True), min=1e-9)
    else:
        att = torch.softmax(scores, dim=-1)
    mean = torch.einsum("bt,btd->bd", att, h)
    var = torch.einsum("bt,btd->bd", att, h.square()) - mean.square()
    std = torch.sqrt(torch.clamp(var, min=1e-9))
    e = dense(model.proj, torch.cat([mean, std], dim=-1))
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)
