"""Canary (NVIDIA's FastConformer attention-encoder-decoder ASR), in PyTorch.

Canary-1B-Flash (https://huggingface.co/nvidia/canary-1b-flash): a
FastConformer encoder of 32 layers over 8x subsampled log-mel frames (80 ms
a frame) and a Transformer decoder of 4 layers, width 1,024, 8 heads of 128,
feed-forward 4,096, depthwise kernel 9.  The equations are NeMo's
(``ConformerLayer``, ``RelPositionMultiHeadAttention``,
``ConformerConvolution``, ``ConvSubsampling(dw_striding)``,
``TransformerDecoder(pre_ln)``); LN is LayerNorm with bias, FF(x) =
W2 swish(W1 x + b1) + b2:

  features   ops.mel.nemo_log_mel: pre-emphasis, centred 512-point frames of
             a 400-sample Hann window every 160 samples, 128 Slaney mels,
             log(x + 2^-24), each bin normalised over the clip's frames
  subsample  [B,1,T,128] -> conv3x3 s2 (1->256) -> ReLU -> (dw3x3 s2 ->
             pw1x1 -> ReLU) x 2 -> [B,T/8,256*16] -> Linear -> x sqrt(d)
  layer      r = x + FF1(LN1 x)/2;  r += MHSA_rel(LN2 r);  r += Conv(LN3 r);
             r += FF2(LN4 r)/2;  y = LN5 r
  MHSA_rel   per head: softmax(((q+u)k^T + rel_shift((q+v)p^T)) / sqrt(dk)) V,
             p = Wpos PE(T-1 .. -(T-1)); query i, key j reads the position
             term at index (T-1) - i + j, relative position i - j
  Conv       pw1 (d->2d) -> GLU -> padded frames zeroed -> depthwise k 'same'
             -> BatchNorm (running statistics) -> swish -> pw2
  decoder    h = LN_emb(E[tok] + PE_abs(pos));  h += SelfAttn(LN h);
             h += CrossAttn(LN h, memory);  h += W2 relu(W1 LN h);
             logits = LN(h) E^T + b  (the head tied to E)

Departures from NeMo, each exact for a clip alone: the subsampling stem
zeroes the frames past each stage's valid length before the next stage
(NeMo's stem reads a padded batch's padding frames at a clip's end), so a
clip's result does not depend on its batch; padded query rows attend like
valid ones (NeMo zeroes their weights; their outputs are never read).  The
BatchNorm's running statistics are parameters (the benchmark draws and
loads parameters only) and fold into the depthwise convolution at each
call.  Dropout and NeMo's streaming caches are absent.

The relative-position attention runs ``F.scaled_dot_product_attention``
with the position term as its additive bias: BD is one batched product a
layer over the 2T-1 positions, and the shift is a strided view of it (no
gather), written once into the bias with the key mask.  The decoder keeps
Moonshine's dim-major caches (``moonshine.DecoderCache``), its cross K/V
(``moonshine.compute_cross_kv``) and K5 for every int8-KV attention;
``decoding.greedy.greedy_decode`` drives it through the model's
``compute_cross_kv``, ``init_cache`` and ``decoder_apply``, after the
configuration's task prompt.

Spans: a coarse ``encode`` (``batch``, ``samples``, ``model``, ``frames``,
``relpos_calls``); under the profiler its fine ``canary.frontend``,
``canary.subsample``, and a ``canary.ffn`` (two), ``canary.relpos_attention``
and ``canary.conv_module`` a layer.  ``canary.relpos_attention`` holds the
attention core only (the bias terms, BD, the shift and the fused
attention), not the projections.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..core.device import resolve_device
from ..ops.int8_kv import Cursor, attend_kv, layer_kv, write_kv
from ..ops.mel import nemo_frames, nemo_log_mel
from . import moonshine as mm
from .layers import Conv1d, Conv2d, Dense, Norm, _param, _uniform, dense_init

NEG_INF = -1e9  # the key mask's bias: finite, so a row never takes (-inf) - (-inf)


@dataclass(frozen=True)
class CanaryArchConfig:
    """Canary's sizes; the defaults are Canary-1B-Flash's.  The vocabulary,
    the task prompt and the end-of-text id are not in any file of this
    repository and are assumed (``benchmark/configs/canary_1b_flash.json``)."""

    name: str = "canary-1b-flash"
    d_model: int = 1024
    encoder_layers: int = 32
    decoder_layers: int = 4
    n_heads: int = 8
    ff_dim: int = 4096
    conv_kernel_size: int = 9
    subsampling_channels: int = 256
    subsampling_stages: int = 3  # stride 2 each: 8x
    n_mels: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemph: float = 0.97
    vocab_size: int = 5248
    max_positions: int = 1024
    layer_norm_eps: float = 1e-5
    batch_norm_eps: float = 1e-5
    xscaling: bool = True
    # start of transcript, source language, task, target language, punctuation
    prompt_ids: tuple[int, ...] = (4, 16, 8, 16, 5)
    eos_token_id: int = 3

    @property
    def hidden_size(self) -> int:
        return self.d_model

    @property
    def decoder_heads(self) -> int:
        return self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def frames_for_samples(self, num_samples: int) -> int:
        """Encoder frames for ``num_samples`` samples: the features' frames,
        then floor((L - 1) / 2) + 1 at each stride-2 stage."""
        n = nemo_frames(num_samples, self.hop_length)
        for _ in range(self.subsampling_stages):
            n = (n - 1) // 2 + 1
        return n

    def min_samples(self) -> int:
        return 1


CANARY_1B_FLASH = CanaryArchConfig()


# =========================================================================
# Parameter holders and initialization
# =========================================================================

class FeedForward(nn.Module):
    def __init__(self, fc1: Dense, fc2: Dense):
        super().__init__()
        self.fc1, self.fc2 = fc1, fc2


class RelPosAttention(nn.Module):
    """q, k, v, o (with bias), the position projection (no bias) and the
    two per-head biases u (``pos_bias_u``) and v (``pos_bias_v``), [H, dk]."""

    def __init__(self, q: Dense, k: Dense, v: Dense, o: Dense, pos: Dense,
                 pos_bias_u: torch.Tensor, pos_bias_v: torch.Tensor):
        super().__init__()
        self.q, self.k, self.v, self.o, self.pos = q, k, v, o, pos
        self.pos_bias_u = _param(pos_bias_u)
        self.pos_bias_v = _param(pos_bias_v)

    def forward(self, cfg: CanaryArchConfig, x: torch.Tensor, pe: torch.Tensor, key_mask,
                parent=None) -> torch.Tensor:
        """x [B, T, D] (the layer's normed input), ``pe`` [2T-1, D] the
        relative encodings -> [B, T, D]."""
        b, t, d = x.shape
        h, dk = cfg.n_heads, cfg.head_dim
        q = _linear(self.q, x).view(b, t, h, dk)
        k = _linear(self.k, x).view(b, t, h, dk)
        v = _linear(self.v, x).view(b, t, h, dk)
        pos = (F.linear(pe, self.pos.weight.to(x.dtype)) * dk ** -0.5).view(2 * t - 1, h, dk)
        sp = profiling.child("canary.relpos_attention", parent)
        o = relpos_attention_core(q, k, v, pos, self.pos_bias_u, self.pos_bias_v, key_mask)
        profiling.end(sp)
        return _linear(self.o, o.reshape(b, t, d))


class BatchNorm(nn.Module):
    """Inference BatchNorm: scale, shift and the running statistics, all
    parameters."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = _param(torch.ones(dim))
        self.bias = _param(torch.zeros(dim))
        self.running_mean = _param(torch.zeros(dim))
        self.running_var = _param(torch.ones(dim))


class ConvModule(nn.Module):
    def __init__(self, pw1: Dense, dw: Conv1d, bn: BatchNorm, pw2: Dense):
        super().__init__()
        self.pw1, self.dw, self.bn, self.pw2 = pw1, dw, bn, pw2


class ConformerLayer(nn.Module):
    def __init__(self, d: int, ff1: FeedForward, attn: RelPosAttention, conv: ConvModule,
                 ff2: FeedForward):
        super().__init__()
        self.ff1_norm, self.ff1 = _norm(d), ff1
        self.attn_norm, self.attn = _norm(d), attn
        self.conv_norm, self.conv = _norm(d), conv
        self.ff2_norm, self.ff2 = _norm(d), ff2
        self.out_norm = _norm(d)


class Subsampling(nn.Module):
    """conv0 (3x3, 1 -> C), then a depthwise 3x3 and a pointwise 1x1 a
    further stage, and the output projection of C * n_mels / 8 features."""

    def __init__(self, conv0: Conv2d, stages: list[tuple[Conv2d, Conv2d]], out: Dense):
        super().__init__()
        self.conv0 = conv0
        self.dw = nn.ModuleList([dw for dw, _ in stages])
        self.pw = nn.ModuleList([pw for _, pw in stages])
        self.out = out


class CanaryEncoder(nn.Module):
    def __init__(self, subsample: Subsampling, layers: list[ConformerLayer]):
        super().__init__()
        self.subsample = subsample
        self.layers = nn.ModuleList(layers)


class _Bias(nn.Module):
    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.bias = _param(bias)


class CanaryDecoder(nn.Module):
    """``embed`` [V, D] (also the output head, with ``head.bias``), the
    embedding's LayerNorm, pre-LN layers (``moonshine.DecoderLayer``'s
    fields, every projection with bias, ``mlp`` a ReLU feed-forward) and
    the final LayerNorm."""

    def __init__(self, embed: torch.Tensor, layers: list[mm.DecoderLayer], d: int, vocab: int):
        super().__init__()
        self.embed = _param(embed)
        self.embed_norm = _norm(d)
        self.layers = nn.ModuleList(layers)
        self.norm = _norm(d)
        self.head = _Bias(torch.zeros(vocab))
        self.tp = None  # moonshine.compute_cross_kv reads it: never split


class Canary(nn.Module):
    """The whole model: ``encoder`` and ``decoder``.  Its methods are what
    ``greedy_decode`` and the offline backend call of any model."""

    def __init__(self, encoder: CanaryEncoder, decoder: CanaryDecoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def encode(self, cfg: CanaryArchConfig, audio, lengths=None, *, span_parent=None):
        return encode(self, cfg, audio, lengths, span_parent=span_parent)

    def decoder_prompt(self, cfg: CanaryArchConfig) -> tuple[int, ...]:
        return cfg.prompt_ids

    def compute_cross_kv(self, cfg: CanaryArchConfig, memory: torch.Tensor):
        return mm.compute_cross_kv(self.decoder, cfg, memory)

    def init_cache(self, cfg: CanaryArchConfig, *args, **kw) -> mm.DecoderCache:
        return mm.init_cache(cfg, *args, **kw)

    def decoder_apply(self, cfg: CanaryArchConfig, tokens, cache):
        return decoder_apply(self.decoder, cfg, tokens, cache)


def _norm(d: int) -> Norm:
    return Norm(torch.ones(d), torch.zeros(d))


def _conv_init(g: torch.Generator, shape: tuple) -> torch.Tensor:
    return _uniform(g, shape, (1.0 / math.prod(shape[1:])) ** 0.5)


def conformer_layers(cfg: CanaryArchConfig, g: torch.Generator, n: int) -> list[ConformerLayer]:
    """``n`` FastConformer layers of ``cfg``'s widths drawn from ``g``:
    dense and conv weights and the position biases uniform in
    +-1/sqrt(fan_in), biases 0, norms 1 and 0, the BatchNorm statistics 0
    and 1."""
    d, h, dk = cfg.d_model, cfg.n_heads, cfg.head_dim

    def ffn():
        return FeedForward(dense_init(g, d, cfg.ff_dim), dense_init(g, cfg.ff_dim, d))

    return [
        ConformerLayer(
            d, ffn(),
            RelPosAttention(dense_init(g, d, d), dense_init(g, d, d), dense_init(g, d, d),
                            dense_init(g, d, d), dense_init(g, d, d, bias=False),
                            _uniform(g, (h, dk), dk ** -0.5), _uniform(g, (h, dk), dk ** -0.5)),
            ConvModule(dense_init(g, d, 2 * d),
                       Conv1d(_conv_init(g, (d, 1, cfg.conv_kernel_size)), torch.zeros(d)),
                       BatchNorm(d), dense_init(g, d, d)),
            ffn())
        for _ in range(n)
    ]


def encoder_init(cfg: CanaryArchConfig, g: torch.Generator) -> CanaryEncoder:
    """The stem and the FastConformer layers drawn from ``g``."""
    ch = cfg.subsampling_channels
    stages = [(Conv2d(_conv_init(g, (ch, 1, 3, 3)), torch.zeros(ch)),
               Conv2d(_conv_init(g, (ch, ch, 1, 1)), torch.zeros(ch)))
              for _ in range(cfg.subsampling_stages - 1)]
    feat = ch * (cfg.n_mels >> cfg.subsampling_stages)
    subsample = Subsampling(Conv2d(_conv_init(g, (ch, 1, 3, 3)), torch.zeros(ch)), stages,
                            dense_init(g, feat, cfg.d_model))
    return CanaryEncoder(subsample, conformer_layers(cfg, g, cfg.encoder_layers))


def init_params(cfg: CanaryArchConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Canary:
    """Random weights from ``generator`` (on the CPU), then moved to
    ``device`` (CUDA unless named): dense and conv weights and the
    position biases uniform in +-1/sqrt(fan_in), biases 0, norms 1 and 0,
    the BatchNorm statistics 0 and 1, the embedding N(0, 0.02^2)."""
    g = generator
    d = cfg.d_model
    encoder = encoder_init(cfg, g)

    def attn():
        return mm.Attention(*(dense_init(g, d, d) for _ in range(4)))

    dec_layers = [mm.DecoderLayer(_norm(d), attn(), _norm(d), attn(), _norm(d),
                                  mm.Mlp(dense_init(g, d, cfg.ff_dim), dense_init(g, cfg.ff_dim, d)))
                  for _ in range(cfg.decoder_layers)]
    embed = torch.randn((cfg.vocab_size, d), generator=g) * 0.02
    model = Canary(encoder, CanaryDecoder(embed, dec_layers, d, cfg.vocab_size))
    return model.to(resolve_device(device))


# =========================================================================
# Encoder
# =========================================================================

def _linear(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """A dense layer in x's dtype, its bias in the product's epilogue."""
    return F.linear(x, p.weight.to(x.dtype), None if p.bias is None else p.bias.to(x.dtype))


def _ln(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p.weight.to(x.dtype), p.bias.to(x.dtype), eps)


def fold_batch_norm(conv: Conv1d, bn: BatchNorm, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The depthwise convolution followed by inference BatchNorm as one
    convolution: (weight, bias) in float32, w * g / sqrt(var + eps) and
    (b - mean) * g / sqrt(var + eps) + beta."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    w = conv.weight.float() * scale[:, None, None]
    b = (conv.bias.float() - bn.running_mean.float()) * scale + bn.bias.float()
    return w, b


def subsample(p: Subsampling, cfg: CanaryArchConfig, feats: torch.Tensor,
              frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """features [B, T, n_mels] and their valid frames [B] -> (x [B, T/8, D]
    scaled by sqrt(D) where ``xscaling``, valid frames [B]).  Each stage's
    frames past the valid ones are zeroed before the next stage reads
    them."""
    x = feats[:, None]  # [B, 1, T, M]
    lengths = frames
    last = cfg.subsampling_stages - 1
    for i in range(cfg.subsampling_stages):
        if i == 0:
            x = F.conv2d(x, p.conv0.weight, p.conv0.bias, stride=2, padding=1)
        else:
            dw, pw = p.dw[i - 1], p.pw[i - 1]
            x = F.conv2d(x, dw.weight, dw.bias, stride=2, padding=1, groups=x.shape[1])
            x = F.conv2d(x, pw.weight, pw.bias)
        x = x.relu_()
        lengths = (lengths - 1) // 2 + 1
        if i < last:
            keep = torch.arange(x.shape[2], device=x.device)[None, :] < lengths[:, None]
            x = x.masked_fill_(~keep[:, None, :, None], 0.0)
    b, c, t, f = x.shape
    x = _linear(p.out, x.transpose(1, 2).reshape(b, t, c * f))
    if cfg.xscaling:
        x = x * math.sqrt(cfg.d_model)
    return x, lengths


@functools.lru_cache(maxsize=32)
def relative_positions(t: int, d: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[2t - 1, d]: NeMo's ``RelPositionalEncoding`` of the relative
    positions t-1 down to -(t-1) (sin in even channels, cos in odd), made
    once a length and device."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.stack([torch.sin(pos * div), torch.cos(pos * div)], dim=-1).flatten(1)
    return pe.to(dtype)


def rel_shift_view(bd: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """The shifted position term [B, H, T, T] as a view of ``bd`` [H, B*T,
    2T-1] (contiguous): element (b, h, i, j) is bd[h, b*T + i, (T-1) - i + j]."""
    w = 2 * t - 1
    h = bd.shape[0]
    return bd.as_strided((b, h, t, t), (t * w, b * t * w, w - 1, 1), bd.storage_offset() + t - 1)


def relpos_attention_core(q, k, v, pos, bias_u, bias_v, key_mask):
    """The attention of ``RelPositionMultiHeadAttention`` from its
    projections: q, k, v [B, T, H, dk]; ``pos`` [2T-1, H, dk], the
    projected position encodings scaled by dk^-0.5; ``bias_u``, ``bias_v``
    [H, dk]; ``key_mask`` [B, T] bool or None.  Returns [B, T, H, dk]."""
    b, t, h, dk = q.shape
    qu = (q + bias_u.to(q.dtype)).transpose(1, 2)
    qv = q + bias_v.to(q.dtype)
    # BD of every head in one product: [H, B*T, dk] (a strided view of qv) x [H, dk, 2T-1].
    bd = torch.matmul(qv.view(b * t, h, dk).transpose(0, 1), pos.permute(1, 2, 0))
    shifted = rel_shift_view(bd, b, t)
    # The bias, its rows padded to 16 columns so the fused attention reads it in place.
    bias = torch.empty((b, h, t, -(-t // 16) * 16), dtype=q.dtype, device=q.device)[..., :t]
    if key_mask is None:
        bias.copy_(shifted)
    else:
        torch.where(key_mask[:, None, None, :], shifted, torch.tensor(NEG_INF, dtype=q.dtype),
                    out=bias)
    o = F.scaled_dot_product_attention(qu, k.transpose(1, 2), v.transpose(1, 2), attn_mask=bias,
                                       scale=dk ** -0.5)
    return o.transpose(1, 2)


def _conv_module(p: ConvModule, cfg: CanaryArchConfig, x: torch.Tensor, keep) -> torch.Tensor:
    y = F.glu(_linear(p.pw1, x), dim=-1)
    if keep is not None:
        y = y.masked_fill(~keep[:, :, None], 0.0)
    w, bias = fold_batch_norm(p.dw, p.bn, cfg.batch_norm_eps)
    y = F.conv1d(y.transpose(1, 2), w.to(y.dtype), bias.to(y.dtype),
                 padding=cfg.conv_kernel_size // 2, groups=y.shape[-1])
    return _linear(p.pw2, F.silu(y).transpose(1, 2))


def _ffn(p: FeedForward, x: torch.Tensor, parent) -> torch.Tensor:
    sp = profiling.child("canary.ffn", parent)
    y = _linear(p.fc2, F.silu(_linear(p.fc1, x)))
    profiling.end(sp)
    return y


def conformer_layer(lp: ConformerLayer, cfg: CanaryArchConfig, x: torch.Tensor, pe, key_mask,
                    parent=None) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    r = torch.add(x, _ffn(lp.ff1, _ln(lp.ff1_norm, x, eps), parent), alpha=0.5)
    r = r + lp.attn(cfg, _ln(lp.attn_norm, r, eps), pe, key_mask, parent)
    sp = profiling.child("canary.conv_module", parent)
    r = r + _conv_module(lp.conv, cfg, _ln(lp.conv_norm, r, eps), key_mask)
    profiling.end(sp)
    r = torch.add(r, _ffn(lp.ff2, _ln(lp.ff2_norm, r, eps), parent), alpha=0.5)
    return _ln(lp.out_norm, r, eps)


def encode(
    model: Canary,
    cfg: CanaryArchConfig,
    audio: torch.Tensor,  # [B, N] float32
    lengths: torch.Tensor | None = None,  # [B] valid samples
    *,
    span_parent: profiling.Span | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [B, N] -> (memory [B, T, D] in the model's dtype, frame mask
    [B, T]).  The features are float32; everything after them computes in
    the model's dtype.  Records a coarse ``encode`` span (``batch``,
    ``samples``, ``model``, ``frames``: T, ``relpos_calls``), enqueued on
    CUDA, and its fine spans under the profiler (module docstring)."""
    b, n = audio.shape
    sp = profiling.begin("encode", span_parent, batch=b, samples=n, model=cfg.name)
    x, mask = encoder_forward(model.encoder, cfg, audio, lengths, sp)
    sp.enqueued = audio.device.type == "cuda"
    profiling.end(sp, frames=x.shape[1], relpos_calls=len(model.encoder.layers))
    return x, mask


def encoder_forward(enc: CanaryEncoder, cfg: CanaryArchConfig, audio: torch.Tensor,
                    lengths: torch.Tensor | None, sp: profiling.Span | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The features, the stem and the FastConformer layers of ``enc``:
    audio [B, N] -> (x [B, T, D], frame mask [B, T]), the fine spans under
    ``sp``; ``encode`` without its coarse span."""
    dev = audio.device
    st = profiling.child("canary.frontend", sp)
    feats, frames = nemo_log_mel(audio, lengths, cfg.n_fft, cfg.win_length, cfg.hop_length,
                                 cfg.n_mels, cfg.sample_rate, cfg.preemph)
    profiling.end(st)
    st = profiling.child("canary.subsample", sp)
    x, valid = subsample(enc.subsample, cfg, feats.to(enc.subsample.out.weight.dtype), frames)
    profiling.end(st)
    t = x.shape[1]
    mask = torch.arange(t, device=dev)[None, :] < valid[:, None]
    return conformer_stack(enc.layers, cfg, x, mask if lengths is not None else None, sp), mask


def conformer_stack(layers, cfg: CanaryArchConfig, x: torch.Tensor, key_mask, sp) -> torch.Tensor:
    """x [B, T, D] through ``layers`` (``ConformerLayer``s), the frames
    past ``key_mask`` [B, T] (None: every frame) hidden as keys."""
    pe = relative_positions(x.shape[1], cfg.d_model, x.device, x.dtype)
    for lp in layers:
        x = conformer_layer(lp, cfg, x, pe, key_mask, sp)
    return x


# =========================================================================
# Decoder with KV cache
# =========================================================================

@functools.lru_cache(maxsize=16)
def absolute_positions(n: int, d: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[n, d]: NeMo's ``FixedPositionalEncoding`` (sin in even channels,
    cos in odd, divided by sqrt(d)), made once a device and dtype."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.stack([torch.sin(pos * div), torch.cos(pos * div)], dim=-1).flatten(1)
    return (pe / math.sqrt(d)).to(dtype)


def _self_attention(cfg: CanaryArchConfig, h, lp: mm.DecoderLayer, layer: int,
                    cache: mm.DecoderCache, mask):
    """Self-attention over s new tokens; writes their keys and values into
    the layer's cache at [cur_len, cur_len + s).  Returns (h, the layer's
    self caches as written)."""
    b, s, _ = h.shape
    a, heads, hd = lp.self_attn, cfg.n_heads, cfg.head_dim
    x = _ln(lp.ln1, h, cfg.layer_norm_eps)
    q = _linear(a.q, x).view(b, s, heads, hd)
    k = _linear(a.k, x).view(b, s, heads, hd).permute(0, 2, 3, 1)  # [B, H, hd, s]
    v = _linear(a.v, x).view(b, s, heads, hd).permute(0, 2, 3, 1)
    kv = write_kv(layer_kv(cache, "self", layer), k, v, Cursor(cache.cur_len))
    o = attend_kv(q, kv, mask)
    return h + _linear(a.o, o.reshape(b, s, -1)), kv


def _cross_attention_ffn(cfg: CanaryArchConfig, h, lp: mm.DecoderLayer, layer: int,
                         cache: mm.DecoderCache, mask) -> torch.Tensor:
    b, s, _ = h.shape
    a, eps = lp.cross_attn, cfg.layer_norm_eps
    q = _linear(a.q, _ln(lp.ln2, h, eps)).view(b, s, cfg.n_heads, cfg.head_dim)
    o = attend_kv(q, layer_kv(cache, "cross", layer), mask)
    h = h + _linear(a.o, o.reshape(b, s, -1))
    x = _ln(lp.ln3, h, eps)
    return h + _linear(lp.mlp.fc2, F.relu(_linear(lp.mlp.fc1, x)))


def decoder_apply(
    p: CanaryDecoder,
    cfg: CanaryArchConfig,
    tokens: torch.Tensor,  # [B, s] new token ids
    cache: mm.DecoderCache,
) -> tuple[torch.Tensor, mm.DecoderCache, None]:
    """Run the decoder over ``s`` new tokens at positions cur_len ..
    cur_len + s - 1, writing their keys and values into the cache in place
    (into new self caches where autograd records the new keys).  Returns
    (logits [B, s, V] float32, the cache with ``cur_len`` advanced by s,
    None), as ``moonshine.decoder_apply`` does."""
    b, s = tokens.shape
    max_len = cache.k_self.shape[4]
    if cache.cur_len + s > min(max_len, cfg.max_positions):
        raise ValueError(f"cache holds {min(max_len, cfg.max_positions)} positions; cannot "
                         f"write {s} tokens at position {cache.cur_len}")
    dev = tokens.device
    pe = absolute_positions(cfg.max_positions, cfg.d_model, dev, p.embed.dtype)
    h = _ln(p.embed_norm, p.embed[tokens] + pe[cache.cur_len:cache.cur_len + s],
            cfg.layer_norm_eps)
    self_mask = mm._self_mask(cache, s, None, dev)
    cross_mask = cache.memory_mask[:, None, None, :]
    written = []
    for layer, lp in enumerate(p.layers):
        h, kv = _self_attention(cfg, h, lp, layer, cache, self_mask)
        written.append(kv)
        h = _cross_attention_ffn(cfg, h, lp, layer, cache, cross_mask)
    cache = mm._with_written_self(cache, written)
    h = _ln(p.norm, h, cfg.layer_norm_eps)
    logits = h.float() @ p.embed.float().t() + p.head.bias.float()
    return logits, cache._replace(cur_len=cache.cur_len + s), None
