"""Moonshine encoder/decoder (non-streaming family), in PyTorch.

Counterpart of the JAX package's ``models/moonshine.py``: a strided-conv
raw-audio frontend, a rotary transformer encoder (pre-LN, GELU MLP) and a
KV-cached decoder with rotary causal self-attention, rope-free
cross-attention, a SwiGLU MLP and a tied output projection.

Where the JAX package stacks layer parameters on a leading axis and walks
them with ``lax.scan``, the port keeps one ``nn.Module`` per layer in an
``nn.ModuleList`` and walks it with a Python loop.  Public layouts stay the
JAX ones, so the two packages can be compared tensor for tensor: audio
``[B, N]``, features and memory ``[B, T, D]``, frame masks ``[B, T]`` bool,
and dim-major KV caches ``[L, B, H, hd, T]``.

Unlike the JAX package, ``decoder_apply`` writes the new self-attention
keys and values into the cache tensors in place (PyTorch tensors are
mutable; a copy of the whole cache per token would double the decode's
memory traffic), and ``DecoderCache.cur_len`` is a host integer.

Tensor parallelism (``parallel.sharding.shard_params``) keeps each rank's
blocks of the weights and sets ``tp`` on the attention, MLP and decoder
holders; the layer functions then compute the Megatron split: q, k, v and
fc1 on this rank's output features (its heads, so each rank's KV caches
hold only its heads), o and fc2 on its input features with an all-reduce
over ``model`` before the bias, the embedding's lookup on its vocabulary
block with an all-reduce, and the tied logits on its block with an
all-gather (``parallel/tensor_parallel.py``).  Head counts are read from
the weights, so the same code runs a whole model and a rank's share.

Training: the encoder's pair-swapped rotary projections are copies of q
and k (``prepare_rotary_params``).  Where q's weight requires grad they are
derived from q and k in the forward, as the JAX package does for a tree
without them, so the gradient reaches q and k; ``prepare_rotary_params(...,
refresh=True)`` brings the copies up to date after an update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..core.config import MoonshineArchConfig
from ..core.device import resolve_device
from ..ops.encoder_attention import (
    K1_LAUNCHES,
    encoder_attention_packed,
    encoder_attention_packed_sharded,
)
from ..ops.int8_kv import attention_dm_q8, attention_dm_q8_with_weights, quantize_kv
from ..ops.rotary import (
    apply_rotary,
    apply_rotary_fullwidth,
    pair_swap_perm,
    rotary_tables,
    swap_dense_params,
)
from ..parallel.tensor_parallel import copy_to_model, gather_from_model, reduce_from_model
from ..quant import weight_of
from .layers import (
    ACTIVATIONS,
    Conv1d,
    Dense,
    Norm,
    conv1d,
    conv1d_init,
    dense,
    dense_init,
    group_norm_all,
    layer_norm,
    norm_init,
)

NEG_INF = -1e9  # large-negative mask value; avoids NaN from (-inf) - (-inf)
ATTN_IMPLS = ("auto", "xla", "pallas_shmap")


# =========================================================================
# Parameter holders and initialization
# =========================================================================

class Attention(nn.Module):
    """q/k/v/o projections; the encoder's also carry the pair-swapped q/k
    projections, which ``prepare_rotary_params`` adds (``init_params`` and
    ``weights.params_from_jax_numpy`` call it)."""

    def __init__(self, q: Dense, k: Dense, v: Dense, o: Dense):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        self.q_swapped: Dense | None = None
        self.k_swapped: Dense | None = None
        self.tp = None  # parallel.tensor_parallel.ModelParallel once sharded


class Mlp(nn.Module):
    def __init__(self, fc1: Dense, fc2: Dense):
        super().__init__()
        self.fc1, self.fc2 = fc1, fc2
        self.tp = None


class EncoderLayer(nn.Module):
    def __init__(self, ln1: Norm, attn: Attention, ln2: Norm, mlp: Mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecoderLayer(nn.Module):
    def __init__(self, ln1: Norm, self_attn: Attention, ln2: Norm,
                 cross_attn: Attention, ln3: Norm, mlp: Mlp):
        super().__init__()
        self.ln1, self.self_attn, self.ln2 = ln1, self_attn, ln2
        self.cross_attn, self.ln3, self.mlp = cross_attn, ln3, mlp


class Frontend(nn.Module):
    def __init__(self, conv1: Conv1d, gn: Norm, conv2: Conv1d, conv3: Conv1d):
        super().__init__()
        self.conv1, self.gn, self.conv2, self.conv3 = conv1, gn, conv2, conv3


class Encoder(nn.Module):
    def __init__(self, layers: list[EncoderLayer], norm: Norm):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class Decoder(nn.Module):
    def __init__(self, embed: torch.Tensor, layers: list[DecoderLayer], norm: Norm):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)  # [V, D], tied output
        self.layers = nn.ModuleList(layers)
        self.norm = norm
        self.tp = None


class Moonshine(nn.Module):
    """The whole model's parameters: ``frontend``, ``encoder``, ``decoder``.
    Its methods are what ``greedy_decode`` and the offline backend call of
    any model (``models.canary.Canary`` has the same); each calls this
    module's function of its name."""

    def __init__(self, frontend: Frontend, encoder: Encoder, decoder: Decoder):
        super().__init__()
        self.frontend, self.encoder, self.decoder = frontend, encoder, decoder

    def encode(self, cfg: MoonshineArchConfig, audio, lengths=None, *, span_parent=None):
        return encode(self, cfg, audio, lengths, attn_impl="auto", span_parent=span_parent)

    def decoder_prompt(self, cfg: MoonshineArchConfig) -> tuple[int, ...]:
        return (cfg.decoder_start_token_id,)

    def compute_cross_kv(self, cfg: MoonshineArchConfig, memory: torch.Tensor):
        return compute_cross_kv(self.decoder, cfg, memory)

    def init_cache(self, cfg: MoonshineArchConfig, *args, **kw) -> DecoderCache:
        return init_cache(cfg, *args, **kw)

    def decoder_apply(self, cfg: MoonshineArchConfig, tokens, cache):
        return decoder_apply(self.decoder, cfg, tokens, cache)


def _attn_init(g: torch.Generator, dim: int, heads: int, head_dim: int, bias: bool) -> Attention:
    return Attention(
        dense_init(g, dim, heads * head_dim, bias=bias),
        dense_init(g, dim, heads * head_dim, bias=bias),
        dense_init(g, dim, heads * head_dim, bias=bias),
        dense_init(g, heads * head_dim, dim, bias=False),
    )


def init_params(cfg: MoonshineArchConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> Moonshine:
    """Random weights drawn from ``generator`` (on the CPU), then moved to
    ``device`` (CUDA unless named).  The draws differ from the JAX
    package's; tests carry JAX weights across with
    ``weights.params_from_jax_numpy``."""
    g = generator
    d = cfg.hidden_size
    k1, k2, k3 = cfg.conv_kernels
    frontend = Frontend(
        conv1d_init(g, k1, 1, d, bias=False),
        norm_init(d, bias=True),
        conv1d_init(g, k2, d, 2 * d),
        conv1d_init(g, k3, 2 * d, d),
    )
    enc_layers = [
        EncoderLayer(
            norm_init(d),
            _attn_init(g, d, cfg.encoder_heads, cfg.head_dim, cfg.attention_bias),
            norm_init(d),
            Mlp(dense_init(g, d, cfg.intermediate_size), dense_init(g, cfg.intermediate_size, d)),
        )
        for _ in range(cfg.encoder_layers)
    ]
    dec_layers = [
        DecoderLayer(
            norm_init(d),
            _attn_init(g, d, cfg.decoder_heads, cfg.head_dim, cfg.attention_bias),
            norm_init(d),
            _attn_init(g, d, cfg.decoder_heads, cfg.head_dim, cfg.attention_bias),
            norm_init(d),
            Mlp(dense_init(g, d, cfg.intermediate_size * 2),
                dense_init(g, cfg.intermediate_size, d)),
        )
        for _ in range(cfg.decoder_layers)
    ]
    embed = torch.randn((cfg.vocab_size, d), generator=g) * 0.02
    model = Moonshine(frontend, Encoder(enc_layers, norm_init(d)),
                      Decoder(embed, dec_layers, norm_init(d)))
    return prepare_rotary_params(model, cfg).to(resolve_device(device))


def _out_features(p: Dense) -> int:
    return (p.w_q if p.quantized else p.weight).shape[0]


def _heads(p: Dense, head_dim: int) -> int:
    """The heads a q/k/v projection holds: all of them, or a rank's share."""
    n = _out_features(p)
    if n % head_dim:
        raise ValueError(f"a projection of {n} features does not hold whole heads of "
                         f"{head_dim}: the model axis must divide the heads")
    return n // head_dim


def _swap_perms(cfg: MoonshineArchConfig, a: Attention):
    half = cfg.rotary_dim // 2
    return (pair_swap_perm(cfg.head_dim, half, _heads(a.q, cfg.head_dim)),
            pair_swap_perm(cfg.head_dim, half, _heads(a.k, cfg.head_dim)))


def prepare_rotary_params(model: Moonshine, cfg: MoonshineArchConfig,
                          refresh: bool = False) -> Moonshine:
    """Give every encoder attention its pair-swapped q/k projections, once
    at load time (exact: a permutation of output channels), as the encoder
    requires.  Idempotent; updates ``model`` in place and returns it.  With
    ``refresh`` the existing copies are rewritten from q and k (after a
    training step has changed them)."""
    for layer in model.encoder.layers:
        a = layer.attn
        q_perm, k_perm = _swap_perms(cfg, a)
        for name, src, perm in (("q_swapped", a.q, q_perm), ("k_swapped", a.k, k_perm)):
            old = getattr(a, name)
            if old is None:
                setattr(a, name, swap_dense_params(src, perm))
            elif refresh:
                new = swap_dense_params(src, perm)
                with torch.no_grad():
                    for t_old, t_new in zip(old.parameters(), new.parameters()):
                        t_old.copy_(t_new)
    return model


# =========================================================================
# Attention core
# =========================================================================

def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, heads, -1)  # [B, S, H*hd] -> [B, S, H, hd]


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None, with_weights: bool = False):
    """Split-head attention of the JAX package's XLA path: float32 logits
    and softmax, weights rounded to q's dtype, AV product in q's dtype.

    q [B, S, H, hd], k/v [B, T, H, hd], mask bool broadcastable to
    [B, H, S, T] (True = attend).  Products of bf16 values are exact in
    float32, so a float32 product is "bf16 operands, float32 accumulation".
    With ``with_weights`` it also returns the float32 softmax weights
    [B, H, S, T] (the JAX package's ``_attention_with_weights``).
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", weights.to(q.dtype), v)
    return (out, weights) if with_weights else out


def _attention_dm(q, k, v, mask, with_weights: bool = False):
    """Attention over dim-major K/V [B, H, hd, T] (see DecoderCache); with
    ``with_weights`` also returns the float32 softmax weights [B, H, s, T]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bhdt->bhst", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bhdt->bshd", weights.to(q.dtype), v)
    return (out, weights) if with_weights else out


# =========================================================================
# Frontend + encoder
# =========================================================================

def frontend_apply(
    p: Frontend,
    cfg: MoonshineArchConfig,
    audio: torch.Tensor,  # [B, N] float32 in [-1, 1]
    lengths: torch.Tensor | None = None,  # [B] valid sample counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """Strided-conv frontend: raw waveform -> [B, T, D] features + [B, T] mask."""
    if cfg.frames_for_samples(audio.shape[-1]) < 1:
        raise ValueError(
            f"Audio too short: {audio.shape[-1]} samples yields no encoder "
            f"frames (minimum {cfg.min_samples()} samples at 16 kHz)"
        )
    s1, s2, s3 = cfg.conv_strides
    k1 = cfg.conv_kernels[0]
    n_frames1 = (audio.shape[-1] - k1) // s1 + 1
    w1 = p.conv1.weight  # [D, 1, k1]
    if k1 <= 2 * s1:
        # Space-to-channel, as in the JAX package: stride-s1 sample blocks
        # become s1 input channels, so stage 1 is a k=2 conv over the block
        # axis, with the kernel zero-padded from k1 to 2*s1 taps.
        pad = (-audio.shape[-1]) % s1 + s1  # to a block multiple, +1 block
        a = torch.nn.functional.pad(audio.to(w1.dtype), (0, pad))
        blocks = a.reshape(a.shape[0], -1, s1)  # [B, nb, s1]
        w1_full = torch.nn.functional.pad(w1[:, 0, :], (0, 2 * s1 - k1))  # [D, 2*s1]
        w_blocks = w1_full.reshape(-1, 2, s1).transpose(1, 2)  # [D, s1, 2]
        y = torch.nn.functional.conv1d(blocks.transpose(1, 2), w_blocks)
        h = torch.tanh(y.transpose(1, 2)[:, :n_frames1]).to(w1.dtype)
    else:  # generic form for other conv geometries
        windows = audio.to(w1.dtype).unfold(-1, k1, s1)  # [B, T1, k1]
        h = torch.tanh(windows.float() @ w1[:, 0, :].float().t()).to(w1.dtype)
    if p.conv1.bias is not None:
        h = h + p.conv1.bias.to(h.dtype)
    if lengths is not None:
        l1 = torch.clamp((lengths - k1) // s1 + 1, min=0)
        m1 = torch.arange(h.shape[1], device=h.device)[None, :] < l1[:, None]
    else:
        m1 = None
    h = group_norm_all(p.gn, h, m1)
    h = ACTIVATIONS["gelu"](conv1d(p.conv2, h, s2))
    h = ACTIVATIONS["gelu"](conv1d(p.conv3, h, s3))
    t = h.shape[1]
    if lengths is not None:
        valid = lengths
        for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
            valid = (valid - k) // s + 1
        valid = torch.clamp(valid, min=0)
        mask = torch.arange(t, device=h.device)[None, :] < valid[:, None]
    else:
        mask = torch.ones((h.shape[0], t), dtype=torch.bool, device=h.device)
    return h, mask


def frames_for_samples(cfg: MoonshineArchConfig, n: int) -> int:
    """Encoder frame count for ``n`` input samples (host int math)."""
    for k, s in zip(cfg.conv_kernels, cfg.conv_strides):
        n = (n - k) // s + 1
    return max(n, 0)


def lane_aligned_samples(cfg: MoonshineArchConfig, n: int, align: int = 128) -> int:
    """Smallest padded sample count >= ``n`` whose encoder frame count is a
    multiple of ``align`` (the JAX package's bucketing helper)."""
    f = frames_for_samples(cfg, n)
    target = max(-(-f // align) * align, align)
    hop = cfg.samples_per_frame
    while frames_for_samples(cfg, n) < target:
        n += hop * max(target - frames_for_samples(cfg, n), 1)
    return n


def _dense_row(p: Dense, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel dense layer: this rank's input features, the partial
    products summed over ``model``, then the (replicated) bias; ``dense``
    itself when the model is not split."""
    if tp is None:
        return dense(p, x)
    y = reduce_from_model(F.linear(x, p.weight.to(x.dtype)), tp)
    return y if p.bias is None else y + p.bias.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _perm_tensor(perm: tuple, device: torch.device) -> torch.Tensor:
    """A permutation on ``device``, copied there once."""
    return torch.tensor(perm, dtype=torch.long, device=device)


def _encoder_qkv(cfg: MoonshineArchConfig, h: torch.Tensor, lp: EncoderLayer,
                 cos, sin) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An encoder layer's attention inputs from its input ``h``: q and k
    with rotary, and v, each [B, T, heads * hd] (heads not split; a rank's
    heads when the model is split)."""
    a = lp.attn
    x = copy_to_model(layer_norm(lp.ln1, h, cfg.layer_norm_eps), a.tp)
    hd = cfg.head_dim
    qf, kf = dense(a.q, x), dense(a.k, x)
    if a.q.weight is not None and a.q.weight.requires_grad and torch.is_grad_enabled():
        # Training: the swapped operand as a permutation of q's and k's own
        # outputs, so the gradient reaches q and k (the stored copies are
        # leaves of their own).
        q_perm, k_perm = (_perm_tensor(tuple(perm), x.device) for perm in _swap_perms(cfg, a))
        qsf, ksf = qf.index_select(-1, q_perm), kf.index_select(-1, k_perm)
    else:
        # The pair-swapped projections (prepare_rotary_params) give the
        # rotary's swapped operand from the same GEMM shape, with no gather.
        qsf, ksf = dense(a.q_swapped, x), dense(a.k_swapped, x)
    q_full = apply_rotary_fullwidth(qf, qsf, cos, sin, hd, _heads(a.q, hd))
    k_full = apply_rotary_fullwidth(kf, ksf, cos, sin, hd, _heads(a.k, hd))
    return q_full, k_full, dense(a.v, x)


def _encoder_layer_apply(cfg: MoonshineArchConfig, h: torch.Tensor, lp: EncoderLayer,
                         cos, sin, frame_mask, attn_impl: str, mesh=None) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    a = lp.attn
    q_full, k_full, v_full = _encoder_qkv(cfg, h, lp, cos, sin)
    heads, kv_heads = _heads(a.q, cfg.head_dim), _heads(a.k, cfg.head_dim)
    if attn_impl == "auto":
        # q/v stay [B, T, D]; K goes dim-major once, as the kernel reads it.
        o_full = encoder_attention_packed(
            q_full, k_full.transpose(1, 2).contiguous(), v_full, frame_mask, heads=heads)
    elif attn_impl == "pallas_shmap":
        o_full = encoder_attention_packed_sharded(
            q_full, k_full.transpose(1, 2).contiguous(), v_full, frame_mask,
            cfg.encoder_heads, mesh)
    else:
        mask = None if frame_mask is None else frame_mask[:, None, None, :]
        o = _attention(_split_heads(q_full, heads), _split_heads(k_full, kv_heads),
                       _split_heads(v_full, kv_heads), mask)
        o_full = o.reshape(o.shape[0], o.shape[1], -1)
    h = h + _dense_row(a.o, o_full, a.tp)
    x = copy_to_model(layer_norm(lp.ln2, h, eps), lp.mlp.tp)
    act = ACTIVATIONS[cfg.encoder_hidden_act]
    return h + _dense_row(lp.mlp.fc2, act(dense(lp.mlp.fc1, x)), lp.mlp.tp)


def _check_attn_impl(cfg: MoonshineArchConfig, attn_impl: str, mesh) -> None:
    """"auto" is the packed attention (its wrapper launches the CUDA kernel
    on CUDA tensors and runs the plain version on CPU tensors); "xla" is the
    split-head attention of the JAX package's XLA path; "pallas_shmap" is the
    packed attention on a (data, model) ``mesh``, its heads split over
    ``model`` (``encoder_attention_packed_sharded``)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if attn_impl != "xla" and cfg.encoder_kv_heads != cfg.encoder_heads:
        raise ValueError(
            f"the packed encoder attention needs encoder_kv_heads "
            f"({cfg.encoder_kv_heads}) == encoder_heads ({cfg.encoder_heads}); "
            f"pass attn_impl='xla'")
    if (attn_impl == "pallas_shmap") != (mesh is not None):
        raise ValueError("attn_impl='pallas_shmap' needs a mesh, and only it takes one")


def encoder_apply(
    p: Encoder,
    cfg: MoonshineArchConfig,
    features: torch.Tensor,  # [B, T, D]
    frame_mask: torch.Tensor | None = None,  # [B, T] bool
    attn_impl: str = "auto",
    mesh=None,  # a (data, model) DeviceMesh, for attn_impl="pallas_shmap"
) -> torch.Tensor:
    """Rotary transformer encoder -> [B, T, D] hidden states.  With a mesh,
    ``features`` are this rank's rows (parallel.sharding.shard_batch)."""
    _check_attn_impl(cfg, attn_impl, mesh)
    if attn_impl == "pallas_shmap" and p.layers and p.layers[0].attn.tp is not None:
        raise ValueError("attn_impl='pallas_shmap' splits the heads of replicated weights; "
                         "a model split by shard_params already holds only its heads")
    t = features.shape[1]
    cos, sin = rotary_tables(torch.arange(t, device=features.device), cfg.rotary_dim,
                             cfg.rope_theta)
    h = features
    for lp in p.layers:
        h = _encoder_layer_apply(cfg, h, lp, cos, sin, frame_mask, attn_impl, mesh)
    return layer_norm(p.norm, h, cfg.layer_norm_eps)


def encode(
    model: Moonshine,
    cfg: MoonshineArchConfig,
    audio: torch.Tensor,
    lengths: torch.Tensor | None = None,
    attn_impl: str = "auto",
    mesh=None,
    *,
    span_parent: profiling.Span | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [B, N] -> (memory [B, T, D], frame_mask [B, T]).  Records a
    coarse ``encode`` span (``batch``, ``samples``, ``k1_launches``) under
    ``span_parent``, enqueued on CUDA."""
    sp = profiling.begin("encode", span_parent, batch=audio.shape[0], samples=audio.shape[1])
    k1 = profiling.counter(K1_LAUNCHES)
    feats, mask = frontend_apply(model.frontend, cfg, audio, lengths)
    memory = encoder_apply(model.encoder, cfg, feats, mask if lengths is not None else None,
                           attn_impl=attn_impl, mesh=mesh)
    sp.enqueued = audio.device.type == "cuda"
    profiling.end(sp, k1_launches=profiling.counter(K1_LAUNCHES) - k1)
    return memory, mask


# =========================================================================
# Decoder with KV cache
# =========================================================================

class DecoderCache(NamedTuple):
    """Decoder state threaded through the decode steps.

    Layout is dim-major ``[L, B, H, hd, T]``, the JAX package's.  The self
    caches have a fixed capacity and are written in place at ``cur_len``;
    the cross caches are computed once per memory.  When the scale fields
    are set, the K/V arrays hold int8 values with one float32 scale per key
    column (``ops/int8_kv.py``).
    """

    k_self: torch.Tensor  # [L, B, H, hd, S_max]
    v_self: torch.Tensor  # [L, B, H, hd, S_max]
    cur_len: int
    k_cross: torch.Tensor  # [L, B, H, hd, T]
    v_cross: torch.Tensor  # [L, B, H, hd, T]
    memory_mask: torch.Tensor  # [B, T] bool
    k_self_scale: torch.Tensor | None = None  # [L, B, H, S_max] f32
    v_self_scale: torch.Tensor | None = None  # [L, B, H, S_max] f32
    k_cross_scale: torch.Tensor | None = None  # [L, B, H, T] f32
    v_cross_scale: torch.Tensor | None = None  # [L, B, H, T] f32


def init_cache(
    cfg: MoonshineArchConfig,
    batch: int,
    max_len: int,
    k_cross: torch.Tensor,
    v_cross: torch.Tensor,
    memory_mask: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    kv_int8: bool = False,
) -> DecoderCache:
    # The cross caches' heads: all of them, or a split model's share.
    shape = (cfg.decoder_layers, batch, k_cross.shape[2], cfg.head_dim, max_len)
    dev = k_cross.device
    if not kv_int8:
        return DecoderCache(
            k_self=torch.zeros(shape, dtype=dtype, device=dev),
            v_self=torch.zeros(shape, dtype=dtype, device=dev),
            cur_len=0, k_cross=k_cross, v_cross=v_cross, memory_mask=memory_mask,
        )
    sshape = shape[:3] + shape[4:]  # [L, B, H, S]
    kc_q, kc_s = quantize_kv(k_cross)
    vc_q, vc_s = quantize_kv(v_cross)
    return DecoderCache(
        k_self=torch.zeros(shape, dtype=torch.int8, device=dev),
        v_self=torch.zeros(shape, dtype=torch.int8, device=dev),
        cur_len=0, k_cross=kc_q, v_cross=vc_q, memory_mask=memory_mask,
        # Unwritten columns have scale 0 (quantize_kv gives 1.0 only to
        # columns it writes whose amax is 0), as in the JAX package.
        k_self_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
        v_self_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
        k_cross_scale=kc_s, v_cross_scale=vc_s,
    )


def compute_cross_kv(p: Decoder, cfg: MoonshineArchConfig,
                     memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of every layer from encoder memory, dim-major
    [L, B, H, hd, T] (H: a split model's heads)."""
    hd = cfg.hidden_size // cfg.decoder_heads
    memory = copy_to_model(memory, p.tp)
    ks, vs = [], []
    for lp in p.layers:
        a = lp.cross_attn
        for proj, out in ((a.k, ks), (a.v, vs)):
            h = _heads(proj, hd)
            # weight_of: an exec-quantized layer's weight, dequantized in the
            # memory's dtype, as the JAX package folds it into this product.
            w = weight_of(proj, memory.dtype).reshape(h, hd, cfg.hidden_size)
            x = torch.einsum("btd,hkd->bhkt", memory, w)
            if proj.bias is not None:
                x = x + proj.bias.to(memory.dtype).reshape(1, h, hd, 1)
            out.append(x)
    return torch.stack(ks), torch.stack(vs)


def _self_mask(cache: DecoderCache, s: int, token_mask: torch.Tensor | None,
               device) -> torch.Tensor:
    """Self-attention mask over cache keys: key j is visible to query i iff
    j <= cur_len + i; with ``token_mask``, padded query rows are masked and
    the padded tokens' own keys are hidden from every query."""
    max_len = cache.k_self.shape[4]
    key_pos = torch.arange(max_len, device=device)
    positions = cache.cur_len + torch.arange(s, device=device)
    mask = (key_pos[None, :] <= positions[:, None])[None, None]  # [1, 1, s, S_max]
    if token_mask is not None:
        mask = mask & token_mask[:, None, :, None]
        rel = key_pos - cache.cur_len
        in_block = (rel >= 0) & (rel < s)
        blk_valid = token_mask[:, torch.clamp(rel, 0, s - 1)]  # [B, S_max]
        key_valid = torch.where(in_block[None, :], blk_valid, True)
        mask = mask & key_valid[:, None, None, :]
    return mask


def _write_cols(buf: torch.Tensor, new: torch.Tensor, start: int) -> torch.Tensor:
    """``new`` written into the last axis of ``buf`` at ``start``: in place,
    or, where autograd records ``new``, into a copy (the layers' caches are
    views of one tensor, so an in-place write would change what an earlier
    layer saved for its backward)."""
    if torch.is_grad_enabled() and new.requires_grad:
        return torch.slice_scatter(buf, new, dim=-1, start=start, end=start + new.shape[-1])
    buf[..., start:start + new.shape[-1]] = new
    return buf


def _decoder_layer_apply(cfg, h, lp: DecoderLayer, layer: int, cache: DecoderCache,
                         cos, sin, self_mask):
    """Self-attention of one decoder layer over s new tokens; writes their
    keys and values into the layer's cache at [cur_len, cur_len + s).
    Returns (h, the layer's self K, its self V)."""
    b, s, _ = h.shape
    a = lp.self_attn
    x = copy_to_model(layer_norm(lp.ln1, h, cfg.layer_norm_eps), a.tp)
    hd = cfg.head_dim
    q = apply_rotary(_split_heads(dense(a.q, x), _heads(a.q, hd)), cos, sin)
    k_new = apply_rotary(_split_heads(dense(a.k, x), _heads(a.k, hd)), cos, sin)
    v_new = _split_heads(dense(a.v, x), _heads(a.v, hd))
    k_new_dm = k_new.permute(0, 2, 3, 1)  # [B, H, hd, s]
    v_new_dm = v_new.permute(0, 2, 3, 1)
    cols = slice(cache.cur_len, cache.cur_len + s)
    k_l, v_l = cache.k_self[layer], cache.v_self[layer]
    if cache.k_self_scale is not None:
        kq, ks = quantize_kv(k_new_dm)
        vq, vs = quantize_kv(v_new_dm)
        k_l[..., cols] = kq
        v_l[..., cols] = vq
        cache.k_self_scale[layer][..., cols] = ks
        cache.v_self_scale[layer][..., cols] = vs
        o = attention_dm_q8(q, k_l, cache.k_self_scale[layer], v_l,
                            cache.v_self_scale[layer], self_mask)
    else:
        k_l = _write_cols(k_l, k_new_dm.to(k_l.dtype), cache.cur_len)
        v_l = _write_cols(v_l, v_new_dm.to(v_l.dtype), cache.cur_len)
        o = _attention_dm(q, k_l.to(q.dtype), v_l.to(q.dtype), self_mask)
    return h + _dense_row(a.o, o.reshape(b, s, -1), a.tp), k_l, v_l


def _decoder_cross_mlp_apply(cfg, h, lp: DecoderLayer, layer: int, cache: DecoderCache,
                             cross_mask, collect_weights: bool, beam_k: int):
    b, s, _ = h.shape
    a = lp.cross_attn
    heads = _heads(a.q, cfg.head_dim)
    x = copy_to_model(layer_norm(lp.ln2, h, cfg.layer_norm_eps), a.tp)
    q = _split_heads(dense(a.q, x), heads)
    if beam_k > 1:
        # The K beams of one utterance share its memory: the cross caches
        # stay at B rows and the beams fold into the query axis (exact,
        # since cross attention has no causal structure).
        q = q.reshape(b // beam_k, beam_k * s, heads, -1)
    kc, vc = cache.k_cross[layer], cache.v_cross[layer]
    w = None
    if cache.k_cross_scale is not None:
        args = (q, kc, cache.k_cross_scale[layer], vc, cache.v_cross_scale[layer], cross_mask)
        if collect_weights:
            o, w = attention_dm_q8_with_weights(*args)
        else:
            o = attention_dm_q8(*args)
    elif collect_weights:
        o, w = _attention_dm(q, kc.to(q.dtype), vc.to(q.dtype), cross_mask, with_weights=True)
    else:
        o = _attention_dm(q, kc.to(q.dtype), vc.to(q.dtype), cross_mask)
    h = h + _dense_row(a.o, o.reshape(b, s, -1), a.tp)
    # SwiGLU MLP: fc1 -> (h, gate) -> act(gate) * h -> fc2.  A split fc1
    # holds the same block of both halves (parallel.sharding.shard_params).
    x = copy_to_model(layer_norm(lp.ln3, h, cfg.layer_norm_eps), lp.mlp.tp)
    hh, gate = torch.chunk(dense(lp.mlp.fc1, x), 2, dim=-1)
    act = ACTIVATIONS[cfg.decoder_hidden_act]
    return h + _dense_row(lp.mlp.fc2, act(gate) * hh, lp.mlp.tp), w


def _embed(p: Decoder, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; a split model looks up its vocabulary block,
    zeroes the rows of ids outside it and sums over ``model`` (exact: one
    rank holds each id)."""
    if p.tp is None:
        return p.embed[tokens]
    rows = p.embed.shape[0]
    local = tokens - p.tp.rank * rows
    inside = (local >= 0) & (local < rows)
    h = p.embed[local.clamp(0, rows - 1)]
    return reduce_from_model(torch.where(inside[..., None], h, torch.zeros_like(h)), p.tp)


def decoder_apply(
    p: Decoder,
    cfg: MoonshineArchConfig,
    tokens: torch.Tensor,  # [B, s] new token ids
    cache: DecoderCache,
    token_mask: torch.Tensor | None = None,  # [B, s] True for real tokens
    collect_cross_attention: bool = False,
    beam_k: int = 1,  # >1: tokens carry B*K beam rows; cross caches stay at B
) -> tuple[torch.Tensor, DecoderCache, torch.Tensor | None]:
    """Run the decoder over ``s`` new tokens, updating the cache.

    Returns (logits [B, s, V] float32, the cache with ``cur_len`` advanced
    by s, cross-attention weights [L, B, H, s, T] or None).  The self caches
    of ``cache`` are written in place, except where autograd records the
    new keys: then the returned cache holds new self caches.
    """
    b, s = tokens.shape
    max_len = cache.k_self.shape[4]
    if cache.cur_len + s > max_len:
        raise ValueError(f"cache holds {max_len} positions; cannot write {s} "
                         f"tokens at position {cache.cur_len}")
    if beam_k > 1 and collect_cross_attention:
        raise ValueError("collect_cross_attention is not supported with beam_k > 1")
    dev = tokens.device
    h = _embed(p, tokens)  # compute dtype follows the parameter dtype
    positions = cache.cur_len + torch.arange(s, device=dev)
    cos, sin = rotary_tables(positions, cfg.rotary_dim, cfg.rope_theta)
    self_mask = _self_mask(cache, s, token_mask, dev)
    cross_mask = cache.memory_mask[:, None, None, :]  # [B, 1, 1, T]
    weights, k_self, v_self = [], [], []
    for layer, lp in enumerate(p.layers):
        h, k_l, v_l = _decoder_layer_apply(cfg, h, lp, layer, cache, cos, sin, self_mask)
        k_self.append(k_l)
        v_self.append(v_l)
        h, w = _decoder_cross_mlp_apply(cfg, h, lp, layer, cache, cross_mask,
                                        collect_cross_attention, beam_k)
        weights.append(w)
    if k_self and k_self[0].requires_grad:  # written out of place (_write_cols)
        cache = cache._replace(k_self=torch.stack(k_self), v_self=torch.stack(v_self))
    h = layer_norm(p.norm, h, cfg.layer_norm_eps)
    # Tied output projection: operands in the compute dtype, float32 result
    # (bf16 products are exact in float32); a split model's vocabulary
    # blocks are gathered before anyone takes a softmax or an argmax.
    logits = gather_from_model(copy_to_model(h, p.tp).float() @ p.embed.float().t(), p.tp)
    cross_w = torch.stack(weights) if collect_cross_attention else None
    return logits, cache._replace(cur_len=cache.cur_len + s), cross_w

