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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..core.config import MoonshineArchConfig
from ..core.device import resolve_device
from ..ops.encoder_attention import encoder_attention_packed, encoder_attention_packed_sharded
from ..ops.int8_kv import attention_dm_q8, attention_dm_q8_with_weights, quantize_kv
from ..ops.rotary import (
    apply_rotary,
    apply_rotary_fullwidth,
    pair_swap_perm,
    rotary_tables,
    swap_dense_params,
)
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


class Mlp(nn.Module):
    def __init__(self, fc1: Dense, fc2: Dense):
        super().__init__()
        self.fc1, self.fc2 = fc1, fc2


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


class Moonshine(nn.Module):
    """The whole model's parameters: ``frontend``, ``encoder``, ``decoder``."""

    def __init__(self, frontend: Frontend, encoder: Encoder, decoder: Decoder):
        super().__init__()
        self.frontend, self.encoder, self.decoder = frontend, encoder, decoder


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


def prepare_rotary_params(model: Moonshine, cfg: MoonshineArchConfig) -> Moonshine:
    """Give every encoder attention its pair-swapped q/k projections, once
    at load time (exact: a permutation of output channels), as the encoder
    requires.  Idempotent; updates ``model`` in place and returns it."""
    half = cfg.rotary_dim // 2
    q_perm = pair_swap_perm(cfg.head_dim, half, cfg.encoder_heads)
    k_perm = pair_swap_perm(cfg.head_dim, half, cfg.encoder_kv_heads)
    for layer in model.encoder.layers:
        a = layer.attn
        if a.q_swapped is None:
            a.q_swapped = swap_dense_params(a.q, q_perm)
        if a.k_swapped is None:
            a.k_swapped = swap_dense_params(a.k, k_perm)
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


def _encoder_qkv(cfg: MoonshineArchConfig, h: torch.Tensor, lp: EncoderLayer,
                 cos, sin) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An encoder layer's attention inputs from its input ``h``: q and k
    with rotary, and v, each [B, T, heads * hd] (heads not split)."""
    x = layer_norm(lp.ln1, h, cfg.layer_norm_eps)
    a = lp.attn
    hd = cfg.head_dim
    # The pair-swapped projections (prepare_rotary_params) give the rotary's
    # swapped operand from the same GEMM shape, with no gather per call.
    q_full = apply_rotary_fullwidth(dense(a.q, x), dense(a.q_swapped, x), cos, sin, hd,
                                    cfg.encoder_heads)
    k_full = apply_rotary_fullwidth(dense(a.k, x), dense(a.k_swapped, x), cos, sin, hd,
                                    cfg.encoder_kv_heads)
    return q_full, k_full, dense(a.v, x)


def _encoder_layer_apply(cfg: MoonshineArchConfig, h: torch.Tensor, lp: EncoderLayer,
                         cos, sin, frame_mask, attn_impl: str, mesh=None) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    a = lp.attn
    q_full, k_full, v_full = _encoder_qkv(cfg, h, lp, cos, sin)
    if attn_impl == "auto":
        # q/v stay [B, T, D]; K goes dim-major once, as the kernel reads it.
        o_full = encoder_attention_packed(
            q_full, k_full.transpose(1, 2).contiguous(), v_full, frame_mask,
            heads=cfg.encoder_heads)
    elif attn_impl == "pallas_shmap":
        o_full = encoder_attention_packed_sharded(
            q_full, k_full.transpose(1, 2).contiguous(), v_full, frame_mask,
            cfg.encoder_heads, mesh)
    else:
        mask = None if frame_mask is None else frame_mask[:, None, None, :]
        o = _attention(_split_heads(q_full, cfg.encoder_heads),
                       _split_heads(k_full, cfg.encoder_kv_heads),
                       _split_heads(v_full, cfg.encoder_kv_heads), mask)
        o_full = o.reshape(o.shape[0], o.shape[1], -1)
    h = h + dense(a.o, o_full)
    x = layer_norm(lp.ln2, h, eps)
    act = ACTIVATIONS[cfg.encoder_hidden_act]
    return h + dense(lp.mlp.fc2, act(dense(lp.mlp.fc1, x)))


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [B, N] -> (memory [B, T, D], frame_mask [B, T])."""
    feats, mask = frontend_apply(model.frontend, cfg, audio, lengths)
    memory = encoder_apply(model.encoder, cfg, feats, mask if lengths is not None else None,
                           attn_impl=attn_impl, mesh=mesh)
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
    shape = (cfg.decoder_layers, batch, cfg.decoder_kv_heads, cfg.head_dim, max_len)
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
    [L, B, H, hd, T]."""
    h = cfg.decoder_kv_heads
    hd = cfg.hidden_size // cfg.decoder_heads
    ks, vs = [], []
    for lp in p.layers:
        a = lp.cross_attn
        for proj, out in ((a.k, ks), (a.v, vs)):
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


def _decoder_layer_apply(cfg, h, lp: DecoderLayer, layer: int, cache: DecoderCache,
                         cos, sin, self_mask):
    """Self-attention of one decoder layer over s new tokens; writes their
    keys and values into the layer's cache at [cur_len, cur_len + s)."""
    b, s, _ = h.shape
    x = layer_norm(lp.ln1, h, cfg.layer_norm_eps)
    a = lp.self_attn
    q = apply_rotary(_split_heads(dense(a.q, x), cfg.decoder_heads), cos, sin)
    k_new = apply_rotary(_split_heads(dense(a.k, x), cfg.decoder_kv_heads), cos, sin)
    v_new = _split_heads(dense(a.v, x), cfg.decoder_kv_heads)
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
        k_l[..., cols] = k_new_dm.to(k_l.dtype)
        v_l[..., cols] = v_new_dm.to(v_l.dtype)
        o = _attention_dm(q, k_l.to(q.dtype), v_l.to(q.dtype), self_mask)
    return h + dense(a.o, o.reshape(b, s, -1))


def _decoder_cross_mlp_apply(cfg, h, lp: DecoderLayer, layer: int, cache: DecoderCache,
                             cross_mask, collect_weights: bool, beam_k: int):
    b, s, _ = h.shape
    heads = cfg.decoder_heads
    x = layer_norm(lp.ln2, h, cfg.layer_norm_eps)
    a = lp.cross_attn
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
    h = h + dense(a.o, o.reshape(b, s, -1))
    # SwiGLU MLP: fc1 -> (h, gate) -> act(gate) * h -> fc2
    x = layer_norm(lp.ln3, h, cfg.layer_norm_eps)
    hh, gate = torch.chunk(dense(lp.mlp.fc1, x), 2, dim=-1)
    act = ACTIVATIONS[cfg.decoder_hidden_act]
    return h + dense(lp.mlp.fc2, act(gate) * hh), w


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
    of ``cache`` are written in place.
    """
    b, s = tokens.shape
    max_len = cache.k_self.shape[4]
    if cache.cur_len + s > max_len:
        raise ValueError(f"cache holds {max_len} positions; cannot write {s} "
                         f"tokens at position {cache.cur_len}")
    if beam_k > 1 and collect_cross_attention:
        raise ValueError("collect_cross_attention is not supported with beam_k > 1")
    dev = tokens.device
    h = p.embed[tokens]  # compute dtype follows the parameter dtype
    positions = cache.cur_len + torch.arange(s, device=dev)
    cos, sin = rotary_tables(positions, cfg.rotary_dim, cfg.rope_theta)
    self_mask = _self_mask(cache, s, token_mask, dev)
    cross_mask = cache.memory_mask[:, None, None, :]  # [B, 1, 1, T]
    weights = []
    for layer, lp in enumerate(p.layers):
        h = _decoder_layer_apply(cfg, h, lp, layer, cache, cos, sin, self_mask)
        h, w = _decoder_cross_mlp_apply(cfg, h, lp, layer, cache, cross_mask,
                                        collect_cross_attention, beam_k)
        weights.append(w)
    h = layer_norm(p.norm, h, cfg.layer_norm_eps)
    # Tied output projection: operands in the compute dtype, float32 result
    # (bf16 products are exact in float32).
    logits = h.float() @ p.embed.float().t()
    cross_w = torch.stack(weights) if collect_cross_attention else None
    return logits, cache._replace(cur_len=cache.cur_len + s), cross_w

