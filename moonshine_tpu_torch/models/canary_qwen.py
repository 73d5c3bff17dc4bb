"""Canary-Qwen-2.5B (NVIDIA's speech-augmented language model), in PyTorch.

https://huggingface.co/nvidia/canary-qwen-2.5b: NeMo's ``speechlm2`` SALM.
Canary-1B-Flash's FastConformer encoder (``models/canary.py``, called as it
is: 32 layers, d 1,024, 8 heads of 128, feed-forward 4,096, depthwise kernel
9, an 8x dw_striding stem of 256 channels over 128 mels, one frame per 80
ms), a modality adapter, a linear projection to the LLM's width, and
Qwen3-1.7B (https://huggingface.co/Qwen/Qwen3-1.7B: width 2,048, 28 layers,
16 query heads over 8 K/V heads of 128, SwiGLU of 6,144, vocabulary 151,936
tied to the head, RoPE at theta 10^6, RMSNorm at eps 1e-6, no biases) that
reads the audio frames in place of a placeholder of its chat prompt and
generates the transcript:

  RMSNorm(x; w) = w * x / sqrt(mean(x^2) + eps)    (a plain gain w, not 1 + w)
  layer   a = RMSNorm(h; ln1)
          q = RoPE(RMSNorm_head(Wq a; q_norm)),  k = RoPE(RMSNorm_head(Wk a; k_norm)),  v = Wv a
          h += Wo softmax(q k^T / sqrt(128) + causal and padding mask) v
               (q head i reads K/V head i // 2)
          m = RMSNorm(h; ln2);  h += W_down (silu(W_gate m) * W_up m)
  RoPE    NeoX halves over all 128 dims, inv_freq_j = theta^(-2j/128), at each
          row's own positions 0, 1, 2, ...
  output  logits = RMSNorm(h; norm) E^T      (E the embedding, tied)
  SALM    memory = adapter(encoder(audio));  x = W_proj memory + b_proj
          prompt_b = E[prefix] ++ x_b[0 : F_b] ++ E[suffix]   (F_b: clip b's own valid
          frames, no padding inside); greedy decode after it, EOS <|im_end|>

Assumed (``benchmark/configs/canary_qwen_2_5b.json``'s ``assumed``): the
adapter is 2 FastConformer layers of the encoder's widths without
subsampling (the ``speechlm2`` example configuration's modality adapter);
the projection is biased; LoRA is merged into the dense weights; the
prompt is Qwen's chat template around "Transcribe the following: <audio>"
(a prefix of 9 ids and a suffix of 5, the ids assumed: Qwen's tokenizer is
not in the repository).

The port's form: W_q, W_k, W_v are one product (``qkv``, rows q then k then
v) and W_gate, W_up another (``gate_up``, gate rows first); a checkpoint's
separate matrices concatenate into them.  RMSNorm is ``F.rms_norm`` in the
activations' dtype (float32 inside).  The head is the bf16 table read in
place with a float32 output (cuBLAS's product with ``out_dtype``), never a
float32 copy of the 151,936 x 2,048 table; and only each row's last
position is scored.

The decode.  ``greedy_decode`` asks for ``prompt_embeds``: the prompt of
every row left-padded to the batch's longest, P = 14 + T columns (T the
memory's frames), so that row b's prompt fills columns [P - L_b, P), L_b =
14 + F_b.  The cache (:class:`LMCache`) is dim-major ``[L, B, H_kv, hd, S]``
(int8 with K7's writes, or the model's dtype) written at one host cursor
(``int8_kv.Cursor``) for every row, as Moonshine's and Canary's are: the
prompt in one call, then one column a token.  Each row's position at column
c is c - (P - L_b), so a row's rotary phases, and so its logits, are those
of the clip alone; the columns before its prompt are masked for every
query.  The prompt's call (``cur_len`` 0) runs causal attention over its
own new K/V in the model's dtype (``F.scaled_dot_product_attention`` with
``enable_gqa``, each K/V head read in place by its two q heads), then K7
writes them; every later call
attends through ``int8_kv.attend_kv`` (K5 with grouped heads on int8
caches) over the written columns only.

Spans: a coarse ``encode`` (``batch``, ``samples``, ``model``
"canary_qwen", ``frames``, ``relpos_calls``) with Canary's fine spans and
``salm.adapter`` and ``salm.project`` under it; ``salm.prefill`` (``batch``,
``positions``: the rows' prompt lengths summed, ``max_positions``: P) under
greedy's ``greedy.prefill``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import profiling
from ..core.device import resolve_device
from ..ops.int8_kv import Cursor, LayerKV, attend_kv, layer_kv, write_kv
from . import canary
from .layers import Dense, Norm, _param, dense_init

# <|im_start|>user\n "Transcribe the following: " (ids assumed), then the
# audio, then <|im_end|>\n<|im_start|>assistant\n.
PROMPT_PREFIX_IDS = (151644, 872, 198, 3167, 3114, 279, 2701, 25, 220)
PROMPT_SUFFIX_IDS = (151645, 198, 151644, 77091, 198)


@dataclass(frozen=True)
class CanaryQwenArchConfig:
    """Canary-Qwen's sizes; the defaults are Canary-Qwen-2.5B's.  The
    encoder's fields are Canary-1B-Flash's (``canary.CanaryArchConfig``),
    the ``llm_*`` fields Qwen3-1.7B's; the adapter and the prompt are
    assumed (module docstring)."""

    name: str = "canary-qwen-2.5b"
    # the encoder
    d_model: int = 1024
    encoder_layers: int = 32
    n_heads: int = 8
    ff_dim: int = 4096
    conv_kernel_size: int = 9
    subsampling_channels: int = 256
    subsampling_stages: int = 3
    n_mels: int = 128
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemph: float = 0.97
    layer_norm_eps: float = 1e-5
    batch_norm_eps: float = 1e-5
    xscaling: bool = True
    adapter_layers: int = 2
    # the LLM
    llm_hidden_size: int = 2048
    llm_layers: int = 28
    llm_heads: int = 16
    llm_kv_heads: int = 8
    llm_head_dim: int = 128
    llm_intermediate_size: int = 6144
    vocab_size: int = 151936
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    prompt_prefix_ids: tuple[int, ...] = PROMPT_PREFIX_IDS
    prompt_suffix_ids: tuple[int, ...] = PROMPT_SUFFIX_IDS
    eos_token_id: int = 151645  # <|im_end|>

    @functools.cached_property
    def encoder(self) -> canary.CanaryArchConfig:
        """The encoder's and the adapter's configuration, as Canary's."""
        return canary.CanaryArchConfig(
            name=self.name, d_model=self.d_model, encoder_layers=self.encoder_layers,
            decoder_layers=0, n_heads=self.n_heads, ff_dim=self.ff_dim,
            conv_kernel_size=self.conv_kernel_size, subsampling_channels=self.subsampling_channels,
            subsampling_stages=self.subsampling_stages, n_mels=self.n_mels,
            sample_rate=self.sample_rate, n_fft=self.n_fft, win_length=self.win_length,
            hop_length=self.hop_length, preemph=self.preemph, layer_norm_eps=self.layer_norm_eps,
            batch_norm_eps=self.batch_norm_eps, xscaling=self.xscaling)

    @property
    def prompt_extra(self) -> int:
        """Prompt ids around the audio: 14."""
        return len(self.prompt_prefix_ids) + len(self.prompt_suffix_ids)

    def frames_for_samples(self, num_samples: int) -> int:
        return self.encoder.frames_for_samples(num_samples)

    def min_samples(self) -> int:
        return 1


CANARY_QWEN_2_5B = CanaryQwenArchConfig()


# =========================================================================
# Parameter holders and initialization
# =========================================================================

class QwenLayer(nn.Module):
    """RMSNorm gains ``ln1``, ``ln2`` [D] and ``q_norm``, ``k_norm`` [hd];
    ``qkv`` [(H + 2 H_kv) hd, D], ``o`` [D, H hd], ``gate_up`` [2 F, D],
    ``down`` [D, F], none biased."""

    def __init__(self, ln1: Norm, qkv: Dense, q_norm: Norm, k_norm: Norm, o: Dense, ln2: Norm,
                 gate_up: Dense, down: Dense):
        super().__init__()
        self.ln1, self.qkv, self.q_norm, self.k_norm, self.o = ln1, qkv, q_norm, k_norm, o
        self.ln2, self.gate_up, self.down = ln2, gate_up, down


class QwenLM(nn.Module):
    """``embed`` [V, D] (also the head), the layers and the final RMSNorm."""

    def __init__(self, embed: torch.Tensor, layers: list[QwenLayer], norm: Norm):
        super().__init__()
        self.embed = _param(embed)
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class LMCache(NamedTuple):
    """The LLM's K/V, dim-major ``[L, B, H_kv, hd, S]``, written at the host
    cursor ``cur_len`` for every row; ``lengths`` [B] each row's prompt
    length and ``start`` [B] its first column (P - length, set by the
    prompt's call); the scales [L, B, H_kv, S] where the caches are int8."""

    k_self: torch.Tensor
    v_self: torch.Tensor
    cur_len: int
    lengths: torch.Tensor
    start: torch.Tensor | None = None
    k_self_scale: torch.Tensor | None = None
    v_self_scale: torch.Tensor | None = None


class CanaryQwen(nn.Module):
    """The whole model: Canary's ``encoder``, the ``adapter`` (FastConformer
    layers), the ``project``ion and the LLM (``decoder``).  Its methods are
    what ``greedy_decode`` and the offline backend call of any model."""

    def __init__(self, encoder: canary.CanaryEncoder, adapter: list[canary.ConformerLayer],
                 project: Dense, decoder: QwenLM):
        super().__init__()
        self.encoder = encoder
        self.adapter = nn.ModuleList(adapter)
        self.project = project
        self.decoder = decoder

    def encode(self, cfg: CanaryQwenArchConfig, audio, lengths=None, *, span_parent=None):
        return encode(self, cfg, audio, lengths, span_parent=span_parent)

    def prompt_embeds(self, cfg: CanaryQwenArchConfig, memory: torch.Tensor,
                      memory_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return prompt_embeds(self.decoder, cfg, memory, memory_mask)

    def init_cache(self, cfg: CanaryQwenArchConfig, *args, **kw) -> LMCache:
        return init_cache(cfg, *args, **kw)

    def decoder_apply(self, cfg: CanaryQwenArchConfig, inputs, cache, *, span_parent=None):
        return decoder_apply(self.decoder, cfg, inputs, cache, span_parent=span_parent)


def init_params(cfg: CanaryQwenArchConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> CanaryQwen:
    """Random weights from ``generator`` (on the CPU), then moved to
    ``device`` (CUDA unless named): the encoder as ``canary.init_params``
    draws it, the adapter's layers as the encoder's, dense weights uniform
    in +-1/sqrt(fan_in), biases 0, RMSNorm gains 1, the embedding N(0,
    0.02^2)."""
    g = generator
    ecfg = cfg.encoder
    encoder = canary.encoder_init(ecfg, g)
    adapter = canary.conformer_layers(ecfg, g, cfg.adapter_layers)
    dl, hd, ff = cfg.llm_hidden_size, cfg.llm_head_dim, cfg.llm_intermediate_size
    width = (cfg.llm_heads + 2 * cfg.llm_kv_heads) * hd
    layers = [QwenLayer(Norm(torch.ones(dl)), dense_init(g, dl, width, bias=False),
                        Norm(torch.ones(hd)), Norm(torch.ones(hd)),
                        dense_init(g, cfg.llm_heads * hd, dl, bias=False), Norm(torch.ones(dl)),
                        dense_init(g, dl, 2 * ff, bias=False), dense_init(g, ff, dl, bias=False))
              for _ in range(cfg.llm_layers)]
    embed = torch.randn((cfg.vocab_size, dl), generator=g) * 0.02
    model = CanaryQwen(encoder, adapter, dense_init(g, cfg.d_model, dl),
                       QwenLM(embed, layers, Norm(torch.ones(dl))))
    return model.to(resolve_device(device))


# =========================================================================
# Encoder, adapter, projection
# =========================================================================

def encode(
    model: CanaryQwen,
    cfg: CanaryQwenArchConfig,
    audio: torch.Tensor,  # [B, N] float32
    lengths: torch.Tensor | None = None,  # [B] valid samples
    *,
    span_parent: profiling.Span | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """audio [B, N] -> (the projected audio embeddings [B, T, llm width] in
    the model's dtype, frame mask [B, T]): Canary's encoder, the adapter
    (its attention hiding the frames past each clip's valid ones, as the
    encoder's does) and the projection.  Records a coarse ``encode`` span
    with ``salm.adapter`` and ``salm.project`` under it."""
    b, n = audio.shape
    ecfg = cfg.encoder
    sp = profiling.begin("encode", span_parent, batch=b, samples=n, model="canary_qwen")
    x, mask = canary.encoder_forward(model.encoder, ecfg, audio, lengths, sp)
    st = profiling.child("salm.adapter", sp)
    x = canary.conformer_stack(model.adapter, ecfg, x, mask if lengths is not None else None, st)
    profiling.end(st)
    st = profiling.child("salm.project", sp)
    x = F.linear(x, model.project.weight.to(x.dtype), model.project.bias.to(x.dtype))
    profiling.end(st)
    sp.enqueued = audio.device.type == "cuda"
    profiling.end(sp, frames=x.shape[1],
                  relpos_calls=len(model.encoder.layers) + len(model.adapter))
    return x, mask


# =========================================================================
# The prompt
# =========================================================================

@functools.lru_cache(maxsize=16)
def _prompt_ids(ids: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The prompt's ids on ``device``, made once a device."""
    return torch.tensor(ids, dtype=torch.long).to(device)


def splice(src: torch.Tensor, frames: torch.Tensor, n_prefix: int, n_suffix: int) -> torch.Tensor:
    """Each row's prompt, left-padded: ``src`` [B, P, D] is the prefix's
    ``n_prefix`` rows, the T audio frames and the suffix's ``n_suffix`` rows
    (P = n_prefix + T + n_suffix); row b keeps its first ``frames[b]``
    frames only, its prompt ending at column P - 1 and the columns before
    it zero.  Returns [B, P, D]."""
    b, p, d = src.shape
    t = p - n_prefix - n_suffix
    col = torch.arange(p, device=src.device)
    r = col[None, :] - (t - frames)[:, None]  # the column within row b's own prompt
    idx = torch.where(r < n_prefix + frames[:, None], r, col[None, :]).clamp_(min=0)
    out = src.gather(1, idx[..., None].expand(b, p, d))
    return out.masked_fill_((r < 0)[..., None], 0.0)


def prompt_embeds(p: QwenLM, cfg: CanaryQwenArchConfig, memory: torch.Tensor,
                  memory_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(prompt embeddings [B, P, D] left-padded, each row's prompt length
    [B]) from the projected audio ``memory`` [B, T, D] and its frame mask:
    E[prefix] ++ the row's valid frames ++ E[suffix]."""
    b = memory.shape[0]
    n_pre = len(cfg.prompt_prefix_ids)
    ids = _prompt_ids(cfg.prompt_prefix_ids + cfg.prompt_suffix_ids, memory.device)
    emb = p.embed[ids].to(memory.dtype)
    src = torch.cat([emb[None, :n_pre].expand(b, -1, -1), memory,
                     emb[None, n_pre:].expand(b, -1, -1)], dim=1)
    frames = memory_mask.sum(dim=1)
    return splice(src, frames, n_pre, len(cfg.prompt_suffix_ids)), frames + cfg.prompt_extra


# =========================================================================
# The LLM with its K/V cache
# =========================================================================

def init_cache(cfg: CanaryQwenArchConfig, batch: int, max_len: int, prompt_lengths: torch.Tensor,
               dtype: torch.dtype = torch.float32, kv_int8: bool = False) -> LMCache:
    """Empty caches of ``max_len`` columns for rows whose prompts are
    ``prompt_lengths`` [B] long; unwritten int8 columns have scale 0."""
    shape = (cfg.llm_layers, batch, cfg.llm_kv_heads, cfg.llm_head_dim, max_len)
    dev = prompt_lengths.device
    if not kv_int8:
        return LMCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev), 0, prompt_lengths)
    sshape = shape[:3] + shape[4:]
    return LMCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                   torch.zeros(shape, dtype=torch.int8, device=dev), 0, prompt_lengths,
                   k_self_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
                   v_self_scale=torch.zeros(sshape, dtype=torch.float32, device=dev))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """w * x / sqrt(mean(x^2) + eps) over the last axis, in x's dtype."""
    return F.rms_norm(x, x.shape[-1:], w.to(x.dtype), eps)


def rope_tables(positions: torch.Tensor, hd: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, signed sin) [B, s, 1, hd] float32 for positions [B, s]: the NeoX
    halves, inv_freq_j = theta^(-2j/hd), the sine's first half negated."""
    inv_freq = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device)
                         / hd)
    ang = positions.float()[..., None] * inv_freq  # [B, s, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], -1)[:, :, None],
            torch.cat([-sin, sin], -1)[:, :, None])


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, s, H, hd] rotated in float32 (NeoX: x cos + rotate_half(x) sin,
    rotate_half(x) = (-x2, x1)), in x's dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    swapped = torch.cat([xf[..., half:], xf[..., :half]], -1)
    return torch.addcmul(xf * cos, swapped, sin).to(x.dtype)


def positions(cache: LMCache, s: int) -> torch.Tensor:
    """[B, s]: each row's positions of columns cur_len .. cur_len + s - 1,
    counted from its prompt's first column (0 for the columns before it)."""
    cols = cache.cur_len + torch.arange(s, device=cache.lengths.device)
    return (cols[None, :] - cache.start[:, None]).clamp(min=0)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """The prompt's attention over its own K/V in the model's dtype: q
    [B, s, H, hd], k and v [B, s, H_kv, hd], mask [B, 1, s, s] ->
    [B, s, H, hd], q head h reading K/V head h // (H / H_kv) in place
    (``enable_gqa``: no copy of K/V at q's heads)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          attn_mask=mask, enable_gqa=True).transpose(1, 2)


def _prefill_mask(cache: LMCache, s: int) -> torch.Tensor:
    """[B, 1, s, s]: query i sees key j <= i from its row's first column
    on; a column before the row's prompt sees itself only."""
    col = torch.arange(s, device=cache.lengths.device)
    causal = col[None, :] <= col[:, None]
    own = col[None, None, :] >= cache.start[:, None, None]
    return ((causal[None] & own) | torch.eye(s, dtype=torch.bool, device=col.device))[:, None]


def _step_mask(cache: LMCache, s: int) -> torch.Tensor:
    """[B, 1, s, cur_len + s]: query cur_len + i sees the columns of its row
    from its prompt's first up to itself."""
    t = cache.cur_len + s
    key = torch.arange(t, device=cache.lengths.device)
    causal = key[None, :] <= cache.cur_len + torch.arange(s, device=key.device)[:, None]
    return (causal[None] & (key[None, None, :] >= cache.start[:, None, None]))[:, None]


def _layer(cfg: CanaryQwenArchConfig, lp: QwenLayer, layer: int, h: torch.Tensor,
           cache: LMCache, cos, sin, mask, prefill: bool) -> torch.Tensor:
    b, s, _ = h.shape
    nh, nk, hd, eps = cfg.llm_heads, cfg.llm_kv_heads, cfg.llm_head_dim, cfg.rms_norm_eps
    qkv = F.linear(rms_norm(h, lp.ln1.weight, eps), lp.qkv.weight.to(h.dtype))
    q, k, v = qkv.split([nh * hd, nk * hd, nk * hd], dim=-1)
    q = rope(rms_norm(q.view(b, s, nh, hd), lp.q_norm.weight, eps), cos, sin)
    k = rope(rms_norm(k.view(b, s, nk, hd), lp.k_norm.weight, eps), cos, sin)
    v = v.view(b, s, nk, hd)
    kv = write_kv(layer_kv(cache, "self", layer), k.permute(0, 2, 3, 1), v.permute(0, 2, 3, 1),
                  Cursor(cache.cur_len))
    if prefill:
        o = prefill_attention(q, k, v, mask)
    else:
        t = cache.cur_len + s
        o = attend_kv(q, LayerKV(*(None if x is None else x[..., :t] for x in kv)), mask)
    h = h + F.linear(o.reshape(b, s, nh * hd), lp.o.weight.to(h.dtype))
    gate, up = F.linear(rms_norm(h, lp.ln2.weight, eps), lp.gate_up.weight.to(h.dtype)).chunk(2, -1)
    return h + F.linear(F.silu(gate) * up, lp.down.weight.to(h.dtype))


def tied_logits(h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """float32 logits h E^T [..., V], the table read in its own dtype: on
    CUDA cuBLAS's product with a float32 output (no float32 copy of E);
    elsewhere the float32 product."""
    if h.device.type == "cuda" and embed.dtype != torch.float32:
        flat = torch.mm(h.reshape(-1, h.shape[-1]), embed.t(), out_dtype=torch.float32)
        return flat.view(*h.shape[:-1], embed.shape[0])
    return h.float() @ embed.float().t()


def decoder_apply(
    p: QwenLM,
    cfg: CanaryQwenArchConfig,
    inputs: torch.Tensor,  # [B, s, D] embeddings (the prompt) or [B, s] token ids
    cache: LMCache,
    *,
    span_parent: profiling.Span | None = None,
) -> tuple[torch.Tensor, LMCache, None]:
    """Run the LLM over ``s`` new columns at cur_len .. cur_len + s - 1,
    writing their keys and values into the caches in place.  The prompt's
    call (cur_len 0) sets each row's first column and records
    ``salm.prefill`` under ``span_parent``.  Returns (logits [B, 1, V]
    float32 of the last new column, the cache advanced by s, None)."""
    h = inputs.to(p.embed.dtype) if inputs.is_floating_point() else p.embed[inputs]
    b, s, _ = h.shape
    if cache.cur_len + s > cache.k_self.shape[-1]:
        raise ValueError(f"cache holds {cache.k_self.shape[-1]} columns; cannot write {s} at "
                         f"column {cache.cur_len}")
    prefill = cache.cur_len == 0
    sp = None
    if prefill:
        cache = cache._replace(start=s - cache.lengths)
        sp = profiling.child("salm.prefill", span_parent)
        if sp is not None:  # fine spans only: the lengths' read waits for the encode
            sp.attrs.update(batch=b, positions=int(cache.lengths.sum()), max_positions=s)
    cos, sin = rope_tables(positions(cache, s), cfg.llm_head_dim, cfg.rope_theta)
    mask = _prefill_mask(cache, s) if prefill else _step_mask(cache, s)
    for layer, lp in enumerate(p.layers):
        h = _layer(cfg, lp, layer, h, cache, cos, sin, mask, prefill)
    logits = tied_logits(rms_norm(h[:, -1:], p.norm.weight, cfg.rms_norm_eps), p.embed)
    profiling.end(sp)
    return logits, cache._replace(cur_len=cache.cur_len + s), None


def parameter_count(cfg: CanaryQwenArchConfig) -> dict[str, int]:
    """Parameters by part, from the configuration (the BatchNorm running
    statistics not counted): the encoder, the adapter, the projection, the
    LLM's layers and final norm, and its tied embedding."""
    with torch.device("meta"):
        model = init_params(cfg, torch.Generator(), device="meta")
    out = {part: sum(v.numel() for k, v in getattr(model, part).state_dict().items()
                     if ".running_" not in k)
           for part in ("encoder", "adapter", "project", "decoder")}
    out["embedding"] = cfg.vocab_size * cfg.llm_hidden_size
    out["decoder"] -= out["embedding"]
    return out
