"""Streaming Moonshine family, in PyTorch: incremental encoder/decoder.

Counterpart of the JAX package's ``models/streaming.py`` (a mirror of the
reference ``MoonshineStreamingModel``).  Each stage is a function over an
explicit ``StreamingState`` of fixed-capacity tensors, with the JAX
package's capacities, so that the same reads see the same data:

- frontend: strictly causal with O(1) carry: 79-sample context and two
  4-frame conv carries, one feature per ``frame_len`` (80) samples;
- encoder: sliding-window re-encode with a left context of ``16 * depth``
  frames, withholding ``total_lookahead`` (16) frames until ``is_final``;
- adapter: projects new encoded frames with an absolute sinusoidal position
  and appends them 1:1 to ``memory``, with their cross-attention K/V;
- decoder: rotary causal self-attention over a ``max_seq_len`` cache,
  rope-free cross-attention over memory, SwiGLU MLP; ``decoder_reset``
  keeps the cross K/V and clears the self cache;
- speculative self-verify: the previous hypothesis is verified in one
  decoder pass and decoding continues from the first divergence with the
  cache rolled back by index.

Where the JAX package threads the state functionally and keeps its cursors
on the device, the port writes the state's buffers in place (the returned
state shares them) and keeps the cursors (``frame_count``, ``feat_count``,
``enc_emitted``, ``mem_len``, ``cache_len``) as host integers, so that no
update reads the device to know where it is.  Reads keep the clamping of
JAX's ``dynamic_slice`` (a window that would run past its buffer starts
earlier); a write that JAX's ``dynamic_update_slice`` would clamp raises
here.  The greedy loops are Python loops with one host read per step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..core.config import StreamingConfig
from ..core.device import resolve_device
from ..ops.rotary import apply_rotary, rotary_tables
from .layers import (
    ACTIVATIONS,
    Conv1d,
    Dense,
    Norm,
    conv1d,
    dense,
    dense_init,
    layer_norm,
    norm_init,
)
from .moonshine import (
    Attention,
    Decoder,
    DecoderLayer,
    EncoderLayer,
    Mlp,
    _attention,
    _split_heads,
)

SAMPLE_CTX = 79  # frontend sample carry
CONV_CARRY = 4  # frames of carry per causal conv
CONV_K = CONV_CARRY + 1  # causal conv kernel size
ENC_STEP = 128  # new frames encoded per call
ENC_WIN = 256  # padded encoder window (left context + step + lookahead)
# Max usable frames per segment: the VAD's force-split bounds segments to
# ~15 s (up to ~20 s at low thresholds) = 4000 frames at 200 fps.
SEG_CAP = 4096
# Buffer slack so that windowed reads never clamp near the cap.
FEAT_CAP = SEG_CAP + ENC_WIN
MEM_CAP = SEG_CAP + ENC_STEP


# =========================================================================
# Parameters
# =========================================================================

class StreamingFrontend(nn.Module):
    """159-sample projection (79 carry + 80 new samples per frame), two
    causal convolutions and a norm."""

    def __init__(self, proj: Dense, conv1: Conv1d, conv2: Conv1d, norm: Norm):
        super().__init__()
        self.proj, self.conv1, self.conv2, self.norm = proj, conv1, conv2, norm


class StreamingEncoder(nn.Module):
    def __init__(self, in_proj: Dense, layers: list[EncoderLayer], norm: Norm):
        super().__init__()
        self.in_proj = in_proj
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class Adapter(nn.Module):
    def __init__(self, proj: Dense, norm: Norm):
        super().__init__()
        self.proj, self.norm = proj, norm


class StreamingMoonshine(nn.Module):
    """The whole streaming model: ``frontend``, ``encoder``, ``adapter``,
    ``decoder`` (the JAX tree's four subtrees)."""

    def __init__(self, frontend: StreamingFrontend, encoder: StreamingEncoder,
                 adapter: Adapter, decoder: Decoder):
        super().__init__()
        self.frontend, self.encoder = frontend, encoder
        self.adapter, self.decoder = adapter, decoder


def _conv_carry_init(g: torch.Generator, cin: int, cout: int) -> Conv1d:
    scale = (1.0 / (cin * CONV_K)) ** 0.5
    w = torch.empty((cout, cin, CONV_K)).uniform_(-scale, scale, generator=g)
    return Conv1d(w, torch.zeros(cout))


def _attn_init(g: torch.Generator, dim: int, cfg: StreamingConfig) -> Attention:
    width = cfg.nheads * cfg.head_dim
    return Attention(dense_init(g, dim, width, bias=False), dense_init(g, dim, width, bias=False),
                     dense_init(g, dim, width, bias=False), dense_init(g, width, dim, bias=False))


def init_params(cfg: StreamingConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> StreamingMoonshine:
    """Random weights drawn from ``generator`` (on the CPU), then moved to
    ``device`` (CUDA unless named).  The draws differ from the JAX
    package's; tests carry JAX weights across through the canonical state
    dict (``weights.import_streaming``)."""
    g = generator
    d = cfg.d_model_frontend
    frontend = StreamingFrontend(
        dense_init(g, SAMPLE_CTX + cfg.frame_len, d),
        _conv_carry_init(g, d, cfg.c1),
        _conv_carry_init(g, cfg.c1, cfg.c2),
        norm_init(cfg.c2),
    )
    e = cfg.encoder_dim
    enc_layers = [
        EncoderLayer(norm_init(e), _attn_init(g, e, cfg), norm_init(e),
                     Mlp(dense_init(g, e, 4 * e), dense_init(g, 4 * e, e)))
        for _ in range(cfg.enc_depth)
    ]
    dd = cfg.decoder_dim
    dec_layers = [
        DecoderLayer(norm_init(dd), _attn_init(g, dd, cfg), norm_init(dd),
                     _attn_init(g, dd, cfg), norm_init(dd),
                     Mlp(dense_init(g, dd, 8 * dd), dense_init(g, 4 * dd, dd)))
        for _ in range(cfg.depth)
    ]
    model = StreamingMoonshine(
        frontend,
        StreamingEncoder(dense_init(g, cfg.c2, e), enc_layers, norm_init(e)),
        Adapter(dense_init(g, e, dd), norm_init(dd)),
        Decoder(torch.randn((cfg.vocab_size, dd), generator=g) * 0.02, dec_layers,
                norm_init(dd)),
    )
    return model.to(resolve_device(device))


# =========================================================================
# State
# =========================================================================

class StreamingState(NamedTuple):
    """Incremental state of one stream: fixed-capacity tensors on the
    model's device and host-integer cursors."""

    # frontend
    sample_ctx: torch.Tensor  # [79]
    conv1_carry: torch.Tensor  # [4, d_model_frontend]
    conv2_carry: torch.Tensor  # [4, c1]
    frame_count: int
    # features
    feats: torch.Tensor  # [FEAT_CAP, c2]
    feat_count: int
    enc_emitted: int
    # memory + cross K/V, sequence-major [L, MEM_CAP, H, hd]
    memory: torch.Tensor  # [MEM_CAP, decoder_dim]
    mem_len: int
    k_cross: torch.Tensor
    v_cross: torch.Tensor
    # decoder self K/V [L, max_seq_len, H, hd]
    k_self: torch.Tensor
    v_self: torch.Tensor
    cache_len: int


def init_state(cfg: StreamingConfig, dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> StreamingState:
    """A fresh, zeroed state on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    L, H, hd = cfg.depth, cfg.nheads, cfg.head_dim

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return StreamingState(
        sample_ctx=z(SAMPLE_CTX), conv1_carry=z(CONV_CARRY, cfg.d_model_frontend),
        conv2_carry=z(CONV_CARRY, cfg.c1), frame_count=0,
        feats=z(FEAT_CAP, cfg.c2), feat_count=0, enc_emitted=0,
        memory=z(MEM_CAP, cfg.decoder_dim), mem_len=0,
        k_cross=z(L, MEM_CAP, H, hd), v_cross=z(L, MEM_CAP, H, hd),
        k_self=z(L, cfg.max_seq_len, H, hd), v_self=z(L, cfg.max_seq_len, H, hd),
        cache_len=0,
    )


def decoder_reset(state: StreamingState) -> StreamingState:
    """Keep the cross K/V, clear the self cache."""
    return state._replace(cache_len=0)


def _read_start(start: int, size: int, dim: int) -> int:
    """The start JAX's ``dynamic_slice`` reads from: clamped so that the
    ``size`` rows fit in ``dim``."""
    return min(max(start, 0), dim - size)


def _check_write(what: str, start: int, size: int, dim: int) -> None:
    """A write JAX's ``dynamic_update_slice`` would clamp raises here."""
    if start + size > dim:
        raise ValueError(f"{what} holds {dim} rows; cannot write {size} at row {start}")


# =========================================================================
# Frontend
# =========================================================================

def _causal_conv(p: Conv1d, x_with_carry: torch.Tensor) -> torch.Tensor:
    """Valid conv over [carry + n, cin] -> [n, cout] (kernel CONV_K)."""
    return conv1d(p, x_with_carry[None], stride=1)[0]


@torch.inference_mode()
def frontend_step(model: StreamingMoonshine, cfg: StreamingConfig, chunk: torch.Tensor,
                  state: StreamingState) -> StreamingState:
    """Process ``n_frames * frame_len`` new samples (``chunk``, on the
    state's device) into ``n_frames`` feature rows of the state."""
    p = model.frontend
    n = chunk.shape[0] // cfg.frame_len
    _check_write("feats", state.feat_count, n, state.feats.shape[0])
    x = torch.cat([state.sample_ctx, chunk])  # [79 + 80n]
    # Overlapping 159-sample windows at stride 80 (a view).
    windows = x.unfold(0, SAMPLE_CTX + cfg.frame_len, cfg.frame_len)[:n]
    h = ACTIVATIONS["gelu"](dense(p.proj, windows))  # [n, d_model]
    h1_in = torch.cat([state.conv1_carry, h])  # [4 + n, d]
    h1 = ACTIVATIONS["gelu"](_causal_conv(p.conv1, h1_in))  # [n, c1]
    h2_in = torch.cat([state.conv2_carry, h1])
    h2 = ACTIVATIONS["gelu"](_causal_conv(p.conv2, h2_in))  # [n, c2]
    feats = layer_norm(p.norm, h2)
    state.feats[state.feat_count:state.feat_count + n] = feats.to(state.feats.dtype)
    return state._replace(
        sample_ctx=x[-SAMPLE_CTX:],
        conv1_carry=h1_in[-CONV_CARRY:],
        conv2_carry=h2_in[-CONV_CARRY:],
        frame_count=state.frame_count + n,
        feat_count=state.feat_count + n,
    )


# =========================================================================
# Encoder + adapter
# =========================================================================

def _encoder_layer(cfg: StreamingConfig, h, lp: EncoderLayer, cos, sin, mask):
    x = layer_norm(lp.ln1, h)
    a = lp.attn
    q = apply_rotary(_split_heads(dense(a.q, x)[None], cfg.nheads)[0], cos, sin)  # [W, H, hd]
    k = apply_rotary(_split_heads(dense(a.k, x)[None], cfg.nheads)[0], cos, sin)
    v = _split_heads(dense(a.v, x)[None], cfg.nheads)[0]
    o = _attention(q[None], k[None], v[None], mask)[0]
    h = h + dense(a.o, o.reshape(o.shape[0], -1))
    x = layer_norm(lp.ln2, h)
    return h + dense(lp.mlp.fc2, ACTIVATIONS["gelu"](dense(lp.mlp.fc1, x)))


def _sinusoid(pos: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    # log(10000) in float32, as JAX computes it; made on the device (a
    # tensor copied from the host would synchronise the stream).
    log_base = torch.full((), 10000.0, device=pos.device).log()
    freqs = torch.exp(-log_base * torch.arange(half, device=pos.device) / half)
    angles = pos.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


@torch.inference_mode()
def encode_step(model: StreamingMoonshine, cfg: StreamingConfig, state: StreamingState,
                n_new: int) -> StreamingState:
    """Re-encode the sliding window and append ``n_new`` (0 < n_new <=
    ENC_STEP) frames to memory and to the cross K/V.  The window is
    ``[enc_emitted - left_context, ...)`` clamped at 0, ENC_WIN frames,
    the frames past ``feat_count`` masked."""
    dev = state.feats.device
    win_start = max(state.enc_emitted - cfg.left_context_frames, 0)
    win_valid = min(state.feat_count - win_start, ENC_WIN)
    start = _read_start(win_start, ENC_WIN, state.feats.shape[0])
    h = dense(model.encoder.in_proj, state.feats[start:start + ENC_WIN])  # [ENC_WIN, e]

    positions = torch.arange(ENC_WIN, device=dev)
    cos, sin = rotary_tables(positions, cfg.head_dim - (cfg.head_dim % 2), cfg.rope_theta)
    mask = (positions < win_valid)[None, None, None, :]  # key mask
    for lp in model.encoder.layers:
        h = _encoder_layer(cfg, h, lp, cos, sin, mask)
    h = layer_norm(model.encoder.norm, h)

    # The newly stable frames, window-relative.  With a left context above
    # ENC_WIN - ENC_STEP frames (enc_depth > 8) this read clamps, as JAX's.
    rel = _read_start(state.enc_emitted - win_start, ENC_STEP, ENC_WIN)
    new_block = h[rel:rel + ENC_STEP]
    new_mask = torch.arange(ENC_STEP, device=dev) < n_new

    # Adapter: absolute sinusoidal position + projection.
    mem_new = dense(model.adapter.proj, new_block)
    pos = state.mem_len + torch.arange(ENC_STEP, device=dev)
    mem_new = mem_new + _sinusoid(pos, mem_new.shape[-1]).to(mem_new.dtype)
    mem_new = layer_norm(model.adapter.norm, mem_new)
    mem_new = torch.where(new_mask[:, None], mem_new, 0.0)

    m0 = state.mem_len
    _check_write("memory", m0, ENC_STEP, state.memory.shape[0])
    state.memory[m0:m0 + ENC_STEP] = mem_new.to(state.memory.dtype)
    # Incremental cross K/V of the new memory rows (a frame's K/V depends
    # on that frame only).
    for layer, lp in enumerate(model.decoder.layers):
        c = lp.cross_attn
        state.k_cross[layer, m0:m0 + ENC_STEP] = _split_heads(
            dense(c.k, mem_new)[None], cfg.nheads)[0].to(state.k_cross.dtype)
        state.v_cross[layer, m0:m0 + ENC_STEP] = _split_heads(
            dense(c.v, mem_new)[None], cfg.nheads)[0].to(state.v_cross.dtype)
    return state._replace(enc_emitted=state.enc_emitted + n_new, mem_len=m0 + n_new)


def encode(model: StreamingMoonshine, cfg: StreamingConfig, state: StreamingState,
           is_final: bool) -> tuple[StreamingState, int]:
    """Emit every newly stable frame (a host loop over ``encode_step``):
    all frames if ``is_final``, else all but ``total_lookahead``.  Returns
    (state, frames emitted)."""
    total = state.feat_count
    stable = total if is_final else max(0, total - cfg.total_lookahead)
    new = stable - state.enc_emitted
    if new <= 0:
        return state, 0
    emitted = 0
    while emitted < new:
        step = min(new - emitted, ENC_STEP)
        state = encode_step(model, cfg, state, step)
        emitted += step
    return state, new


# =========================================================================
# Decoder
# =========================================================================

MEM_BUCKETS = (512, 1024, 2048, MEM_CAP)


def mem_bucket_for(mem_len: int) -> int:
    """Smallest memory bucket covering ``mem_len`` frames: the decoder's
    cross-attention reads that many rows of the cross K/V, the rows past
    ``mem_len`` masked, as the JAX package's static buckets do."""
    for b in MEM_BUCKETS:
        if mem_len <= b:
            return b
    return MEM_CAP


@torch.inference_mode()
def decode_tokens(
    model: StreamingMoonshine,
    cfg: StreamingConfig,
    tokens: torch.Tensor,  # [s] token ids, on the state's device
    state: StreamingState,
    collect_attention: bool = False,
    mem_bucket: int = MEM_CAP,
) -> tuple[torch.Tensor, StreamingState, torch.Tensor | None]:
    """Run the decoder over ``s`` tokens from the cache position, writing
    their self K/V in place.  Returns (logits [s, vocab] float32, the state
    with ``cache_len`` advanced by s, cross-attention weights
    [L, H, s, mem_bucket] float32 or None)."""
    dec = model.decoder
    s = tokens.shape[0]
    dev = tokens.device
    cl = state.cache_len
    _check_write("the self cache", cl, s, state.k_self.shape[1])
    h = dec.embed[tokens]  # [s, d]
    positions = cl + torch.arange(s, device=dev)
    cos, sin = rotary_tables(positions, cfg.head_dim - (cfg.head_dim % 2), cfg.rope_theta)
    key_pos = torch.arange(cfg.max_seq_len, device=dev)
    self_mask = key_pos[None, None, None, :] <= positions[None, None, :, None]
    cross_mask = (torch.arange(mem_bucket, device=dev) < state.mem_len)[None, None, None, :]
    weights = []
    for layer, lp in enumerate(dec.layers):
        # Self-attention
        x = layer_norm(lp.ln1, h)
        a = lp.self_attn
        q = apply_rotary(_split_heads(dense(a.q, x)[None], cfg.nheads)[0], cos, sin)
        k_new = apply_rotary(_split_heads(dense(a.k, x)[None], cfg.nheads)[0], cos, sin)
        v_new = _split_heads(dense(a.v, x)[None], cfg.nheads)[0]
        k_l, v_l = state.k_self[layer], state.v_self[layer]
        k_l[cl:cl + s] = k_new.to(k_l.dtype)
        v_l[cl:cl + s] = v_new.to(v_l.dtype)
        o = _attention(q[None], k_l[None].to(q.dtype), v_l[None].to(q.dtype), self_mask)[0]
        h = h + dense(a.o, o.reshape(s, -1))
        # Cross-attention over memory
        x = layer_norm(lp.ln2, h)
        c = lp.cross_attn
        qc = _split_heads(dense(c.q, x)[None], cfg.nheads)[0]
        kc = state.k_cross[layer, :mem_bucket][None].to(qc.dtype)
        vc = state.v_cross[layer, :mem_bucket][None].to(qc.dtype)
        if collect_attention:
            oc, w = _attention(qc[None], kc, vc, cross_mask, with_weights=True)
            weights.append(w[0])
        else:
            oc = _attention(qc[None], kc, vc, cross_mask)
        h = h + dense(c.o, oc[0].reshape(s, -1))
        # SwiGLU MLP
        x = layer_norm(lp.ln3, h)
        hh, gate = torch.chunk(dense(lp.mlp.fc1, x), 2, dim=-1)
        h = h + dense(lp.mlp.fc2, ACTIVATIONS["silu"](gate) * hh)
    h = layer_norm(dec.norm, h)
    logits = h.float() @ dec.embed.float().t()
    cross_w = torch.stack(weights) if collect_attention else None
    return logits, state._replace(cache_len=cl + s), cross_w


def _greedy_continue(model, cfg: StreamingConfig, first_token: torch.Tensor,
                     state: StreamingState, budget: int,
                     mem_bucket: int = MEM_CAP) -> tuple[list[int], StreamingState]:
    """Greedy loop from ``first_token`` ([1], on the device) until EOS, a
    full cache or ``budget`` tokens; one host read per step (the stop
    test), and the next step's input stays on the device."""
    tokens: list[int] = []
    last = first_token
    while True:
        logits, state, _ = decode_tokens(model, cfg, last, state, mem_bucket=mem_bucket)
        last = logits[-1:].argmax(dim=-1)
        nxt = int(last)
        if nxt == cfg.eos_id:
            break
        tokens.append(nxt)
        if state.cache_len >= cfg.max_seq_len - 1 or len(tokens) >= budget:
            break
    return tokens, state


def decode_full_fused(
    model: StreamingMoonshine,
    cfg: StreamingConfig,
    state: StreamingState,
    draft: list[int],  # the previous hypothesis (no EOS)
    budget: int,  # token cap
    mem_bucket: int = MEM_CAP,
) -> tuple[list[int], StreamingState]:
    """Verify + rollback + greedy continuation: the JAX package's one
    device program, here one verify pass, one host read for the first
    divergence and its correction, then the greedy loop (one read a step).
    The draft goes to the device once, before the loop.  Returns (tokens,
    state).

    The JAX program verifies its whole [max_seq_len] draft buffer; the
    positions past ``min(len(draft), budget)`` cannot change the result
    (the decoder is causal and they are never accepted), so the port
    verifies only the draft it can accept.
    """
    state = decoder_reset(state)
    dev = state.k_self.device
    draft = list(draft)[:max(min(budget, cfg.max_seq_len - 2), 0)]
    seq = torch.tensor([cfg.bos_id] + draft, dtype=torch.long, device=dev)
    logits, vstate, _ = decode_tokens(model, cfg, seq, state, mem_bucket=mem_bucket)
    preds = logits.argmax(dim=-1)  # [len(draft) + 1]
    d = seq[1:]
    agree = (preds[:-1] == d) & (d != cfg.eos_id)
    # First position where agreement fails (== number of accepted tokens).
    n_accept = torch.argmin(torch.cat([agree, agree.new_zeros(1)]).int())
    n_accept, corr = torch.stack([n_accept, preds[n_accept]]).tolist()
    tokens = draft[:n_accept]
    # The cache holds [bos, d0..d_{n_accept-1}]; the continuation consumes
    # the correction itself (writing its K/V at 1 + n_accept).
    state = vstate._replace(cache_len=1 + n_accept)
    if corr == cfg.eos_id or n_accept >= budget:
        return tokens, state
    tokens.append(corr)
    if len(tokens) >= budget:
        return tokens, state
    more, state = _greedy_continue(model, cfg, preds[n_accept:n_accept + 1], state,
                                   budget - len(tokens), mem_bucket)
    return tokens + more, state


def decode_full(
    model: StreamingMoonshine,
    cfg: StreamingConfig,
    state: StreamingState,
    speculative_tokens: list[int] | None = None,
    max_tokens: int | None = None,
) -> tuple[list[int], StreamingState]:
    """Full decode with speculative verification (the host-side form).

    With ``speculative_tokens`` (the previous pass's hypothesis), one
    decoder pass verifies the whole draft; decoding continues from the
    first divergence with the cache rolled back by index.  Otherwise greedy
    from BOS.
    """
    state = decoder_reset(state)
    cap = cfg.max_seq_len - 2
    max_tokens = min(max_tokens or cap, cap)
    dev = state.k_self.device
    mem_bucket = mem_bucket_for(state.mem_len)
    draft = [t for t in (speculative_tokens or []) if t != cfg.eos_id][:max_tokens]
    accepted: list[int] = []
    if draft:
        seq = torch.tensor([cfg.bos_id] + draft, device=dev)
        logits, vstate, _ = decode_tokens(model, cfg, seq, state, mem_bucket=mem_bucket)
        preds = logits.argmax(dim=-1).tolist()
        n_match = 0
        for i, d in enumerate(draft):
            if preds[i] != d:
                break
            n_match += 1
        accepted = draft[:n_match]
        next_token = preds[n_match]  # first diverging prediction
        state = vstate._replace(cache_len=1 + n_match)  # roll back
        if next_token == cfg.eos_id or len(accepted) >= max_tokens:
            return accepted, state
        budget = max_tokens - len(accepted) - 1
        accepted.append(next_token)
    else:
        bos = torch.tensor([cfg.bos_id], device=dev)
        logits, state, _ = decode_tokens(model, cfg, bos, state, mem_bucket=mem_bucket)
        next_token = int(logits[-1].argmax())
        if next_token == cfg.eos_id:
            return [], state
        accepted.append(next_token)
        budget = max_tokens - 1
    if budget > 0:
        start = torch.tensor([next_token], device=dev)
        more, state = _greedy_continue(model, cfg, start, state, budget, mem_bucket)
        accepted.extend(more)
    return accepted, state
