"""Multi-stream batched streaming, in PyTorch: one update for all streams.

Counterpart of the JAX package's ``models/streaming_batch.py``.  The state
of every stream carries a leading stream axis, and each phase of an update
runs once, batched over the streams:

    masked frontend ingest -> windowed encode -> adapter and cross K/V
    -> speculative verify -> greedy continuation over all lanes

Per-stream control (segment resets, final flags, new frame counts, token
budgets, drafts) comes in as tensors, and the cursors (``feat_count``,
``enc_emitted``, ``mem_len``, ``cache_len``, ...) live on the device as in
JAX, so an update reads the device only for the greedy loop's stop test,
once a step.  Every ``dynamic_slice`` and ``dynamic_update_slice`` of the
JAX program at a per-stream offset is a gather or a scatter here, its
start clamped as XLA clamps it, ``clamp(offset, 0, dim - size)``: a read
or a write that would run past its buffer starts earlier instead, over
rows the buffer already holds (the write past ``mem_bucket`` rows of a
long segment does so).  Masked streams still write as JAX's do: each
encode writes a whole ``ENC_STEP`` block (zero rows past ``n_new``) and
its cross K/V, and a finished lane of the greedy loop writes its K/V at
its unchanged ``cache_len``.

The state's bulk buffers (features, memory, the four KV caches and their
scales) are written in place (JAX donates the state to the same end); the
small fields are new tensors each update.  KV caches are layer-major and
dim-major, ``[L, S, H, hd, T]``, with per-column int8 scales ``[L, S, H,
T]`` in the ``kv_int8`` mode.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from .. import profiling
from ..core.config import StreamingConfig
from ..core.device import resolve_device
from ..ops.int8_kv import (KV_WRITE_LAUNCHES, Q8_LAUNCHES, LayerKV, RowStarts, attend_kv,
                           dequantize_kv, layer_kv, write_kv)
from ..ops.rotary import apply_rotary, rotary_tables
from .layers import ACTIVATIONS, conv1d, dense, layer_norm
from .moonshine import _split_heads
from .streaming import (
    CONV_CARRY,
    ENC_STEP,
    ENC_WIN,
    FEAT_CAP,
    MEM_CAP,
    SAMPLE_CTX,
    StreamingMoonshine,
    StreamingState,
    _encoder_layer,
    _sinusoid,
)

# Default static caps for the service (tunable per deployment).
DRAFT_CAP = 256  # verified draft tokens per update (about 19 s at 13 tok/s)


def cast_params(model: StreamingMoonshine, dtype: torch.dtype) -> StreamingMoonshine:
    """The model with its encoder, adapter and decoder cast to ``dtype``;
    the frontend stays float32 (its per-channel dynamic range is extreme),
    int8 ``w_q`` stays int8 and float32 ``w_scale`` stays float32 (the
    w8a8 dequantization uses float32 scales).  Returns ``model`` itself
    when nothing would change, so that services sharing a cast model share
    its tensors."""
    parts = (model.encoder, model.adapter, model.decoder)

    def needs_cast(name: str, p: torch.Tensor) -> bool:
        return p.is_floating_point() and not name.endswith("w_scale") and p.dtype != dtype

    if not any(needs_cast(n, p) for m in parts for n, p in m.named_parameters()):
        return model
    cast = []
    for module in parts:
        module = copy.deepcopy(module)
        for name, p in module.named_parameters():
            if needs_cast(name, p):
                p.data = p.data.to(dtype)
        cast.append(module)
    return StreamingMoonshine(model.frontend, *cast)


# KV fields live in layer-major, dim-major layout [L, S, H, hd, T]; the
# per-key-column int8 scales (None when the caches are float) in [L, S, H, T].
_KV_FIELDS = ("k_cross", "v_cross", "k_self", "v_self")
_KV_SCALE_FIELDS = ("k_cross_scale", "v_cross_scale", "k_self_scale", "v_self_scale")


class BatchedStreamingState(NamedTuple):
    """StreamingState with a stream axis (KV caches layer/dim-major); the
    cursors are int32 tensors on the state's device."""

    sample_ctx: torch.Tensor  # [S, 79] f32
    conv1_carry: torch.Tensor  # [S, 4, d_model_frontend] f32
    conv2_carry: torch.Tensor  # [S, 4, c1] f32
    frame_count: torch.Tensor  # [S]
    feats: torch.Tensor  # [S, FEAT_CAP, c2]
    feat_count: torch.Tensor  # [S]
    enc_emitted: torch.Tensor  # [S]
    memory: torch.Tensor  # [S, mem_cap, decoder_dim]
    mem_len: torch.Tensor  # [S]
    k_cross: torch.Tensor  # [L, S, H, hd, mem_cap]
    v_cross: torch.Tensor
    k_self: torch.Tensor  # [L, S, H, hd, max_seq_len]
    v_self: torch.Tensor
    cache_len: torch.Tensor  # [S]
    k_cross_scale: torch.Tensor | None = None  # [L, S, H, mem_cap] f32
    v_cross_scale: torch.Tensor | None = None
    k_self_scale: torch.Tensor | None = None  # [L, S, H, max_seq_len] f32
    v_self_scale: torch.Tensor | None = None


def init_batch_state(
    cfg: StreamingConfig,
    n_streams: int,
    dtype: torch.dtype = torch.float32,
    mem_cap: int = MEM_CAP,
    kv_int8: bool = False,
    device: str | torch.device | None = None,
) -> BatchedStreamingState:
    """A zeroed state on ``device`` (CUDA unless named).  ``dtype`` applies
    to features, memory and float KV; the frontend carries stay float32;
    ``kv_int8`` stores the four KV caches as int8 with per-key-column
    scales."""
    dev = resolve_device(device)
    L, H, hd = cfg.depth, cfg.nheads, cfg.head_dim
    kv_dtype = torch.int8 if kv_int8 else dtype

    def z(*shape, dt=dtype):
        return torch.zeros((n_streams, *shape), dtype=dt, device=dev)

    def zkv(t):
        return torch.zeros((L, n_streams, H, hd, t), dtype=kv_dtype, device=dev)

    def zs(t):
        return torch.zeros((L, n_streams, H, t), dtype=torch.float32, device=dev) \
            if kv_int8 else None

    def zi():
        return torch.zeros((n_streams,), dtype=torch.int32, device=dev)

    f32 = torch.float32
    return BatchedStreamingState(
        sample_ctx=z(SAMPLE_CTX, dt=f32), conv1_carry=z(CONV_CARRY, cfg.d_model_frontend, dt=f32),
        conv2_carry=z(CONV_CARRY, cfg.c1, dt=f32), frame_count=zi(),
        feats=z(FEAT_CAP, cfg.c2), feat_count=zi(), enc_emitted=zi(),
        memory=z(mem_cap, cfg.decoder_dim), mem_len=zi(),
        k_cross=zkv(mem_cap), v_cross=zkv(mem_cap),
        k_self=zkv(cfg.max_seq_len), v_self=zkv(cfg.max_seq_len), cache_len=zi(),
        k_cross_scale=zs(mem_cap), v_cross_scale=zs(mem_cap),
        k_self_scale=zs(cfg.max_seq_len), v_self_scale=zs(cfg.max_seq_len),
    )


def _single(state: BatchedStreamingState, s: int) -> StreamingState:
    """Stream ``s`` as a single-stream StreamingState (a testing aid): the
    KV caches back in the sequence-major [L, T, H, hd] layout, int8 caches
    dequantized to float32, the cursors host integers."""
    vals = {}
    for name, x in zip(BatchedStreamingState._fields, state):
        if name in _KV_SCALE_FIELDS:
            continue
        if name in _KV_FIELDS:
            kv = x[:, s]  # [L, H, hd, T]
            scale = getattr(state, name + "_scale")
            if scale is not None:
                kv = dequantize_kv(kv, scale[:, s])
            vals[name] = kv.permute(0, 3, 1, 2)
        elif x.dim() == 1:
            vals[name] = int(x[s])
        else:
            vals[name] = x[s]
    return StreamingState(**vals)


# Buffers a reset does NOT need to zero: every read is masked or sliced by
# the cursors the reset does clear (feat_count, enc_emitted, mem_len,
# per-tick cache_len): cross attention masks keys by mem_len, the windowed
# encode masks by win_valid and reads only the rows it then writes, the
# decoder's self caches are rewritten from position 0 each update, and
# memory and feats append at their cursors before any read.
_RESET_SKIP_FIELDS = _KV_FIELDS + _KV_SCALE_FIELDS + ("memory", "feats")


def _mask_reset(state: BatchedStreamingState, reset: torch.Tensor) -> BatchedStreamingState:
    """Zero the control state (cursors, frontend carries, sample context)
    of the streams flagged in ``reset`` [S] bool; the bulk buffers keep
    their stale contents, unreachable once the cursors are zero."""

    def f(name, x):
        if x is None or name in _RESET_SKIP_FIELDS:
            return x
        m = reset.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, torch.zeros_like(x), x)

    return BatchedStreamingState(*[f(n, x) for n, x in zip(BatchedStreamingState._fields, state)])


# -- per-stream offsets ------------------------------------------------------

def _rows(start: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """[S, size] indices of the ``size`` rows from ``start`` [S], the start
    clamped to [0, dim - size] as XLA clamps a dynamic slice's."""
    start = start.long().clamp(0, dim - size)
    return start[:, None] + torch.arange(size, device=start.device)


def _read(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Per-stream ``dynamic_slice`` of ``size`` rows along axis 1 of x [S, T, ...]."""
    rows = _rows(start, size, x.shape[1])
    return x.gather(1, rows.reshape(rows.shape + (1,) * (x.dim() - 2)).expand(
        (-1, -1) + x.shape[2:]))


def _write(buf: torch.Tensor, start: torch.Tensor, val: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-stream ``dynamic_update_slice`` in place: ``val``'s extent along
    axis ``dim`` of ``buf`` (the stream axis first) written from ``start``.
    Returns ``buf``."""
    size = val.shape[dim]
    rows = _rows(start, size, buf.shape[dim])  # [S, size]
    shape = [1] * buf.dim()
    shape[0], shape[dim] = rows.shape
    return buf.scatter_(dim, rows.reshape(shape).expand(val.shape), val.to(buf.dtype))


# -- masked frontend: F padded frames per stream, n_valid real ----------------

def _frontend(model: StreamingMoonshine, cfg: StreamingConfig, state: BatchedStreamingState,
              chunk: torch.Tensor, n_valid: torch.Tensor) -> BatchedStreamingState:
    """Frontend over every stream's F padded frames.  Causality makes
    partial progress safe: frame i depends only on samples <= (i+1)*80, so
    rows >= n_valid are garbage that the advancing write cursor overwrites
    on the next update; the carries roll forward by exactly n_valid
    frames."""
    p = model.frontend
    F = chunk.shape[1] // cfg.frame_len
    x = torch.cat([state.sample_ctx, chunk.float()], dim=1)  # [S, 79 + 80F]
    windows = x.unfold(1, SAMPLE_CTX + cfg.frame_len, cfg.frame_len)[:, :F]  # [S, F, 159]
    h = ACTIVATIONS["gelu"](dense(p.proj, windows))  # [S, F, d]
    h1_in = torch.cat([state.conv1_carry, h], dim=1)  # [S, 4+F, d]
    h1 = ACTIVATIONS["gelu"](conv1d(p.conv1, h1_in, stride=1))  # [S, F, c1]
    h2_in = torch.cat([state.conv2_carry, h1], dim=1)
    h2 = ACTIVATIONS["gelu"](conv1d(p.conv2, h2_in, stride=1))
    out = layer_norm(p.norm, h2)  # [S, F, c2]
    _write(state.feats, state.feat_count, out, 1)
    n_valid = n_valid.to(state.feat_count.dtype)
    return state._replace(
        sample_ctx=_read(x, n_valid.long() * cfg.frame_len, SAMPLE_CTX),
        conv1_carry=_read(h1_in, n_valid, CONV_CARRY),
        conv2_carry=_read(h2_in, n_valid, CONV_CARRY),
        feat_count=state.feat_count + n_valid,
        frame_count=state.frame_count + n_valid,
    )


# -- encoder window + adapter + incremental cross K/V -------------------------

def _encode(model: StreamingMoonshine, cfg: StreamingConfig, state: BatchedStreamingState,
            n_new: torch.Tensor) -> BatchedStreamingState:
    """One ENC_STEP window re-encode of every stream; appends n_new [S]
    (0 <= n_new <= ENC_STEP) frames to memory and to the cross K/V."""
    dev = n_new.device
    win_start = torch.clamp(state.enc_emitted - cfg.left_context_frames, min=0)
    win_valid = torch.clamp(state.feat_count - win_start, max=ENC_WIN)
    h = dense(model.encoder.in_proj, _read(state.feats, win_start, ENC_WIN))  # [S, W, e]

    positions = torch.arange(ENC_WIN, device=dev)
    cos, sin = rotary_tables(positions, cfg.head_dim - (cfg.head_dim % 2), cfg.rope_theta)
    mask = (positions[None, :] < win_valid[:, None])[:, None, None, :]  # [S, 1, 1, W]
    for lp in model.encoder.layers:
        h = _encoder_layer(cfg, h, lp, cos, sin, mask)
    h = layer_norm(model.encoder.norm, h)

    # The newly stable frames, window-relative: rel = min(enc_emitted,
    # left); with a left context above ENC_WIN - ENC_STEP frames
    # (enc_depth > 8) the read clamps, as JAX's does.
    new_block = _read(h, state.enc_emitted - win_start, ENC_STEP)  # [S, 128, e]
    block_idx = torch.arange(ENC_STEP, device=dev)
    new_mask = block_idx[None, :] < n_new[:, None]
    mem_new = dense(model.adapter.proj, new_block)
    pos = state.mem_len[:, None] + block_idx
    mem_new = mem_new + _sinusoid(pos, mem_new.shape[-1]).to(mem_new.dtype)
    mem_new = layer_norm(model.adapter.norm, mem_new)
    mem_new = torch.where(new_mask[..., None], mem_new, 0.0)
    _write(state.memory, state.mem_len, mem_new, 1)

    for layer, lp in enumerate(model.decoder.layers):
        c = lp.cross_attn
        # [S, 128, H, hd] -> dim-major [S, H, hd, 128].
        k = _split_heads(dense(c.k, mem_new), cfg.nheads).permute(0, 2, 3, 1)
        v = _split_heads(dense(c.v, mem_new), cfg.nheads).permute(0, 2, 3, 1)
        write_kv(layer_kv(state, "cross", layer), k, v, RowStarts(state.mem_len))
    n_new = n_new.to(state.mem_len.dtype)
    return state._replace(mem_len=state.mem_len + n_new, enc_emitted=state.enc_emitted + n_new)


# -- batched decoder step (shared by verify and continue) ----------------------

def _decode_step_batch(
    model: StreamingMoonshine,
    cfg: StreamingConfig,
    tokens: torch.Tensor,  # [S, s]
    cache_len: torch.Tensor,  # [S]
    state: BatchedStreamingState,
    mem_bucket: int,
) -> torch.Tensor:
    """The decoder over s tokens of every stream, from each stream's
    ``cache_len``; writes their self K/V into the state's caches in place
    and reads the first ``mem_bucket`` columns of the cross K/V.  Returns
    float32 logits [S, s, vocab]."""
    dec = model.decoder
    S, s = tokens.shape
    dev = tokens.device
    cols = RowStarts(cache_len)
    h = dec.embed[tokens.long()]  # [S, s, d]
    positions = cache_len[:, None].long() + torch.arange(s, device=dev)  # [S, s]
    # Per-stream tables [S, s, half] (JAX: a vmap of apply_rotary).
    cos, sin = rotary_tables(positions, cfg.head_dim - (cfg.head_dim % 2), cfg.rope_theta)
    key_pos = torch.arange(cfg.max_seq_len, device=dev)
    self_mask = key_pos[None, None, None, :] <= positions[:, None, :, None]  # [S, 1, s, T]
    mem_pos = torch.arange(mem_bucket, device=dev)
    cross_mask = (mem_pos[None, :] < state.mem_len[:, None])[:, None, None, :]  # [S, 1, 1, M]
    for layer, lp in enumerate(dec.layers):
        x = layer_norm(lp.ln1, h)
        a = lp.self_attn
        q = apply_rotary(_split_heads(dense(a.q, x), cfg.nheads), cos, sin)  # [S, s, H, hd]
        k_new = apply_rotary(_split_heads(dense(a.k, x), cfg.nheads), cos, sin).permute(0, 2, 3, 1)
        v_new = _split_heads(dense(a.v, x), cfg.nheads).permute(0, 2, 3, 1)  # [S, H, hd, s]
        o = attend_kv(q, write_kv(layer_kv(state, "self", layer), k_new, v_new, cols), self_mask)
        h = h + dense(a.o, o.reshape(S, s, -1))
        x = layer_norm(lp.ln2, h)
        c = lp.cross_attn
        qc = _split_heads(dense(c.q, x), cfg.nheads)
        cross = LayerKV(*(t if t is None else t[..., :mem_bucket]
                          for t in layer_kv(state, "cross", layer)))
        oc = attend_kv(qc, cross, cross_mask)
        h = h + dense(c.o, oc.reshape(S, s, -1))
        x = layer_norm(lp.ln3, h)
        hh, gate = torch.chunk(dense(lp.mlp.fc1, x), 2, dim=-1)
        h = h + dense(lp.mlp.fc2, ACTIVATIONS["silu"](gate) * hh)
    h = layer_norm(dec.norm, h)
    return h.float() @ dec.embed.float().t()


# -- the service update ----------------------------------------------------------

class ServiceUpdateOut(NamedTuple):
    tokens: torch.Tensor  # [S, max_seq_len] int32, EOS-padded hypotheses
    counts: torch.Tensor  # [S] int32
    state: BatchedStreamingState
    # tokens || count [S, max_seq_len + 1]: one host read fetches both.
    packed: torch.Tensor | None = None
    # [S] int32 draft tokens the verify accepted (not read by the service,
    # which finds the same count on the host).
    n_accept: torch.Tensor | None = None


def _with_packed(out: ServiceUpdateOut) -> ServiceUpdateOut:
    return out._replace(packed=torch.cat([out.tokens, out.counts[:, None]], dim=1))


@torch.no_grad()
def service_update(
    model: StreamingMoonshine,
    cfg: StreamingConfig,
    state: BatchedStreamingState,
    chunk: torch.Tensor,  # [S, F*frame_len] padded new segment samples
    n_frames: torch.Tensor,  # [S] valid new frames per stream
    reset: torch.Tensor,  # [S] bool: reset the stream before ingesting (new segment)
    is_final: torch.Tensor,  # [S] bool: segment ended; release the lookahead
    draft: torch.Tensor,  # [S, draft_cap] EOS-padded previous hypotheses
    draft_len: torch.Tensor,  # [S]
    budget: torch.Tensor,  # [S] token caps
    decode_mask: torch.Tensor,  # [S] bool: streams that decode this update
    mem_bucket: int = 2048,
    draft_cap: int = DRAFT_CAP,
    enc_passes: int = 2,
    decode: bool = True,
) -> ServiceUpdateOut:
    """Reset + frontend + encode + decode for S streams.  Masked streams
    still pay the padded compute; their outputs are ignored and their
    cursors advance by zero."""
    return _with_packed(_service_update_impl(
        model, cfg, state, chunk, n_frames, reset, is_final, draft, draft_len, budget,
        decode_mask, mem_bucket, draft_cap, enc_passes, decode))


@torch.no_grad()
def service_update_meta(
    model: StreamingMoonshine,
    cfg: StreamingConfig,
    state: BatchedStreamingState,
    chunk: torch.Tensor,  # [S, F*frame_len]
    meta: torch.Tensor,  # [6, S] int32 control plane, see below
    draft: torch.Tensor,  # [S, draft_cap]
    mem_bucket: int = 2048,
    draft_cap: int = DRAFT_CAP,
    enc_passes: int = 2,
    decode: bool = True,
    decode_mem_bucket: int | None = None,
    span: profiling.Span | None = None,
) -> ServiceUpdateOut:
    """:func:`service_update` with a one-tensor control plane: ``meta``'s
    rows are (n_frames, reset, is_final, draft_len, budget, decode_mask),
    one host-to-device copy per update instead of six.  ``span``, the
    service update's (its ``decoder_calls``, ``read_ns`` and
    ``q8_launches`` and ``kv_write_launches`` set to 0 when it opened),
    counts the call's decoder calls, blocked reads, K5 launches and K7
    launches, and holds its fine spans (``service.ingest``,
    ``service.verify``, ``service.step``, ``service.read``)."""
    return _with_packed(_service_update_impl(
        model, cfg, state, chunk, meta[0], meta[1] != 0, meta[2] != 0, draft, meta[3],
        meta[4], meta[5] != 0, mem_bucket, draft_cap, enc_passes, decode, decode_mem_bucket,
        span))


_SPAN_LAUNCHES = {"q8_launches": Q8_LAUNCHES, "kv_write_launches": KV_WRITE_LAUNCHES}


def _launch_counts() -> dict:
    return {attr: profiling.counter(c) for attr, c in _SPAN_LAUNCHES.items()}


def _count_launches(span: profiling.Span | None, before: dict) -> None:
    """Add the K5 and K7 launches since ``before`` to the span's counts."""
    if span is not None:
        for attr, c in _SPAN_LAUNCHES.items():
            span.attrs[attr] += profiling.counter(c) - before[attr]


def _service_update_impl(model, cfg: StreamingConfig, state: BatchedStreamingState,
                         chunk, n_frames, reset, is_final, draft, draft_len, budget,
                         decode_mask, mem_bucket: int, draft_cap: int, enc_passes: int,
                         decode: bool, decode_mem_bucket: int | None = None,
                         span: profiling.Span | None = None) -> ServiceUpdateOut:
    # The decode phases (verify, greedy continuation) read only the first
    # decode_mem_bucket columns of the cross caches; the caller guarantees
    # that every stream's memory fits there after this update's encode.
    dmb = mem_bucket if decode_mem_bucket is None else min(decode_mem_bucket, mem_bucket)
    launched = _launch_counts()
    ingest = profiling.child("service.ingest", span)
    state = _mask_reset(state, reset)
    state = _frontend(model, cfg, state, chunk, n_frames)

    # Stable-frame arithmetic on the device.
    lookahead = torch.where(is_final, 0, cfg.total_lookahead).to(state.feat_count.dtype)
    for _ in range(enc_passes):
        stable = torch.clamp(state.feat_count - lookahead, min=0)
        n_new = torch.clamp(stable - state.enc_emitted, 0, ENC_STEP)
        state = _encode(model, cfg, state, n_new)
    profiling.end(ingest)

    S = chunk.shape[0]
    dev = chunk.device
    eos = cfg.eos_id
    i32 = torch.int32
    if not decode:
        _count_launches(span, launched)
        return ServiceUpdateOut(
            tokens=torch.full((S, cfg.max_seq_len), eos, dtype=i32, device=dev),
            counts=torch.zeros((S,), dtype=i32, device=dev), state=state)

    # ---- speculative verify (decoder reset: self cache from position 0) ----
    verify = profiling.child("service.verify", span)
    draft = draft[:, :draft_cap].to(i32)
    zero_len = torch.zeros((S,), dtype=i32, device=dev)
    seq = torch.cat([torch.full((S, 1), cfg.bos_id, dtype=i32, device=dev), draft], dim=1)
    logits = _decode_step_batch(model, cfg, seq, zero_len, state, dmb)
    preds = logits.argmax(dim=-1).to(i32)  # [S, 1 + draft_cap]; the first maximum, as JAX

    idx = torch.arange(draft_cap, device=dev)[None, :]
    eff_budget = torch.where(decode_mask, budget, 0).to(i32)
    valid = idx < torch.minimum(draft_len.to(i32), eff_budget)[:, None]
    agree = (preds[:, :draft_cap] == draft) & valid & (draft != eos)
    n_accept = torch.argmin(
        torch.cat([agree, torch.zeros((S, 1), dtype=torch.bool, device=dev)], dim=1).to(i32),
        dim=1).to(i32)  # [S]: the first disagreement
    correction = preds.gather(1, n_accept[:, None].long())[:, 0]

    max_seq = cfg.max_seq_len
    out_idx = torch.arange(max_seq, device=dev)[None, :]
    draft_pad = torch.cat(
        [draft, torch.full((S, max_seq - draft_cap), eos, dtype=i32, device=dev)], dim=1)
    tokens = torch.where(out_idx < n_accept[:, None], draft_pad, eos)
    corr_is_token = (correction != eos) & (n_accept < eff_budget) & decode_mask
    tokens = torch.where((out_idx == n_accept[:, None]) & corr_is_token[:, None],
                         correction[:, None], tokens).to(i32)
    count = n_accept + corr_is_token.to(i32)
    cache_len = 1 + n_accept  # [bos, accepted...]
    done = ~corr_is_token | (count >= eff_budget)
    last = correction
    calls, st = 1, verify  # st: the span whose read decides whether a step follows

    # ---- greedy continuation over all lanes: one host read a step ----------
    while True:
        more = profiling.timed_read(lambda: bool((~done).any()), span, "service.read", st)
        profiling.end(st)
        if not more:
            break
        st = profiling.child("service.step", span)
        lg = _decode_step_batch(model, cfg, last[:, None], cache_len, state, dmb)
        nxt = lg[:, -1].argmax(dim=-1).to(i32)
        act = ~done
        is_eos = nxt == eos
        cache_full = cache_len + 1 >= max_seq - 1
        write = act & ~is_eos
        tokens = torch.where((out_idx == count[:, None]) & write[:, None], nxt[:, None], tokens)
        count = count + write.to(i32)
        done = done | is_eos | cache_full | (count >= eff_budget)
        # Finished lanes keep their cursors: their K/V write landed at the
        # unchanged cache_len row and is voided by not advancing.
        cache_len = torch.where(act, cache_len + 1, cache_len)
        last = torch.where(act, nxt, last)
        calls += 1
    if span is not None:
        span.attrs["decoder_calls"] += calls
    _count_launches(span, launched)
    return ServiceUpdateOut(tokens=tokens, counts=count, state=state._replace(cache_len=cache_len),
                            n_accept=n_accept)
