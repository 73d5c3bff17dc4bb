"""Batched beam search over the KV-cached decoder, in PyTorch.

Counterpart of the JAX package's ``decoding/beam.py``.  Beams are
flattened into the batch axis, so every step is one decoder call over
``B*K`` rows, and the self-KV caches are reordered by parent along that
axis on the device.  JAX runs the loop as one ``lax.while_loop``; here it
is a Python loop of eager steps that stops once every beam has finished
(one host sync per step, as in ``decoding/greedy.py``).

Finished beams stay in the active set with frozen scores: their only
continuation is EOS at log-prob 0 (every other token at -1e9), so top-k
keeps or drops them against live hypotheses.  The best beam is chosen by
the Google-NMT length-normalised score ``score / ((5+len)/6)**alpha``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import MoonshineArchConfig
from ..models import moonshine as mm
from ..ops.beam_gather import _gather_rows_torch, gather_kv_rows, gather_scale_rows

NEG_INF = -1e9
GATHER_IMPLS = ("auto", "xla")
_LOW32 = (1 << 32) - 1


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_tokens] int64, best beam, EOS-padded
    lengths: torch.Tensor  # [B] int64
    scores: torch.Tensor  # [B] float32 normalised log-prob of the best beam
    # (_search gives every beam: [B, K, max_tokens], [B, K] and [B, K])
    steps: int  # decode steps after the first expansion: one cache reorder each


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of a float32 ``[R, C]`` tensor:
    values in descending order, the lower index first among equal values.

    ``torch.topk`` promises no order among equal values (on CUDA it varies),
    and beam search meets exact ties.  So each entry becomes one int64 key,
    its value's bits mapped to an order-preserving int32 in the high half
    and the complement of its column in the low half: every key differs,
    and the key order is JAX's order.
    """
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"top_k takes a float32 [R, C] tensor; got {x.dtype} {tuple(x.shape)}")
    bits = x.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()  # float order as int
    cols = torch.arange(x.shape[1], device=x.device)
    keys = ordered * (1 << 32) + (_LOW32 - cols)
    idx = _LOW32 - (keys.topk(k, dim=-1, sorted=True).values & _LOW32)
    return x.gather(1, idx), idx


def _reorder(cache: mm.DecoderCache, parent: torch.Tensor, gather_impl: str) -> mm.DecoderCache:
    """The self caches (and their int8 scales) with row ``n`` taken from
    row ``parent[n]``, as fresh tensors."""
    int8 = cache.k_self_scale is not None
    # "xla", the JAX package's jnp.take branch, is the kernels' plain version.
    kv, scale = ((gather_kv_rows, gather_scale_rows) if gather_impl == "auto"
                 else (_gather_rows_torch, _gather_rows_torch))
    k_self, v_self = kv(cache.k_self, cache.v_self, parent)
    if int8:
        ks, vs = scale(cache.k_self_scale, cache.v_self_scale, parent)
    cache = cache._replace(k_self=k_self, v_self=v_self)
    if int8:
        cache = cache._replace(k_self_scale=ks, v_self_scale=vs)
    return cache


@torch.inference_mode()
def _search(
    model: mm.Moonshine,
    cfg: MoonshineArchConfig,
    memory: torch.Tensor,  # [B, T, D]
    memory_mask: torch.Tensor,  # [B, T] bool
    beam_size: int = 4,
    max_tokens: int = 64,
    length_penalty: float = 0.6,
    token_caps: torch.Tensor | None = None,  # [B]
    gather_impl: str = "auto",  # "auto": ops/beam_gather (the CUDA kernels on
    # CUDA tensors, their plain versions on CPU tensors); "xla": index_select
    kv_int8: bool = False,  # int8 KV caches (ops/int8_kv.py); the parent
    # reorder then also gathers the per-column scale arrays
) -> BeamResult:
    """Every beam at the end of the search: tokens [B, K, max_tokens],
    lengths [B, K] and length-normalised scores [B, K]."""
    if gather_impl not in GATHER_IMPLS:
        raise ValueError(f"gather_impl must be one of {GATHER_IMPLS}, got {gather_impl!r}")
    b = memory.shape[0]
    k = beam_size
    bk = b * k
    dev = memory.device
    dec = model.decoder
    eos = cfg.eos_token_id
    vocab = cfg.vocab_size

    # The cross caches stay at B rows: the K beams of an utterance share its
    # memory, and decoder_apply(beam_k=k) folds them into the query axis.
    # Only the self caches hold one row per beam.
    k_cross, v_cross = mm.compute_cross_kv(dec, cfg, memory)
    cache = mm.init_cache(cfg, bk, max_tokens + 1, k_cross, v_cross, memory_mask,
                          dtype=memory.dtype, kv_int8=kv_int8)
    if token_caps is None:
        caps = torch.full((b,), max_tokens, dtype=torch.long, device=dev)
    else:
        caps = torch.clamp(torch.as_tensor(token_caps, device=dev).long(), max=max_tokens)
    caps = caps[:, None]  # [B, 1], against [B, K]

    bos = torch.full((bk, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    logits, cache, _ = mm.decoder_apply(dec, cfg, bos, cache, beam_k=k)
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [B*K, V]
    # Initial expansion: the top-k distinct first tokens of beam 0 (all
    # beams are identical so far).
    scores, last = top_k(logp0.reshape(b, k, vocab)[:, 0], k)  # [B, K]

    tokens = torch.full((b, k, max_tokens), eos, dtype=torch.long, device=dev)
    tokens[:, :, 0] = last
    finished = (last == eos) | (caps <= 0)
    lengths = (~finished).long()

    # Per-step tables, made on the card once: a host-made tensor inside the
    # loop would wait for the stream at every step.
    eos_only = torch.full((vocab,), NEG_INF, device=dev)
    eos_only[eos] = 0.0
    row_base = torch.arange(b, device=dev)[:, None] * k  # [B, 1]
    step = 1
    while step < max_tokens and not bool(finished.all()):
        logits, cache, _ = mm.decoder_apply(dec, cfg, last.reshape(bk, 1), cache, beam_k=k)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(b, k, vocab)
        # Finished beams: only EOS, at log-prob 0 (the score stays frozen).
        logp = torch.where(finished[:, :, None], eos_only, logp)
        cand = (scores[:, :, None] + logp).reshape(b, k * vocab)
        scores, idx = top_k(cand, k)  # [B, K]
        parent = idx // vocab
        token = idx % vocab

        tokens = tokens.gather(1, parent[:, :, None].expand(b, k, max_tokens))
        lengths = lengths.gather(1, parent)
        was_finished = finished.gather(1, parent)
        cache = _reorder(cache, (row_base + parent).reshape(bk), gather_impl)

        is_eos = token == eos
        keep = ~was_finished & ~is_eos
        tokens[:, :, step] = torch.where(keep, token, eos)
        lengths = lengths + keep.long()
        finished = was_finished | is_eos | (lengths >= caps)
        last = torch.where(finished, eos, token)
        step += 1

    return BeamResult(tokens, lengths,
                      scores / ((5.0 + lengths.float()) / 6.0) ** length_penalty, step - 1)


def beam_decode(
    model: mm.Moonshine,
    cfg: MoonshineArchConfig,
    memory: torch.Tensor,  # [B, T, D]
    memory_mask: torch.Tensor,  # [B, T] bool
    beam_size: int = 4,
    max_tokens: int = 64,
    length_penalty: float = 0.6,
    token_caps: torch.Tensor | None = None,  # [B]
    gather_impl: str = "auto",
    kv_int8: bool = False,
) -> BeamResult:
    """Beam search; returns the beam of each utterance with the best
    length-normalised score (arguments as in :func:`_search`)."""
    beams = _search(model, cfg, memory, memory_mask, beam_size, max_tokens, length_penalty,
                    token_caps, gather_impl, kv_int8)
    best = beams.scores.argmax(dim=1, keepdim=True)  # the first maximum, as jnp.argmax
    return BeamResult(
        tokens=beams.tokens.gather(1, best[:, :, None].expand(-1, 1, max_tokens))[:, 0],
        lengths=beams.lengths.gather(1, best)[:, 0],
        scores=beams.scores.gather(1, best)[:, 0],
        steps=beams.steps,
    )
