"""Cross-model speculative decoding (small draft model, large verifier), in
PyTorch.

Counterpart of the JAX package's ``decoding/speculative.py``.  The draft
model proposes ``gamma`` tokens autoregressively, the verifier scores the
whole proposal in one pass, and the longest agreeing prefix is accepted
(greedy acceptance: the output equals the verifier's own greedy decode).
Lanes accept different prefix lengths each round, so every lane has its own
cache cursor (``_decoder_apply_vec``), and rolling a cache back after a
round only moves the cursor.  Rounds run in lockstep over the lanes;
finished lanes keep frozen cursors and change nothing.

JAX runs the loop as one ``lax.while_loop``; here it is a Python loop of
eager rounds that stops once no lane is running, which costs one host sync
per round and no other.

Cache-position invariant (as in JAX): with the input sequence
I = [bos, t0, t1, ...], a lane's caches at cursor m hold K/V for I[0..m-1]
and its next input is I[m].  At the start of every round both caches'
cursors equal the lane's count of accepted tokens.  The draft consumes one
input beyond its last proposal, so its cache stays valid when every
proposal is accepted.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.config import MoonshineArchConfig
from ..models import moonshine as mm
from ..models.layers import dense, layer_norm
from ..ops.int8_kv import LayerKV, attend_kv, quantize_kv, write_kv
from ..ops.rotary import apply_rotary, rotary_tables


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # [max_tokens] int64, EOS-padded
    length: torch.Tensor  # scalar int64
    # Telemetry: accepted draft tokens and verifier calls, the two numbers
    # that decide whether speculation pays off.
    accepted_draft_tokens: torch.Tensor  # scalar int64
    verify_calls: int


class BatchSpecResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_tokens] int64, EOS-padded
    lengths: torch.Tensor  # [B] int64
    accepted_draft_tokens: torch.Tensor  # [B] int64
    rounds: int  # verify passes, shared by the lanes (lockstep)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Write ``new`` [B, H, hd, s] into the dim-major cache [B, H, hd, cap]
    at each lane's ``positions`` [B, s], in place, and return the cache;
    writes at or past ``cap`` vanish.

    One indexed write.  A lane's positions are consecutive, so its writes
    past the cap are a suffix; they are sent to the lane's first slot with
    the value that slot receives anyway (the first new entry, or the slot's
    own value when even that is past the cap), so indices that repeat
    carry equal values and the write is the same in any order."""
    b, s = positions.shape
    cap = cache.shape[-1]
    slots = cache.permute(0, 3, 1, 2)  # [B, cap, H, hd], a view of the cache
    new = new.permute(0, 3, 1, 2).to(cache.dtype)  # [B, s, H, hd]
    lanes = torch.arange(b, device=positions.device)
    valid = positions < cap
    first = positions[:, 0].clamp(max=cap - 1)
    head = torch.where(valid[:, 0, None, None], new[:, 0], slots[lanes, first])
    slots[lanes[:, None].expand(b, s), torch.where(valid, positions, first[:, None])] = (
        torch.where(valid[:, :, None, None], new, head[:, None]))
    return cache


def _decoder_apply_vec(
    dec: mm.Decoder,
    cfg: MoonshineArchConfig,
    tokens: torch.Tensor,  # [B, s]
    cur_len: torch.Tensor,  # [B] per-lane cache cursors
    k_self: torch.Tensor,  # [L, B, H, hd, cap], written in place
    v_self: torch.Tensor,
    k_cross: torch.Tensor,  # [L, B, H, hd, T] (int8 if the scales are set)
    v_cross: torch.Tensor,
    memory_mask: torch.Tensor,  # [B, T]
    k_cross_scale: torch.Tensor | None = None,  # [L, B, H, T] f32
    v_cross_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """``models.moonshine.decoder_apply`` with one cache cursor per lane.

    The same layer math (rotary causal self-attention over the cache,
    rope-free cross-attention, SwiGLU MLP, tied unembedding).  Lane b's new
    keys and values go to slots ``cur_len[b] + i`` by an indexed write;
    writes at or past the cache's capacity vanish (JAX's one-hot scatter has
    the same effect), and the self-attention mask hides every slot past a
    query's position.  Returns the logits [B, s, V] in float32.
    """
    b, s = tokens.shape
    cap = k_self.shape[4]
    dev = tokens.device
    eps = cfg.layer_norm_eps
    positions = cur_len[:, None] + torch.arange(s, device=dev)  # [B, s]
    # Per-lane tables, made on the card from the cursors: no host sync.
    cos, sin = rotary_tables(positions, cfg.rotary_dim, cfg.rope_theta)  # [B, s, half]
    self_mask = (torch.arange(cap, device=dev) <= positions[:, :, None])[:, None]  # [B,1,s,cap]
    cross = mm.DecoderCache(k_self, v_self, 0, k_cross, v_cross, memory_mask,
                            k_cross_scale=k_cross_scale, v_cross_scale=v_cross_scale)
    cross_mask = memory_mask[:, None, None, :]
    put = functools.partial(_write_cache, positions=positions)
    h = dec.embed[tokens]
    for layer, lp in enumerate(dec.layers):
        x = layer_norm(lp.ln1, h, eps)
        a = lp.self_attn
        q = apply_rotary(mm._split_heads(dense(a.q, x), cfg.decoder_heads), cos, sin)
        k_new = apply_rotary(mm._split_heads(dense(a.k, x), cfg.decoder_kv_heads), cos, sin)
        v_new = mm._split_heads(dense(a.v, x), cfg.decoder_kv_heads)
        kv = write_kv(LayerKV(k_self[layer], v_self[layer]), k_new.permute(0, 2, 3, 1),
                      v_new.permute(0, 2, 3, 1), put)
        o = attend_kv(q, kv, self_mask)
        h = h + dense(a.o, o.reshape(b, s, -1))
        h, _ = mm._decoder_cross_mlp_apply(cfg, h, lp, layer, cross, cross_mask, False, 1)
    h = layer_norm(dec.norm, h, eps)
    return h.float() @ dec.embed.float().t()


@torch.inference_mode()
def _speculate(draft: mm.Moonshine, draft_cfg: MoonshineArchConfig,
               verify: mm.Moonshine, verify_cfg: MoonshineArchConfig,
               draft_memory, draft_mask, verify_memory, verify_mask,
               gamma: int, max_tokens: int, token_caps, kv_int8: bool, single: bool):
    """The lockstep rounds of both entry points.  Returns (tokens [B,
    max_tokens], counts [B], accepted draft tokens [B], rounds).

    ``single`` keeps the telemetry of JAX's single-utterance
    ``speculative_decode``: a round that reaches ``max_tokens`` counts every
    accepted proposal, also those past the cap, where the batched version
    counts only the tokens kept.  Tokens and lengths are the same."""
    if draft_cfg.eos_token_id != verify_cfg.eos_token_id:
        raise ValueError("draft and verifier must share the EOS token")
    eos = verify_cfg.eos_token_id
    bos = verify_cfg.decoder_start_token_id
    b = draft_memory.shape[0]
    dev = draft_memory.device
    if token_caps is None:
        caps = torch.full((b,), max_tokens, dtype=torch.long, device=dev)
    else:
        caps = torch.clamp(torch.as_tensor(token_caps, device=dev).long(), max=max_tokens)
    ddec, vdec = draft.decoder, verify.decoder
    cap = max_tokens + gamma + 2  # cache slack for a final over-proposal

    dk, dv = mm.compute_cross_kv(ddec, draft_cfg, draft_memory)
    vk, vv = mm.compute_cross_kv(vdec, verify_cfg, verify_memory)
    dk_s = dv_s = vk_s = vv_s = None
    if kv_int8:  # only the cross caches, as in JAX
        dk, dk_s = quantize_kv(dk)
        dv, dv_s = quantize_kv(dv)
        vk, vk_s = quantize_kv(vk)
        vv, vv_s = quantize_kv(vv)

    def self_caches(c: MoonshineArchConfig, dtype):
        shape = (c.decoder_layers, b, c.decoder_kv_heads, c.head_dim, cap)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    dks, dvs = self_caches(draft_cfg, draft_memory.dtype)
    vks, vvs = self_caches(verify_cfg, verify_memory.dtype)

    buf = max_tokens + gamma + 1
    out_idx = torch.arange(buf, device=dev)[None, :]
    tokens = torch.full((b, buf), eos, dtype=torch.long, device=dev)
    count = torch.zeros(b, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    accepted = torch.zeros(b, dtype=torch.long, device=dev)
    never = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    rounds = 0
    while bool((~done).any()):  # the round's one host sync
        act = ~done
        prev = tokens.gather(1, (count - 1).clamp(min=0)[:, None])[:, 0]
        last = torch.where(count > 0, prev, bos)

        # The draft proposes gamma tokens per lane, then consumes the last
        # one so that its cache covers position count + gamma.
        nxt, props = last, []
        for i in range(gamma):
            lg = _decoder_apply_vec(ddec, draft_cfg, nxt[:, None], count + i, dks, dvs, dk, dv,
                                    draft_mask, dk_s, dv_s)
            nxt = lg[:, -1].argmax(dim=-1)
            props.append(nxt)
        proposals = torch.stack(props, dim=1)  # [B, gamma]
        _decoder_apply_vec(ddec, draft_cfg, nxt[:, None], count + gamma, dks, dvs, dk, dv,
                           draft_mask, dk_s, dv_s)

        # The verifier scores [last, p0 .. p_{gamma-1}] in one pass:
        # preds[:, i] is its token at position count + i.
        seq = torch.cat([last[:, None], proposals], dim=1)
        preds = _decoder_apply_vec(vdec, verify_cfg, seq, count, vks, vvs, vk, vv, verify_mask,
                                   vk_s, vv_s).argmax(dim=-1)  # [B, gamma + 1]
        agree = preds[:, :gamma] == proposals
        n_accept = torch.cat([agree, never], dim=1).long().argmin(dim=1)  # first disagreement
        correction = preds.gather(1, n_accept[:, None])[:, 0]
        # An EOS among the accepted proposals ends the lane there.
        eos_pos = torch.cat([proposals == eos, ~never], dim=1).long().argmax(dim=1)
        eos_in_accept = eos_pos < n_accept
        n_raw = torch.where(eos_in_accept, eos_pos, n_accept)
        n_keep = torch.minimum(n_raw, (caps - count).clamp(min=0))

        # Accepted proposals go to [count, count + n_keep) and a real
        # correction token to count + n_keep.
        rel = out_idx - count[:, None]  # [B, buf]
        corr_is_token = act & ~eos_in_accept & (correction != eos) & (count + n_keep < caps)
        prop_at = proposals.gather(1, rel.clamp(0, gamma - 1))
        write_prop = act[:, None] & (rel >= 0) & (rel < n_keep[:, None])
        write_corr = (rel == n_keep[:, None]) & corr_is_token[:, None]
        tokens = torch.where(write_prop, prop_at,
                             torch.where(write_corr, correction[:, None], tokens))
        accepted = accepted + torch.where(act, n_raw if single else n_keep, 0)
        n_keep = torch.where(act, n_keep, 0)
        count = count + n_keep + corr_is_token.long()
        done = done | eos_in_accept | (correction == eos) | (count >= caps)
        rounds += 1
    tokens = torch.where(out_idx < count[:, None], tokens, eos)[:, :max_tokens]
    return tokens, count, accepted, rounds


def speculative_decode(
    draft: mm.Moonshine,
    draft_cfg: MoonshineArchConfig,
    verify: mm.Moonshine,
    verify_cfg: MoonshineArchConfig,
    draft_memory: torch.Tensor,  # [1, Td, Dd]
    draft_mask: torch.Tensor,  # [1, Td]
    verify_memory: torch.Tensor,  # [1, Tv, Dv]
    verify_mask: torch.Tensor,  # [1, Tv]
    gamma: int = 4,
    max_tokens: int = 64,
) -> SpecResult:
    """Single-utterance greedy decode of the verifier, accelerated by the
    draft model.  Output equals ``greedy_decode`` on the verifier."""
    if draft_memory.shape[0] != 1:
        raise ValueError("speculative_decode takes one utterance; use speculative_decode_batched")
    tokens, count, accepted, rounds = _speculate(
        draft, draft_cfg, verify, verify_cfg, draft_memory, draft_mask, verify_memory,
        verify_mask, gamma, max_tokens, None, False, single=True)
    return SpecResult(tokens[0], count[0], accepted[0], rounds)


def speculative_decode_batched(
    draft: mm.Moonshine,
    draft_cfg: MoonshineArchConfig,
    verify: mm.Moonshine,
    verify_cfg: MoonshineArchConfig,
    draft_memory: torch.Tensor,  # [B, Td, Dd]
    draft_mask: torch.Tensor,  # [B, Td]
    verify_memory: torch.Tensor,  # [B, Tv, Dv]
    verify_mask: torch.Tensor,  # [B, Tv]
    gamma: int = 4,
    max_tokens: int = 64,
    token_caps: torch.Tensor | None = None,  # [B] optional per-lane caps
    kv_int8: bool = False,  # int8 cross caches (ops/int8_kv.py); self caches stay float
) -> BatchSpecResult:
    """Batched draft / verifier greedy speculative decoding; every lane's
    output equals the verifier's own greedy decode of it."""
    return BatchSpecResult(*_speculate(
        draft, draft_cfg, verify, verify_cfg, draft_memory, draft_mask, verify_memory,
        verify_mask, gamma, max_tokens, token_caps, kv_int8, single=False))
