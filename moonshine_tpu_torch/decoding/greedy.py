"""Greedy autoregressive decoding over the KV-cached decoder, in PyTorch.

Counterpart of the JAX package's ``decoding/greedy.py``.  JAX runs the loop
as one ``lax.while_loop`` on the device; here it is a Python loop of eager
steps.  It stops once every batch element has emitted EOS or reached its
per-utterance token cap (the ``duration * max_tokens_per_second``
hallucination watchdog), which costs one host sync per step.  Each call
records its spans in ``profiling``.

The decoder is the model's own: ``greedy_decode`` calls the model's
``decoder_prompt``, ``compute_cross_kv``, ``init_cache`` and
``decoder_apply``, which ``models.moonshine.Moonshine`` and
``models.canary.Canary`` both have.  The prompt, P tokens (Moonshine's is
its start token, Canary's its task tokens), fills the self-attention cache
in one decoder call.

A model may instead hand it a prompt of its own per row (a decoder-only
LM, ``models.canary_qwen.CanaryQwen``): its ``prompt_embeds(cfg, memory,
memory_mask)`` gives (embeddings [B, P, D], each row's prompt length [B]),
the rows left-padded to P, its ``init_cache(cfg, batch, max_len,
prompt_lengths, dtype=, kv_int8=)`` a cache that knows each row's padding,
and ``decoder_apply`` takes the embeddings in the prompt's call (with
``span_parent``: greedy's ``greedy.prefill``) and token ids after it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import profiling
from ..ops.int8_kv import KV_WRITE_LAUNCHES, Q8_LAUNCHES


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_tokens] int64, EOS-padded
    lengths: torch.Tensor  # [B] int64 tokens emitted before EOS (exclusive)


@torch.inference_mode()
def greedy_decode(
    model,  # models.moonshine.Moonshine, models.canary.Canary
    cfg,  # its configuration
    memory: torch.Tensor,  # [B, T, D] encoder output
    memory_mask: torch.Tensor,  # [B, T] bool
    max_tokens: int,
    token_caps: torch.Tensor | None = None,  # [B] per-utterance cap
    kv_int8: bool = False,  # int8 KV caches (ops/int8_kv.py)
    *,
    span_parent: profiling.Span | None = None,
) -> GreedyResult:
    """Records a coarse ``greedy.decode`` span (``batch``, ``prompt_tokens``:
    P, ``prompt_positions``: the rows' prompt lengths summed,
    ``decoder_calls``, ``read_ns``, ``q8_launches`` and ``kv_write_launches``:
    K5's and K7's launches in the call) under ``span_parent``; with fine
    spans on, a ``greedy.prefill`` and a ``greedy.step`` a decoder call under
    it, each ending with its ``greedy.read``."""
    b = memory.shape[0]
    dev = memory.device
    eos = cfg.eos_token_id
    prompt_embeds = getattr(model, "prompt_embeds", None)
    sp = profiling.begin("greedy.decode", span_parent, batch=b, read_ns=0)
    q8, kvw = profiling.counter(Q8_LAUNCHES), profiling.counter(KV_WRITE_LAUNCHES)
    pre = profiling.child("greedy.prefill", sp)
    if prompt_embeds is None:  # token ids, the same for every row
        prompt = model.decoder_prompt(cfg)
        n_prompt = prompt_lengths = len(prompt)
        k_cross, v_cross = model.compute_cross_kv(cfg, memory)
        # The prompt's positions, then one a token.
        cache = model.init_cache(cfg, b, max_tokens + n_prompt, k_cross, v_cross, memory_mask,
                                 dtype=memory.dtype, kv_int8=kv_int8)
        # Copied without a wait: a blocking copy would hold the host until the encode ends.
        ids = torch.tensor(prompt).to(dev, non_blocking=True).expand(b, -1)
        logits, cache, _ = model.decoder_apply(cfg, ids, cache)
    else:  # embeddings of each row's own length, left-padded to the longest
        inputs, prompt_lengths = prompt_embeds(cfg, memory, memory_mask)
        n_prompt = inputs.shape[1]
        cache = model.init_cache(cfg, b, max_tokens + n_prompt, prompt_lengths,
                                 dtype=memory.dtype, kv_int8=kv_int8)
        logits, cache, _ = model.decoder_apply(cfg, inputs, cache, span_parent=pre)
    if token_caps is None:
        caps = torch.full((b,), max_tokens, dtype=torch.long, device=dev)
    else:
        caps = torch.clamp(torch.as_tensor(token_caps, device=dev).long(), max=max_tokens)
    first = logits[:, -1, :].argmax(dim=-1)

    tokens = torch.full((b, max_tokens), eos, dtype=torch.long, device=dev)
    keep = (first != eos) & (caps > 0)
    tokens[:, 0] = torch.where(keep, first, eos)
    lengths = keep.long()
    done = (first == eos) | (lengths >= caps)
    last = torch.where(done, eos, first)
    step, st = 1, pre  # st: the span whose read decides whether a step follows
    while True:
        stop = step >= max_tokens or profiling.timed_read(lambda: bool(done.all()), sp,
                                                          "greedy.read", st)
        profiling.end(st)
        if stop:
            break
        st = profiling.child("greedy.step", sp)
        logits, cache, _ = model.decoder_apply(cfg, last[:, None], cache)
        nxt = logits[:, -1, :].argmax(dim=-1)
        is_eos = nxt == eos
        keep = ~done & ~is_eos
        tokens[:, step] = torch.where(keep, nxt, eos)
        lengths = lengths + keep.long()
        # An element stops on EOS or at its per-utterance token cap.
        done = done | is_eos | (lengths >= caps)
        last = torch.where(done, eos, nxt)
        step += 1
    # Stopped at max_tokens, the last step was never read.
    sp.enqueued = dev.type == "cuda" and step >= max_tokens
    # Per-row lengths are read once the loop has waited for the device.
    positions = b * prompt_lengths if isinstance(prompt_lengths, int) else int(
        prompt_lengths.sum())
    profiling.end(sp, prompt_tokens=n_prompt, prompt_positions=positions, decoder_calls=step,
                  q8_launches=profiling.counter(Q8_LAUNCHES) - q8,
                  kv_write_launches=profiling.counter(KV_WRITE_LAUNCHES) - kvw)
    return GreedyResult(tokens, lengths)
