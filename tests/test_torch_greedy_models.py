"""``greedy_decode`` takes its decoder from the model it is given: for a
Moonshine model it gives the tokens and lengths, bit for bit, of the loop
that called ``models.moonshine`` directly (kept below as it was), in
float32 and with int8 KV caches, and the same spans; a prompt of several
tokens is one decoder call."""

from __future__ import annotations

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch import profiling
from moonshine_tpu_torch.core.config import MoonshineArchConfig
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.models import moonshine as mm

# Base's shape (8 heads, the SwiGLU decoder, partial rotary) at a tiny width.
CFG = MoonshineArchConfig(name="base", hidden_size=64, intermediate_size=128, encoder_layers=2,
                          decoder_layers=2, vocab_size=96)


@torch.inference_mode()
def _loop_before(model, cfg, memory, memory_mask, max_tokens, token_caps, kv_int8):
    """The greedy loop as it called ``models.moonshine`` itself."""
    b, dev, dec, eos = memory.shape[0], memory.device, model.decoder, cfg.eos_token_id
    k_cross, v_cross = mm.compute_cross_kv(dec, cfg, memory)
    cache = mm.init_cache(cfg, b, max_tokens + 1, k_cross, v_cross, memory_mask,
                          dtype=memory.dtype, kv_int8=kv_int8)
    caps = torch.clamp(torch.as_tensor(token_caps, device=dev).long(), max=max_tokens)
    bos = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long, device=dev)
    logits, cache, _ = mm.decoder_apply(dec, cfg, bos, cache)
    first = logits[:, -1, :].argmax(dim=-1)
    tokens = torch.full((b, max_tokens), eos, dtype=torch.long, device=dev)
    keep = (first != eos) & (caps > 0)
    tokens[:, 0] = torch.where(keep, first, eos)
    lengths = keep.long()
    done = (first == eos) | (lengths >= caps)
    last = torch.where(done, eos, first)
    step = 1
    while step < max_tokens and not bool(done.all()):
        logits, cache, _ = mm.decoder_apply(dec, cfg, last[:, None], cache)
        nxt = logits[:, -1, :].argmax(dim=-1)
        is_eos = nxt == eos
        keep = ~done & ~is_eos
        tokens[:, step] = torch.where(keep, nxt, eos)
        lengths = lengths + keep.long()
        done = done | is_eos | (lengths >= caps)
        last = torch.where(done, eos, nxt)
        step += 1
    return tokens, lengths


def _model_and_memory(seed: int):
    model = mm.init_params(CFG, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():  # biases and norms off their initial values, so rows differ
        g = torch.Generator().manual_seed(seed + 1)
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    g = torch.Generator().manual_seed(seed + 2)
    memory = torch.randn((4, 23, CFG.hidden_size), generator=g)
    mask = torch.arange(23)[None, :] < torch.tensor([23, 17, 9, 1])[:, None]
    return model, memory, mask


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float32", "int8-kv"])
@pytest.mark.parametrize("seed", [0, 7])
def test_moonshine_tokens_are_bit_equal_to_the_loop_before(kv_int8, seed):
    model, memory, mask = _model_and_memory(seed)
    caps = torch.tensor([12, 5, 1, 12])
    tokens, lengths = _loop_before(model, CFG, memory, mask, 12, caps, kv_int8)
    res = greedy_decode(model, CFG, memory, mask, max_tokens=12, token_caps=caps,
                        kv_int8=kv_int8)
    assert torch.equal(res.tokens, tokens) and torch.equal(res.lengths, lengths)
    assert len(set(tokens[0].tolist())) > 1  # the rows decode more than one token
    sp = profiling.spans("greedy.decode")[-1]
    assert sp.attrs["prompt_tokens"] == 1 and sp.attrs["batch"] == 4


def test_a_prompt_is_one_decoder_call(monkeypatch):
    """A prompt of three tokens fills the cache in one decoder call; each
    later call feeds one token."""
    model, memory, mask = _model_and_memory(3)
    calls = []
    real = mm.decoder_apply

    def counted(p, cfg, tokens, cache, *a, **kw):
        calls.append(tokens.shape[1])
        return real(p, cfg, tokens, cache, *a, **kw)

    monkeypatch.setattr(mm, "decoder_apply", counted)
    monkeypatch.setattr(model, "decoder_prompt", lambda cfg: (cfg.decoder_start_token_id, 5, 6))
    greedy_decode(model, CFG, memory, mask, max_tokens=4)
    assert calls[0] == 3 and set(calls[1:]) <= {1}
    assert profiling.spans("greedy.decode")[-1].attrs["prompt_tokens"] == 3
