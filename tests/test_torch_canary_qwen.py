"""Canary-Qwen (``models/canary_qwen.py``) on the CPU at a tiny size (2
encoder layers of width 64, 1 adapter layer, 2 LLM layers of width 64 with
4 query heads over 2 K/V heads of 16, a vocabulary of 300), on seeded
random weights of the benchmark's law (``portbench/weights.py``), against
the plain reference of the benchmark (``benchmark/reference/canary_qwen.py``,
written from the published architecture); a batch of clips of different
lengths against each clip alone; the offline backend and ``Transcriber``;
and Canary's greedy tokens and decoder calls as the loop before per-row
prompts gave them.

Tolerances.  float32 on both sides, the same arithmetic in another order
(SDPA against an explicit softmax, ``F.rms_norm`` against its formula, the
fused q/k/v product against three): the audio embeddings to 1e-5 relative
RMS, as Canary's memory; the logits to atol 1e-4 on values of magnitude
about 1, as Canary's decoder.  A row of a padded batch against its clip
alone: the same arithmetic on other shapes, 1e-5 relative.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch import profiling
from moonshine_tpu_torch.core.config import MoonshineArchConfig
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.models import canary as cm
from moonshine_tpu_torch.models import moonshine as mm
from moonshine_tpu_torch.models import canary_qwen as cq

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from portbench.weights import leaf_shapes, load_into, make_weights  # noqa: E402
from reference import canary_qwen as ref  # noqa: E402
from reference.numerics import Products  # noqa: E402

CFG = cq.CanaryQwenArchConfig(
    d_model=64, encoder_layers=2, n_heads=4, ff_dim=128, subsampling_channels=16,
    adapter_layers=1, llm_hidden_size=64, llm_layers=2, llm_heads=4, llm_kv_heads=2,
    llm_head_dim=16, llm_intermediate_size=128, vocab_size=300,
    prompt_prefix_ids=(1, 2, 3, 4, 5, 6, 7, 8, 9), prompt_suffix_ids=(10, 11, 12, 13, 14),
    eos_token_id=0)
ARCH = dataclasses.asdict(CFG)
F32 = Products("float32")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def model_and_weights():
    model = cq.init_params(CFG, torch.Generator(), device="cpu")
    w = make_weights(leaf_shapes(model), 11, "cpu")
    load_into(model, w)
    return model, w


def _clips(lengths: list[int], seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    n = max(lengths)
    audio = torch.zeros(len(lengths), n)
    for i, k in enumerate(lengths):
        audio[i, :k] = torch.randn(k, generator=g) * 0.1
    return audio, torch.tensor(lengths)


def test_full_width_parameter_count():
    """Canary-Qwen-2.5B at its published widths, on the meta device: 2.58 B
    parameters (the encoder 811 M, the adapter 50 M, the projection 2 M,
    the LLM's 28 layers 1,409 M and its tied embedding 311 M)."""
    parts = cq.parameter_count(cq.CANARY_QWEN_2_5B)
    assert parts == {"encoder": 810_984_448, "adapter": 50_415_616, "project": 2_099_200,
                     "decoder": 1_409_410_048, "embedding": 311_164_928}
    assert sum(parts.values()) == 2_584_074_240
    c = cq.CANARY_QWEN_2_5B
    assert (c.llm_hidden_size, c.llm_layers, c.llm_heads, c.llm_kv_heads, c.llm_head_dim,
            c.llm_intermediate_size, c.vocab_size) == (2048, 28, 16, 8, 128, 6144, 151936)
    assert c.encoder.d_model == 1024 and c.encoder.encoder_layers == 32 and c.prompt_extra == 14


def test_audio_embeddings_match_the_reference(model_and_weights):
    model, w = model_and_weights
    audio, lengths = _clips([30000, 17000])
    with torch.inference_mode():
        x, mask = cq.encode(model, CFG, audio, lengths)
    for i in range(2):
        expect = ref.audio_embeddings(w, ARCH, audio[i, :lengths[i]], F32)
        f = expect.shape[0]
        assert int(mask[i].sum()) == f == CFG.frames_for_samples(int(lengths[i]))
        assert _rel(x[i, :f], expect) < 1e-5


def test_splice_puts_each_rows_frames_between_the_prompt_ids():
    """Row b: zeros, then the prefix, its own first F_b frames, the suffix,
    ending at the last column."""
    b, t, d = 3, 5, 2
    pre, suf = torch.full((2, d), 7.0), torch.full((3, d), 9.0)
    mem = torch.arange(b * t * d, dtype=torch.float32).view(b, t, d)
    frames = torch.tensor([5, 3, 1])
    src = torch.cat([pre.expand(b, -1, -1), mem, suf.expand(b, -1, -1)], 1)
    out = cq.splice(src, frames, 2, 3)
    for i, f in enumerate(frames.tolist()):
        pad = t - f
        want = torch.cat([torch.zeros(pad, d), pre, mem[i, :f], suf])
        assert torch.equal(out[i], want)


def _decode_logits(model, x, mask, tokens, kv_int8):
    """The prompt's call, then one call a token: the logits of each."""
    inputs, lengths = model.prompt_embeds(CFG, x, mask)
    cache = model.init_cache(CFG, x.shape[0], inputs.shape[1] + len(tokens), lengths,
                             dtype=x.dtype, kv_int8=kv_int8)
    rows = []
    with torch.inference_mode():
        logits, cache, _ = model.decoder_apply(CFG, inputs, cache)
        rows.append(logits[:, -1])
        for tok in tokens:
            logits, cache, _ = model.decoder_apply(CFG, torch.full((x.shape[0], 1), tok), cache)
            rows.append(logits[:, -1])
    return torch.stack(rows, 1)  # [B, 1 + S, V]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float32", "int8-kv"])
def test_prefill_then_cached_decode_matches_the_full_forward(model_and_weights, kv_int8):
    model, w = model_and_weights
    audio, lengths = _clips([26000, 12000], seed=2)
    tokens = [17, 200, 200, 3, 9]
    with torch.inference_mode():
        x, mask = cq.encode(model, CFG, audio, lengths)
    got = _decode_logits(model, x, mask, tokens, kv_int8)
    for i in range(2):
        emb = ref.audio_embeddings(w, ARCH, audio[i, :lengths[i]], F32)
        expect = ref.forced_logits(w, ARCH, emb, torch.tensor(tokens), F32, kv_int8)
        torch.testing.assert_close(got[i], expect, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float32", "int8-kv"])
def test_a_batch_decodes_each_clip_as_alone(model_and_weights, kv_int8):
    """Rows of different lengths in one batch (each left-padded to the
    longest prompt) give the tokens and, within float32 rounding, the
    logits of each clip decoded alone."""
    model, _ = model_and_weights
    lengths = [31000, 19000, 8000]
    audio, lens = _clips(lengths, seed=4)
    with torch.inference_mode():
        x, mask = cq.encode(model, CFG, audio, lens)
    tokens = [5, 40, 41]
    batch = _decode_logits(model, x, mask, tokens, kv_int8)
    res = greedy_decode(model, CFG, x, mask, max_tokens=6, kv_int8=kv_int8)
    for i, k in enumerate(lengths):
        with torch.inference_mode():
            xa, ma = cq.encode(model, CFG, audio[i:i + 1, :k], lens[i:i + 1])
        alone = _decode_logits(model, xa, ma, tokens, kv_int8)
        assert _rel(batch[i], alone[0]) < 1e-5
        one = greedy_decode(model, CFG, xa, ma, max_tokens=6, kv_int8=kv_int8)
        assert torch.equal(res.tokens[i], one.tokens[0]) and res.lengths[i] == one.lengths[0]


def test_greedy_decode_records_the_prompt_and_its_spans(model_and_weights):
    model, _ = model_and_weights
    audio, lengths = _clips([24000, 9000])
    profiling.enable_device_run_log(True)
    try:
        with torch.inference_mode():
            x, mask = cq.encode(model, CFG, audio, lengths)
        greedy_decode(model, CFG, x, mask, max_tokens=4, kv_int8=True)
    finally:
        profiling.enable_device_run_log(False)
    frames = [CFG.frames_for_samples(k) for k in (24000, 9000)]
    dec = profiling.spans("greedy.decode")[-1]
    assert dec.attrs["prompt_tokens"] == 14 + x.shape[1]
    assert dec.attrs["prompt_positions"] == sum(14 + f for f in frames)
    pre = profiling.spans("salm.prefill")[-1]
    assert pre.attrs == {"batch": 2, "positions": sum(14 + f for f in frames),
                         "max_positions": 14 + x.shape[1]}
    enc = profiling.spans("encode")[-1]
    assert enc.attrs["model"] == "canary_qwen" and enc.attrs["relpos_calls"] == 3
    for name in ("salm.adapter", "salm.project"):
        assert profiling.spans(name)[-1].parent == enc.id


def test_the_head_is_the_tied_product():
    h = torch.randn(2, 1, 8)
    e = torch.randn(30, 8)
    assert torch.equal(cq.tied_logits(h, e), h @ e.t())
    assert cq.tied_logits(h.bfloat16(), e.bfloat16()).dtype == torch.float32


def test_offline_backend_and_transcriber_run_canary_qwen(tmp_path, model_and_weights):
    """``Transcriber(cfg).with_params(model)`` and ``OfflineBackend`` route a
    Canary-Qwen model through its encode and the shared greedy decode."""
    from moonshine_tpu_torch import Transcriber
    from moonshine_tpu_torch.core.tokenizer import BinTokenizer
    from moonshine_tpu_torch.pipeline.backends import OfflineBackend

    model, _ = model_and_weights
    tok = BinTokenizer([f"▁w{i}".encode() for i in range(CFG.vocab_size)])
    path = tmp_path / "tokenizer.bin"
    path.write_bytes(tok.to_bytes())
    audio = _clips([24000])[0][0].numpy()
    backend = OfflineBackend(model, CFG, tok, max_tokens_per_second=4.0)
    text = backend.transcribe_segment(audio, 0, True).text
    assert text.startswith("w") and len(text.split()) <= 6
    t = Transcriber(CFG, tokenizer_path=str(path), device="cpu").with_params(model)
    t.with_options(vad_threshold=0, max_tokens_per_second=4.0).load()
    assert isinstance(t._pipeline.backend, OfflineBackend) and t.model is model
    lines = t.transcribe(audio).lines
    assert lines and set(lines[0].text.split()) <= {f"w{i}" for i in range(CFG.vocab_size)}
    with pytest.raises(ValueError, match="word timestamps"):
        OfflineBackend(model, CFG, tok, word_timestamps=True)
    with pytest.raises(NotImplementedError, match="Canary-Qwen"):
        Transcriber("canary-qwen-2.5b", weights=str(tmp_path / "w.safetensors"),
                    tokenizer_path=str(path), device="cpu").load()


def test_catalog_resolves_canary_qwen_beside_the_jax_listing(tmp_path, monkeypatch):
    from moonshine_tpu_torch import catalog

    assert "canary-qwen-2.5b-en" not in catalog.list_models()
    monkeypatch.setenv(catalog.DEFAULT_CACHE_ENV, str(tmp_path))
    root = tmp_path / "canary-qwen-2.5b-en"
    root.mkdir()
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        catalog.resolve("canary-qwen-2.5b", "en")
    for name in ("model.safetensors", "tokenizer.json"):
        (root / name).write_bytes(b"")
    found = catalog.resolve("canary-qwen-2.5b", "en").path("tokenizer.json")
    assert found == root / "tokenizer.json"


# -- Moonshine's and Canary's decodes as they were before per-row prompts -------

CANARY = cm.CanaryArchConfig(d_model=64, encoder_layers=2, decoder_layers=2, n_heads=4, ff_dim=128,
                             subsampling_channels=16, vocab_size=300, max_positions=128)
MOONSHINE = MoonshineArchConfig(name="base", hidden_size=64, intermediate_size=128,
                                encoder_layers=2, decoder_layers=2, vocab_size=96)


@torch.inference_mode()
def _loop_before(model, cfg, memory, memory_mask, max_tokens, token_caps, kv_int8):
    """``greedy_decode`` as it ran a model of token-id prompts before a model
    could hand it per-row embeddings; returns (tokens, lengths, calls)."""
    b, dev, eos = memory.shape[0], memory.device, cfg.eos_token_id
    prompt = model.decoder_prompt(cfg)
    k_cross, v_cross = model.compute_cross_kv(cfg, memory)
    cache = model.init_cache(cfg, b, max_tokens + len(prompt), k_cross, v_cross, memory_mask,
                             dtype=memory.dtype, kv_int8=kv_int8)
    caps = torch.clamp(torch.as_tensor(token_caps, device=dev).long(), max=max_tokens)
    ids = torch.tensor(prompt).to(dev).expand(b, -1)
    logits, cache, _ = model.decoder_apply(cfg, ids, cache)
    first = logits[:, -1, :].argmax(dim=-1)
    tokens = torch.full((b, max_tokens), eos, dtype=torch.long, device=dev)
    keep = (first != eos) & (caps > 0)
    tokens[:, 0] = torch.where(keep, first, eos)
    lengths = keep.long()
    done = (first == eos) | (lengths >= caps)
    last = torch.where(done, eos, first)
    step = 1
    while step < max_tokens and not bool(done.all()):
        logits, cache, _ = model.decoder_apply(cfg, last[:, None], cache)
        nxt = logits[:, -1, :].argmax(dim=-1)
        is_eos = nxt == eos
        keep = ~done & ~is_eos
        tokens[:, step] = torch.where(keep, nxt, eos)
        lengths = lengths + keep.long()
        done = done | is_eos | (lengths >= caps)
        last = torch.where(done, eos, nxt)
        step += 1
    return tokens, lengths, step


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float32", "int8-kv"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("family", ["moonshine", "canary"])
def test_tokens_and_decoder_calls_are_those_of_the_loop_before(family, kv_int8, seed):
    """A model of token-id prompts decodes as before, bit for bit, in as many
    decoder calls."""
    mod, cfg = (mm, MOONSHINE) if family == "moonshine" else (cm, CANARY)
    model = mod.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    load_into(model, make_weights(leaf_shapes(model), seed, "cpu"))
    audio, lengths = _clips([20000, 9000, 16000], seed=seed)
    with torch.inference_mode():
        memory, mask = model.encode(cfg, audio, lengths)
    caps = torch.tensor([7, 2, 5])
    tokens, lens, calls = _loop_before(model, cfg, memory, mask, 7, caps, kv_int8)
    seen = []
    apply = model.decoder_apply
    model.decoder_apply = lambda *a: seen.append(1) or apply(*a)
    try:
        res = greedy_decode(model, cfg, memory, mask, max_tokens=7, token_caps=caps,
                            kv_int8=kv_int8)
    finally:
        del model.decoder_apply
    assert torch.equal(res.tokens, tokens) and torch.equal(res.lengths, lens)
    assert len(seen) == calls == profiling.spans("greedy.decode")[-1].attrs["decoder_calls"]
