"""Canary (``models/canary.py``) on the CPU at a tiny width (2 + 2 layers,
width 64, 4 heads, 16 stem channels), against the plain reference of the
benchmark (``benchmark/reference/canary.py``, written from NeMo's modules)
on seeded random weights of the benchmark's law, and the pieces the
encoder is made of against their definitions.

Tolerances.  The program and the reference compute the same float32
arithmetic in another order (the DFT as a product with a basis against
``torch.stft``, BD as one product of every head and a strided view against
NeMo's pad-and-view shift, SDPA against an explicit softmax, BatchNorm
folded into the convolution): the memory is held to 1e-5 relative RMS,
about 100 float32 steps of the unit-variance features after 2 layers,
and far under what one wrong term (a missing position bias: above 1e-2)
gives.  The decoder's logits to atol 1e-4 on values of magnitude ~1 after
4 LayerNorms, 5 tokens of prompt and 8 decoded.  A clip alone against its
row of a padded batch: the same arithmetic on other GEMM shapes, 1e-5.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch.decoding.greedy import greedy_decode
from moonshine_tpu_torch.models import canary as cm

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference import canary as ref  # noqa: E402
from reference.numerics import Products  # noqa: E402

CFG = cm.CanaryArchConfig(d_model=64, encoder_layers=2, decoder_layers=2, n_heads=4, ff_dim=128,
                          subsampling_channels=16, vocab_size=300, max_positions=128)
ARCH = dataclasses.asdict(CFG)
MEMORY_TOL = 1e-5


def _weights(model: torch.nn.Module, seed: int) -> dict:
    """Every leaf drawn as the benchmark draws it (``portbench/weights.py``):
    weights uniform in +-1/sqrt(fan_in), norm scales and statistics
    1 + U(-0.1, 0.1), biases U(-0.02, 0.02), the embedding N(0, 0.02^2);
    copied into ``model``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        u = torch.empty(p.shape).uniform_(-1.0, 1.0, generator=g)
        if name == "decoder.embed":
            out[name] = torch.randn(p.shape, generator=g) * 0.02
        elif name.endswith(".bias"):
            out[name] = u * 0.02
        elif p.dim() == 1:
            out[name] = 1.0 + 0.1 * u
        else:
            out[name] = u / math.sqrt(math.prod(p.shape[1:]))
    model.load_state_dict(out)
    return out


@pytest.fixture(scope="module")
def model_and_weights():
    model = cm.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return model, _weights(model, 3)


def _clips(lengths, seed=1):
    g = torch.Generator().manual_seed(seed)
    n = max(lengths)
    audio = torch.randn((len(lengths), n), generator=g) * 0.1
    for i, k in enumerate(lengths):
        audio[i, k:] = 0.0
    return audio, torch.tensor(lengths)


def _rel_rms(a, b) -> float:
    return float((a - b).norm() / b.norm())


def test_encoder_matches_the_reference(model_and_weights):
    model, w = model_and_weights
    audio, lengths = _clips([24000, 13000, 4321])
    with torch.inference_mode():
        memory, mask = cm.encode(model, CFG, audio, lengths)
    for i, k in enumerate(lengths.tolist()):
        expect = ref.encode(w, ARCH, audio[i, :k], Products())
        t = expect.shape[0]
        assert int(mask[i].sum()) == t
        assert _rel_rms(memory[i, :t], expect) < MEMORY_TOL


def test_dropping_the_position_term_leaves_the_tolerance(model_and_weights, monkeypatch):
    """The comparison sees the relative-position term: the encoder with BD
    zeroed lies far outside the tolerance."""
    model, w = model_and_weights
    audio, lengths = _clips([16000])
    real = cm.rel_shift_view

    def zero(bd, b, t):
        return real(torch.zeros_like(bd), b, t)

    monkeypatch.setattr(cm, "rel_shift_view", zero)
    with torch.inference_mode():
        memory, _ = cm.encode(model, CFG, audio, lengths)
    expect = ref.encode(w, ARCH, audio[0], Products())
    assert _rel_rms(memory[0, :expect.shape[0]], expect) > 100 * MEMORY_TOL


def test_padded_rows_match_each_clip_alone(model_and_weights):
    model, _ = model_and_weights
    audio, lengths = _clips([30000, 17000, 999, 16001])
    with torch.inference_mode():
        memory, mask = cm.encode(model, CFG, audio, lengths)
        for i, k in enumerate(lengths.tolist()):
            alone, alone_mask = cm.encode(model, CFG, audio[i:i + 1, :k])
            t = alone.shape[1]
            assert alone_mask.all() and int(mask[i].sum()) == t
            assert _rel_rms(memory[i, :t], alone[0]) < MEMORY_TOL


@pytest.mark.parametrize("samples", [1, 159, 160, 161, 999, 1280, 16000, 16001, 81920, 655360])
def test_subsampled_lengths_follow_the_formula(samples):
    """Features: one frame a hop of 160 and one more; then floor((L - 1) / 2)
    + 1 at each of the three stride-2 stages."""
    frames = samples // 160 + 1
    for _ in range(3):
        frames = (frames - 1) // 2 + 1
    assert CFG.frames_for_samples(samples) == frames
    if samples <= 16001:
        model = cm.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
        with torch.inference_mode():
            memory, mask = cm.encode(model, CFG, torch.zeros(1, samples))
        assert memory.shape[1] == mask.shape[1] == frames


def test_rel_shift_view_is_the_index_loop():
    b, h, t = 2, 3, 5
    bd = torch.randn(h, b * t, 2 * t - 1)
    out = cm.rel_shift_view(bd, b, t)
    for bi in range(b):
        for hi in range(h):
            for i in range(t):
                for j in range(t):
                    assert out[bi, hi, i, j] == bd[hi, bi * t + i, (t - 1) - i + j]
    # NeMo's pad-and-view shift (the reference's) reads the same elements.
    nemo = ref.rel_shift(bd.view(h, b, t, 2 * t - 1)[:, 1])[:, :, :t]
    assert torch.equal(nemo, out[1])


def test_folded_batch_norm_is_conv_then_batch_norm():
    g = torch.Generator().manual_seed(4)
    d, k = 8, 9
    conv = cm.Conv1d(torch.randn(d, 1, k, generator=g), torch.randn(d, generator=g))
    bn = cm.BatchNorm(d)
    with torch.no_grad():
        for p in (bn.weight, bn.bias, bn.running_mean):
            p.copy_(torch.randn(d, generator=g))
        bn.running_var.copy_(torch.rand(d, generator=g) + 0.5)
    x = torch.randn(2, d, 30, generator=g)
    w, bias = cm.fold_batch_norm(conv, bn, 1e-5)
    folded = F.conv1d(x, w, bias, padding=k // 2, groups=d)
    plain = F.batch_norm(F.conv1d(x, conv.weight, conv.bias, padding=k // 2, groups=d),
                         bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, 1e-5)
    torch.testing.assert_close(folded, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["float32", "int8-kv"])
def test_prefill_then_cached_decode_matches_the_full_forward(model_and_weights, kv_int8):
    """The prompt in one decoder call, then one token a call through the
    cache: each row's logits against the reference's forward over the
    whole sequence (the reference's int8 columns where the caches are
    int8), on the program's own memory."""
    model, w = model_and_weights
    audio, lengths = _clips([20000, 9000])
    g = torch.Generator().manual_seed(5)
    follow = torch.randint(0, CFG.vocab_size, (2, 8), generator=g)
    p = len(CFG.prompt_ids)
    with torch.inference_mode():
        memory, mask = cm.encode(model, CFG, audio, lengths)
        kc, vc = model.compute_cross_kv(CFG, memory)
        cache = model.init_cache(CFG, 2, p + 8, kc, vc, mask, dtype=memory.dtype,
                                 kv_int8=kv_int8)
        prompt = torch.tensor([CFG.prompt_ids] * 2)
        logits, cache, _ = model.decoder_apply(CFG, prompt, cache)
        rows = [logits]
        for j in range(8):
            logits, cache, _ = model.decoder_apply(CFG, follow[:, j:j + 1], cache)
            rows.append(logits)
    got = torch.cat(rows, dim=1)
    assert cache.cur_len == p + 8
    for i, k in enumerate(lengths.tolist()):
        t = CFG.frames_for_samples(k)
        seq = torch.cat([prompt[i], follow[i]])
        expect = ref.forced_logits(w, ARCH, memory[i, :t], seq, Products(), kv_int8)
        torch.testing.assert_close(got[i], expect, atol=1e-4, rtol=0)


def test_greedy_decode_runs_the_prompt_and_counts_it(model_and_weights):
    from moonshine_tpu_torch import profiling

    model, _ = model_and_weights
    audio, lengths = _clips([20000, 9000])
    with torch.inference_mode():
        memory, mask = cm.encode(model, CFG, audio, lengths)
    res = greedy_decode(model, CFG, memory, mask, max_tokens=6, token_caps=torch.tensor([6, 2]),
                        kv_int8=True)
    assert res.tokens.shape == (2, 6) and res.lengths[1] <= 2
    sp = profiling.spans("greedy.decode")[-1]
    assert sp.attrs["prompt_tokens"] == len(CFG.prompt_ids) and sp.attrs["batch"] == 2
    enc = profiling.spans("encode")[-1]
    assert enc.attrs["model"] == CFG.name and enc.attrs["relpos_calls"] == CFG.encoder_layers
    assert enc.attrs["frames"] == memory.shape[1]


def test_full_width_parameter_count():
    """Canary-1B-Flash at its published widths, built on the meta device:
    883,554,432 parameters with the vocabulary of 5,248 assumed (the model
    card: 883 M), and the 32 layers' BatchNorm statistics besides."""
    with torch.device("meta"):
        model = cm.init_params(cm.CANARY_1B_FLASH, torch.Generator(), device="meta")
    sizes = {k: v.numel() for k, v in model.state_dict().items()}
    stats = sum(n for k, n in sizes.items() if ".running_" in k)
    assert sum(sizes.values()) - stats == 883_554_432
    assert stats == 2 * 32 * 1024
    cfg = cm.CANARY_1B_FLASH
    assert (cfg.d_model, cfg.encoder_layers, cfg.decoder_layers, cfg.n_heads, cfg.head_dim,
            cfg.ff_dim, cfg.conv_kernel_size, cfg.subsampling_channels, cfg.n_mels) == (
        1024, 32, 4, 8, 128, 4096, 9, 256, 128)


def test_offline_backend_and_transcriber_run_canary(tmp_path, model_and_weights):
    """``Transcriber(cfg).with_params(model)`` and ``OfflineBackend`` route a
    Canary model through its encode and the shared greedy decode."""
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
    with pytest.raises(NotImplementedError, match="Canary"):
        Transcriber("canary-1b-flash", weights=str(tmp_path / "w.safetensors"),
                    tokenizer_path=str(path), device="cpu").load()


def test_catalog_resolves_canary_beside_the_jax_listing(tmp_path, monkeypatch):
    from moonshine_tpu_torch import catalog

    assert "canary-1b-flash-en" not in catalog.list_models()
    monkeypatch.setenv(catalog.DEFAULT_CACHE_ENV, str(tmp_path))
    root = tmp_path / "canary-1b-flash-en"
    root.mkdir()
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        catalog.resolve("canary-1b-flash", "en")
    for name in ("model.safetensors", "tokenizer.model"):
        (root / name).write_bytes(b"")
    assert catalog.resolve("canary-1b-flash", "en").path("tokenizer.model") == root / "tokenizer.model"
