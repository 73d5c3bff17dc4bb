"""The plain reference of Canary-Qwen (``reference/canary_qwen.py``): its
pieces against their definitions written out here, and the whole against
moonshine_tpu_torch at a small size on the CPU, float32 on both sides (the
audio embeddings; the LLM's logits through the cache, float and int8); the
FLOPs and roofline arithmetic of ``portbench/flops_salm.py``; and the two
roofline readers on a made-up trace."""

import math

import pytest
import torch
from portbench import flops_salm, spec
from portbench.drivers.common import benchmark_weights, meta_model, program_model, tuples
from portbench.trace import Session
from portbench.weights import leaf_shapes
from reference import canary_qwen as ref
from reference.numerics import Products

F32 = Products("float32")
TINY = dict(d_model=64, encoder_layers=2, n_heads=4, ff_dim=128, subsampling_channels=16,
            adapter_layers=1, llm_hidden_size=64, llm_layers=2, llm_heads=4, llm_kv_heads=2,
            llm_head_dim=16, llm_intermediate_size=128, vocab_size=300,
            prompt_prefix_ids=[1, 2, 3, 4, 5, 6, 7, 8, 9], prompt_suffix_ids=[10, 11, 12, 13, 14],
            eos_token_id=0)


def _arch(**change) -> dict:
    return dict(spec.load_json(spec.BENCH_DIR / "configs" / "canary_qwen_2_5b.json")["arch"],
                **change)


def _program():
    from moonshine_tpu_torch.models import canary_qwen

    arch = _arch(**TINY)
    cfg = canary_qwen.CanaryQwenArchConfig(**tuples(arch))
    meta = meta_model(canary_qwen.init_params, cfg)
    w = benchmark_weights(leaf_shapes(meta), 11, "cpu", ())
    return arch, cfg, canary_qwen, program_model(meta, w, "cpu"), w


def test_rms_norm_is_the_plain_gain():
    x = torch.randn(3, 8)
    w = torch.rand(8) + 0.5
    want = w * x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    torch.testing.assert_close(ref.rms_norm(x, w, 1e-6), want)


def test_rotation_is_neox_halves():
    """Channel j < hd/2 pairs with j + hd/2, rotated by position * theta^(-2j/hd)."""
    hd, theta = 8, 1e6
    x = torch.randn(5, 2, hd)
    pos = torch.arange(5) + 3
    out = ref.rotate(x, pos, theta)
    for j in range(hd // 2):
        ang = pos.float() * theta ** (-2 * j / hd)
        a, b = x[..., j], x[..., j + hd // 2]
        c, s = ang.cos()[:, None], ang.sin()[:, None]
        torch.testing.assert_close(out[..., j], a * c - b * s)
        torch.testing.assert_close(out[..., j + hd // 2], b * c + a * s)


def test_relative_rotation():
    """q.k after rotation depends on the positions' difference only."""
    q, k = torch.randn(1, 1, 16), torch.randn(1, 1, 16)
    dots = [float((ref.rotate(q, torch.tensor([p + 4]), 1e4)
                   * ref.rotate(k, torch.tensor([p]), 1e4)).sum()) for p in (0, 7, 100)]
    assert max(dots) - min(dots) < 1e-4


def test_attention_groups_heads_and_offsets_the_causal_mask():
    """Query head i reads K/V head i // 2; a query at position first + s sees
    keys up to it."""
    s, t, hd = 3, 7, 4
    q, k, v = torch.randn(s, 4, hd), torch.randn(t, 2, hd), torch.randn(t, 2, hd)
    out = ref.attention(F32, q, k, v, first=t - s)
    for i in range(4):
        for r in range(s):
            n = t - s + r + 1
            w = torch.softmax(k[:n, i // 2] @ q[r, i] / math.sqrt(hd), 0)
            torch.testing.assert_close(out[r, i], w @ v[:n, i // 2], atol=1e-6, rtol=1e-6)


def test_audio_embeddings_match_the_program():
    arch, cfg, cq, model, w = _program()
    audio = torch.randn(16000 * 2 + 77, generator=torch.Generator().manual_seed(1)) * 0.1
    padded = torch.nn.functional.pad(audio, (0, 9000))[None]
    with torch.inference_mode():
        x, mask = cq.encode(model, cfg, padded, torch.tensor([audio.numel()]))
    expect = ref.audio_embeddings(w, arch, audio, F32)
    f = expect.shape[0]
    assert int(mask.sum()) == f and expect.shape[1] == arch["llm_hidden_size"]
    torch.testing.assert_close(x[0, :f], expect, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_forced_logits_match_the_program(kv_int8):
    """The prompt's call then one call a token, a row of a padded batch of
    two, against the reference's one forward over the clip alone."""
    arch, cfg, cq, model, w = _program()
    g = torch.Generator().manual_seed(2)
    audio = torch.zeros(2, 30000)
    audio[0] = torch.randn(30000, generator=g) * 0.1
    audio[1, :14000] = torch.randn(14000, generator=g) * 0.1
    lengths = torch.tensor([30000, 14000])
    tokens = [17, 200, 200, 3, 9]
    with torch.inference_mode():
        x, mask = cq.encode(model, cfg, audio, lengths)
        inputs, plen = model.prompt_embeds(cfg, x, mask)
        cache = model.init_cache(cfg, 2, inputs.shape[1] + len(tokens), plen, kv_int8=kv_int8)
        logits, cache, _ = model.decoder_apply(cfg, inputs, cache)
        rows = [logits[:, -1]]
        for tok in tokens:
            logits, cache, _ = model.decoder_apply(cfg, torch.full((2, 1), tok), cache)
            rows.append(logits[:, -1])
    program = torch.stack(rows, 1)
    for b in range(2):
        emb = ref.audio_embeddings(w, arch, audio[b, :lengths[b]], F32)
        expect = ref.forced_logits(w, arch, emb, torch.tensor(tokens), F32, kv_int8)
        torch.testing.assert_close(program[b], expect, atol=1e-4, rtol=1e-4)


def test_flops_and_bounds_at_full_width():
    """The LLM's 1.41 B parameters of products: 2.82 GFLOP a position and
    its attention; a 20.48 s clip's prompt of 271 positions; the prefill of
    128 such prompts bound by its operations, a decode step by its bytes:
    3.44 GB of weights (the layers and the tied table) and the K/V."""
    arch = _arch()
    assert flops_salm.prompt_length(arch, 327680) == 14 + 257
    assert flops_salm._layer_weights(arch) * 28 == 1_409_286_144
    dense = 2 * 1_409_286_144
    assert flops_salm.llm_flops(arch, 1) == dense + 28 * 2 * 2 * 16 * 128
    assert flops_salm.llm_flops(arch, 3, first=2) == 3 * dense + 28 * 4 * 16 * 128 * (3 + 4 + 5)
    assert flops_salm.weight_bytes(arch, 2) == 2 * (1_409_286_144 + 151936 * 2048)
    pre = flops_salm.prefill_bound(arch, [271] * 128, 2)
    assert pre["bound_by"] == "operations" and 0.08 < pre["bound_s"] < 0.11
    step = flops_salm.step_bound(arch, [271] * 128, 1, 2)
    kv = 28 * 2 * 8 * (128 + 4)
    assert step["bytes"] == flops_salm.weight_bytes(arch, 2) + 128 * 272 * kv + 128 * kv
    assert flops_salm.steps_bound_s(arch, [271] * 128, 3, 2) == pytest.approx(
        step["bound_s"] + flops_salm.step_bound(arch, [271] * 128, 2, 2)["bound_s"])
    enc = flops_salm.encode_flops(arch, 20 * 16000)
    from portbench import flops_aed

    adapter = enc - flops_aed.encode_flops(arch, 20 * 16000) - 2 * 251 * 1024 * 2048
    assert adapter == pytest.approx(2 / 32 * (flops_aed.encode_flops(arch, 20 * 16000)
                                              - flops_aed.encode_flops(dict(arch, encoder_layers=0),
                                                                       20 * 16000)))


def _record(sessions):
    from portbench.runner import RunRecord

    rec = RunRecord("c", {})
    rec.sessions = sessions
    return rec


@pytest.mark.parametrize("name,span,bound", [
    ("llm_prefill_roofline.salm", "salm.prefill",
     lambda a, n: flops_salm.prefill_bound(a, n, 2)["bound_s"]),
    ("llm_step_roofline.salm", "greedy.step",
     lambda a, n: flops_salm.steps_bound_s(a, n, 3, 2)),
])
def test_the_roofline_readers(monkeypatch, name, span, bound):
    """Each reader: the bound over the device time launched inside its
    spans; nothing to read without the spans or the sessions' info."""
    import portbench.launches as launches

    arch = _arch()
    sess = Session("decode", 1.0, [("a", 0.0, 100.0), ("b", 200.0, 300.0), ("c", 400.0, 450.0)])
    sess.info.update(launch_us=[5.0, 15.0, 40.0], steps=3,
                     salm={"arch": arch, "prompt_lengths": [271, 250], "elt_bytes": 2})
    spans = {span: [(0.0, 10.0), (30.0, 50.0)]}
    monkeypatch.setattr(launches, "span_intervals_us", lambda n: spans.get(n, []))
    read = spec.metric_reader(name)
    assert read(_record([sess])) == pytest.approx(100 * bound(arch, [271, 250]) / 150e-6)
    spans.clear()
    assert read(_record([sess])) is None
    assert read(_record([Session("encode", 1.0, [("a", 0.0, 1.0)])])) is None
