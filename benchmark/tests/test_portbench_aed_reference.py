"""The plain reference of Canary (``reference/canary.py``): its pieces
against their definitions written out here, and the whole against
moonshine_tpu_torch at a small size on the CPU, float32 on both sides (the
encoder's memory; the decoder's logits through the cache, float and int8);
the FLOPs and roofline arithmetic of ``portbench/flops_aed.py``; and the
readers' matching of device operations to the program's spans."""

import copy

import numpy as np
import pytest
import torch
from portbench import flops_aed, launches, spec
from portbench.drivers.common import benchmark_weights, meta_model, program_model, tuples
from portbench.trace import Session
from portbench.weights import leaf_shapes
from reference import canary as ref
from reference.numerics import Products

F32 = Products("float32")
TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2, n_heads=4, ff_dim=128,
            subsampling_channels=16, vocab_size=300, max_positions=128)


def _program():
    from moonshine_tpu_torch.models import canary

    arch = dict(spec.load_json(spec.BENCH_DIR / "configs" / "canary_1b_flash.json")["arch"],
                **TINY)
    cfg = canary.CanaryArchConfig(**tuples(arch))
    meta = meta_model(canary.init_params, cfg)
    w = benchmark_weights(leaf_shapes(meta), 11, "cpu", ())
    return arch, cfg, canary, program_model(meta, w, "cpu"), w


def test_rel_shift_is_the_relative_index():
    """Query i, key j reads the position term at index (T-1) - i + j, the
    relative position i - j."""
    h, t = 2, 6
    x = torch.randn(h, t, 2 * t - 1)
    out = ref.rel_shift(x)[:, :, :t]
    for i in range(t):
        for j in range(t):
            assert torch.equal(out[:, i, j], x[:, i, t - 1 - i + j])


def test_relative_encoding_positions():
    pe = ref.relative_encoding(4, 8, "cpu")
    pos = torch.tensor([3.0, 2, 1, 0, -1, -2, -3])
    assert torch.allclose(pe[:, 0], torch.sin(pos)) and torch.allclose(pe[:, 1], torch.cos(pos))
    assert torch.allclose(pe[:, 2], torch.sin(pos * 10000 ** (-2 / 8)))


def test_mel_filters_are_slaney_triangles():
    """Each filter is a triangle over its two neighbours' centres, of area
    about 1 in Hz (Slaney's norm: within 4 % where a filter spans more
    than 16 bins of the 512-point DFT, from filter 80 on), non-negative and
    zero at 0 Hz."""
    fb = ref.mel_filters(128, 512, 16000).numpy()
    assert fb.shape == (128, 257) and (fb >= 0).all() and fb[:, 0].max() == 0
    area = fb.sum(axis=1) * (16000 / 512)
    assert np.allclose(area[80:], 1.0, atol=0.04)
    assert (np.diff(fb.argmax(axis=1)) >= 0).all()


def test_features_are_normalised_per_bin():
    """One frame a hop of 160 samples and one more; each mel bin of mean 0
    and unbiased std 1 (less the 1e-5 added to it) over the clip."""
    x = torch.randn(16000 + 37, generator=torch.Generator().manual_seed(3)) * 0.1
    arch = spec.load_json(spec.BENCH_DIR / "configs" / "canary_1b_flash.json")["arch"]
    f = ref.features(x, arch, F32)
    assert f.shape == (101, 128)
    assert torch.allclose(f.mean(0), torch.zeros(128), atol=1e-5)
    assert torch.allclose(f.std(0), torch.ones(128), atol=1e-4)


def test_encode_matches_the_program():
    arch, cfg, canary, model, w = _program()
    audio = torch.randn(16000 * 2 + 77, generator=torch.Generator().manual_seed(1)) * 0.1
    padded = torch.nn.functional.pad(audio, (0, 9000))[None]
    with torch.inference_mode():
        memory, mask = canary.encode(model, cfg, padded, torch.tensor([audio.numel()]))
    expect = ref.encode(w, arch, audio, F32)
    t = expect.shape[0]
    assert int(mask.sum()) == t == cfg.frames_for_samples(audio.numel())
    torch.testing.assert_close(memory[0, :t], expect, atol=1e-4, rtol=1e-4)


def test_attention_probe_matches_the_program():
    """The check's probe: the program's first encoder attention, its
    position projection scaled, read by a hook on its own input in a padded
    batch, against the reference's (float32 on both sides; 1e-4 as for the
    memory)."""
    from portbench.drivers.aed_offline import POS_PROBE_SCALE

    arch, cfg, canary, model, w = _program()
    audio = torch.randn(16000 * 3 + 5, generator=torch.Generator().manual_seed(3)) * 0.1
    padded = torch.nn.functional.pad(audio, (0, 12000))[None]
    attn = model.encoder.layers[0].attn
    probe = copy.deepcopy(attn)
    with torch.no_grad():
        probe.pos.weight.mul_(POS_PROBE_SCALE)
    seen = []
    hook = attn.register_forward_hook(lambda m, args, out: seen.append(probe(*args[:4])))
    with torch.inference_mode():
        canary.encode(model, cfg, padded, torch.tensor([audio.numel()]))
    hook.remove()
    expect = ref.attention_probe(w, arch, audio, F32, POS_PROBE_SCALE)
    unscaled = ref.attention_probe(w, arch, audio, F32, 1.0)
    t = expect.shape[0]
    assert len(seen) == 1
    torch.testing.assert_close(seen[0][0, :t], expect, atol=1e-4, rtol=1e-4)
    # The scale sharpens the position term: the output moves far beyond the tolerance.
    assert (expect - unscaled).abs().max() > 1e-2


@pytest.mark.parametrize("kv_int8", [True, False])
def test_decoder_logits_match_the_program(kv_int8):
    arch, cfg, canary, model, w = _program()
    audio = torch.randn(16000, generator=torch.Generator().manual_seed(2)) * 0.1
    tokens = list(arch["prompt_ids"]) + [17, 200, 200, 3, 9]
    p = len(arch["prompt_ids"])
    with torch.inference_mode():
        memory, mask = canary.encode(model, cfg, audio[None])
        kc, vc = model.compute_cross_kv(cfg, memory)
        cache = model.init_cache(cfg, 1, len(tokens), kc, vc, mask, kv_int8=kv_int8)
        first, cache, _ = model.decoder_apply(cfg, torch.tensor([tokens[:p]]), cache)
        rows = [first[0]]
        for tok in tokens[p:]:
            logits, cache, _ = model.decoder_apply(cfg, torch.tensor([[tok]]), cache)
            rows.append(logits[0])
    program = torch.cat(rows)
    expect = ref.forced_logits(w, arch, memory[0], torch.tensor(tokens), F32, kv_int8)
    torch.testing.assert_close(program, expect, atol=1e-4, rtol=1e-4)


def test_flops_of_a_clip_at_full_width():
    """About 21 GFLOP a second of audio in the encoder at Canary's widths;
    the decoder's share of a 20 s clip under 5 %."""
    arch = spec.load_json(spec.BENCH_DIR / "configs" / "canary_1b_flash.json")["arch"]
    assert flops_aed.frames(arch, 20 * 16000) == [2001, 1001, 501, 251]
    enc = flops_aed.encode_flops(arch, 20 * 16000)
    assert 18e9 < enc / 20 < 24e9
    dec = flops_aed.decode_flops(arch, 251, 5, 80)
    assert dec < 0.05 * enc
    b = flops_aed.relpos_attention_bound(1024, [251, 100], 2)
    t = 251
    assert b["flops"] == 2 * 1024 * (2 * t * t + t * (2 * t - 1)) + 2 * 1024 * (
        2 * 100 * 100 + 100 * 199)
    assert b["bound_by"] == "bytes" and b["bound_s"] == b["bytes"] / 3.35e12


def test_launches_inside_spans():
    """Device operations are claimed by the span their launch lies in: the
    union of their intervals, in seconds."""
    sess = Session("t", 1.0, [("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 300.0, 310.0),
                              ("d", 400.0, 500.0)])
    sess.info["launch_us"] = [5.0, 6.0, 20.0, None]
    assert launches.launched_within_s([sess], [(0.0, 10.0)]) == pytest.approx(150e-6)
    assert launches.launched_within_s([sess], [(0.0, 10.0), (15.0, 25.0)]) == pytest.approx(
        160e-6)
    assert launches.launched_within_s([sess], [(30.0, 40.0)]) is None
    assert launches.launched_within_s([Session("u", 1.0, [("a", 0.0, 1.0)])], [(0, 9)]) is None
