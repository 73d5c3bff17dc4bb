"""Operations and bytes: the K1 bound against ``chip_smoke.attention_bound``
at its shapes, and the model FLOPs against a count from the layer shapes."""

import pytest
import torch
from portbench import flops, spec
from portbench.peaks import PEAK_FLOPS

ARCH = spec.load_json(spec.BENCH_DIR / "configs" / "moonshine_base.json")["arch"]


@pytest.mark.parametrize("b,t,h,hd,dtype", [
    (512, 384, 8, 52, torch.bfloat16), (1, 82, 8, 52, torch.float32),
    (1, 665, 8, 52, torch.float32), (1, 2665, 8, 52, torch.float32), (4, 415, 8, 52,
                                                                         torch.bfloat16)])
def test_attention_bound_is_chip_smokes(b, t, h, hd, dtype):
    import chip_smoke

    theirs = chip_smoke.attention_bound(b, t, h, hd, dtype, f32_weights=False)
    peak = PEAK_FLOPS["bfloat16" if dtype == torch.bfloat16 else "float32_six_pass"]
    ours = flops.attention_bound(b, t, h, hd, torch.empty((), dtype=dtype).element_size(), peak)
    assert ours["bytes"] == theirs["bytes"] and ours["flops"] == theirs["flops"]
    assert ours["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-12)
    assert ours["bound_by"] == theirs["bound_by"]


def test_attention_bound_counts_each_rows_valid_length():
    one = flops.attention_bound(1, 100, 8, 52, 2, 989e12)
    two = flops.attention_bound(2, [100, 50], 8, 52, 2, 989e12)
    half = flops.attention_bound(1, 50, 8, 52, 2, 989e12)
    assert two["flops"] == one["flops"] + half["flops"]
    assert two["bytes"] == one["bytes"] + half["bytes"]


def test_base_flops_per_audio_second():
    """About 2.9 GFLOP per audio second of a 10 s clip at 6.5 tokens a
    second: frontend 0.5 (its 7-tap convolution at 83 frames a second),
    encoder 1.6 with attention, cross K/V 0.2, decoder 0.5."""
    n = 16000 * 10
    frames = flops.moonshine_frames(ARCH, n)[-1]
    total = flops.moonshine_encode_flops(ARCH, n) + flops.moonshine_decode_flops(ARCH, frames, 65)
    assert 2.6e9 < total / 10 < 3.2e9
    d, ff = ARCH["hidden_size"], ARCH["intermediate_size"]
    # One encoder layer's products over `frames` frames, counted by hand.
    dense = frames * 2 * (4 * d * d + 2 * d * ff)
    attn = 2 * 2 * frames * frames * d
    frontend = flops.moonshine_encode_flops(ARCH, n) - ARCH["encoder_layers"] * (dense + attn)
    assert 0.4e10 < frontend < 0.6e10  # the frontend, about 0.5 GFLOP an audio second
