"""The traffic generator: deterministic per seed, the same sizes for every
seed, the stated length distributions, and the batches of
``eval/librispeech._buckets``."""

import numpy as np
import pytest
import torch
from portbench import spec, traffic

ARCH = spec.load_json(spec.BENCH_DIR / "configs" / "moonshine_base.json")["arch"]
MIXES = {name: spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")
         for name in ("offline_corpus_b64",)}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_lengths_follow_the_stated_distribution(mix):
    clips = MIXES[mix]["clips"]
    lengths = traffic.clip_lengths(clips) / traffic.SAMPLE_RATE
    assert len(lengths) == clips["pool"]
    assert lengths.min() >= clips["min_s"] and lengths.max() <= clips["max_s"]
    assert abs(np.median(lengths) - clips["median_s"]) < 0.01 * clips["median_s"]
    inside = np.log(lengths[(lengths > clips["min_s"]) & (lengths < clips["max_s"])])
    assert abs(inside.std() - clips["sigma"]) < 0.15 * clips["sigma"] + 0.02


def test_offline_corpus_mean_and_total():
    lengths = traffic.clip_lengths(MIXES["offline_corpus_b64"]["clips"]) / traffic.SAMPLE_RATE
    assert 7.0 < lengths.mean() < 7.4  # about LibriSpeech test-clean's 7.4 s
    assert 57_000 < lengths.sum() < 60_000


def test_same_sizes_for_every_seed():
    lengths = traffic.clip_lengths(dict(MIXES["offline_corpus_b64"]["clips"], pool=32))
    o1 = traffic.rng(2**31 + 5, 3).permutation(32)
    assert np.array_equal(o1, traffic.rng(2**31 + 5, 3).permutation(32))
    assert sorted(lengths[o1]) == sorted(lengths[traffic.rng(7, 3).permutation(32)])


def _librispeech_buckets(utts, batch):
    """eval/librispeech._buckets of the port, over (id, audio) pairs."""
    from moonshine_tpu_torch.core.config import BASE
    from moonshine_tpu_torch.eval.librispeech import _buckets

    return [(n, [u for u, _ in items]) for n, items in _buckets(BASE, utts, batch)]


@pytest.mark.parametrize("batch", [64, 512])
def test_batches_are_the_librispeech_buckets(batch):
    lengths = traffic.clip_lengths(MIXES["offline_corpus_b64"]["clips"])[::8]
    order = traffic.rng(11, 3).permutation(len(lengths))
    ours = traffic.bucket_batches(ARCH, lengths, order, batch)
    theirs = _librispeech_buckets([(int(i), np.zeros(lengths[i], np.float32)) for i in order],
                                  batch)
    assert [(n, list(idx)) for n, idx in ours] == theirs


def test_bucket_counts_and_interleave():
    mix = MIXES["offline_corpus_b64"]
    lengths = traffic.clip_lengths(mix["clips"])
    order = traffic.rng(3, 3).permutation(len(lengths))
    batches = traffic.bucket_batches(ARCH, lengths, order, mix["batch"])
    assert sum(len(idx) for _, idx in batches) == mix["clips"]["pool"]
    sizes = sorted({n for n, _ in batches})
    assert len(sizes) == 10  # 128-frame steps up to 1,280 frames (30 s)
    mixed = traffic.interleave(batches, 3)
    assert sorted(id(b) for b in mixed) == sorted(id(b) for b in batches)
    # Every quarter of the order holds each bucket's batches in proportion.
    q = len(mixed) // 4
    for n in sizes:
        total = sum(1 for m, _ in batches if m == n)
        first = sum(1 for m, _ in mixed[:q] if m == n)
        assert abs(first - total / 4) <= 1.01


def test_padded_noise_is_zero_past_each_length():
    lens = torch.tensor([5, 9, 1])
    a = traffic.padded_noise(lens, 9, 0.1, traffic.device_generator(2**31 + 5, 1, "cpu"))
    b = traffic.padded_noise(lens, 9, 0.1, traffic.device_generator(2**31 + 5, 1, "cpu"))
    c = traffic.padded_noise(lens, 9, 0.1, traffic.device_generator(7, 1, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == (3, 9)
    for r, k in enumerate(lens.tolist()):
        assert bool((a[r, k:] == 0).all()) and bool((a[r, :k] != 0).all())
