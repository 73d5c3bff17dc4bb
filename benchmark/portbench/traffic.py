"""The general traffic generator: clip lengths, noise audio and batches,
from a mix's parameters and the run's seed.

Every seed gets the same set of sizes: the clip lengths are the quantiles
of the mix's log-normal at (i + 1/2) / pool, clipped to its range, so that
runs with different seeds do the same work.  The seed decides which clip
gets which length, the samples of each clip and the order of the batches.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

SAMPLE_RATE = 16000


def clip_lengths(clips: dict) -> np.ndarray:
    """The mix's clip lengths in samples: ``pool`` quantiles of a
    log-normal of median ``median_s`` and shape ``sigma``, clipped to
    [``min_s``, ``max_s``], in ascending order."""
    unit = NormalDist()
    n = clips["pool"]
    secs = [math.exp(math.log(clips["median_s"]) + clips["sigma"] * unit.inv_cdf((i + 0.5) / n))
            for i in range(n)]
    secs = np.clip(np.asarray(secs), clips["min_s"], clips["max_s"])
    return np.round(secs * SAMPLE_RATE).astype(np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one named use of the run's seed."""
    return np.random.default_rng([seed, stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named use of the run's seed."""
    mixed = int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def padded_noise(lengths: torch.Tensor, n: int, std: float, gen: torch.Generator) -> torch.Tensor:
    """A batch of Gaussian noise at ``std``, row r holding ``lengths[r]``
    samples and zeros after them up to ``n``, made on the generator's
    device in one call."""
    out = torch.empty((len(lengths), n), dtype=torch.float32, device=lengths.device)
    out.normal_(0.0, std, generator=gen)
    out.masked_fill_(torch.arange(n, device=lengths.device)[None, :] >= lengths[:, None], 0.0)
    return out


# -- batches: eval/librispeech._buckets' arithmetic -----------------------------

def frames_for_samples(arch: dict, n: int) -> int:
    for k, s in zip(arch["conv_kernels"], arch["conv_strides"]):
        n = (n - k) // s + 1
    return max(n, 0)


def _hop(arch: dict) -> int:
    return math.prod(arch["conv_strides"])


def lane_aligned_samples(arch: dict, n: int, align: int = 128) -> int:
    """Smallest padded sample count >= ``n`` whose frame count is a
    multiple of ``align`` (``models.moonshine.lane_aligned_samples``)."""
    f = frames_for_samples(arch, n)
    target = max(-(-f // align) * align, align)
    while frames_for_samples(arch, n) < target:
        n += _hop(arch) * max(target - frames_for_samples(arch, n), 1)
    return n


def bucket_batches(arch: dict, lengths: np.ndarray, order: np.ndarray, batch: int,
                   step: int = 128, max_frames: int = 1408) -> list[tuple[int, np.ndarray]]:
    """Clips grouped into frame buckets of ``step``-frame steps (the last
    takes every longer clip), ``batch`` to a batch in ``order`` within a
    bucket, as ``eval/librispeech._buckets`` groups them.  Returns
    (padded samples, clip indices) per batch, bucket by bucket."""
    ladder = list(range(step, max_frames + 1, step))
    groups: dict[int, list[int]] = {}
    for i in order:
        f = frames_for_samples(arch, int(lengths[i]))
        b = next((b for b in ladder if f <= b), ladder[-1])
        groups.setdefault(b, []).append(int(i))
    out = []
    smallest = lane_aligned_samples(arch, 1)
    for b, items in sorted(groups.items()):
        n = lane_aligned_samples(arch, smallest + (b - step) * _hop(arch))
        for i in range(0, len(items), batch):
            out.append((n, np.asarray(items[i:i + batch])))
    return out


def interleave(batches: list, seed: int) -> list:
    """The batches in an order whose every stretch holds the buckets in
    about the pool's proportions: batch j of a bucket with m batches goes
    to (j + u) / m, u uniform from the seed."""
    r = rng(seed, 2)
    counts: dict[int, int] = {}
    for n, _ in batches:
        counts[n] = counts.get(n, 0) + 1
    seen: dict[int, int] = {}
    keys = []
    for n, _ in batches:
        j = seen.get(n, 0)
        seen[n] = j + 1
        keys.append((j + r.uniform()) / counts[n])
    return [batches[i] for i in np.argsort(keys, kind="stable")]
