"""``ops.mel.nemo_log_mel`` (the features of NeMo's FastConformer models)
against a plain numpy definition of the same features, written out here:
pre-emphasis, 256 zeros on each side, a frame every 160 samples under a
symmetric 400-sample Hann window centred in 512 points, ``numpy.fft.rfft``,
the power spectrum, librosa's Slaney mel filters from 0 Hz to Nyquist,
``log(x + 2^-24)``, each bin normalised by its mean and unbiased std
(+1e-5) over the clip's valid frames, zeros after them.

Tolerance: the port computes in float32 (the DFT as a product with a basis
of 512 terms), numpy in float64.  The normalised features have unit
variance; their float32 error is 1e-5 to 3e-5 for clips of a second or
more, and 1.0e-4 for a clip of two frames (whose std of two values
magnifies it): 1e-3 absolute is ten times the largest difference seen
and far below a wrong window, mel scale or normalisation (all above
1e-2).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch.ops.mel import nemo_frames, nemo_log_mel

TOL = 1e-3


def _slaney_mel(f):
    f = np.asarray(f, np.float64)
    with np.errstate(divide="ignore"):
        return np.where(f >= 1000.0, 15.0 + np.log(f / 1000.0) / (np.log(6.4) / 27.0),
                        3.0 * f / 200.0)


def _slaney_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), 200.0 * m / 3.0)


def _filters(n_mels=128, n_fft=512, sr=16000) -> np.ndarray:
    """[n_bins, n_mels]: triangles between adjacent mel points, each scaled
    by 2 / (its width in Hz)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _slaney_hz(np.linspace(_slaney_mel(0.0), _slaney_mel(sr / 2.0), n_mels + 2))
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        rise = (freqs - lo) / (c - lo)
        fall = (hi - freqs) / (hi - c)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb


def _plain(clip: np.ndarray, n_frames: int) -> np.ndarray:
    """[n_frames, 128] of one clip (its valid samples), zeros past its own
    frames."""
    x = np.concatenate([clip[:1], clip[1:] - 0.97 * clip[:-1]]).astype(np.float64)
    x = np.concatenate([np.zeros(256), x, np.zeros(256 + 160 * n_frames)])
    window = np.zeros(512)
    window[56:456] = np.hanning(400)
    valid = len(clip) // 160 + 1
    frames = np.stack([x[160 * t:160 * t + 512] * window for t in range(valid)])
    power = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    mel = np.log(power @ _filters() + 2.0**-24)
    std = mel.std(axis=0, ddof=1) if valid > 1 else np.zeros(mel.shape[1])
    out = np.zeros((n_frames, mel.shape[1]))
    out[:valid] = (mel - mel.mean(axis=0)) / (std + 1e-5)
    return out


@pytest.mark.parametrize("lengths", [[16000, 9123, 161, 40], [48000]])
def test_features_match_the_plain_definition(lengths):
    rng = np.random.default_rng(len(lengths))
    n = max(lengths)
    audio = np.zeros((len(lengths), n), np.float32)
    for i, k in enumerate(lengths):
        audio[i, :k] = rng.standard_normal(k) * 0.1 * (1 + np.sin(np.arange(k) / 800.0))
    feats, frames = nemo_log_mel(torch.from_numpy(audio), torch.tensor(lengths))
    assert feats.shape == (len(lengths), n // 160 + 1, 128) and feats.dtype == torch.float32
    assert frames.tolist() == [nemo_frames(k) for k in lengths] == [k // 160 + 1 for k in lengths]
    for i, k in enumerate(lengths):
        expect = _plain(audio[i, :k], feats.shape[1])
        assert np.abs(feats[i].numpy() - expect).max() < TOL


def test_a_clip_does_not_depend_on_its_padding():
    rng = np.random.default_rng(3)
    clip = torch.from_numpy((rng.standard_normal(7000) * 0.1).astype(np.float32))
    alone, _ = nemo_log_mel(clip[None])
    padded = torch.zeros(2, 20000)
    padded[0, :7000] = clip
    padded[1] = torch.from_numpy((rng.standard_normal(20000) * 0.1).astype(np.float32))
    batch, frames = nemo_log_mel(padded, torch.tensor([7000, 20000]))
    torch.testing.assert_close(batch[0, :frames[0]], alone[0], atol=1e-5, rtol=0)
    assert not batch[0, frames[0]:].any()
