"""Log-mel spectrograms, in PyTorch.

Counterpart of the JAX package's ``ops/mel.py``: framing by a strided view,
the DFT as a float32 product with a precomputed real basis, a triangular
mel filterbank as a second product, and ``log(mel + eps)``.  The numpy
parts (mel scales, filterbanks, DFT bases) are copied as they are; the
torch functions compute what their JAX namesakes compute, in float32 (the
port's entry points turn TF32 off on the card, ``core/device.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@lru_cache(maxsize=16)
def mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular (Slaney-style unnormalized) filters."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(int)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, c, hi = bins[m], bins[m + 1], bins[m + 2]
        for k in range(lo, c):
            if c > lo:
                fb[k, m] = (k - lo) / (c - lo)
        for k in range(c, hi):
            if hi > c:
                fb[k, m] = (hi - k) / (hi - c)
    return fb


@lru_cache(maxsize=16)
def _dft_basis(n_fft: int) -> np.ndarray:
    """Real-DFT basis with Hann window: [n_fft, 2*(n_fft//2+1)]."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)
    k = np.arange(n_bins)
    cos = np.cos(2 * np.pi * np.outer(t, k) / n_fft)
    sin = -np.sin(2 * np.pi * np.outer(t, k) / n_fft)
    window = np.hanning(n_fft)[:, None]
    return (np.concatenate([cos, sin], axis=1) * window).astype(np.float32)


# Slaney-scale variant: the micro frontend's math (torchaudio MelSpectrogram
# with norm="slaney", mel_scale="slaney", periodic Hann, center reflect
# padding).

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # == 15.0
_LOG_STEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= _MIN_LOG_HZ, _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOG_STEP, f / _F_SP)


def mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOG_STEP * (m - _MIN_LOG_MEL)), _F_SP * m)


@lru_cache(maxsize=16)
def mel_filterbank_slaney(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float = 20.0, fmax: float | None = None
) -> np.ndarray:
    """[n_fft//2+1, n_mels] Slaney-scale triangles with Slaney area norm:
    bin frequencies sample_rate/2 * k/(n_freq-1), each triangle scaled by
    2/(f_right-f_left)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freq = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    bin_hz = sample_rate * 0.5 * np.arange(n_freq) / (n_freq - 1)
    fb = np.zeros((n_freq, n_mels), np.float32)
    for m in range(n_mels):
        f_left, f_center, f_right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        enorm = 2.0 / (f_right - f_left)
        up = (bin_hz - f_left) / (f_center - f_left)
        down = (f_right - bin_hz) / (f_right - f_center)
        w = np.where(bin_hz <= f_center, up, down)
        w = np.where((bin_hz <= f_left) | (bin_hz >= f_right), 0.0, w) * enorm
        fb[:, m] = w.astype(np.float32)
    return fb


@lru_cache(maxsize=16)
def _dft_basis_periodic(n_fft: int) -> np.ndarray:
    """Real-DFT basis with PERIODIC Hann window: [n_fft, 2*(n_fft//2+1)],
    w[i] = 0.5 - 0.5 cos(2*pi*i/n) (torch.hann_window(periodic=True))."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)
    k = np.arange(n_bins)
    cos = np.cos(2 * np.pi * np.outer(t, k) / n_fft)
    sin = -np.sin(2 * np.pi * np.outer(t, k) / n_fft)
    window = (0.5 - 0.5 * np.cos(2 * np.pi * t / n_fft))[:, None]
    return (np.concatenate([cos, sin], axis=1) * window).astype(np.float32)


@lru_cache(maxsize=64)
def _on_device(table, args: tuple, device: torch.device) -> torch.Tensor:
    """A numpy table copied to ``device`` once (a copy from the host inside
    every call would synchronise the card's stream)."""
    return torch.from_numpy(table(*args)).to(device)


def _log_mel_power(frames: torch.Tensor, basis: torch.Tensor, fb: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """[..., n_fft] frames -> [..., n_mels] log-mel energies (float32)."""
    spec = frames.float() @ basis
    n_bins = basis.shape[1] // 2
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    power = re * re + im * im
    return torch.log(power @ fb + eps)


def _standardize(mel: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """Per-clip/window mean/std normalisation: Bessel std clamped >= 1e-3."""
    mean = mel.mean(dim=dims, keepdim=True)
    std = mel.std(dim=dims, keepdim=True, correction=1)
    return (mel - mean) / torch.clamp(std, min=1e-3)


def _frames(audio: torch.Tensor, n_fft: int, hop: int, pad: int, n_frames: int | None = None):
    """[B, N] -> [B, T, n_fft] overlapping frames after reflect padding."""
    if pad:
        audio = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = audio.unfold(-1, n_fft, hop)
    return frames if n_frames is None else frames[:, :n_frames]


def log_mel_clip(
    audio: torch.Tensor,  # [B, N]
    n_fft: int = 512,
    hop: int = 125,
    n_mels: int = 64,
    sample_rate: int = 16000,
    target_frames: int = 128,
    fmin: float = 20.0,
    fmax: float | None = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """[B, N] waveform -> [B, 1, n_mels, target_frames] normalised log-mel:
    center reflect pad, periodic Hann, power spectrum, Slaney filterbank,
    crop or right-pad to target_frames with log(eps), per-clip
    standardisation."""
    dev = audio.device
    pad = n_fft // 2
    n = audio.shape[-1] + 2 * pad
    n_frames = min(1 + (n - n_fft) // hop, target_frames)
    basis = _on_device(_dft_basis_periodic, (n_fft,), dev)
    fb = _on_device(mel_filterbank_slaney, (n_mels, n_fft, sample_rate, fmin, fmax), dev)
    mel = _log_mel_power(_frames(audio, n_fft, hop, pad, n_frames), basis, fb, eps)
    mel = mel.transpose(1, 2)  # [B, M, T]
    if n_frames < target_frames:
        mel = F.pad(mel, (0, target_frames - n_frames), value=float(np.log(eps)))
    return _standardize(mel, (1, 2))[:, None, :, :]


def mel_columns(
    hops: torch.Tensor,  # [B, H, n_fft]: non-overlapping hops (hop == n_fft)
    n_fft: int = 512,
    n_mels: int = 32,
    sample_rate: int = 16000,
    fmin: float = 20.0,
    fmax: float | None = 8000.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Per-hop log-mel columns [B, H, n_mels] for the streaming VAD
    frontend: one windowed FFT per 512-sample hop, no reflect padding."""
    dev = hops.device
    basis = _on_device(_dft_basis_periodic, (n_fft,), dev)
    fb = _on_device(mel_filterbank_slaney, (n_mels, n_fft, sample_rate, fmin, fmax), dev)
    return _log_mel_power(hops, basis, fb, eps)


def log_mel(
    audio: torch.Tensor,  # [B, N]
    n_fft: int = 400,
    hop: int = 160,
    n_mels: int = 80,
    sample_rate: int = 16000,
    center: bool = True,
    eps: float = 1e-6,
) -> torch.Tensor:
    """[B, N] waveform -> [B, T, n_mels] log-mel energies."""
    dev = audio.device
    basis = _on_device(_dft_basis, (n_fft,), dev)
    fb = _on_device(mel_filterbank, (n_mels, n_fft, sample_rate), dev)
    return _log_mel_power(_frames(audio, n_fft, hop, n_fft // 2 if center else 0), basis,
                          fb, eps)
