"""WORLD-lite vocoder, in PyTorch: all pulses rendered as ONE batched FFT
program.

Counterpart of the JAX package's ``tts/worldlite.py``.  The reference
renders 61-control WORLD-lite frames — f0 (Hz, 0 = unvoiced), benv[48]
(sqrt-power envelope at mel knots), bap[12] (aperiodicity at mel band
centers), 5 ms / 16 kHz — to PCM one pulse at a time with kissfft on an
M33 (reference: micro/neural-tts/src/worldlite_synth.cc, itself a float
port of WORLD Synthesis(), mmorise/World BSD-3-Clause).  Here:

- pulse locations come from the f0 contour alone, so the whole pulse
  plan (positions, fractional shifts, voicing, noise sizes) is computed
  up front in vectorized numpy (``pulse_plan``, copied);
- the mel-knot->513-bin piecewise-linear expansion is a dense matrix
  multiply (``expand_matrices``, copied);
- every pulse's minimum-phase periodic + shaped-noise aperiodic response
  is computed in one batched [P, 1024] rfft/irfft pipeline on the device
  (``render``), then overlap-added.

Where a straight translation would part from JAX's results:

- Inverse FFTs: the shifted periodic spectrum has an imaginary part at
  the Nyquist bin; JAX's CPU ``irfft`` ignores it, and cuFFT's C2R makes
  no promise for such non-Hermitian input, so the DC and Nyquist
  imaginary parts are zeroed before every ``torch.fft.irfft``.
- Noise: JAX draws ``jax.random.normal(PRNGKey(seed), (P, 512))``, which
  torch cannot reproduce.  The port draws from a CPU ``torch.Generator``
  seeded by ``seed`` (the same draw whatever the device), or takes the
  draw as ``noise=``; the same seed gives other PCM than JAX's.
- Overlap-add: pulses land at irregular positions, and ``index_add_`` on
  CUDA sums colliding indices with atomics in no fixed order.  The pulses
  are split into sets whose 1,024-sample responses never overlap (pulse
  i goes to set i mod G, G the least stride at which pulses are 1,024
  samples apart) and the sets are added in turn, so the sum is the same
  on every run and device (in another order than JAX's scatter).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

SAMPLE_RATE = 16000
FFT_SIZE = 1024
FRAME_SAMPLES = 80  # 5 ms
N_BENV = 48
N_BAP = 12
SPEC_BINS = FFT_SIZE // 2 + 1  # 513
F0_FLOOR = 32.0
UNVOICED_PULSE_HZ = 200.0
MAX_NOISE = FFT_SIZE // 2


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def expand_matrices() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(W_benv [513,48], W_bap [513,12], dc_remover [1024]).

    W maps knot values to FFT bins by mel piecewise-linear interpolation
    (reference: worldlite_synth.cc InitTables / build_map); dc_remover is
    WORLD's GetDCRemover window.
    """

    def build(n_knots):
        W = np.zeros((SPEC_BINS, n_knots), np.float32)
        mel_max = _hz_to_mel(SAMPLE_RATE / 2.0)
        for i in range(SPEC_BINS):
            hz = i * (SAMPLE_RATE / 2.0) / (SPEC_BINS - 1)
            pos = _hz_to_mel(hz) / mel_max * (n_knots - 1)
            idx = min(int(pos), n_knots - 2)
            frac = min(max(pos - idx, 0.0), 1.0)
            W[i, idx] = 1.0 - frac
            W[i, idx + 1] = frac
        return W

    half = np.arange(FFT_SIZE // 2)
    dc = 0.5 - 0.5 * np.cos(2.0 * np.pi * (half + 1.0) / (1.0 + FFT_SIZE))
    total = dc.sum() * 2.0
    dc = dc / total
    dc_remover = np.concatenate([dc, dc[::-1]]).astype(np.float32)
    return build(N_BENV), build(N_BAP), dc_remover


def pulse_plan(f0_frames: np.ndarray) -> dict:
    """Vectorized pulse plan from the frame-rate f0 contour.

    Mirrors the per-sample loop of worldlite_synth.cc Synthesize():
    per-sample f0 interpolation with the voiced/unvoiced selection rules,
    phase accumulation, pulses at 2π wraps, fractional shift from the
    linear crossing.  Returns arrays over pulses.
    """
    f0 = np.asarray(f0_frames, np.float32).copy()
    f0[f0 < F0_FLOOR] = 0.0
    T = len(f0)
    y_len = T * FRAME_SAMPLES
    s = np.arange(y_len)
    ft = s / FRAME_SAMPLES
    t0 = np.minimum(ft.astype(np.int64), T - 1)
    t1 = np.minimum(t0 + 1, T - 1)
    w = ft - t0
    f0_a = f0[t0]
    f0_b = f0[t1]
    va = f0_a > 0.0
    vb = f0_b > 0.0
    voiced_s = np.where(w < 0.5, va, vb)
    f0_s = np.where(
        va & vb,
        f0_a + w * (f0_b - f0_a),
        np.where(voiced_s, np.where(va, f0_a, f0_b), UNVOICED_PULSE_HZ),
    ).astype(np.float64)

    dphi = 2.0 * np.pi * f0_s / SAMPLE_RATE
    phase = np.cumsum(dphi)
    wrapped = np.mod(phase, 2.0 * np.pi)
    pulse = np.zeros(y_len, bool)
    pulse[1:] = np.abs(wrapped[1:] - wrapped[:-1]) > np.pi

    idx = np.nonzero(pulse)[0]  # wrap sample s; pulse sits at s-1
    prev_w = wrapped[idx - 1]
    py1 = prev_w - 2.0 * np.pi
    py2 = wrapped[idx]
    frac = np.where(py2 > py1, -py1 / np.maximum(py2 - py1, 1e-12), 0.0)

    pulse_index = idx - 1
    pt = pulse_index / FRAME_SAMPLES
    pt0 = np.minimum(pt.astype(np.int64), T - 1)
    pt1 = np.minimum(pt0 + 1, T - 1)
    pw = (pt - pt0).astype(np.float32)

    noise = np.minimum(
        (SAMPLE_RATE / f0_s[idx] + 0.5).astype(np.int64), MAX_NOISE
    )
    noise = np.maximum(noise, 1)

    return {
        "pulse_index": pulse_index.astype(np.int64),
        "frac_shift_s": (frac / SAMPLE_RATE).astype(np.float32),
        "voiced": voiced_s[idx],
        "pt0": pt0,
        "pt1": pt1,
        "pw": pw,
        "noise_size": noise,
        "y_len": y_len,
    }


_TABLES: tuple | None = None


def _tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = expand_matrices()
    return _TABLES


def _irfft(spec: torch.Tensor) -> torch.Tensor:
    """Unnormalized inverse real FFT (kissfft's fftri, N x irfft) of
    ``[P, 513]``, the DC and Nyquist imaginary parts taken as zero."""
    if spec.is_complex():
        im = spec.imag.clone()
        im[:, 0] = 0.0
        im[:, -1] = 0.0
        spec = torch.complex(spec.real, im)
    return torch.fft.irfft(spec, n=FFT_SIZE, dim=-1) * FFT_SIZE


def _min_phase(log_amp_half: torch.Tensor) -> torch.Tensor:
    """Batched minimum-phase spectrum from half log-amplitude [P, 513].

    cepstral folding exactly as worldlite_synth.cc MinimumPhase: an
    UNNORMALIZED inverse DFT of the hermitian-even log-amplitude (kissfft
    fftri ≡ N · irfft), fold to causal, forward rfft, complex exp with the
    1/N compensation.
    """
    n = FFT_SIZE
    cep = _irfft(log_amp_half)
    fold = torch.cat(
        [cep[:, :1], cep[:, 1 : n // 2] * 2.0, cep[:, n // 2 : n // 2 + 1],
         torch.zeros_like(cep[:, n // 2 + 1 :])],
        dim=-1,
    )
    spec = torch.fft.rfft(fold, n=n, dim=-1)
    inv_n = 1.0 / n
    mag = torch.exp(spec.real * inv_n)
    ph = spec.imag * inv_n
    return torch.complex(mag * torch.cos(ph), mag * torch.sin(ph))


def overlap_sets(pulse_index: np.ndarray) -> int:
    """The least G such that pulses G apart in the plan lie at least
    FFT_SIZE samples apart: pulses i and i + G never overlap."""
    for g in range(1, len(pulse_index)):
        if np.all(pulse_index[g:] - pulse_index[:-g] >= FFT_SIZE):
            return g
    return max(len(pulse_index), 1)


def _render_pulses(
    spec_pow: torch.Tensor,  # [T, 513] power envelope per frame
    ap: torch.Tensor,  # [T, 513] aperiodicity per frame (clipped)
    dc_remover: torch.Tensor,  # [1024]
    pt0: torch.Tensor, pt1: torch.Tensor, pw: torch.Tensor,  # [P] frame interpolation
    voiced: torch.Tensor,  # [P] bool
    frac_shift_s: torch.Tensor,  # [P]
    noise_size: torch.Tensor,  # [P] int
    pulse_index: torch.Tensor,  # [P]
    noise: torch.Tensor,  # [P, MAX_NOISE] standard normal
    sets: list[tuple[int, int]],  # pulse ranges whose responses never overlap
    y_len: int,
) -> torch.Tensor:
    eps = 1e-12
    n = FFT_SIZE
    dev = spec_pow.device

    pow_i = spec_pow[pt0] + pw[:, None] * (spec_pow[pt1] - spec_pow[pt0])
    ap_i = ap[pt0] + pw[:, None] * (ap[pt1] - ap[pt0])
    ap2 = ap_i * ap_i

    # -- periodic component (voiced pulses only) ---------------------------
    log_per = 0.5 * torch.log(pow_i * (1.0 - ap2) + eps)
    mp = _min_phase(log_per)  # [P, 513] complex
    # fractional time shift: linear phase ramp with the reference's
    # sqrt(1-cos^2) sine convention (theta folded into [0, pi]).
    coef = 2.0 * np.pi * frac_shift_s[:, None] * SAMPLE_RATE / n
    bins = torch.arange(SPEC_BINS, device=dev)[None, :]
    re2 = torch.cos(coef * bins)
    im2 = torch.sqrt(torch.clamp(1.0 - re2 * re2, min=0.0))
    shifted = torch.complex(mp.real * re2 + mp.imag * im2, mp.imag * re2 - mp.real * im2)
    per = _irfft(shifted)
    per = torch.roll(per, n // 2, dims=-1)  # fftshift
    dc = per[:, n // 2 :].sum(dim=-1, keepdim=True)
    per = per - dc * dc_remover[None, :]
    per = torch.where(voiced[:, None], per, 0.0)

    # -- aperiodic component ----------------------------------------------
    log_ap = torch.where(
        voiced[:, None],
        0.5 * torch.log(pow_i * ap2 + eps),
        0.5 * torch.log(pow_i + eps),
    )
    mp_ap = _min_phase(log_ap)
    mask = torch.arange(MAX_NOISE, device=dev)[None, :] < noise_size[:, None]
    noise = torch.where(mask, noise, 0.0)
    mean = noise.sum(dim=-1, keepdim=True) / noise_size[:, None]
    noise = torch.where(mask, noise - mean, 0.0)
    nspec = torch.fft.rfft(noise, n=n, dim=-1)
    aper = _irfft(mp_ap * nspec)
    aper = torch.roll(aper, n // 2, dims=-1)

    # -- mix + overlap-add -------------------------------------------------
    resp = (per * torch.sqrt(noise_size[:, None].float()) + aper) / n

    out = torch.zeros(y_len + 2 * n, dtype=torch.float32, device=dev)
    # response j lands at sample pulse_index - n/2 + 1 + j; bias by n so
    # negative offsets stay in-range, then slice.
    offs = pulse_index[:, None] + (torch.arange(n, device=dev)[None, :] - n // 2 + 1) + n
    for a, b in sets:  # no two responses of a set overlap: no colliding adds
        out.index_add_(0, offs[a:b].reshape(-1), resp[a:b].reshape(-1))
    return out[n : n + y_len]


def render(
    benv: np.ndarray,  # [T, 48] sqrt-power at mel knots
    bap: np.ndarray,  # [T, 12] aperiodicity
    f0_frames: np.ndarray,  # [T] Hz
    gain: float,
    seed: int = 0,
    *,
    noise: torch.Tensor | np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """Frames -> int16 PCM [T*80] at 16 kHz, rendered on ``device`` (CUDA
    unless named).  ``noise``: the pulses' standard-normal draw, at least
    ``[P, MAX_NOISE]`` for the plan's P pulses (rows past P are not
    used); by default drawn from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    W_benv, W_bap, dc_remover = _tables()
    plan = pulse_plan(f0_frames)
    if len(plan["pulse_index"]) == 0:
        return np.zeros(plan["y_len"], np.int16)

    amp = np.asarray(benv, np.float32) @ W_benv.T  # [T, 513]
    spec_pow = np.maximum(amp * amp, 1e-12)
    ap = np.clip(np.asarray(bap, np.float32) @ W_bap.T, 0.001, 0.999)

    # Bucket the pulse count and output length as JAX does (its compiled
    # programs are shared by utterances of similar size); the padding
    # pulses render into the discarded scatter margin.
    y_len = plan["y_len"]
    y_bucket = -(-y_len // 16384) * 16384
    P = len(plan["pulse_index"])
    Pb = 1 << max(P - 1, 1).bit_length()

    if noise is None:
        noise = torch.randn((Pb, MAX_NOISE), generator=torch.Generator().manual_seed(seed))
    else:
        noise = (noise.float().cpu() if isinstance(noise, torch.Tensor)
                 else torch.from_numpy(np.array(noise, np.float32)))
        if noise.shape[0] < P or noise.shape[1:] != (MAX_NOISE,):
            raise ValueError(f"noise must be at least [{P}, {MAX_NOISE}], got "
                             f"{tuple(noise.shape)}")
        noise = torch.cat([noise[:P], torch.zeros((Pb - P, MAX_NOISE))])

    # Real pulse i goes to set i mod G, the padding pulses (all at one
    # place in the margin) to a last set of their own.
    g = overlap_sets(plan["pulse_index"])
    order = np.concatenate([np.argsort(np.arange(P) % g, kind="stable"), np.arange(P, Pb)])
    bounds = np.cumsum([0] + np.bincount(np.arange(P) % g, minlength=g).tolist() + [Pb - P])
    sets = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

    def pulses(a, value):  # padded to Pb, in set order, on the device
        return torch.from_numpy(np.concatenate([a, np.full(Pb - P, value, a.dtype)])[order]).to(dev)

    pcm = _render_pulses(
        torch.from_numpy(spec_pow).to(dev), torch.from_numpy(ap).to(dev),
        torch.from_numpy(dc_remover).to(dev),
        pulses(plan["pt0"], 0), pulses(plan["pt1"], 0), pulses(plan["pw"], 0.0),
        pulses(plan["voiced"], False), pulses(plan["frac_shift_s"], 0.0),
        pulses(plan["noise_size"], 1),
        # pad pulses land at y_bucket+511: their whole 1024-sample response
        # falls in the discarded upper scatter margin.
        pulses(plan["pulse_index"], y_bucket + 511),
        noise[torch.from_numpy(order)].to(dev), sets, y_len=y_bucket,
    )
    pcm = pcm.cpu().numpy()[:y_len] * gain * 32767.0
    return np.clip(pcm, -32768, 32767).astype(np.int16)
