"""Neural TTS acoustic model and iSTFT vocoder, in PyTorch.

Counterpart of the JAX package's ``models/tts.py``: a StyleTTS-flavoured
model with static shapes,

  phoneme ids -> text encoder (rotary transformer, style-conditioned)
  -> duration predictor -> length regulation (a fixed frame budget, masked)
  -> frame decoder -> iSTFT head (magnitude + phase -> overlap-add)
  -> 24 kHz waveform

over ``[MAX_PHONEMES, MAX_FRAMES]`` whatever the text; the caller slices the
waveform to the predicted length.  A voice is a ``[style_dim]`` style
vector.  The transformer layers are ``moonshine.EncoderLayer`` holders
(``ln1``, ``attn`` q/k/v/o, ``ln2``, ``mlp``) in an ``nn.ModuleList``
where JAX stacks them, with the interleaved rotary of ``ops/rotary.py``
and the exact GELU.

Where a straight translation would part from JAX's results:

- ``_istft``'s inverse FFT: the phase head gives the DC and Nyquist bins
  an imaginary part; JAX's CPU ``irfft`` ignores it, and cuFFT's C2R
  makes no promise for such non-Hermitian input, so both are zeroed
  before ``torch.fft.irfft``.
- Overlap-add: JAX scatter-adds every frame; ``index_add_`` on CUDA sums
  with atomics in no fixed order.  N_FFT is 4 * HOP, so the sum here is
  four shifted blocks of frames, added in the order of JAX's scatter, and
  the window-square normaliser is a constant computed once.
- ``softplus`` is JAX's ``logaddexp(x, 0)``; ``F.softplus`` returns x
  above its threshold of 20.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.rotary import apply_rotary, rotary_tables
from .layers import Dense, Norm, dense, dense_init, gelu, layer_norm, norm_init
from .moonshine import Attention, EncoderLayer, Mlp

SAMPLE_RATE = 24000
N_FFT = 1024
HOP = 256
STYLE_DIM = 128
MAX_PHONEMES = 256
MAX_FRAMES = 1024  # ~10.9 s at 93.75 fps

# Phoneme inventory: IPA symbols the G2P engines emit + specials.
_IPA_SYMBOLS = [
    "<pad>", "<bos>", "<eos>", " ", "|", "‖",
    "a", "b", "d", "e", "f", "h", "i", "j", "k", "l", "m", "n", "o", "p",
    "r", "s", "t", "u", "v", "w", "x", "z",
    "æ", "ɑ", "ɔ", "ə", "ɛ", "ɝ", "ɪ", "ʊ", "ʌ", "ŋ", "ɡ", "ɹ", "ɾ",
    "ʃ", "ʒ", "θ", "ð", "ʝ", "ɲ", "ʔ",
    "aɪ", "aʊ", "eɪ", "oʊ", "ɔɪ", "tʃ", "dʒ", "ju", "kw", "ks",
    # Appended (ids above stay stable): stress marks + r-colored schwa,
    # emitted by the baked real-pronunciation dictionary (tts/g2p_dict.py).
    "ˈ", "ˌ", "ɚ",
]
PHONEME_TO_ID = {p: i for i, p in enumerate(_IPA_SYMBOLS)}
VOCAB = len(_IPA_SYMBOLS)
PAD, BOS, EOS = 0, 1, 2


def ipa_to_ids(ipa: str) -> list[int]:
    """Greedy longest-match IPA string -> phoneme ids."""
    ids = [BOS]
    i = 0
    while i < len(ipa):
        if ipa[i : i + 2] in PHONEME_TO_ID:
            ids.append(PHONEME_TO_ID[ipa[i : i + 2]])
            i += 2
        elif ipa[i] in PHONEME_TO_ID:
            ids.append(PHONEME_TO_ID[ipa[i]])
            i += 1
        else:
            i += 1  # unknown symbol: skip
    ids.append(EOS)
    return ids[:MAX_PHONEMES]


class TTSConfig(NamedTuple):
    dim: int = 256
    encoder_layers: int = 4
    decoder_layers: int = 4
    heads: int = 4
    style_dim: int = STYLE_DIM


class TTS(nn.Module):
    """The JAX tree's leaves as holders: ``embed [VOCAB, dim]``,
    ``style_proj``, ``encoder_layers`` + ``encoder_norm``, the duration
    head ``duration_fc1``, ``duration_fc2``, ``decoder_layers`` +
    ``decoder_norm``, ``head_mag`` and ``head_phase``."""

    def __init__(self, embed: torch.Tensor, style_proj: Dense, encoder_layers: list[EncoderLayer],
                 encoder_norm: Norm, duration_fc1: Dense, duration_fc2: Dense,
                 decoder_layers: list[EncoderLayer], decoder_norm: Norm, head_mag: Dense,
                 head_phase: Dense):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.style_proj = style_proj
        self.encoder_layers = nn.ModuleList(encoder_layers)
        self.encoder_norm = encoder_norm
        self.duration_fc1, self.duration_fc2 = duration_fc1, duration_fc2
        self.decoder_layers = nn.ModuleList(decoder_layers)
        self.decoder_norm = decoder_norm
        self.head_mag, self.head_phase = head_mag, head_phase


def _block_init(generator: torch.Generator, dim: int) -> EncoderLayer:
    """As in the JAX initializer, q, k, v and o start equal: JAX draws all
    four from one key."""
    qkvo = dense_init(generator, dim, dim, bias=False).weight.data
    attn = Attention(*(Dense(qkvo.clone()) for _ in range(4)))
    mlp = Mlp(dense_init(generator, dim, dim * 4), dense_init(generator, dim * 4, dim))
    return EncoderLayer(norm_init(dim), attn, norm_init(dim), mlp)


def init_params(cfg: TTSConfig, generator: torch.Generator, device=None) -> TTS:
    """Random weights from ``generator`` on ``device`` (CUDA unless named),
    with the JAX initializer's distributions."""
    d = cfg.dim
    n_bins = N_FFT // 2 + 1
    enc = [_block_init(generator, d) for _ in range(cfg.encoder_layers)]
    dec = [_block_init(generator, d) for _ in range(cfg.decoder_layers)]
    model = TTS(torch.randn((VOCAB, d), generator=generator) * 0.02,
                dense_init(generator, cfg.style_dim, d), enc, norm_init(d),
                dense_init(generator, d, d), dense_init(generator, d, 1), dec, norm_init(d),
                dense_init(generator, d, n_bins), dense_init(generator, d, 2 * n_bins))
    return model.to(resolve_device(device))


def _transformer(layers, h: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """Pre-norm rotary transformer over ``h [..., T, D]`` (one sequence, or
    a batch of them as in the voice cloner); keys outside ``mask [..., T]``
    get -1e9."""
    *lead, t, dim = h.shape
    hd = dim // heads
    cos, sin = rotary_tables(torch.arange(t, device=h.device), hd - (hd % 2), 10000.0)
    scale = float(np.sqrt(np.float32(hd)))
    for lp in layers:
        x = layer_norm(lp.ln1, h)
        q = apply_rotary(dense(lp.attn.q, x).reshape(*lead, t, heads, -1), cos, sin)
        k = apply_rotary(dense(lp.attn.k, x).reshape(*lead, t, heads, -1), cos, sin)
        v = dense(lp.attn.v, x).reshape(*lead, t, heads, -1)
        logits = torch.einsum("...shd,...thd->...hst", q.float(), k.float()) / scale
        logits = logits.masked_fill(~mask[..., None, None, :], -1e9)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("...hst,...thd->...shd", w, v)
        h = h + dense(lp.attn.o, o.reshape(*lead, t, -1))
        x2 = layer_norm(lp.ln2, h)
        h = h + dense(lp.mlp.fc2, gelu(dense(lp.mlp.fc1, x2)))
    return h


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``softplus``, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


class SynthesisResult(NamedTuple):
    waveform: torch.Tensor  # [MAX_FRAMES * HOP] padded
    n_frames: torch.Tensor  # scalar int32: valid frames
    durations: torch.Tensor  # [MAX_PHONEMES] per-phoneme frames


@torch.inference_mode()
def synthesize(model: TTS, cfg: TTSConfig, phonemes: torch.Tensor, n_phonemes: int,
               style: torch.Tensor, speed: float = 1.0) -> SynthesisResult:
    """phonemes ``[MAX_PHONEMES]`` (PAD-padded, ``n_phonemes`` valid) and a
    style ``[style_dim]`` -> the padded waveform, its valid frame count and
    the durations.  Everything stays on the model's device."""
    dev = phonemes.device
    pmask = torch.arange(MAX_PHONEMES, device=dev) < n_phonemes
    h = model.embed[phonemes.long()]
    style_vec = dense(model.style_proj, style)
    h = h + style_vec[None, :]
    h = _transformer(model.encoder_layers, h, pmask, cfg.heads)
    h = layer_norm(model.encoder_norm, h)

    # Durations in frames per phoneme (softplus, >= 1 for real phonemes).
    dur_h = gelu(dense(model.duration_fc1, h))
    durations = softplus(dense(model.duration_fc2, dur_h))[..., 0] + 1.0
    durations = durations / speed
    durations = torch.where(pmask, durations, 0.0)
    # Scale down if the total exceeds the frame budget.
    total = durations.sum()
    scale = torch.clamp((MAX_FRAMES - 1) / torch.clamp(total, min=1.0), max=1.0)
    durations = durations * scale
    ends = torch.cumsum(durations, dim=0)
    n_frames = torch.clamp(torch.round(ends[-1]).to(torch.int32), max=MAX_FRAMES)

    # Length regulation: frame t takes the first phoneme whose end is past it.
    frame_pos = torch.arange(MAX_FRAMES, dtype=torch.float32, device=dev) + 0.5
    src = torch.clamp(torch.searchsorted(ends, frame_pos), 0, MAX_PHONEMES - 1)
    frames = h[src]  # [MAX_FRAMES, d]
    fmask = torch.arange(MAX_FRAMES, device=dev) < n_frames

    frames = frames + style_vec[None, :]
    frames = _transformer(model.decoder_layers, frames, fmask, cfg.heads)
    frames = layer_norm(model.decoder_norm, frames)

    # iSTFT head: log-magnitude + unit-normalized phase pair per bin.
    n_bins = N_FFT // 2 + 1
    mag = torch.exp(torch.clamp(dense(model.head_mag, frames), -8.0, 6.0))
    pp = dense(model.head_phase, frames).reshape(MAX_FRAMES, n_bins, 2)
    norm = torch.clamp(torch.sqrt((pp * pp).sum(-1)), min=1e-6)
    re = torch.where(fmask[:, None], mag * (pp[..., 0] / norm), 0.0)
    im = torch.where(fmask[:, None], mag * (pp[..., 1] / norm), 0.0)
    return SynthesisResult(istft(re, im), n_frames, durations)


def _hann() -> np.ndarray:
    return np.hanning(N_FFT).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _istft_constants(t: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The window and the overlap-added window square of ``t`` frames
    (``[(t + 3) * HOP]``, summed in the order of JAX's scatter), made on the
    host and copied to ``device`` once: a copy from the host inside the
    synthesis would wait for the device."""
    w2 = (_hann() * _hann()).reshape(N_FFT // HOP, HOP)
    acc = np.zeros((t + 3, HOP), np.float32)
    for k in reversed(range(N_FFT // HOP)):
        acc[k:k + t] += w2[k]
    return (torch.from_numpy(_hann()).to(device),
            torch.from_numpy(acc.reshape(-1)).to(device))


def overlap_add(frames: torch.Tensor) -> torch.Tensor:
    """``[T, N_FFT]`` frames at a hop of HOP -> ``[(T + 3) * HOP]``.

    Output block j sums frame j - k's block k for k = 3, 2, 1, 0: the
    order in which JAX's scatter adds them, with no atomics."""
    t = frames.shape[0]
    blocks = frames.reshape(t, N_FFT // HOP, HOP)
    acc = frames.new_zeros((t + 3, HOP))
    for k in reversed(range(N_FFT // HOP)):
        acc[k:k + t] += blocks[:, k]
    return acc.reshape(-1)


def istft(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``[T, n_bins]`` real/imag -> overlap-added waveform ``[T * HOP]``
    (the JAX package's ``_istft``)."""
    t = re.shape[0]
    im = im.clone()
    im[:, 0] = 0.0  # DC and Nyquist: a real signal's bins are real
    im[:, -1] = 0.0
    frames = torch.fft.irfft(torch.complex(re, im), n=N_FFT, dim=-1)
    window, window_sum = _istft_constants(t, str(re.device))
    wav = overlap_add(frames * window[None, :])
    wav = wav / torch.clamp(window_sum, min=1e-6)
    return wav[N_FFT // 2 : N_FFT // 2 + t * HOP]


def make_voice(generator: torch.Generator) -> torch.Tensor:
    """A random style vector (the .kokorovoice analog; real voice packs
    ship trained vectors keyed by name), on the CPU."""
    return torch.randn((STYLE_DIM,), generator=generator) * 0.5
