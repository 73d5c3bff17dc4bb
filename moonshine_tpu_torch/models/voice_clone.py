"""Zero-shot voice cloning via conditional flow matching, in PyTorch.

Counterpart of the JAX package's ``models/voice_clone.py``, a capability
mirror of the reference ZipVoice engine (reference:
core/moonshine-tts/src/zipvoice-tts.h:21-108, zipvoice-mel.h:11-30): text
encoder + flow-matching decoder + vocoder at 24 kHz, cloned from a
reference clip (prompt mel + its transcript), with the reference's
sampling contract: distill defaults 8 steps / guidance 3.0 (full: 16 /
1.0), ``t_shift`` 0.5 time warp, ``feat_scale`` 0.1, ``target_rms`` 0.1,
deterministic seeded Gaussian latent, pause compression post-process.
Classifier-free guidance batches the conditional and unconditional
branches on one leading axis, so each Euler step is one batch of 2.  The
transformer is ``models/tts``'s, and so is the iSTFT head's inverse FFT
and overlap-add (``tts.istft``, with its DC/Nyquist zeroing).

Where a straight translation would part from JAX's results:

- The latent: JAX draws ``jax.random.normal(PRNGKey(seed), (1024, 100))``,
  which torch cannot reproduce.  The port draws from a CPU
  ``torch.Generator`` seeded by ``seed`` (the same draw whatever the
  device) or takes it as ``x0=``; the same seed gives other speech than
  JAX's.
- The init: as in JAX, each transformer block's q, k, v and o start
  equal (JAX draws all four from one key).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.mel import log_mel
from .layers import ACTIVATIONS, Dense, Norm, dense, dense_init, layer_norm, norm_init
from .moonshine import EncoderLayer
from .tts import MAX_PHONEMES, VOCAB, _block_init, _transformer, ipa_to_ids, istft

SAMPLE_RATE = 24000  # reference: zipvoice-tts.h kSampleRateHz
N_FFT = 1024  # reference: zipvoice-mel.h
HOP = 256
N_MELS = 100
MAX_FRAMES = 1024
DISTILL_STEPS, DISTILL_GUIDANCE = 8, 3.0  # reference: zipvoice-tts.h:33-36
FULL_STEPS, FULL_GUIDANCE = 16, 1.0


class CloneConfig(NamedTuple):
    dim: int = 256
    text_layers: int = 2
    fm_layers: int = 4
    heads: int = 4
    t_shift: float = 0.5
    feat_scale: float = 0.1
    target_rms: float = 0.1


class VoiceCloneModel(nn.Module):
    """The JAX tree's leaves as holders: ``embed``, ``text_layers`` +
    ``text_norm``, ``in_proj``, ``time_fc1`` and ``time_fc2``,
    ``fm_layers`` + ``fm_norm``, ``out_proj`` and the iSTFT vocoder head
    ``voc_fc1``, ``voc_fc2``, ``voc_mag``, ``voc_phase``."""

    def __init__(self, embed: torch.Tensor, text_layers: list[EncoderLayer], text_norm: Norm,
                 in_proj: Dense, time_fc1: Dense, time_fc2: Dense,
                 fm_layers: list[EncoderLayer], fm_norm: Norm, out_proj: Dense,
                 voc_fc1: Dense, voc_fc2: Dense, voc_mag: Dense, voc_phase: Dense):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.text_layers, self.text_norm = nn.ModuleList(text_layers), text_norm
        self.in_proj, self.time_fc1, self.time_fc2 = in_proj, time_fc1, time_fc2
        self.fm_layers, self.fm_norm = nn.ModuleList(fm_layers), fm_norm
        self.out_proj = out_proj
        self.voc_fc1, self.voc_fc2, self.voc_mag, self.voc_phase = (voc_fc1, voc_fc2, voc_mag,
                                                                    voc_phase)


def compute_mel(audio: torch.Tensor) -> torch.Tensor:
    """[B, N] 24 kHz waveform -> [B, T, 100] log-mel (VocosFbank contract)."""
    return log_mel(audio, n_fft=N_FFT, hop=HOP, n_mels=N_MELS, sample_rate=SAMPLE_RATE)


def init_params(cfg: CloneConfig, generator: torch.Generator, device=None) -> VoiceCloneModel:
    """Random weights from ``generator`` on ``device`` (CUDA unless named),
    with the JAX initializer's distributions."""
    d = cfg.dim
    n_bins = N_FFT // 2 + 1
    model = VoiceCloneModel(
        torch.randn((VOCAB, d), generator=generator) * 0.02,
        [_block_init(generator, d) for _ in range(cfg.text_layers)], norm_init(d),
        dense_init(generator, N_MELS * 2 + d, d),  # x_t + prompt-cond mel + text
        dense_init(generator, 64, d), dense_init(generator, d, d),
        [_block_init(generator, d) for _ in range(cfg.fm_layers)], norm_init(d),
        dense_init(generator, d, N_MELS),
        dense_init(generator, N_MELS, d), dense_init(generator, d, d),
        dense_init(generator, d, n_bins), dense_init(generator, d, 2 * n_bins))
    return model.to(resolve_device(device))


def _time_embedding(t: torch.Tensor, dim: int = 64) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    ang = t[..., None] * freqs * 1000.0
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _velocity(model: VoiceCloneModel, cfg: CloneConfig, x_t, t, text_cond, prompt_cond, fmask):
    """Predict the flow velocity field.  Leading axis batches the CFG pair."""
    b = x_t.shape[0]
    te = _time_embedding(t.expand(b))
    temb = dense(model.time_fc2, ACTIVATIONS["silu"](dense(model.time_fc1, te)))
    h = dense(model.in_proj, torch.cat([x_t, prompt_cond, text_cond], dim=-1))
    h = h + temb[:, None, :]
    h = _transformer(model.fm_layers, h, fmask, cfg.heads)
    h = layer_norm(model.fm_norm, h)
    return dense(model.out_proj, h)


def initial_latent(seed: int, t_frames: int) -> torch.Tensor:
    """The seeded Gaussian latent ``[t_frames, N_MELS]``, drawn on the CPU."""
    return torch.randn((t_frames, N_MELS), generator=torch.Generator().manual_seed(int(seed)))


@torch.inference_mode()
def flow_matching_sample(
    model: VoiceCloneModel,
    cfg: CloneConfig,
    text_cond: torch.Tensor,  # [T_frames, d] upsampled text condition
    prompt_cond: torch.Tensor,  # [T_frames, n_mels] prompt mel (zeros past prompt)
    fmask: torch.Tensor,  # [T_frames] valid-frame mask
    seed: int,
    guidance_scale: float = DISTILL_GUIDANCE,
    num_steps: int = DISTILL_STEPS,
    *,
    x0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Euler ODE from the seeded Gaussian latent (or ``x0``) -> mel frames
    [T_frames, n_mels], on the inputs' device.

    Classifier-free guidance runs the conditional and text-free branches as
    one batch of 2 per step (reference: distill 8 steps / guidance 3.0).
    """
    dev = text_cond.device
    t_frames = text_cond.shape[0]
    x = (initial_latent(seed, t_frames) if x0 is None else torch.as_tensor(x0)).to(dev)

    cond = torch.stack([text_cond, torch.zeros_like(text_cond)])  # [2, T, d]
    pc = torch.stack([prompt_cond, prompt_cond])
    mask2 = torch.stack([fmask, fmask])

    # Time grid with the reference's t_shift warp: t' = s*t / (1 + (s-1)*t).
    ts = torch.linspace(0.0, 1.0, num_steps + 1, device=dev)
    s = cfg.t_shift
    ts = s * ts / (1.0 + (s - 1.0) * ts)

    for i in range(num_steps):
        t0, t1 = ts[i], ts[i + 1]
        v = _velocity(model, cfg, torch.stack([x, x]), t0, cond, pc, mask2)
        v_cond, v_uncond = v[0], v[1]
        v_guided = v_uncond + guidance_scale * (v_cond - v_uncond)
        x = x + (t1 - t0) * v_guided
    return torch.where(fmask[:, None], x, 0.0)


@torch.inference_mode()
def vocode(model: VoiceCloneModel, mel: torch.Tensor) -> torch.Tensor:
    """[T, n_mels] mel -> waveform [T * HOP] via the iSTFT head."""
    gelu = ACTIVATIONS["gelu"]
    h = gelu(dense(model.voc_fc1, mel))
    h = gelu(dense(model.voc_fc2, h)) + h
    n_bins = N_FFT // 2 + 1
    mag = torch.exp(torch.clamp(dense(model.voc_mag, h), -8.0, 6.0))
    pp = dense(model.voc_phase, h).reshape(mel.shape[0], n_bins, 2)
    norm = torch.clamp(torch.linalg.vector_norm(pp, dim=-1), min=1e-6)
    re = mag * pp[..., 0] / norm
    im = mag * pp[..., 1] / norm
    return _istft_24k(re, im)


def _istft_24k(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_istft_24k``: the TTS model's iSTFT (24 kHz,
    1,024 / 256)."""
    return istft(re, im)


class VoiceCloner:
    """Text -> waveform in a cloned voice (reference: ZipVoiceTTS API), on
    ``device`` (CUDA unless named); numpy in and out."""

    def __init__(
        self,
        params: VoiceCloneModel | None = None,
        cfg: CloneConfig | None = None,
        distill: bool = True,
        seed: int = 666,  # reference default
        speed: float = 1.0,
        vocoder_onnx: str | None = None,
        *,
        device=None,
    ):
        self.cfg = cfg or CloneConfig()
        self.device = resolve_device(device)
        self.params = (params.to(self.device) if params is not None
                       else init_params(self.cfg, torch.Generator().manual_seed(0), self.device))
        self.num_steps = DISTILL_STEPS if distill else FULL_STEPS
        self.guidance = DISTILL_GUIDANCE if distill else FULL_GUIDANCE
        self.seed = seed
        self.speed = speed
        # Published mel->wav vocoder export in the reference's vocoder.ort
        # slot (zipvoice-tts.h:84-104); runs via the ONNX interpreter.
        # Contract: [n_mels, T] in, T*HOP samples out (Vocos 24k/1024/256).
        if vocoder_onnx is not None:
            from .tts_onnx import OnnxVocoder

            self.vocoder = OnnxVocoder.from_onnx(vocoder_onnx, self.device)
        else:
            self.vocoder = None
        self._prompt_mel: np.ndarray | None = None
        self._prompt_ipa = ""

    def set_reference(
        self, clone_pcm: np.ndarray, clone_transcript: str = "", sample_rate: int = SAMPLE_RATE
    ) -> None:
        if sample_rate != SAMPLE_RATE:
            from ..audio.resample import resample_audio

            clone_pcm = resample_audio(clone_pcm, sample_rate, SAMPLE_RATE)
        # RMS-normalize the prompt to target_rms (reference: target_rms 0.1).
        rms = float(np.sqrt(np.mean(np.square(clone_pcm)) + 1e-12))
        if rms > 1e-6:
            clone_pcm = clone_pcm * (self.cfg.target_rms / rms)
        audio = torch.from_numpy(np.asarray(clone_pcm, np.float32)[None]).to(self.device)
        mel = compute_mel(audio)[0].cpu().numpy()
        self._prompt_mel = mel * self.cfg.feat_scale
        if clone_transcript:
            from ..tts.g2p import GraphemeToPhonemizer

            self._prompt_ipa = GraphemeToPhonemizer("en").text_to_ipa(clone_transcript)

    @torch.inference_mode()
    def mel_from_ipa(self, ipa: str, *, x0: torch.Tensor | None = None):
        """The sampled mel ``[MAX_FRAMES, n_mels]`` (feature scale undone,
        on the device) and the prompt's and the whole utterance's frame
        counts."""
        if self._prompt_mel is None:
            raise RuntimeError("Call set_reference() with a clone clip first")
        ids = ipa_to_ids(ipa.replace(" ", ""))
        prompt_ids = ipa_to_ids(self._prompt_ipa.replace(" ", "")) if self._prompt_ipa else []
        prompt_frames = min(len(self._prompt_mel), MAX_FRAMES // 2)

        # Target length by phoneme-rate ratio against the prompt (ZipVoice's
        # length estimate), bounded by the static budget.
        if prompt_ids:
            frames_per_phoneme = prompt_frames / max(len(prompt_ids), 1)
        else:
            frames_per_phoneme = 8.0
        gen_frames = int(len(ids) * frames_per_phoneme / self.speed)
        gen_frames = max(min(gen_frames, MAX_FRAMES - prompt_frames), 8)
        total = prompt_frames + gen_frames

        # Text condition: phoneme embeddings through the text encoder,
        # upsampled uniformly over the generated span.
        dev = self.device
        phon = np.zeros(MAX_PHONEMES, np.int64)
        seq = (prompt_ids + ids)[:MAX_PHONEMES]
        phon[: len(seq)] = seq
        pmask = torch.arange(MAX_PHONEMES, device=dev) < len(seq)
        h = self.params.embed[torch.from_numpy(phon).to(dev)][None]
        h = _transformer(self.params.text_layers, h, pmask[None], self.cfg.heads)
        h = layer_norm(self.params.text_norm, h)[0]  # [MAX_PHONEMES, d]
        # Uniform frame->phoneme map over the whole utterance.
        src = np.minimum(
            (np.arange(MAX_FRAMES) * max(len(seq), 1) // max(total, 1)), len(seq) - 1
        )
        text_cond = h[torch.from_numpy(src).to(dev)]

        prompt_cond = np.zeros((MAX_FRAMES, N_MELS), np.float32)
        prompt_cond[:prompt_frames] = self._prompt_mel[:prompt_frames]
        fmask = np.arange(MAX_FRAMES) < total

        mel = flow_matching_sample(
            self.params, self.cfg, text_cond, torch.from_numpy(prompt_cond).to(dev),
            torch.from_numpy(fmask).to(dev), self.seed, guidance_scale=self.guidance,
            num_steps=self.num_steps, x0=x0)
        return mel / self.cfg.feat_scale, prompt_frames, total

    def synthesize_from_ipa(self, ipa: str, *, x0: torch.Tensor | None = None) -> np.ndarray:
        mel, prompt_frames, total = self.mel_from_ipa(ipa, x0=x0)
        if self.vocoder is not None:
            # External vocoders take [n_mels, T] mel.
            wav = np.asarray(self.vocoder(mel.T.cpu().numpy()))
        else:
            wav = vocode(self.params, mel).cpu().numpy()
        wav = wav[prompt_frames * HOP : total * HOP]
        wav = np.clip(wav, -1.0, 1.0)  # reference: always clip, no peak norm
        return compress_long_pauses(wav, SAMPLE_RATE)

    def synthesize(self, text: str, *, x0: torch.Tensor | None = None) -> np.ndarray:
        from ..tts.g2p import GraphemeToPhonemizer

        return self.synthesize_from_ipa(GraphemeToPhonemizer("en").text_to_ipa(text), x0=x0)


def compress_long_pauses(
    wav: np.ndarray,
    sample_rate: int,
    max_silence_ms: float = 350.0,
    keep_silence_ms: float = 180.0,
    fade_ms: float = 12.0,
) -> np.ndarray:
    """Shorten internal pauses with crossfades (reference:
    zipvoice_compress_long_pauses, zipvoice-tts.h:97-104)."""
    wav = np.asarray(wav, np.float32)
    if wav.size == 0:
        return wav
    win = max(int(sample_rate * 0.01), 1)
    n_win = len(wav) // win
    if n_win == 0:
        return wav
    energy = np.sqrt(np.mean(wav[: n_win * win].reshape(n_win, win) ** 2, axis=1))
    thresh = max(float(np.max(energy)) * 0.03, 1e-5)
    silent = energy < thresh

    max_wins = int(max_silence_ms / 10)
    keep_wins = max(int(keep_silence_ms / 10), 1)
    fade = max(int(sample_rate * fade_ms / 1000), 1)

    out: list[np.ndarray] = []
    i = 0
    while i < n_win:
        if not silent[i]:
            out.append(wav[i * win : (i + 1) * win])
            i += 1
            continue
        j = i
        while j < n_win and silent[j]:
            j += 1
        run = j - i
        if run > max_wins and i > 0 and j < n_win:
            keep = wav[i * win : (i + keep_wins) * win].copy()
            # Crossfade the trim boundary.
            k = min(fade, len(keep))
            keep[-k:] *= np.linspace(1.0, 0.0, k, dtype=np.float32)
            nxt_start = j * win
            out.append(keep)
            lead_in = wav[nxt_start : nxt_start + k].copy()
            if len(lead_in):
                lead_in *= np.linspace(0.0, 1.0, len(lead_in), dtype=np.float32)
                out.append(lead_in)
                i = j + (k + win - 1) // win
                continue
        else:
            out.append(wav[i * win : j * win])
        i = j
    tail = wav[n_win * win :]
    if tail.size:
        out.append(tail)
    return np.concatenate(out) if out else wav
