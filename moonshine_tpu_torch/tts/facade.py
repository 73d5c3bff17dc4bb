"""TextToSpeech facade: voices, options, synthesis queue, in PyTorch.

Counterpart of the JAX package's ``tts/facade.py``: synthesis at 24 kHz
through the neural acoustic model (``models/tts.py``) on ``device`` (CUDA
unless named), per-call option overrides for speed, volume and
normalisation, ``synthesize_from_phonemes``, and the queued ``say()`` with
a synthesis thread and a playback thread (the next utterance synthesizes
while the last one plays).  Voice packs use the JAX package's tensor names
(``voice/<name>``, ``params/<path of the JAX tree>``) and layouts, so a pack
written by either package loads in the other.

Voices named ``klatt*`` route to the code-only formant voice
(``tts/klatt.py``, 22.05 kHz) and ``neural-pack*`` to the reference's
published voice pack (``tts/neural_pack.py``, 16 kHz), both on the
facade's device, as the JAX facade routes them.  Without the pack, a
``neural-pack*`` voice raises the pack's ``FileNotFoundError``; no voice
falls back to another.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .. import weights
from ..core.device import resolve_device
from ..models import tts as tts_model
from .g2p import GraphemeToPhonemizer

SAMPLE_RATE = tts_model.SAMPLE_RATE


def split_say_utterances(text: str) -> list[str]:
    """Approximate sentence split so ``say()`` can speak sooner.

    Splits on ``.``/``!``/``?``/``:`` followed by whitespace — not a full
    segmenter, but enough to start playback of the first clause while the
    later ones synthesize (reference: tts.py:34-65).
    """
    stripped = (text or "").strip()
    if not stripped:
        return []
    parts: list[str] = []
    start = i = 0
    n = len(stripped)
    while i < n:
        if stripped[i] in ".!?:" and i + 1 < n and stripped[i + 1].isspace():
            piece = stripped[start : i + 1].strip()
            if piece:
                parts.append(piece)
            i += 1
            while i < n and stripped[i].isspace():
                i += 1
            start = i
            continue
        i += 1
    tail = stripped[start:].strip()
    if tail:
        parts.append(tail)
    return parts


def _make_beep(kind: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Two-tone feedback cue: 'error' descends, 'success' ascends.

    The reference plays bundled assets/{error,success}.wav; with no audio
    assets in this tree the cues are synthesized once and cached — same
    audible contract (short two-tone beep, reference: tts.py:124-151).
    """
    freqs = (880.0, 440.0) if kind == "error" else (440.0, 880.0)
    tone_s, fade_s = 0.11, 0.008
    out = []
    for f in freqs:
        t = np.arange(int(tone_s * sr), dtype=np.float32) / sr
        tone = 0.4 * np.sin(2 * np.pi * f * t).astype(np.float32)
        nf = max(1, int(fade_s * sr))
        env = np.ones_like(tone)
        env[:nf] = np.linspace(0.0, 1.0, nf, dtype=np.float32)
        env[-nf:] = np.linspace(1.0, 0.0, nf, dtype=np.float32)
        out.append(tone * env)
    return np.concatenate(out)


def save_voice_pack(
    path: str | Path,
    voices: Mapping[str, np.ndarray],
    params: tts_model.TTS | None = None,
) -> None:
    """Write voices (+ optionally the acoustic model's weights) to one
    safetensors file: ``voice/<name>`` style vectors and, when ``params``
    is given, ``params/<path>`` in the JAX tree's names and layouts."""
    flat: dict[str, np.ndarray] = {
        f"voice/{name}": np.asarray(v, np.float32) for name, v in voices.items()
    }
    if params is not None:
        for name, leaf in weights.flatten_tree(weights.tts_params_to_numpy(params)).items():
            flat[f"params/{name}"] = leaf
    weights.save_safetensors(path, flat)


def voice_pack_shapes(cfg: tts_model.TTSConfig) -> dict[str, tuple[int, ...]]:
    """Every ``params/`` name of a pack for ``cfg`` (the JAX tree's paths)
    with its shape (the JAX tree's layouts)."""
    model = tts_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return {f"params/{k}": v.shape
            for k, v in weights.flatten_tree(weights.tts_params_to_numpy(model)).items()}


def load_voice_pack(path: str | Path, cfg: tts_model.TTSConfig | None = None, device=None):
    """Read a voice pack -> (the ``TTS`` model on ``device`` (CUDA unless
    named) or None, {name: style vector})."""
    flat = weights.load_safetensors(path)
    voices = {
        k[len("voice/"):]: v for k, v in flat.items() if k.startswith("voice/")
    }
    params = None
    if any(k.startswith("params/") for k in flat):
        tree = {}
        for name, shape in voice_pack_shapes(cfg or tts_model.TTSConfig()).items():
            if name not in flat:
                raise KeyError(f"Voice pack missing tensor {name!r}")
            if flat[name].shape != shape:
                raise ValueError(f"Shape mismatch for {name}: {flat[name].shape} vs {shape}")
            tree[name[len("params/"):]] = flat[name].astype(np.float32)
        params = weights.tts_params_from_jax_numpy(weights.unflatten_tree(tree), device)
    return params, voices


@dataclass
class TTSOptions:
    """Per-call synthesis options (reference: moonshine-tts-options.*)."""

    speed: float = 1.0
    volume: float = 1.0
    normalize: bool = True


class TextToSpeech:
    """Chainable-setter TTS runner over the acoustic model, on ``device``
    (CUDA unless named; ``params``, a ``models.tts.TTS``, is moved there)."""

    def __init__(
        self,
        params: tts_model.TTS | None = None,
        cfg: tts_model.TTSConfig | None = None,
        language: str = "en",
        seed: int = 0,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or tts_model.TTSConfig()
        self._language = language
        self._voice_name = "af_default"
        self._seed = seed
        self.params = params.to(self.device) if params is not None else None
        self.voices: dict[str, np.ndarray] = {}
        self._g2p: GraphemeToPhonemizer | None = None
        self._klatt = None  # tts/klatt.KlattTTS, made on first use
        self._neural = None  # tts/neural_pack.NeuralPackTTS, made on first use
        self._playback_fn: Optional[Callable[[np.ndarray, int], None]] = None
        # Two-stage pipeline: the say queue feeds a synthesis thread; the
        # bounded play queue (maxsize=1) feeds a playback thread, so
        # utterance N+1 synthesizes while N is still playing.
        self._say_queue: "queue.Queue" = queue.Queue()
        self._play_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._synth_thread: threading.Thread | None = None
        self._play_thread: threading.Thread | None = None
        self._playing = False
        self._beep_cache: dict[str, np.ndarray] = {}
        self._said: list[str] = []
        self._loaded = False
        self._default_options = TTSOptions()

    # -- chainable setters --------------------------------------------------

    def language(self, code: str) -> "TextToSpeech":
        self._language = code
        return self

    def voice(self, name: str) -> "TextToSpeech":
        self._voice_name = name
        return self

    def play_with(self, fn: Callable[[np.ndarray, int], None]) -> "TextToSpeech":
        """Playback hook (sounddevice, file writer, test recorder...)."""
        self._playback_fn = fn
        return self

    def options(self, **kw) -> "TextToSpeech":
        for k, v in kw.items():
            setattr(self._default_options, k, v)
        return self

    # -- loading ------------------------------------------------------------

    def load(
        self, voice_pack: Mapping[str, np.ndarray] | str | None = None
    ) -> "TextToSpeech":
        """Initialise (or load) the model and voices.

        ``voice_pack``: a mapping of voice name -> style vector, or a path
        to a ``.safetensors`` voice pack written by :func:`save_voice_pack`
        (by either package); a pack may also carry the model's weights
        under ``params/``.  Without weights, the model is random from
        ``seed``; a missing voice is a random style from ``seed + 1``.
        """
        if isinstance(voice_pack, (str, Path)):
            params, voices = load_voice_pack(voice_pack, self.cfg, self.device)
            if params is not None:
                self.params = params
            voice_pack = voices
        if self.params is None:
            self.params = tts_model.init_params(
                self.cfg, torch.Generator().manual_seed(self._seed), self.device)
        if voice_pack:
            self.voices.update({k: np.asarray(v) for k, v in voice_pack.items()})
        if self._voice_name not in self.voices:
            self.voices[self._voice_name] = tts_model.make_voice(
                torch.Generator().manual_seed(self._seed + 1)).numpy()
        self._g2p = GraphemeToPhonemizer(self._language)
        self._loaded = True
        return self

    # -- synthesis ----------------------------------------------------------

    def synthesize(
        self, text: str, options: TTSOptions | None = None
    ) -> tuple[np.ndarray, int]:
        """Text -> (waveform float32, sample rate).

        Engine auto-pick per voice prefix (reference: moonshine-tts.cpp
        engine selection by voice name): ``neural-pack*`` voices route to
        the reference's published in-tree voice (16 kHz), ``klatt*`` to the
        formant voice (22.05 kHz); everything else uses the
        style-conditioned acoustic model (24 kHz).
        """
        if not self._loaded:
            raise RuntimeError("Call load() before synthesize()")
        if self._voice_name.startswith("neural-pack"):
            return self._neural_synthesize(text, options, ipa=None)
        if self._voice_name.startswith("klatt"):
            return self._klatt_synthesize(text, options, ipa=None)
        ipa = self._g2p.text_to_ipa(text)
        return self.synthesize_from_phonemes(ipa, options)

    def _klatt_synthesize(
        self, text: str | None, options: TTSOptions | None, ipa: str | None
    ) -> tuple[np.ndarray, int]:
        """Code-only formant voice (tts/klatt.py — the micro stack's
        Klatt engine; 22.05 kHz, zero trained weights)."""
        from .klatt import KlattTTS

        if self._klatt is None:
            self._klatt = KlattTTS(device=self.device)
        opts = options or self._default_options
        speed = float(opts.speed) if opts.speed else 1.0
        wav = (
            self._klatt.synthesize_ipa(ipa, speed=speed) if ipa is not None
            else self._klatt.synthesize(text or "", speed=speed)
        )
        if opts.volume != 1.0:
            wav = wav * np.float32(opts.volume)
        return wav.astype(np.float32), 22050

    def _neural_synthesize(
        self, text: str | None, options: TTSOptions | None, ipa: str | None
    ) -> tuple[np.ndarray, int]:
        from .neural_pack import NeuralPackTTS

        if self._neural is None:
            self._neural = NeuralPackTTS(device=self.device)
        opts = options or self._default_options
        pcm = (
            self._neural.synthesize_ipa(ipa) if ipa is not None
            else self._neural.synthesize(text or "")
        )
        wav = pcm.astype(np.float32) / 32768.0
        if opts.normalize and wav.size:
            peak = np.max(np.abs(wav))
            if peak > 1e-6:
                wav = wav * (0.95 / max(peak, 0.95))
        if opts.volume != 1.0:
            wav = wav * opts.volume
        return wav, 16000

    def phoneme_batch(self, ipa: str) -> tuple[torch.Tensor, int]:
        """The padded ``[MAX_PHONEMES]`` ids (on the device) and their count
        for an IPA string; spaces are dropped, as JAX's facade drops them."""
        ids = tts_model.ipa_to_ids(ipa.replace(" ", ""))
        phonemes = np.zeros(tts_model.MAX_PHONEMES, np.int32)
        phonemes[: len(ids)] = ids
        return torch.from_numpy(phonemes).to(self.device), len(ids)

    def synthesize_from_phonemes(
        self, ipa: str, options: TTSOptions | None = None
    ) -> tuple[np.ndarray, int]:
        """IPA string -> waveform (reference: moonshine-tts.h
        synthesize_from_phonemes)."""
        if not self._loaded:
            raise RuntimeError("Call load() before synthesize()")
        if self._voice_name.startswith("neural-pack"):
            return self._neural_synthesize(None, options, ipa=ipa)
        if self._voice_name.startswith("klatt"):
            return self._klatt_synthesize(None, options, ipa=ipa)
        opts = options or self._default_options
        phonemes, n_ids = self.phoneme_batch(ipa)
        style = torch.from_numpy(np.array(self.voices[self._voice_name], np.float32))
        result = tts_model.synthesize(
            self.params,
            self.cfg,
            phonemes,
            n_ids,
            style.to(self.device),
            speed=float(opts.speed),
        )
        n = int(result.n_frames) * tts_model.HOP
        wav = result.waveform[:n].cpu().numpy()
        if opts.normalize and wav.size:
            peak = np.max(np.abs(wav))
            if peak > 1e-6:
                wav = wav * (0.95 / max(peak, 0.95))
        if opts.volume != 1.0:
            wav = wav * opts.volume
        return wav, SAMPLE_RATE

    # -- queued speech: a synthesis thread and a playback thread ----------

    def say(self, text: str, options: TTSOptions | None = None) -> None:
        """Queue an utterance; synthesis runs on a worker thread, playback
        on a second, so the first clause plays while later ones render."""
        self._ensure_say_workers()
        pieces = split_say_utterances(text)
        if not pieces:
            return
        self._said.append(text)
        for piece in pieces:
            self._say_queue.put(("text", piece, options or self._default_options))

    def play_error(self) -> None:
        """Queue the short descending error beep (reference: tts.py:1093
        — ordered through the say queue so it never races an in-flight
        ``say``).  Pairs with :meth:`play_success` for recognized/
        unrecognized audible feedback."""
        self._ensure_say_workers()
        self._say_queue.put(("beep", "error", None))

    def play_success(self) -> None:
        """Queue the short ascending success beep (reference: tts.py:1127)."""
        self._ensure_say_workers()
        self._say_queue.put(("beep", "success", None))

    def is_talking(self) -> bool:
        """True while utterances are queued, synthesizing, or playing."""
        return (
            not self._say_queue.empty()
            or not self._play_queue.empty()
            or self._playing
        )

    def wait(self) -> None:
        """Block until all queued utterances are synthesized AND played."""
        self._say_queue.join()
        self._play_queue.join()

    def wait_for_all(self, timeout: float | None = None) -> None:
        self.wait()

    def stop(self) -> None:
        if self._synth_thread is not None:
            self._say_queue.put(None)
            self._synth_thread.join(timeout=5)
            self._synth_thread = None
        if self._play_thread is not None:
            self._play_thread.join(timeout=5)
            self._play_thread = None

    def _ensure_say_workers(self) -> None:
        alive = (
            self._synth_thread is not None
            and self._synth_thread.is_alive()
            and self._play_thread is not None
            and self._play_thread.is_alive()
        )
        if alive:
            return
        self._synth_thread = threading.Thread(target=self._synth_worker, daemon=True)
        self._play_thread = threading.Thread(target=self._play_worker, daemon=True)
        self._synth_thread.start()
        self._play_thread.start()

    def _synth_worker(self) -> None:
        while True:
            item = self._say_queue.get()
            try:
                if item is None:
                    self._play_queue.put(None)
                    return
                kind, payload, opts = item
                if kind == "beep":
                    if payload not in self._beep_cache:
                        self._beep_cache[payload] = _make_beep(payload)
                    self._play_queue.put((self._beep_cache[payload], SAMPLE_RATE))
                else:
                    wav, sr = self.synthesize(payload, opts)
                    self._play_queue.put((wav, sr))
            except Exception as e:  # noqa: BLE001 — a failed utterance must not kill the queue
                import sys

                print(f"TextToSpeech: synthesis failed: {e!r}", file=sys.stderr)
            finally:
                self._say_queue.task_done()

    def _play_worker(self) -> None:
        while True:
            item = self._play_queue.get()
            try:
                if item is None:
                    return
                wav, sr = item
                self._playing = True
                if self._playback_fn is not None:
                    self._playback_fn(wav, sr)
            except Exception as e:  # noqa: BLE001 — a broken output must not kill the queue
                import sys

                print(f"TextToSpeech: playback failed: {e!r}", file=sys.stderr)
            finally:
                self._playing = False
                self._play_queue.task_done()
