"""High-level VoiceClone API: record -> extract clip -> clone -> speak.

Capability mirror of the reference's VoiceClone binding class (reference:
language-bindings/python/src/moonshine_voice/voice_clone.py; C ABI
speech-clip at moonshine-c-api.h:812): accumulate audio (mic or buffers),
watch for a good ~4 s speech clip, refine its end at word boundaries when
a transcriber provides word timings, then hand the clip + transcript to
the flow-matching cloner.

A copy of the JAX package's ``tts/voice_clone_api.py`` with its imports
pointed at the port (``pipeline/speech_clip.py``, ``audio/resample.py``);
the cloner is the port's ``models.voice_clone.VoiceCloner``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..core.types import TranscriptWord
from ..pipeline.speech_clip import (
    SpeechClip,
    SpeechClipOptions,
    extract_speech_clip,
    refine_clone_clip_bounds,
)

SAMPLE_RATE = 16000


@dataclass
class CloneProgress:
    speech_seconds: float
    needed_seconds: float
    ready: bool


class VoiceClone:
    """Capture-and-clone session."""

    def __init__(
        self,
        hop_prob_fn,
        cloner=None,  # models.voice_clone.VoiceCloner
        options: SpeechClipOptions | None = None,
        on_progress: Optional[Callable[[CloneProgress], None]] = None,
    ):
        self.hop_prob_fn = hop_prob_fn
        self.cloner = cloner
        self.options = options or SpeechClipOptions(tail_pad_seconds=1.5)
        self.on_progress = on_progress
        self._audio = np.zeros(0, np.float32)
        self._clip: SpeechClip | None = None
        self.transcript = ""

    def add_audio(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> CloneProgress:
        if sample_rate != SAMPLE_RATE:
            from ..audio.resample import resample_audio

            audio = resample_audio(audio, sample_rate, SAMPLE_RATE)
        self._audio = np.concatenate([self._audio, np.asarray(audio, np.float32)])
        # Re-extract frequently: VAD-only, cheap (reference: speech-clip.h
        # rationale for keeping this step model-free).
        clip = extract_speech_clip(self._audio, self._mk_probe(), self.options)
        self._clip = clip
        progress = CloneProgress(
            speech_seconds=clip.speech_seconds,
            needed_seconds=self.options.minimum_speech_seconds,
            ready=clip.is_complete,
        )
        if self.on_progress:
            self.on_progress(progress)
        return progress

    def _mk_probe(self):
        # A fresh stateful probability function per extraction pass.
        fn = self.hop_prob_fn
        return fn() if callable(fn) and getattr(fn, "is_factory", False) else fn

    @property
    def clip(self) -> SpeechClip | None:
        return self._clip

    def finalize(
        self, words: list[TranscriptWord] | None = None, transcript: str = ""
    ) -> SpeechClip:
        """Refine bounds at word boundaries and load the cloner reference.

        ``words``: absolute-time word timings covering the recording (e.g.
        from a word_timestamps transcription of it).
        """
        if self._clip is None or not self._clip.is_complete:
            raise RuntimeError("Not enough speech captured yet")
        clip = self._clip
        start = clip.start_time_seconds
        duration = self.options.clip_duration_seconds
        if words:
            bounds = refine_clone_clip_bounds(start, duration, words)
            s = int(bounds.start_seconds * SAMPLE_RATE)
            e = int(bounds.end_seconds * SAMPLE_RATE)
            audio = self._audio[s : min(e, len(self._audio))]
            self.transcript = bounds.transcript
        else:
            audio = clip.audio
            self.transcript = transcript
        final = SpeechClip(
            audio=audio,
            start_time_seconds=start,
            speech_seconds=clip.speech_seconds,
            is_complete=True,
        )
        self._clip = final
        if self.cloner is not None:
            self.cloner.set_reference(audio, self.transcript, SAMPLE_RATE)
        return final

    def say(self, text: str) -> np.ndarray:
        if self.cloner is None:
            raise RuntimeError("No cloner attached")
        return self.cloner.synthesize(text)
