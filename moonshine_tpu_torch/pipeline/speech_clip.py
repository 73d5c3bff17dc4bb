"""Speech-clip extraction + clone-clip word refinement for voice cloning.

Ports with identical semantics (reference: core/speech-clip.{h,cpp},
core/clone-clip.{h,cpp}): a sliding 0.1 s-step window over VAD segments
picks the most-speech contiguous ~4 s window; a later word-aware pass
extends the end (<= 1.5 s) so the last word completes and emits the
matching transcript.

A copy of the JAX package's ``pipeline/speech_clip.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..core.types import TranscriptWord
from .vad_segmenter import VadSegmenter

SAMPLE_RATE = 16000
WINDOW_STEP_SECONDS = 0.1


@dataclass
class SpeechClipOptions:
    clip_duration_seconds: float = 4.0
    minimum_speech_seconds: float = 2.0
    vad_threshold: float = 0.5
    tail_pad_seconds: float = 0.0


@dataclass
class SpeechClip:
    audio: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    start_time_seconds: float = 0.0
    speech_seconds: float = 0.0
    is_complete: bool = False


def extract_speech_clip(
    audio: np.ndarray,
    hop_prob_fn,
    options: SpeechClipOptions | None = None,
) -> SpeechClip:
    """Best contiguous mostly-speech window (reference: speech-clip.cpp)."""
    options = options or SpeechClipOptions()
    audio = np.asarray(audio, np.float32)
    result = SpeechClip()
    clip_samples = round(options.clip_duration_seconds * SAMPLE_RATE)
    if audio.size < clip_samples:
        return result

    seg = VadSegmenter(hop_prob_fn, threshold=options.vad_threshold, window_size=1)
    seg.start()
    seg.process_audio(audio)
    seg.stop()
    segments = [
        (s.start_time, s.end_time) for s in seg.segments if s.end_time > s.start_time
    ]
    if not segments:
        return result

    total_seconds = audio.size / SAMPLE_RATE
    last_start = total_seconds - options.clip_duration_seconds
    window_count = 0 if last_start < 0 else int((last_start + 1e-6) / WINDOW_STEP_SECONDS) + 1

    best_start, best_coverage = 0.0, 0.0
    for w in range(window_count):
        start = w * WINDOW_STEP_SECONDS
        end = start + options.clip_duration_seconds
        coverage = sum(max(0.0, min(se, end) - max(ss, start)) for ss, se in segments)
        if coverage > best_coverage:
            best_coverage, best_start = coverage, start

    result.start_time_seconds = best_start
    result.speech_seconds = best_coverage
    if best_coverage < options.minimum_speech_seconds:
        return result

    frm = min(round(best_start * SAMPLE_RATE), audio.size - clip_samples)
    to = frm + clip_samples
    if options.tail_pad_seconds > 0:
        to = min(frm + clip_samples + round(options.tail_pad_seconds * SAMPLE_RATE), audio.size)
    result.audio = audio[frm:to].copy()
    result.start_time_seconds = frm / SAMPLE_RATE
    result.is_complete = True
    return result


@dataclass
class CloneClipBounds:
    start_seconds: float = 0.0
    end_seconds: float = 0.0
    transcript: str = ""


def refine_clone_clip_bounds(
    window_start_seconds: float,
    requested_duration_seconds: float,
    words: Sequence[TranscriptWord],
    max_extension_seconds: float = 1.5,
    end_pad_seconds: float = 0.05,
) -> CloneClipBounds:
    """Word-aware end extension (reference: clone-clip.cpp)."""
    fallback = CloneClipBounds(
        start_seconds=window_start_seconds,
        end_seconds=window_start_seconds + requested_duration_seconds,
    )
    if requested_duration_seconds <= 0 or max_extension_seconds < 0 or end_pad_seconds < 0:
        return fallback

    window_end = window_start_seconds + requested_duration_seconds
    hard_end = window_end + max_extension_seconds

    selected = [
        w
        for w in words
        if w.text and w.end > w.start and window_start_seconds <= w.start < window_end
    ]
    if not selected:
        return fallback

    while selected and selected[-1].end + end_pad_seconds > hard_end + 1e-6:
        selected.pop()
    if not selected:
        return fallback

    start = selected[0].start
    for w in words:
        if w.start < start < w.end and w.end < selected[0].end:
            start = w.end
    start = max(start, window_start_seconds)

    end = selected[-1].end + end_pad_seconds
    while True:
        changed = False
        for w in words:
            if not (w.start + 1e-6 < end and end + 1e-6 < w.end):
                continue
            finish = w.end + end_pad_seconds
            if finish <= hard_end + 1e-6:
                if finish > end + 1e-6:
                    end = finish
                    changed = True
            elif w.start < end:
                end = w.start
                changed = True
        end = min(end, hard_end)
        while selected and selected[-1].end > end + 1e-6:
            selected.pop()
            changed = True
        if not selected:
            return fallback
        if not changed:
            break
        end = min(max(end, selected[-1].end + end_pad_seconds), hard_end)

    if end <= start:
        return fallback

    in_bounds = sorted(
        (w for w in words if w.start + 1e-6 >= start and w.end <= end + 1e-6),
        key=lambda w: w.start,
    )
    transcript = " ".join(w.text for w in in_bounds)
    if not transcript:
        return fallback
    return CloneClipBounds(start_seconds=start, end_seconds=end, transcript=transcript)
