"""Transcriber / Stream: the user-facing transcription pipeline.

Mirrors the reference orchestration (reference: core/transcriber.cpp:
653-1020 and the Python binding's event layer, language-bindings/python/
src/moonshine_voice/transcriber.py:510-630):

  add_audio -> resample to 16 kHz -> [update gate] -> VAD segmentation ->
  per-updated-segment model transcribe -> line diffing -> events.

Contracts kept:
- update gate: a pass needs >= transcription_interval of new audio unless
  FORCE (reference: transcriber.cpp:687-692);
- update-interval floor with overload backoff up to 10x: each pass must
  cover at least what the previous pass cost (reference: transcriber.py:
  510-542);
- line lifecycle: segment index -> stable line id; completed lines frozen;
  only the last line incomplete; mark-all-complete on stop;
- the five events with exactly-once delivery per snapshot (LineStarted /
  LineUpdated / LineTextChanged / LineSpeakersChanged / LineCompleted);
- per-line ``last_transcription_latency_ms`` carried in the transcript
  itself (reference: transcriber.h:40).

A copy of the JAX package's ``pipeline/transcriber.py``: speaker turns come
from an injected ``diarizer`` (``pipeline/diarization.SpeakerDiarizer``)
and spelling mode fuses the matcher with the port's spelling CNN
(``models/spelling.py``) when ``spelling_params`` is given.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..audio.resample import resample_audio
from ..audio.wav import load_wav, save_wav
from ..core.config import TranscriberOptions
from ..core.types import Transcript, TranscriptLine
from .backends import INTERNAL_SAMPLE_RATE, AsrBackend
from .transcript_output import TranscriptOutput
from .vad_segmenter import VadSegmenter

FLAG_FORCE_UPDATE = 1 << 0
FLAG_SPELLING_MODE = 1 << 1

_MAX_UPDATE_INTERVAL_FACTOR = 10.0


# -- events (reference: python transcriber.py:36-100) ----------------------

@dataclass
class TranscriptEvent:
    line: Optional[TranscriptLine]
    stream_id: int


class LineStarted(TranscriptEvent):
    pass


class LineUpdated(TranscriptEvent):
    pass


class LineTextChanged(TranscriptEvent):
    pass


class LineSpeakersChanged(TranscriptEvent):
    pass


class LineCompleted(TranscriptEvent):
    pass


@dataclass
class ErrorEvent(TranscriptEvent):
    error: Exception = None


class TranscriptEventListener:
    """Subclass-and-override listener (reference: transcriber.py:395-427)."""

    def on_line_started(self, event: LineStarted) -> None: ...

    def on_line_updated(self, event: LineUpdated) -> None: ...

    def on_line_text_changed(self, event: LineTextChanged) -> None: ...

    def on_line_speakers_changed(self, event: LineSpeakersChanged) -> None: ...

    def on_line_completed(self, event: LineCompleted) -> None: ...

    def on_error(self, event: ErrorEvent) -> None: ...


def _dispatch(listener, event) -> None:
    if isinstance(listener, TranscriptEventListener):
        if isinstance(event, LineStarted):
            listener.on_line_started(event)
        elif isinstance(event, LineUpdated):
            listener.on_line_updated(event)
        elif isinstance(event, LineTextChanged):
            listener.on_line_text_changed(event)
        elif isinstance(event, LineSpeakersChanged):
            listener.on_line_speakers_changed(event)
        elif isinstance(event, LineCompleted):
            listener.on_line_completed(event)
        elif isinstance(event, ErrorEvent):
            listener.on_error(event)
    else:
        listener(event)


# -- stream ----------------------------------------------------------------

class Stream:
    """One live transcription session over a Transcriber."""

    def __init__(
        self,
        transcriber: "Transcriber",
        stream_id: int,
        update_interval: float = 0.5,
        flags: int = 0,
    ):
        self._transcriber = transcriber
        self.stream_id = stream_id
        self._update_interval = update_interval
        self._flags = flags
        self._listeners: list[Callable] = []
        self._listener_stack: list[list[Callable]] = []
        self._stream_time = 0.0
        self._last_update_time = 0.0
        self._last_pass = 0.0
        self.output = TranscriptOutput()
        self.segmenter: VadSegmenter = transcriber._make_segmenter()
        self.new_audio = np.zeros(0, np.float32)
        self._save_wav_chunks: list[np.ndarray] = []
        self._lock = threading.Lock()

    # lifecycle

    def start(self) -> None:
        self.segmenter.start()

    def stop(self) -> Transcript:
        """Stop the stream and run a final pass.

        Remaining buffered audio is segmented first, then the segmenter is
        stopped (completing the open segment), then every just-updated
        segment gets a final ``is_final=True`` transcription — which, for
        the streaming architecture, releases the encoder lookahead frames
        and (when enabled) aligns word timestamps on the final text.
        """
        transcript = self._transcriber._finalize_stream(self, self._flags)
        self._notify_from_transcript(transcript)
        return transcript

    # audio ingest (reference: transcriber.py:510-542 backoff semantics)

    def add_audio(self, audio: np.ndarray, sample_rate: int = INTERNAL_SAMPLE_RATE) -> None:
        if not self.segmenter.is_active:
            raise RuntimeError(
                f"Adding audio to stream {self.stream_id} but it is not "
                "started. Did you call start()?"
            )
        audio = np.asarray(audio, np.float32)
        if self._transcriber.options.save_input_wav_path:
            self._save_wav_chunks.append(audio.copy())
            self._save_sample_rate = sample_rate
        resampled = resample_audio(audio, sample_rate, INTERNAL_SAMPLE_RATE)
        with self._lock:
            self.new_audio = np.concatenate([self.new_audio, resampled])
        self._stream_time += len(audio) / sample_rate
        # Floor-with-backoff: each pass must cover at least what the last
        # pass cost, capped at 10x the configured interval.
        needed = min(
            max(self._update_interval, self._last_pass),
            self._update_interval * _MAX_UPDATE_INTERVAL_FACTOR,
        )
        if self._stream_time - self._last_update_time >= needed:
            self.update_transcription(self._flags)
            self._last_update_time = self._stream_time

    def update_transcription(self, flags: int = 0) -> Transcript:
        started = time.monotonic()
        transcript = self._transcriber._transcribe_stream(self, flags)
        self._last_pass = time.monotonic() - started
        self._notify_from_transcript(transcript)
        return transcript

    # listeners

    def add_listener(self, listener: Callable) -> None:
        self._listeners.append(listener)

    def remove_listener(self, listener: Callable) -> None:
        if listener in self._listeners:
            self._listeners.remove(listener)

    def remove_all_listeners(self) -> None:
        self._listeners.clear()

    def push_listener(self, listener: Callable) -> None:
        self._listener_stack.append(list(self._listeners))
        self._listeners = [listener]

    def pop_listener(self) -> None:
        if self._listener_stack:
            self._listeners = self._listener_stack.pop()

    def _notify_from_transcript(self, transcript: Transcript) -> None:
        for line in transcript.lines:
            if line.is_new:
                self._emit(LineStarted(line=line, stream_id=self.stream_id))
            if line.is_updated and not line.is_new and not line.is_complete:
                self._emit(LineUpdated(line=line, stream_id=self.stream_id))
            if line.has_text_changed:
                self._emit(LineTextChanged(line=line, stream_id=self.stream_id))
            if line.have_speakers_changed:
                self._emit(LineSpeakersChanged(line=line, stream_id=self.stream_id))
            if line.is_complete and line.is_updated:
                self._emit(LineCompleted(line=line, stream_id=self.stream_id))

    def _emit(self, event: TranscriptEvent) -> None:
        for listener in list(self._listeners):
            try:
                _dispatch(listener, event)
            except Exception as e:  # noqa: BLE001 — listener errors must not break the stream
                err = ErrorEvent(line=None, stream_id=self.stream_id, error=e)
                for other in self._listeners:
                    if other is not listener:
                        try:
                            _dispatch(other, err)
                        except Exception:
                            pass

    def _take_new_audio(self) -> np.ndarray:
        with self._lock:
            audio, self.new_audio = self.new_audio, np.zeros(0, np.float32)
        return audio

    def save_input_wav(self) -> None:
        path = self._transcriber.options.save_input_wav_path
        if path and self._save_wav_chunks:
            import os

            os.makedirs(path, exist_ok=True)
            data = np.concatenate(self._save_wav_chunks)
            save_wav(
                os.path.join(path, f"stream_{self.stream_id}.wav"),
                data,
                getattr(self, "_save_sample_rate", INTERNAL_SAMPLE_RATE),
            )


# -- transcriber -----------------------------------------------------------

class Transcriber:
    """Owns the model backend and multiplexes streams over it
    (reference: core/transcriber.h:77-110, 225-296)."""

    def __init__(
        self,
        backend: AsrBackend,
        options: TranscriberOptions | None = None,
        hop_prob_fn=None,
        diarizer=None,
        spelling_params=None,
    ):
        self.backend = backend
        self.options = options or TranscriberOptions()
        if self.options.log_model_run:
            # The log_ort_run analog: stderr timing of every device run
            # (see profiling.py).
            from .. import profiling

            profiling.enable_device_run_log(True)
        self.hop_prob_fn = hop_prob_fn
        self.diarizer = diarizer
        # Spelling-mode auxiliaries: the matcher is free; the CNN only runs
        # when params were provided (reference: transcriber.h:198-206).
        self.spelling_params = spelling_params
        from .spelling import SpellingMatcher

        self.spelling_matcher = SpellingMatcher()
        self._streams: dict[int, Stream] = {}
        self._next_stream_id = itertools.count()
        self._next_line_id = itertools.count()
        self._lock = threading.Lock()
        self._batch_stream: Stream | None = None

    # -- stream management -------------------------------------------------

    def _make_segmenter(self) -> VadSegmenter:
        opts = self.options.vad
        hop_fn = self.hop_prob_fn or (lambda hops: np.ones(hops.shape[0], np.float32))
        return VadSegmenter(
            hop_fn,
            threshold=opts.threshold,
            window_size=opts.window_size,
            look_behind_sample_count=int(opts.speech_pad * INTERNAL_SAMPLE_RATE),
            max_segment_sample_count=int(opts.max_segment_duration * INTERNAL_SAMPLE_RATE),
        )

    def create_stream(self, update_interval: float | None = None, flags: int = 0) -> Stream:
        with self._lock:
            sid = next(self._next_stream_id)
            stream = Stream(
                self,
                sid,
                update_interval=update_interval
                if update_interval is not None
                else self.options.transcription_interval,
                flags=flags,
            )
            self._streams[sid] = stream
        return stream

    def free_stream(self, stream: Stream) -> None:
        with self._lock:
            self._streams.pop(stream.stream_id, None)
        if self.options.save_input_wav_path:
            stream.save_input_wav()

    # -- core update (reference: transcriber.cpp:653-770) -------------------

    def _transcribe_stream(self, stream: Stream, flags: int) -> Transcript:
        audio = stream._take_new_audio()
        has_new_audio = audio.size > 0
        duration = audio.size / INTERNAL_SAMPLE_RATE
        force = bool(flags & FLAG_FORCE_UPDATE)
        should_update = has_new_audio and (
            duration >= self.options.transcription_interval or force
        )
        is_stopped = not stream.segmenter.is_active

        if not should_update:
            stream.output.clear_update_flags()
            if audio.size:
                # Too little audio for a pass: put it back for next time.
                with stream._lock:
                    stream.new_audio = np.concatenate([audio, stream.new_audio])
            if self.diarizer is not None:
                self._apply_speakers(stream)
            if is_stopped:
                stream.output.mark_all_lines_as_complete()
            return stream.output.snapshot()

        if self.diarizer is not None:
            self.diarizer.add_audio(stream.stream_id, audio)

        stream.segmenter.process_audio(audio, INTERNAL_SAMPLE_RATE)
        self._update_transcript_from_segments(stream, flags)
        if self.diarizer is not None:
            self._apply_speakers(stream)
        return stream.output.snapshot()

    def _update_transcript_from_segments(self, stream: Stream, flags: int) -> None:
        stream.output.clear_update_flags()
        segments = stream.segmenter.segments
        for index, segment in enumerate(segments):
            if not segment.just_updated:
                continue
            # Map segment index -> stable line id (reference: cpp:876-886).
            while index >= len(stream.output.ordered_line_ids):
                stream.output.ordered_line_ids.append(next(self._next_line_id))
            line_id = stream.output.ordered_line_ids[index]

            t0 = time.monotonic()
            result = self.backend.transcribe_segment(
                segment.audio_data, line_id, segment.is_complete
            )
            latency_ms = int((time.monotonic() - t0) * 1000)
            text, words = result.text, list(result.words)
            # Word times are segment-relative; shift to absolute
            # (reference: transcriber.cpp:941-944).
            for w in words:
                w.start += segment.start_time
                w.end += segment.start_time

            line = TranscriptLine(
                id=line_id,
                text=_sanitize_text(text),
                start_time=segment.start_time,
                duration=segment.end_time - segment.start_time,
                is_complete=segment.is_complete,
                is_updated=True,
                last_transcription_latency_ms=latency_ms,
                words=words,
                # Exactly the audio the backend transcribed (reference:
                # transcript_line_t.audio_data, moonshine-c-api.h:151-237;
                # transcriber-test.cpp requires it non-null per line).
                audio_data=np.asarray(segment.audio_data, np.float32).copy(),
            )
            if self.options.log_output_text and text:
                print(f"Transcribed text: {text!r}")
            spelling_mode = bool(flags & FLAG_SPELLING_MODE) or self.options.spelling_mode
            if spelling_mode and line.is_complete:
                self._apply_spelling_fusion(line, segment.audio_data)
            stream.output.add_or_update_line(line)
        if not stream.segmenter.is_active:
            stream.output.mark_all_lines_as_complete()

    def _apply_spelling_fusion(self, line: TranscriptLine, audio) -> bool:
        """Fuse matcher + (optional) spelling-CNN on a completed line,
        replacing the text only on a CHARACTER result (reference:
        transcriber.cpp:832, apply_spelling_fusion)."""
        if line.text is None:
            return False
        from .spelling import fuse_default

        match = self.spelling_matcher.classify(line.text)
        prediction = None
        if self.spelling_params is not None and audio is not None and len(audio):
            from ..models import spelling as spelling_model

            prediction = spelling_model.predict(self.spelling_params, audio)
        result = fuse_default(line.text, match, prediction, self.spelling_matcher)
        if not result.is_character:
            return False
        line.text = result.character
        return True

    def _apply_speakers(self, stream: Stream) -> None:
        turns = self.diarizer.get_turns(stream.stream_id)
        from .diarization import apply_speaker_turns_to_lines

        apply_speaker_turns_to_lines(turns, stream.output)

    def _finalize_stream(self, stream: Stream, flags: int) -> Transcript:
        """Segment any remaining audio, stop the segmenter, and run the
        final transcription pass over just-updated segments (reference:
        transcriber.cpp:556-566 does segment -> stop -> transcribe)."""
        audio = stream._take_new_audio()
        if self.diarizer is not None and audio.size:
            self.diarizer.add_audio(stream.stream_id, audio)
        if stream.segmenter.is_active:
            if audio.size:
                stream.segmenter.process_audio(audio, INTERNAL_SAMPLE_RATE)
            stream.segmenter.stop()
        self._update_transcript_from_segments(stream, flags)
        if self.diarizer is not None:
            self.diarizer.finish_stream(stream.stream_id)
            self._apply_speakers(stream)
        return stream.output.snapshot()

    # -- batch API (reference: transcriber.cpp:534-651) ---------------------

    def transcribe_without_streaming(
        self, audio: np.ndarray, sample_rate: int = INTERNAL_SAMPLE_RATE
    ) -> Transcript:
        stream = self.create_stream()
        try:
            stream.start()
            audio = resample_audio(np.asarray(audio, np.float32), sample_rate, INTERNAL_SAMPLE_RATE)
            with stream._lock:
                stream.new_audio = audio
            return self._finalize_stream(stream, FLAG_FORCE_UPDATE)
        finally:
            self.free_stream(stream)

    def transcribe_wav(self, path: str) -> Transcript:
        audio, sr = load_wav(path)
        return self.transcribe_without_streaming(audio, sr)


def _sanitize_text(text: str | None) -> str | None:
    """UTF-8 sanitation (reference: transcriber.cpp:1340 sanitize_text).

    Python strings are already valid unicode; strip control characters and
    lone surrogates that a malformed byte decode could leave behind.
    """
    if text is None:
        return None
    return "".join(
        ch for ch in text if ch.isprintable() or ch in " \t\n"
    ).replace("�", "")
