"""Alphanumeric dictation: sessions for Ask(mode=SPELLED/DIGITS) and the
transcript-event listener.

Capability mirror of the reference's alphanumeric_listener.py (reference:
language-bindings/python/src/moonshine_voice/alphanumeric_listener.py):
characters are accumulated one utterance at a time through the spelling
matcher (+ optional spelling-CNN fusion), with STOPPED ending the session,
CLEAR resetting the buffer and UNDO deleting the last character.  DIGITS
mode additionally accepts multi-digit number utterances and restricts
letters.  :class:`AlphanumericListener` is the callable listener half —
pass it to ``Stream.add_listener()`` / ``Transcriber.add_listener()`` and
it assembles characters from completed lines, with optional per-character
TTS repeat-back and error feedback (reference: :738-1005).

A copy of the JAX package's ``agent/alphanumeric.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from ..pipeline.spelling import (
    SpellingMatcher,
    SpellingMatchType,
    fuse_default,
    spoken_form,
)


@dataclass
class AlphaEvent:
    """One session update: the action taken and the current buffer."""

    action: str  # "append" | "undo" | "clear" | "stop" | "none"
    character: str = ""
    buffer: str = ""


PredictFn = Callable[[np.ndarray], object]  # audio -> SpellingPrediction


class AlphanumericSession:
    """Accumulates characters from successive utterances."""

    def __init__(
        self,
        mode: str = "spelled",  # "spelled" | "digits"
        predict_fn: Optional[PredictFn] = None,
        on_event: Optional[Callable[[AlphaEvent], None]] = None,
    ):
        self.mode = mode
        self.predict_fn = predict_fn
        self.on_event = on_event
        self.matcher = SpellingMatcher()
        self.buffer: list[str] = []
        self.stopped = False

    @property
    def value(self) -> str:
        return "".join(self.buffer)

    def _emit(self, action: str, character: str = "") -> AlphaEvent:
        ev = AlphaEvent(action=action, character=character, buffer=self.value)
        if self.on_event:
            self.on_event(ev)
        return ev

    def handle_utterance(self, text: str, audio: np.ndarray | None = None) -> AlphaEvent:
        """Process one completed line; returns the resulting event."""
        if self.stopped:
            return self._emit("stop")
        match = self.matcher.classify(text)
        prediction = None
        if self.predict_fn is not None and audio is not None and len(audio):
            prediction = self.predict_fn(audio)
        fused = fuse_default(text, match, prediction, self.matcher)

        if fused.type == SpellingMatchType.STOPPED:
            self.stopped = True
            return self._emit("stop")
        if fused.type == SpellingMatchType.CLEAR:
            self.buffer.clear()
            return self._emit("clear")
        if fused.type == SpellingMatchType.UNDO:
            if self.buffer:
                self.buffer.pop()
            return self._emit("undo")
        if fused.type == SpellingMatchType.CHARACTER:
            ch = fused.character
            if self.mode == "digits":
                # Digits mode accepts only digit strings (multi-digit fine).
                if not ch.isdigit():
                    return self._emit("none")
            self.buffer.extend(ch)
            return self._emit("append", ch)
        return self._emit("none")


class AlphanumericListener:
    """Callable transcript-event listener that assembles dictated text.

    Pass it directly to ``Stream.add_listener()``: it receives raw
    :class:`TranscriptEvent` objects, filters for ``LineCompleted`` (or
    ``LineTextChanged`` when ``use_line_completed=False`` for lower
    latency), deduplicates lines by id, and delegates recognition to a
    :class:`SpellingMatcher`.  ``callback`` fires on every CHARACTER /
    UNDO / CLEAR / STOPPED with the running buffer (reference:
    alphanumeric_listener.py:738-1005).

    When a ``tts`` backend is given, each recognized character is echoed
    via ``tts.say(spoken_form(char))`` and unrecognized utterances trigger
    ``tts.play_error()`` when the backend defines it; exceptions from
    either are swallowed so a flaky TTS cannot break dictation.
    """

    def __init__(
        self,
        callback: Callable[[AlphaEvent], None],
        *,
        use_line_completed: bool = True,
        custom_words: Optional[dict[str, str]] = None,
        matcher: Optional[SpellingMatcher] = None,
        tts: Optional[Any] = None,
        debug: bool = False,
    ):
        self._callback = callback
        self._use_line_completed = use_line_completed
        self._debug = debug
        self._tts = tts
        self._buffer: list[str] = []
        self._processed_line_ids: set = set()
        self._stopped = False
        self._matcher = matcher or SpellingMatcher(custom_words=custom_words)

    def __call__(self, event) -> None:
        # Import here to keep the agent package importable without the
        # pipeline's model dependencies at module import time.
        from ..pipeline.transcriber import LineCompleted, LineTextChanged

        if self._stopped:
            return
        if self._use_line_completed and isinstance(event, LineCompleted):
            self._process_utterance(event.line)
        elif not self._use_line_completed and isinstance(event, LineTextChanged):
            self._process_utterance(event.line)

    @property
    def text(self) -> str:
        return "".join(self._buffer)

    @property
    def stopped(self) -> bool:
        return self._stopped

    @property
    def matcher(self) -> SpellingMatcher:
        return self._matcher

    def clear(self) -> None:
        """Programmatically wipe the buffer (also resets stop state)."""
        self._buffer.clear()
        self._processed_line_ids.clear()
        self._stopped = False
        self._callback(AlphaEvent(action="clear", buffer=self.text))

    def undo(self) -> Optional[str]:
        """Remove and return the last character, or None if empty."""
        if not self._buffer:
            return None
        removed = self._buffer.pop()
        self._callback(AlphaEvent(action="undo", character=removed, buffer=self.text))
        return removed

    def _process_utterance(self, line) -> None:
        line_id = getattr(line, "id", None)
        raw_text = getattr(line, "text", "") or ""
        if line_id is not None:
            if line_id in self._processed_line_ids:
                return
            self._processed_line_ids.add(line_id)

        match = self._matcher.classify(raw_text)
        if match.type == SpellingMatchType.STOPPED:
            self._stopped = True
            self._callback(AlphaEvent(action="stop", buffer=self.text))
            return
        if match.type == SpellingMatchType.CLEAR:
            self.clear()
            return
        if match.type == SpellingMatchType.UNDO:
            self.undo()
            return

        final_char = match.character if match.type == SpellingMatchType.CHARACTER else None
        # The normalizer strips punctuation, so a line whose text IS a
        # bare special character (spelling-fusion writes e.g. ".") would
        # otherwise be dropped — fall back to single-codepoint raw text.
        if final_char is None and len(raw_text) == 1 and not raw_text.isspace():
            final_char = raw_text

        if final_char is not None:
            # Appended as one unit so undo removes a whole spoken token
            # ("forty two" -> "42" undoes atomically, reference: :928).
            self._buffer.append(final_char)
            self._callback(
                AlphaEvent(action="append", character=final_char, buffer=self.text)
            )
            self._speak_character(final_char)
            return

        if self._debug:
            import sys

            print(f"[debug] unrecognised: {raw_text!r}", file=sys.stderr)
        self._play_error_feedback()

    def _speak_character(self, char: str) -> None:
        if self._tts is None:
            return
        phrase = spoken_form(char) if len(char) == 1 else char
        try:
            self._tts.say(phrase)
        except Exception:
            if self._debug:
                import sys

                print(f"[debug] tts.say({phrase!r}) failed", file=sys.stderr)

    def _play_error_feedback(self) -> None:
        if self._tts is None:
            return
        play_error = getattr(self._tts, "play_error", None)
        if play_error is None:
            return
        try:
            play_error()
        except Exception:
            if self._debug:
                import sys

                print("[debug] tts.play_error() failed", file=sys.stderr)
