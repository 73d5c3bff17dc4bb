"""MicTranscriber — live audio in, transcript events out, in PyTorch.

Counterpart of the JAX package's ``mic.py``, over the port's
``api.Transcriber``.  API mirror of the reference binding (reference:
language-bindings/python/src/moonshine_voice/mic_transcriber.py: chainable
setters -> load() -> start()/stop(), on_text/on_line/on_error callbacks,
mute/unmute).

Audio capture is pluggable: ``sounddevice`` when installed (the
reference's backend), else any generator/callable source — a WAV-playback
source ships for tests and headless hosts, and remote clients use
server.py's WebSocket ingest instead of a local device.  Ingest flows
through the native ring buffer (runtime/native_host.NativeRing) exactly
like the reference's capture thread, decoupling the audio callback from
the update cadence; the update loop applies the reference's
update-interval + overload-backoff semantics via pipeline.Stream.

``.device(...)`` names the *sound* device (``sounddevice``'s input).  The
torch device is the ``Transcriber``'s: the one given to
``use_transcriber``, or CUDA for the ``Transcriber`` that ``load()``
builds.  The capture thread makes that device its current one.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np

from .api import Transcriber
from .core.device import device_scope


class WavSource:
    """File-playback audio source: yields blocks at real-time pace
    (or as fast as possible with pace=False, for tests)."""

    def __init__(self, path: str, block_seconds: float = 0.1, pace: bool = True):
        from .audio.wav import load_wav

        self.audio, self.sample_rate = load_wav(path)
        self.block = int(self.sample_rate * block_seconds)
        self.pace = pace

    def __iter__(self):
        for i in range(0, len(self.audio), self.block):
            if self.pace:
                time.sleep(self.block / self.sample_rate)
            yield self.audio[i : i + self.block]


class MicTranscriber:
    """Chainable live transcriber (reference API shape)."""

    def __init__(self):
        self._transcriber: Optional[Transcriber] = None
        self._model = "tiny"
        self._language = "en"
        self._update_interval = 0.5
        self._device = None
        self._samplerate = 16000
        self._blocksize = 1600
        self._source: Optional[Iterable[np.ndarray]] = None
        self._listeners: list[Callable] = []
        self._loaded = False
        self._running = False
        self._muted = False
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        self._ring = None

    # -- chainable setters ---------------------------------------------------

    def language(self, code: str) -> "MicTranscriber":
        self._language = code
        return self

    def model_arch(self, arch: str) -> "MicTranscriber":
        self._model = arch
        return self

    def use_transcriber(self, transcriber: Transcriber) -> "MicTranscriber":
        self._transcriber = transcriber
        return self

    def update_interval(self, seconds: float) -> "MicTranscriber":
        self._update_interval = seconds
        return self

    def device(self, device) -> "MicTranscriber":
        """The sound input device (``sounddevice``'s ``device=``)."""
        self._device = device
        return self

    def samplerate(self, hz: int) -> "MicTranscriber":
        self._samplerate = hz
        return self

    def blocksize(self, frames: int) -> "MicTranscriber":
        self._blocksize = frames
        return self

    def audio_source(self, source: Iterable[np.ndarray]) -> "MicTranscriber":
        """Any iterable of float32 blocks (tests / headless servers)."""
        self._source = source
        return self

    def on_text(self, callback: Callable[[str], None]) -> "MicTranscriber":
        from .pipeline.transcriber import LineCompleted, LineTextChanged

        def listener(event):
            if isinstance(event, (LineTextChanged, LineCompleted)):
                callback(event.line.text)

        self._listeners.append(listener)
        return self

    def on_line(self, callback) -> "MicTranscriber":
        from .pipeline.transcriber import LineCompleted

        def listener(event):
            if isinstance(event, LineCompleted):
                callback(event.line)

        self._listeners.append(listener)
        return self

    def on_error(self, callback) -> "MicTranscriber":
        from .pipeline.transcriber import ErrorEvent

        def listener(event):
            if isinstance(event, ErrorEvent):
                callback(event)

        self._listeners.append(listener)
        return self

    def add_listener(self, listener: Callable) -> "MicTranscriber":
        self._listeners.append(listener)
        return self

    # -- lifecycle ------------------------------------------------------------

    def load(self) -> "MicTranscriber":
        if self._transcriber is None:
            self._transcriber = Transcriber(self._model, self._language).load()
        elif self._transcriber._pipeline is None:
            self._transcriber.load()
        self._loaded = True
        return self

    @property
    def is_running(self) -> bool:
        return self._running

    def mute(self) -> None:
        """Drop incoming audio (the reference mutes during TTS playback)."""
        self._muted = True

    def unmute(self) -> None:
        self._muted = False

    def start(self) -> "MicTranscriber":
        if not self._loaded:
            self.load()
        if self._running:
            return self
        pipeline = self._transcriber._pipeline
        self._stream = pipeline.create_stream(update_interval=self._update_interval)
        for l in self._listeners:
            self._stream.add_listener(l)
        self._stream.start()
        try:
            from .runtime.native_host import NativeRing

            self._ring = NativeRing(self._samplerate * 30)
        except Exception:
            self._ring = None
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop capture and return the final transcript."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        transcript = self._stream.stop() if self._stream is not None else None
        self._stream = None
        return transcript

    # -- capture + update loop -------------------------------------------------

    def _blocks(self):
        if self._source is not None:
            yield from self._source
            return
        try:
            import sounddevice as sd
        except ImportError as e:  # pragma: no cover - env without audio
            raise RuntimeError(
                "No audio source: install sounddevice or pass .audio_source(...)"
            ) from e
        q: "list[np.ndarray]" = []
        cond = threading.Condition()

        def callback(indata, frames, t, status):  # pragma: no cover - hw path
            with cond:
                q.append(indata[:, 0].copy())
                cond.notify()

        with sd.InputStream(  # pragma: no cover - hw path
            samplerate=self._samplerate, channels=1, dtype="float32",
            blocksize=self._blocksize, device=self._device, callback=callback,
        ):
            while self._running:
                with cond:
                    if not q:
                        cond.wait(timeout=0.1)
                    blocks, q[:] = list(q), []
                for b in blocks:
                    yield b

    def _run(self) -> None:
        with device_scope(self._transcriber.device):
            self._pump()

    def _pump(self) -> None:
        # Stream.add_audio applies the update-interval + overload-backoff
        # gate itself (reference: transcriber.py:432-542); the ring simply
        # decouples capture bursts from update passes.
        for block in self._blocks():
            if not self._running:
                break
            if self._muted:
                block = np.zeros_like(block)
            if self._ring is not None:
                self._ring.write(np.asarray(block, np.float32))
                avail = self._ring.available
                pending = self._ring.read(avail) if avail else None
            else:
                pending = np.asarray(block, np.float32)
            if pending is not None and len(pending):
                self._stream.add_audio(pending, self._samplerate)
        # Drain: the final update pass happens in stop().
