"""Public API: the ``Transcriber``, in PyTorch.

Counterpart of the JAX package's ``api.py``, with its constructor and
surface: construct -> chainable setters -> ``load()`` -> use.

    from moonshine_tpu_torch import Transcriber

    t = Transcriber("base", "en").load()        # resolved through the catalog
    transcript = t.transcribe_wav("speech.wav")

    stream = t.create_stream(update_interval=0.5)
    stream.add_listener(lambda e: print(e))
    stream.start(); stream.add_audio(chunk); stream.stop()

It runs on CUDA unless ``device=`` names another device; without CUDA the
default raises.  Weights come from ``with_params`` (a port model, for
example ``weights.params_from_jax_numpy`` of a JAX parameter tree), from
``weights=`` (a checkpoint: an HF Moonshine ``.safetensors`` for the
offline models, a streaming checkpoint directory or ``.safetensors`` for
the streaming ones), from the catalog (``<cache>/<model>-<language>/``), or
at random from ``seed``.  The tokenizer comes from ``tokenizer_path=``, the
catalog, or the catalog's default tokenizer.  Both model families run:
the offline models (``ARCHS``, and Canary: ``model="canary-1b-flash"`` or a
``models.canary.CanaryArchConfig``) and the streaming ones
(``STREAMING_ARCHS``).  A Canary model comes from ``with_params`` or from
``seed``: its checkpoint import is not written yet.
Word timestamps (``with_options(word_timestamps=True)``) come from the
decoder's cross-attention.  ``vad_weights=`` names a TinyVadCNN ONNX
export, which then gives the VAD's speech probabilities (as long as the
VAD threshold is above 0); otherwise the random-weight VAD of ``seed``
does.  ``with_options(identify_speakers=True)`` diarizes every stream with
the segmentation and speaker-embedding models (random weights from
``seed + 2`` and ``seed + 3``, as the JAX package draws them) on the
transcriber's device; ``with_options(spelling_mode=True)`` turns each
completed line into the character the spelling matcher hears in it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import catalog
from .core.config import (
    ARCHS,
    STREAMING_ARCHS,
    MoonshineArchConfig,
    StreamingConfig,
    TranscriberOptions,
)
from .core.device import resolve_device
from .core.tokenizer import BinTokenizer
from .core.types import Transcript
from .models.canary import CANARY_1B_FLASH, CanaryArchConfig
from .models.canary_qwen import CANARY_QWEN_2_5B, CanaryQwenArchConfig
from .pipeline.transcriber import Stream
from .pipeline.transcriber import Transcriber as _PipelineTranscriber
from .pipeline.transcriber import TranscriptEventListener  # noqa: F401  (re-export)


class Transcriber:
    """High-level transcriber with the JAX package's API."""

    def __init__(
        self,
        model: str | MoonshineArchConfig | StreamingConfig | CanaryArchConfig
        | CanaryQwenArchConfig = "tiny",
        language: str = "en",
        weights: str | Path | None = None,
        tokenizer_path: str | Path | None = None,
        options: TranscriberOptions | None = None,
        vad_weights: str | Path | None = None,
        seed: int = 0,
        *,
        device: str | torch.device | None = None,
    ):
        # ``model`` is an ARCHS/STREAMING_ARCHS key, "canary-1b-flash",
        # "canary-qwen-2.5b" or a config instance.
        self._model = model
        self._language = language
        self._weights = weights
        self._params = None
        self._tokenizer_path = tokenizer_path
        model_name = model if isinstance(model, str) else getattr(model, "name", "custom")
        self.options = options or TranscriberOptions(model=model_name)
        self._vad_weights = vad_weights
        self._seed = seed
        self._device = device
        self.device: torch.device | None = None
        self.model = None
        self._pipeline: _PipelineTranscriber | None = None

    # -- chainable setters --------------------------------------------------

    def language(self, code: str) -> "Transcriber":
        self._language = code
        return self

    def with_weights(self, path: str | Path) -> "Transcriber":
        self._weights = path
        return self

    def with_params(self, params) -> "Transcriber":
        """Use an in-memory model (a ``models.moonshine.Moonshine``, a
        ``models.canary.Canary``, a ``models.canary_qwen.CanaryQwen`` or a
        ``models.streaming.StreamingMoonshine``)."""
        self._params = params
        return self

    def with_options(self, **kw) -> "Transcriber":
        for k, v in kw.items():
            self.options.set_option(k, str(v))
        return self

    # -- loading ------------------------------------------------------------

    def _is_streaming(self) -> bool:
        if isinstance(self._model, str):
            return self._model in STREAMING_ARCHS
        return isinstance(self._model, StreamingConfig)

    def _is_canary(self) -> bool:
        return isinstance(self._model, CanaryArchConfig) or self._model == CANARY_1B_FLASH.name

    def _is_canary_qwen(self) -> bool:
        return (isinstance(self._model, CanaryQwenArchConfig)
                or self._model == CANARY_QWEN_2_5B.name)

    def load(self) -> "Transcriber":
        if self._pipeline is not None:
            return self
        from .models import canary, canary_qwen
        from .models import moonshine as mm
        from .models import streaming as ms
        from .pipeline.backends import OfflineBackend, StreamingBackend

        self.device = resolve_device(self._device)
        tokenizer = self._load_tokenizer()
        generator = torch.Generator().manual_seed(self._seed)
        if self._is_streaming():
            cfg = self._model if isinstance(self._model, StreamingConfig) else (
                STREAMING_ARCHS[self._model])
            model, cfg = self._load_or_init(
                lambda: ms.init_params(cfg, generator, self.device), cfg)
            self.model = model.to(self.device)
            backend = StreamingBackend(
                self.model,
                cfg,
                tokenizer,
                use_speculative_decoding=self.options.use_speculative_decoding,
                max_tokens_per_second=self.options.max_tokens_per_second,
                word_timestamps=self.options.word_timestamps,
            )
        else:
            if self._is_canary():
                cfg = self._model if isinstance(self._model, CanaryArchConfig) else CANARY_1B_FLASH
                init = canary.init_params
            elif self._is_canary_qwen():
                cfg = (self._model if isinstance(self._model, CanaryQwenArchConfig)
                       else CANARY_QWEN_2_5B)
                init = canary_qwen.init_params
            else:
                cfg = self._model if isinstance(self._model, MoonshineArchConfig) else (
                    ARCHS[self._model])
                init = mm.init_params
            model, cfg = self._load_or_init(lambda: init(cfg, generator, self.device), cfg)
            self.model = model.to(self.device)
            backend = OfflineBackend(
                self.model,
                cfg,
                tokenizer,
                max_tokens_per_second=self.options.max_tokens_per_second,
                word_timestamps=self.options.word_timestamps,
                kv_int8=self.options.kv_int8,
            )
        diarizer = self._load_diarizer() if self.options.identify_speakers else None
        self._pipeline = _PipelineTranscriber(backend, self.options, hop_prob_fn=self._load_vad(),
                                              diarizer=diarizer)
        return self

    def _load_diarizer(self):
        """A ``SpeakerDiarizer`` over the segmentation and embedding models,
        on this transcriber's device: its callbacks move each numpy batch
        there and the result back."""
        from .models import diarization as dm
        from .pipeline.diarization import SpeakerDiarizer

        seg = dm.init_segmentation_params(torch.Generator().manual_seed(self._seed + 2),
                                          device=self.device)
        emb = dm.init_embedding_params(torch.Generator().manual_seed(self._seed + 3),
                                       device=self.device)

        def activities(batch: np.ndarray) -> np.ndarray:
            audio = torch.from_numpy(batch).to(self.device)
            return dm.segmentation_activations(seg, audio).cpu().numpy()

        def embeddings(batch: np.ndarray, weights: np.ndarray) -> np.ndarray:
            audio = torch.from_numpy(batch).to(self.device)
            w = torch.from_numpy(weights).to(self.device)
            with torch.inference_mode():
                return dm.embedding_forward(emb, audio, w).cpu().numpy()

        return SpeakerDiarizer(activities, embeddings)

    def _load_tokenizer(self) -> BinTokenizer:
        """The explicit path, then the catalog's ``tokenizer.bin`` for this
        model and language, then the catalog's default tokenizer."""
        path = self._tokenizer_path
        if path is None:
            try:
                path = catalog.resolve(self._model, self._language).path("tokenizer.bin")
            except (FileNotFoundError, KeyError):
                path = catalog.default_tokenizer_path()
        if path is None:
            raise FileNotFoundError(
                "No tokenizer.bin found; pass tokenizer_path= or populate the cache "
                f"(${catalog.DEFAULT_CACHE_ENV}/<model>-<language>/)")
        return BinTokenizer.from_file(str(path))

    def _load_or_init(self, init_fn: Callable, cfg):
        """(model, config): ``with_params``'s model, else the checkpoint of
        ``weights=`` or of the catalog, else random weights from
        ``init_fn``.  A streaming checkpoint directory brings its own
        ``streaming_config.json``, which then configures the backend too
        (the JAX package keeps the catalog's config there)."""
        if self._params is not None:
            return self._params, cfg
        if self._weights is None and isinstance(self._model, str):
            try:
                resolved = catalog.resolve(self._model, self._language)
                self._weights = resolved.path("model.safetensors")
            except (FileNotFoundError, KeyError):
                pass
        if self._weights is None:
            return init_fn(), cfg
        if self._is_canary() or self._is_canary_qwen():
            name = "Canary-Qwen" if self._is_canary_qwen() else "Canary"
            raise NotImplementedError(
                f"no importer of {name} checkpoints yet ({self._weights}): pass the model "
                "with with_params(), or no weights for random ones from seed")
        from .weights import import_hf_moonshine, import_streaming, load_streaming_checkpoint

        if not self._is_streaming():
            return import_hf_moonshine(str(self._weights), cfg, device=self.device), cfg
        # The streaming family: a checkpoint directory or one flat
        # safetensors file.
        path = Path(self._weights)
        if path.is_dir():
            return load_streaming_checkpoint(str(path), device=self.device)
        return import_streaming(str(path), cfg, device=self.device), cfg

    def _load_vad(self) -> Optional[Callable]:
        if self.options.vad.threshold <= 0.0:
            return None  # always-voice: the segmenter short-circuits
        from .models import vad as vad_mod

        if self._vad_weights is not None:
            # Real TinyVadCNN weights (an ONNX export, such as the
            # reference's micro/models/tinyvad_cnn_speech_mel.onnx).
            return vad_mod.TinyVad.from_onnx(str(self._vad_weights),
                                             self.device).hop_prob_fn()
        params = vad_mod.init_params(torch.Generator().manual_seed(self._seed + 1),
                                     device=self.device)
        state = [vad_mod.init_state(1, device=self.device)]

        def hop_probs(hops: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(np.asarray(hops, np.float32))[None].to(self.device)
            probs, state[0] = vad_mod.predict_hops(params, x, state[0])
            return probs[0].cpu().numpy()

        return hop_probs

    # -- use ----------------------------------------------------------------

    def _require_loaded(self) -> _PipelineTranscriber:
        if self._pipeline is None:
            raise RuntimeError("Call load() before using the transcriber")
        return self._pipeline

    def _log_api(self, name: str, **args) -> None:
        from . import profiling

        profiling.log_api_call(self.options.log_api_calls, name, **args)

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000) -> Transcript:
        self._log_api("transcribe", audio=audio, sample_rate=sample_rate)
        return self._require_loaded().transcribe_without_streaming(audio, sample_rate)

    def transcribe_wav(self, path: str) -> Transcript:
        self._log_api("transcribe_wav", path=path)
        return self._require_loaded().transcribe_wav(path)

    def create_stream(self, update_interval: float | None = None, flags: int = 0) -> Stream:
        self._log_api("create_stream", update_interval=update_interval, flags=flags)
        return self._require_loaded().create_stream(update_interval, flags)

    def free_stream(self, stream: Stream) -> None:
        self._log_api("free_stream", stream=getattr(stream, "stream_id", stream))
        self._require_loaded().free_stream(stream)

    # -- implicit default stream ---------------------------------------------
    # Single-input apps can forget streams exist: the transcriber exposes
    # the same start/add_audio/update/stop surface, lazily backed by one
    # stream.

    _default_stream: Stream | None = None

    def _stream(self) -> Stream:
        if self._default_stream is None:
            self._default_stream = self.create_stream()
            self._default_stream.start()
        return self._default_stream

    def start(self) -> None:
        self._stream()

    def add_audio(self, audio: np.ndarray, sample_rate: int = 16000) -> None:
        self._stream().add_audio(audio, sample_rate)

    def update_transcription(self, flags: int = 0) -> Transcript:
        return self._stream().update_transcription(flags)

    def add_listener(self, listener) -> None:
        self._stream().add_listener(listener)

    def stop(self) -> Transcript:
        stream = self._stream()
        transcript = stream.stop()
        self.free_stream(stream)
        self._default_stream = None
        return transcript


class MicTranscriber:
    """Microphone-fed transcriber.

    Uses ``sounddevice`` when available and raises a clear error otherwise.
    Events arrive through the stream listeners exactly as for file input.
    """

    def __init__(self, transcriber: Transcriber, update_interval: float = 0.5, device=None):
        self.transcriber = transcriber
        self.update_interval = update_interval
        self.device = device
        self.stream: Stream | None = None
        self._sd_stream = None
        self._muted = False

    def add_listener(self, listener) -> None:
        if self.stream is None:
            self.stream = self.transcriber.create_stream(self.update_interval)
        self.stream.add_listener(listener)

    def mute(self, muted: bool = True) -> None:
        self._muted = muted

    def start(self) -> None:
        try:
            import sounddevice as sd
        except ImportError as e:
            raise RuntimeError(
                "MicTranscriber requires the sounddevice package and an audio input device"
            ) from e
        if self.stream is None:
            self.stream = self.transcriber.create_stream(self.update_interval)
        self.stream.start()

        def callback(indata, frames, time_info, status):  # pragma: no cover - needs a device
            if not self._muted:
                self.stream.add_audio(indata[:, 0].copy(), int(self._sd_stream.samplerate))

        self._sd_stream = sd.InputStream(channels=1, callback=callback, device=self.device)
        self._sd_stream.start()

    def stop(self) -> Transcript:  # pragma: no cover - needs a device
        if self._sd_stream is not None:
            self._sd_stream.stop()
            self._sd_stream.close()
            self._sd_stream = None
        return self.stream.stop()
