"""Public API: the offline ``Transcriber``, in PyTorch.

Counterpart of the JAX package's ``api.py`` for the non-streaming models:
construct -> chainable setters -> ``load()`` -> use.

    from moonshine_tpu_torch import Transcriber

    t = Transcriber(model="base", tokenizer_path="tokenizer.bin").load()
    transcript = t.transcribe(audio)  # float32 samples at 16 kHz

It runs on CUDA unless ``device`` names another device; without CUDA the
default raises.  Weights come from ``with_params`` (for example
``weights.params_from_jax_numpy`` of a JAX parameter tree) or are drawn at
random from ``seed``.  Word timestamps (``with_options(word_timestamps=True)``)
come from the decoder's cross-attention, as in the JAX package.
Checkpoint import, the streaming models, speaker identification and the
rest of the JAX ``Transcriber``'s surface (``transcribe_wav``, streams)
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

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
from .pipeline.transcriber import Transcriber as _PipelineTranscriber


class Transcriber:
    """High-level offline transcriber with the JAX package's API."""

    def __init__(
        self,
        model: str | MoonshineArchConfig = "tiny",
        tokenizer_path: str | Path | None = None,
        options: TranscriberOptions | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        # ``model`` is an ARCHS key or a config instance.
        self._model = model
        self._tokenizer_path = tokenizer_path
        self._params = None
        model_name = model if isinstance(model, str) else getattr(model, "name", "custom")
        self.options = options or TranscriberOptions(model=model_name)
        self._seed = seed
        self._device = device
        self.device: torch.device | None = None
        self.model = None
        self._pipeline: _PipelineTranscriber | None = None

    # -- chainable setters --------------------------------------------------

    def with_params(self, params) -> "Transcriber":
        """Use an in-memory model (a ``models.moonshine.Moonshine``)."""
        self._params = params
        return self

    def with_options(self, **kw) -> "Transcriber":
        for k, v in kw.items():
            self.options.set_option(k, str(v))
        return self

    # -- loading ------------------------------------------------------------

    def load(self) -> "Transcriber":
        if self._pipeline is not None:
            return self
        from .models import moonshine as mm
        from .pipeline.backends import OfflineBackend

        if isinstance(self._model, StreamingConfig) or self._model in STREAMING_ARCHS:
            raise NotImplementedError(
                f"streaming model {self._model!r} is not ported yet (see "
                "ROADMAP.md queue 1); the port runs the offline models "
                f"{sorted(ARCHS)}")
        cfg = self._model if isinstance(self._model, MoonshineArchConfig) else ARCHS[self._model]
        self.device = resolve_device(self._device)
        tokenizer = self._load_tokenizer()
        if self._params is not None:
            model = self._params
        else:
            model = mm.init_params(cfg, torch.Generator().manual_seed(self._seed), self.device)
        self.model = model.to(self.device)
        backend = OfflineBackend(
            self.model,
            cfg,
            tokenizer,
            max_tokens_per_second=self.options.max_tokens_per_second,
            word_timestamps=self.options.word_timestamps,
            kv_int8=self.options.kv_int8,
        )
        self._pipeline = _PipelineTranscriber(
            backend, self.options, hop_prob_fn=self._load_vad())
        return self

    def _load_tokenizer(self) -> BinTokenizer:
        if self._tokenizer_path is None:
            raise FileNotFoundError(
                "pass tokenizer_path= (a tokenizer.bin): the port has no model "
                "catalog yet")
        return BinTokenizer.from_file(str(self._tokenizer_path))

    def _load_vad(self) -> Optional[Callable]:
        if self.options.vad.threshold <= 0.0:
            return None  # always-voice: the segmenter short-circuits
        from .models import vad as vad_mod

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

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16000) -> Transcript:
        return self._require_loaded().transcribe_without_streaming(audio, sample_rate)

