"""Published-voice ONNX vocoders, run by the port's ONNX interpreter.

Counterpart of the JAX package's ``models/tts_onnx.py``.  The reference's
TTS engines run published ONNX artifacts through ONNX Runtime (reference:
core/moonshine-tts/src/zipvoice-tts.h:21-108 — text_encoder.ort /
fm_decoder.ort / **vocoder.ort**; piper-tts.* — VITS voices).  The graphs
whose shapes are static given the input length — the vocoder (mel ->
waveform), where nearly all the FLOPs are — run through
``ops/onnx_graph.execute`` on the device; the dynamic-shape control parts
live in the port's own models (models/tts.py, models/voice_clone.py).

``OnnxVocoder`` accepts any HiFiGAN/Vocos-class vocoder export
(Conv/ConvTranspose/LeakyRelu/Tanh/norm graphs) and is the drop-in
real-weights replacement for the voice cloner's ``vocode`` stage (the
reference's vocoder.ort slot).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device


class OnnxVocoder:
    """mel [B, n_mels, T] (or [n_mels, T]) -> waveform, on ``device``
    (CUDA unless named); numpy in and out."""

    def __init__(self, graph, device=None):
        from ..ops.onnx_graph import compile_graph

        self.graph = graph
        self.device = resolve_device(device)
        self._run = compile_graph(graph)

    @classmethod
    def from_onnx(cls, path: str, device=None) -> "OnnxVocoder":
        from ..core.onnx_io import load_onnx

        return cls(load_onnx(path), device)

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        mel = np.asarray(mel, np.float32)
        squeeze = mel.ndim == 2
        if squeeze:
            mel = mel[None]
        wav = self._run(torch.from_numpy(np.ascontiguousarray(mel)).to(self.device))
        wav = wav.cpu().numpy()
        # Exports emit [B, N] or [B, 1, N]; hand back [N] for 2-D input.
        wav = wav.reshape(wav.shape[0], -1)
        return wav[0] if squeeze else wav
