"""SpellingCNN: the 36-way isolated letter/digit audio classifier, in PyTorch.

Counterpart of the JAX package's ``models/spelling.py``.  Two models:

- the random-weight CNN that spelling mode runs when the pipeline's
  ``Transcriber`` is given ``spelling_params``: a center-framed log-mel of a
  1 s clip (200 frames x 80 mels), per-clip normalisation, four 3x3
  convolutions with XLA's SAME padding (stride 2, 2, 2, 1; 32-64-128-128
  channels, NCHW here where JAX is NHWC), a mean over time and mels and a
  dense head;
- ``SpellingOnnx``, the real-weight SpellingCNN of an ONNX export (51
  classes over a ``[B, 1, 64, 128]`` Slaney log-mel), run by the port's
  ONNX interpreter (``ops/onnx_graph.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.mel import log_mel, log_mel_clip
from ..ops.onnx_graph import compile_graph
from .layers import Conv2d, Dense, conv_same, dense, dense_init

CLASSES = [
    *"abcdefghijklmnopqrstuvwxyz",
    "zero", "one", "two", "three", "four",
    "five", "six", "seven", "eight", "nine",
]
CLASS_TO_CHAR = {c: (c if len(c) == 1 else str(i - 26)) for i, c in enumerate(CLASSES)}

SAMPLE_RATE = 16000
CLIP_SECONDS = 1.0
TARGET_SAMPLES = int(SAMPLE_RATE * CLIP_SECONDS)
N_MELS = 80
TARGET_FRAMES = 200  # hop 80 over 1 s
_HOP = 80
_N_FFT = 400
_CHANNELS = [(1, 32), (32, 64), (64, 128), (128, 128)]


class SpellingPrediction(NamedTuple):
    """Top-1 prediction in canonical form."""

    character: str  # "a".."z" / "0".."9"
    probability: float
    raw_class: str  # e.g. "zero"


class SpellingCNN(nn.Module):
    """Parameters: four ``blocks`` (3x3 convolutions) and the ``head``."""

    def __init__(self, blocks: list[Conv2d], head: Dense):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.head = head


def init_params(generator: torch.Generator, device=None) -> SpellingCNN:
    """Random weights from ``generator`` on ``device`` (CUDA unless named):
    He-normal convolutions, as the JAX initializer draws them."""
    def conv_init(cin, cout):
        std = (2.0 / (cin * 9)) ** 0.5
        w = torch.randn((cout, cin, 3, 3), generator=generator) * std
        return Conv2d(w, torch.zeros(cout))

    model = SpellingCNN([conv_init(cin, cout) for cin, cout in _CHANNELS],
                        dense_init(generator, 128, len(CLASSES)))
    return model.to(resolve_device(device))


def forward(model: SpellingCNN, audio: torch.Tensor) -> torch.Tensor:
    """[B, 16000] waveform -> [B, 36] logits (differentiable, for
    ``train/spelling.py``; the inference callers hold inference mode)."""
    mel = log_mel(audio, n_fft=_N_FFT, hop=_HOP, n_mels=N_MELS, center=True)
    mel = mel[:, :TARGET_FRAMES, :]
    # Per-clip normalisation; jnp.std's default is the population std.
    mean = mel.mean(dim=(1, 2), keepdim=True)
    std = mel.std(dim=(1, 2), keepdim=True, correction=0) + 1e-5
    x = ((mel - mean) / std)[:, None]  # [B, 1, T, M]
    for i, conv in enumerate(model.blocks):
        x = torch.relu(conv_same(x, conv, stride=2 if i < 3 else 1))
    return dense(model.head, x.mean(dim=(2, 3)))


def _center_clip(audio: np.ndarray) -> np.ndarray:
    """Center-crop or center-pad one clip to TARGET_SAMPLES."""
    audio = np.asarray(audio, np.float32)
    clip = np.zeros(TARGET_SAMPLES, np.float32)
    if len(audio) >= TARGET_SAMPLES:
        off = (len(audio) - TARGET_SAMPLES) // 2
        clip[:] = audio[off:off + TARGET_SAMPLES]
    else:
        off = (TARGET_SAMPLES - len(audio)) // 2
        clip[off:off + len(audio)] = audio
    return clip


def _top1(logits: torch.Tensor, classes: list[str]) -> tuple[str, float]:
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    top = int(np.argmax(probs))
    return classes[top], float(probs[top])


@torch.inference_mode()
def predict(model: SpellingCNN, audio: np.ndarray) -> SpellingPrediction:
    """One clip (any length; center-cropped or padded to 1 s) -> top-1, on
    the model's device."""
    device = model.head.weight.device
    logits = forward(model, torch.from_numpy(_center_clip(audio))[None].to(device))
    raw, prob = _top1(logits[0], CLASSES)
    return SpellingPrediction(character=CLASS_TO_CHAR[raw], probability=prob, raw_class=raw)


# ---------------------------------------------------------------------------
# Real-weight path: a SpellingCNN ONNX export (51-way MobileNetV2-style
# classifier over a [B, 1, 64, 128] normalised Slaney log-mel).
# ---------------------------------------------------------------------------

# Class order of the export's metadata (data, not code).
CLASSES_51 = [
    *"abcdefghijklmnopqrstuvwxyz",
    "zero", "one", "two", "three", "four",
    "five", "six", "seven", "eight", "nine",
    "capital", "uppercase", "star", "dollar", "underscore",
    "exclamation", "percent", "dash", "delete", "finish",
    "cancel", "wifi", "ip", "yes", "no",
]
_WORD_TO_CHAR = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "star": "*", "dollar": "$", "underscore": "_", "exclamation": "!",
    "percent": "%", "dash": "-",
}


def class_to_char_51(raw: str) -> str:
    """Canonical single character for a class name (commands map to "")."""
    if len(raw) == 1:
        return raw
    return _WORD_TO_CHAR.get(raw, "")


class SpellingOnnx:
    """SpellingCNN with real exported weights: the ONNX graph runs through
    the port's interpreter on ``device`` (CUDA unless named), on features
    from the Slaney log-mel (``ops/mel.log_mel_clip``).  A clip longer than
    1 s is center-cropped; a shorter one is padded in the mel frames."""

    def __init__(self, graph, classes: list[str] | None = None,
                 device: str | torch.device | None = None):
        self.graph = graph
        self.classes = classes or CLASSES_51
        self.device = resolve_device(device)
        self._fn = compile_graph(graph)

    @classmethod
    def from_onnx(cls, path: str, classes: list[str] | None = None,
                  device: str | torch.device | None = None) -> "SpellingOnnx":
        from ..core.onnx_io import load_onnx

        return cls(load_onnx(path), classes, device)

    def logits(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, <=16000] waveform batch -> [B, n_classes] logits."""
        return self._fn(log_mel_clip(audio.to(self.device)))

    def predict(self, audio: np.ndarray) -> SpellingPrediction:
        """One clip (any length; cropped or frame-padded to 1 s) -> top-1."""
        audio = np.asarray(audio, np.float32)
        if len(audio) > TARGET_SAMPLES:
            off = (len(audio) - TARGET_SAMPLES) // 2
            audio = audio[off:off + TARGET_SAMPLES]
        raw, prob = _top1(self.logits(torch.from_numpy(audio.copy())[None])[0], self.classes)
        return SpellingPrediction(character=class_to_char_51(raw) or raw, probability=prob,
                                  raw_class=raw)
