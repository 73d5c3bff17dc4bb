"""SpellingCNN training recipe, in PyTorch.

Counterpart of the JAX package's ``train/spelling.py``: a dataset reader for
the labeled-by-directory wav layout (``<root>/<class>/*.wav``), waveform
augmentation (gain, circular shift, additive noise), an Adam step over the
36-way CNN of ``models/spelling.py`` and an accuracy evaluator.

The batches and the augmentation draw from a numpy generator, as JAX's
do, so both packages see the same batches from one seed.  The initial
weights come from a ``torch.Generator`` (``init_params`` takes given ones,
e.g. JAX's through ``weights.spelling_params_from_jax_numpy``).
``optax.adam`` becomes ``torch.optim.Adam`` with optax's epsilon.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..audio.wav import load_wav
from ..models import spelling as sp
from .step import adam, freeze, make_train_state


class SpellingDataset(NamedTuple):
    audio: np.ndarray  # [N, 16000] float32
    labels: np.ndarray  # [N] int32 indices into sp.CLASSES
    names: list  # [N] source file names


def load_directory_dataset(root: str, classes: list[str] | None = None) -> SpellingDataset:
    """Read a <root>/<class>/*.wav tree (one directory per class)."""
    classes = classes or sp.CLASSES
    idx = {c: i for i, c in enumerate(classes)}
    audio, labels, names = [], [], []
    for cls in sorted(os.listdir(root)):
        if cls not in idx:
            continue
        d = os.path.join(root, cls)
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            if not f.endswith(".wav"):
                continue
            x, sr = load_wav(os.path.join(d, f))
            if sr != sp.SAMPLE_RATE:
                raise ValueError(f"{f}: expected {sp.SAMPLE_RATE} Hz, got {sr}")
            clip = np.zeros(sp.TARGET_SAMPLES, np.float32)
            n = min(len(x), sp.TARGET_SAMPLES)
            clip[:n] = x[:n]
            audio.append(clip)
            labels.append(idx[cls])
            names.append(f"{cls}/{f}")
    return SpellingDataset(np.stack(audio), np.asarray(labels, np.int32), names)


def augment(rng: np.random.Generator, audio: np.ndarray) -> np.ndarray:
    """Waveform augmentation: gain 0.5x..1.5x, a circular shift of up to
    +-100 ms, additive noise at about 20 dB below each clip's RMS."""
    b, n = audio.shape
    out = audio.copy()
    out *= rng.uniform(0.5, 1.5, (b, 1)).astype(np.float32)
    shifts = rng.integers(-1600, 1600, b)
    for i, s in enumerate(shifts):
        out[i] = np.roll(out[i], int(s))
    rms = np.sqrt((out ** 2).mean(axis=1, keepdims=True)) + 1e-6
    out += (0.1 * rms * rng.standard_normal((b, n))).astype(np.float32)
    return out


class TrainResult(NamedTuple):
    params: sp.SpellingCNN
    losses: list
    train_accuracy: float


def _loss_fn(model: sp.SpellingCNN, audio: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(sp.forward(model, audio).float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def _adam_step(model: sp.SpellingCNN, opt: torch.optim.Optimizer, audio: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """One Adam step on a batch; returns the batch's loss (before it)."""
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = _loss_fn(model, audio, labels)
        loss.backward()
    opt.step()
    return loss.detach()


def train(
    data: SpellingDataset,
    epochs: int = 10,
    batch_size: int = 32,
    lr: float = 3e-3,
    seed: int = 0,
    use_augment: bool = True,
    init_params: sp.SpellingCNN | None = None,
    device: str | torch.device | None = None,
) -> TrainResult:
    """Train the 36-way spelling CNN on ``data`` (from ``init_params`` if
    given, else from weights seeded with ``seed``), on ``device`` (CUDA
    unless named; ``init_params``' own device when given)."""
    rng = np.random.default_rng(seed)
    fresh = init_params is None
    state = make_train_state(sp.init_params(torch.Generator().manual_seed(seed), device)
                             if fresh else init_params, adam(lr), copy_params=not fresh)
    model, opt = state.params, state.opt_state
    dev = model.head.weight.device

    n = len(data.labels)
    losses: list[float] = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            sel = order[lo:lo + batch_size]
            batch = data.audio[sel]
            if use_augment:
                batch = augment(rng, batch)
            loss = _adam_step(model, opt, torch.from_numpy(np.ascontiguousarray(batch)).to(dev),
                              torch.from_numpy(data.labels[sel]).to(dev))
            losses.append(float(loss))
    return TrainResult(freeze(model), losses, accuracy(model, data))


@torch.inference_mode()
def accuracy(model: sp.SpellingCNN, data: SpellingDataset, batch_size: int = 64) -> float:
    dev = model.head.weight.device
    correct = 0
    for lo in range(0, len(data.labels), batch_size):
        logits = sp.forward(model, torch.from_numpy(data.audio[lo:lo + batch_size]).to(dev))
        correct += int((logits.argmax(-1).cpu().numpy()
                        == data.labels[lo:lo + batch_size]).sum())
    return correct / len(data.labels)
