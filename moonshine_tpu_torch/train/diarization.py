"""Train the diarization model pair on labeled multi-speaker audio, in PyTorch.

Counterpart of the JAX package's ``train/diarization.py``.  Given a few
labeled single-speaker recordings it

- stitches labeled multi-speaker training windows (numpy, from a numpy
  generator, so both packages build the same windows from one seed),
- trains ``models/diarization.Segmentation`` with the permutation-invariant
  powerset cross-entropy,
- trains ``models/diarization.Embedding`` with a pairwise cosine
  contrastive loss over the masked attentive-statistics pooling the
  diarizer calls at inference,
- fits a two-covariance PLDA (numpy and scipy, as JAX's) so that the VBx
  clustering path runs with matched statistics.

The minimum over the speaker permutations is ``torch.amin``, which, like
``jnp.min``, spreads the gradient evenly over tied permutations
(``torch.min(dim=)`` would send all of it to one).  ``optax.adam`` becomes
``torch.optim.Adam`` with optax's epsilon.  Initial weights come from a
``torch.Generator``; ``init_params`` takes given ones.
"""

from __future__ import annotations

from itertools import permutations
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..models.diarization import (
    FRAMES_PER_SECOND,
    MAX_LOCAL_SPEAKERS,
    MEL_HOP,
    POWERSET,
    SAMPLE_RATE,
    WINDOW_SAMPLES,
    embedding_forward,
    init_embedding_params,
    init_segmentation_params,
    segmentation_forward,
)
from ..pipeline.vbx import PldaModel
from .step import adam, freeze, make_train_state

__all__ = [
    "voiced_crops",
    "stitch_conversation",
    "make_training_windows",
    "train_segmentation",
    "train_embedding",
    "fit_plda",
    "train_diarization_models",
]


# ---------------------------------------------------------------------------
# Data construction (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def voiced_crops(
    audio: np.ndarray,
    crop_seconds: float = 1.0,
    hop_seconds: float = 0.5,
    energy_percentile: float = 40.0,
) -> np.ndarray:
    """[N, crop] energetic crops of one speaker's recording (an energy gate
    drops the quietest windows, the pauses of read speech)."""
    crop = int(crop_seconds * SAMPLE_RATE)
    hop = int(hop_seconds * SAMPLE_RATE)
    audio = np.asarray(audio, np.float32)
    starts = range(0, max(len(audio) - crop, 0) + 1, hop)
    crops = (np.stack([audio[s:s + crop] for s in starts]) if len(audio) >= crop
             else np.zeros((0, crop), np.float32))
    if len(crops) == 0:
        return crops
    rms = np.sqrt(np.mean(np.square(crops), axis=1))
    keep = rms >= np.percentile(rms, energy_percentile)
    return crops[keep]


class Conversation(NamedTuple):
    audio: np.ndarray  # [n_samples]
    turns: list[tuple[int, float, float]]  # (speaker, start_sec, end_sec)


def stitch_conversation(
    rng: np.random.Generator,
    crops_by_speaker: Sequence[np.ndarray],
    *,
    n_turns: int = 12,
    crops_per_turn: tuple[int, int] = (1, 3),
    gap_seconds: tuple[float, float] = (0.25, 0.7),
    lead_seconds: float = 0.4,
) -> Conversation:
    """Alternating-speaker conversation with known turn boundaries."""
    n_spk = len(crops_by_speaker)
    pieces: list[np.ndarray] = []
    turns: list[tuple[int, float, float]] = []
    t = lead_seconds
    pieces.append(np.zeros(int(lead_seconds * SAMPLE_RATE), np.float32))
    prev = -1
    for _ in range(n_turns):
        spk = int(rng.integers(n_spk))
        if spk == prev:
            spk = (spk + 1) % n_spk
        prev = spk
        k = int(rng.integers(crops_per_turn[0], crops_per_turn[1] + 1))
        idx = rng.integers(len(crops_by_speaker[spk]), size=k)
        seg = np.concatenate([crops_by_speaker[spk][i] for i in idx])
        pieces.append(seg)
        turns.append((spk, t, t + len(seg) / SAMPLE_RATE))
        t += len(seg) / SAMPLE_RATE
        gap = float(rng.uniform(*gap_seconds))
        pieces.append(np.zeros(int(gap * SAMPLE_RATE), np.float32))
        t += gap
    return Conversation(np.concatenate(pieces), turns)


def make_training_windows(
    rng: np.random.Generator,
    crops_by_speaker: Sequence[np.ndarray],
    n_windows: int,
    seg_frames: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Stitched labeled analysis windows ``[N, WINDOW_SAMPLES]`` and their
    per-frame speaker activity ``[N, seg_frames, MAX_LOCAL_SPEAKERS]`` on
    the segmentation model's output grid (local slot = global speaker)."""
    n_spk = len(crops_by_speaker)
    windows = np.zeros((n_windows, WINDOW_SAMPLES), np.float32)
    activity = np.zeros((n_windows, seg_frames, MAX_LOCAL_SPEAKERS), np.float32)
    for w in range(n_windows):
        conv = stitch_conversation(
            rng,
            crops_by_speaker,
            n_turns=int(rng.integers(3, 7)),
            gap_seconds=(0.2, 0.9),
            lead_seconds=float(rng.uniform(0.0, 0.8)),
        )
        a = conv.audio[:WINDOW_SAMPLES]
        windows[w, :len(a)] = a
        for spk, start, end in conv.turns:
            if spk >= n_spk or start >= WINDOW_SAMPLES / SAMPLE_RATE:
                continue
            f0 = int(start * FRAMES_PER_SECOND)
            f1 = min(int(np.ceil(end * FRAMES_PER_SECOND)), seg_frames)
            activity[w, f0:f1, spk] = 1.0
    return windows, activity


# ---------------------------------------------------------------------------
# Segmentation training: permutation-invariant powerset cross-entropy
# ---------------------------------------------------------------------------


def _powerset_class_table() -> np.ndarray:
    """bitmask over MAX_LOCAL_SPEAKERS -> powerset class index (masks with
    more than two speakers map to their largest contained subset's class)."""
    table = np.zeros(2 ** MAX_LOCAL_SPEAKERS, np.int32)
    index = {frozenset(s): i for i, s in enumerate(POWERSET)}
    for bits in range(2 ** MAX_LOCAL_SPEAKERS):
        active = frozenset(s for s in range(MAX_LOCAL_SPEAKERS) if bits >> s & 1)
        while active not in index:
            active = frozenset(sorted(active)[:-1])
        table[bits] = index[active]
    return table


def _speaker_permutations(device) -> list[torch.Tensor]:
    return [torch.tensor(p, device=device) for p in permutations(range(MAX_LOCAL_SPEAKERS))]


def pit_powerset_loss_from_logits(logits: torch.Tensor, activity: torch.Tensor,
                                  class_table: torch.Tensor, perms) -> torch.Tensor:
    """The batch mean of each window's cross-entropy under its best speaker
    permutation; ``logits`` [B, T, C], ``activity`` [B, T, S]."""
    logp = torch.log_softmax(logits, dim=-1)
    weights = 2 ** torch.arange(MAX_LOCAL_SPEAKERS, device=logits.device)
    losses = []
    for perm in perms:
        bits = (activity[:, :, perm].long() * weights).sum(-1)  # [B, T]
        cls = class_table[bits].long()
        losses.append(-logp.gather(-1, cls[..., None])[..., 0].mean(dim=1))  # [B]
    return torch.stack(losses).amin(dim=0).mean()


def _pit_powerset_loss(model, windows, activity, class_table, perms) -> torch.Tensor:
    return pit_powerset_loss_from_logits(segmentation_forward(model, windows), activity,
                                         class_table, perms)


def _seg_frames(device) -> int:
    """The segmentation net's output frame count, probed as JAX's does."""
    probe = init_segmentation_params(torch.Generator().manual_seed(0), dim=8, depth=1,
                                     device=device)
    with torch.inference_mode():
        return int(segmentation_forward(
            probe, torch.zeros((1, WINDOW_SAMPLES), device=device)).shape[1])


def _train_loop(opt, loss_of, draw, steps: int) -> float:
    """``steps`` optimizer steps of ``loss_of(idx)`` over batches
    ``draw()``; returns the last step's loss."""
    last = None
    for _ in range(steps):
        idx = draw()
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_of(idx)
            loss.backward()
        opt.step()
        last = loss.detach()
    return float(last)


def train_segmentation(
    generator: torch.Generator,
    crops_by_speaker: Sequence[np.ndarray],
    *,
    dim: int = 64,
    depth: int = 1,
    steps: int = 120,
    batch: int = 8,
    pool_windows: int = 32,
    lr: float = 2e-3,
    data_seed: int = 0,
    init_params=None,
    device: str | torch.device | None = None,
) -> dict:
    """Train the powerset segmentation model on stitched labeled windows
    (from ``init_params`` if given, else seeded from ``generator``)."""
    fresh = init_params is None
    state = make_train_state(init_segmentation_params(generator, dim=dim, depth=depth,
                                                      device=device)
                             if fresh else init_params, adam(lr), copy_params=not fresh)
    model = state.params
    dev = model.head.weight.device
    nprng = np.random.default_rng(data_seed)
    windows, activity = make_training_windows(nprng, crops_by_speaker, pool_windows,
                                              _seg_frames(dev))
    windows_t = torch.from_numpy(windows).to(dev)
    activity_t = torch.from_numpy(activity).to(dev)
    class_table = torch.from_numpy(_powerset_class_table()).to(dev)
    perms = _speaker_permutations(dev)
    last = _train_loop(
        state.opt_state,
        lambda idx: _pit_powerset_loss(model, windows_t[idx], activity_t[idx], class_table,
                                       perms),
        lambda: torch.from_numpy(nprng.integers(pool_windows, size=batch)).to(dev), steps)
    return {"params": freeze(model), "final_loss": last}


# ---------------------------------------------------------------------------
# Embedding training: pairwise contrastive loss with masked pooling
# ---------------------------------------------------------------------------


def _embedding_examples(
    rng: np.random.Generator,
    crops_by_speaker: Sequence[np.ndarray],
    n_windows: int,
    mel_frames: int,
    seg_frames: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windows, frame_weights, labels) shaped like the diarizer's
    embedding call: full analysis windows and per-speaker mel masks."""
    windows, activity = make_training_windows(rng, crops_by_speaker, n_windows, seg_frames)
    xs, ws, ys = [], [], []
    for w in range(n_windows):
        for spk in range(len(crops_by_speaker)):
            act = activity[w, :, spk]
            if act.sum() / FRAMES_PER_SECOND < 0.4:
                continue
            mask = np.repeat(act, mel_frames // seg_frames + 1)[:mel_frames]
            xs.append(windows[w])
            ws.append(mask.astype(np.float32))
            ys.append(spk)
    if not xs:
        raise ValueError(
            "no (window, speaker) pair reached the 0.4 s activity "
            "threshold — the input recordings are too short or too "
            "quiet to mint embedding training examples"
        )
    return np.stack(xs), np.stack(ws), np.asarray(ys, np.int32)


def contrastive_loss_from_embeddings(emb: torch.Tensor, labels: torch.Tensor,
                                     neg_margin: float = 0.25) -> torch.Tensor:
    """Pairwise cosine push-pull on L2-normalised embeddings [B, E]:
    same-speaker pairs toward cos = 1, different-speaker pairs below
    ``neg_margin``."""
    cos = emb @ emb.T
    same = labels[:, None] == labels[None, :]
    off_diag = ~torch.eye(len(labels), dtype=torch.bool, device=emb.device)
    pos_mask = (same & off_diag).float()
    neg_mask = (~same).float()
    pos = ((1.0 - cos) * pos_mask).sum() / torch.clamp(pos_mask.sum(), min=1.0)
    neg = (torch.relu(cos - neg_margin) * neg_mask).sum() / torch.clamp(neg_mask.sum(), min=1.0)
    return pos + neg


def _contrastive_loss(model, windows, weights, labels, neg_margin=0.25) -> torch.Tensor:
    return contrastive_loss_from_embeddings(embedding_forward(model, windows, weights), labels,
                                            neg_margin)


def train_embedding(
    generator: torch.Generator,
    crops_by_speaker: Sequence[np.ndarray],
    *,
    dim: int = 64,
    steps: int = 120,
    batch: int = 16,
    pool_windows: int = 24,
    lr: float = 2e-3,
    data_seed: int = 1,
    init_params=None,
    device: str | torch.device | None = None,
) -> dict:
    """Train the speaker embedding with the pairwise contrastive objective
    (from ``init_params`` if given, else seeded from ``generator``)."""
    fresh = init_params is None
    state = make_train_state(init_embedding_params(generator, dim=dim, device=device)
                             if fresh else init_params, adam(lr), copy_params=not fresh)
    model = state.params
    dev = model.proj.weight.device
    mel_frames = WINDOW_SAMPLES // MEL_HOP + 1
    nprng = np.random.default_rng(data_seed)
    xs, ws, ys = _embedding_examples(nprng, crops_by_speaker, pool_windows, mel_frames,
                                     _seg_frames(dev))
    xs_t, ws_t, ys_t = (torch.from_numpy(v).to(dev) for v in (xs, ws, ys))
    last = _train_loop(
        state.opt_state, lambda idx: _contrastive_loss(model, xs_t[idx], ws_t[idx], ys_t[idx]),
        lambda: torch.from_numpy(nprng.integers(len(xs), size=batch)).to(dev), steps)
    return {"params": freeze(model), "final_loss": last, "examples": (xs, ws, ys)}


# ---------------------------------------------------------------------------
# PLDA fit from labeled embeddings (two-covariance model; numpy and scipy)
# ---------------------------------------------------------------------------


def fit_plda(
    embeddings: np.ndarray, labels: np.ndarray, lda_dim: int | None = None
) -> PldaModel:
    """Fit a two-covariance PLDA in the VBx wire convention: the generalized
    eigenproblem of the between and within scatters gives ``tr`` with
    ``tr W trᵀ = I`` and ``tr B trᵀ = diag(psi)``, the (tr, psi) pair
    ``PldaModel.from_arrays`` expects."""
    import scipy.linalg

    emb = np.asarray(embeddings, np.float64)
    labels = np.asarray(labels)
    d = emb.shape[1]
    mean1 = emb.mean(0)
    x = emb - mean1
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12) * np.sqrt(d)
    lda = np.eye(d)
    mean2 = np.zeros(d)
    y = x @ lda - mean2
    y = y / np.maximum(np.linalg.norm(y, axis=1, keepdims=True), 1e-12) * np.sqrt(d)

    classes = np.unique(labels)
    mu = y.mean(0)
    within = np.zeros((d, d))
    between = np.zeros((d, d))
    for c in classes:
        yc = y[labels == c]
        mc = yc.mean(0)
        within += (yc - mc).T @ (yc - mc)
        between += len(yc) * np.outer(mc - mu, mc - mu)
    within = within / len(y) + 1e-4 * np.eye(d)
    between = between / len(y) + 1e-6 * np.eye(d)

    evals, evecs = scipy.linalg.eigh(between, within)  # ascending
    order = np.argsort(evals)[::-1]
    tr = evecs.T[order]
    psi = np.maximum(evals[order], 1e-6)
    return PldaModel.from_arrays(mean1, mean2, lda, mu, tr, psi, lda_dim or d)


# ---------------------------------------------------------------------------
# All three from single-speaker recordings
# ---------------------------------------------------------------------------


def train_diarization_models(
    generator: torch.Generator,
    speaker_waves: Sequence[np.ndarray],
    *,
    seg_dim: int = 64,
    seg_depth: int = 1,
    emb_dim: int = 64,
    seg_steps: int = 120,
    emb_steps: int = 120,
    device: str | torch.device | None = None,
) -> dict:
    """Train segmentation + embedding + PLDA from single-speaker waves
    (both models' initial weights drawn from ``generator``, in turn)."""
    crops = [voiced_crops(w) for w in speaker_waves]
    seg = train_segmentation(generator, crops, dim=seg_dim, depth=seg_depth, steps=seg_steps,
                             device=device)
    emb = train_embedding(generator, crops, dim=emb_dim, steps=emb_steps, device=device)
    xs, ws, ys = emb["examples"]
    model = emb["params"]
    dev = model.proj.weight.device
    with torch.inference_mode():
        trained = embedding_forward(model, torch.from_numpy(xs).to(dev),
                                    torch.from_numpy(ws).to(dev)).cpu().numpy()
    plda = fit_plda(trained, ys)
    return {
        "segmentation": seg["params"],
        "embedding": model,
        "plda": plda,
        "seg_loss": seg["final_loss"],
        "emb_loss": emb["final_loss"],
        "crops": crops,
    }
