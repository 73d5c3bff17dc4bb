"""Speaker-identification eval: embedding verification EER.

Mirror of the reference's eval-speaker-id.py (reference: scripts/
eval-speaker-id.py): score same-speaker vs different-speaker trial pairs
with cosine similarity of speaker embeddings and report the equal error
rate and accuracy at the EER threshold.

A copy of the JAX package's ``eval/speaker_id.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np


def score_trials(
    embeddings_a: np.ndarray,  # [N, D]
    embeddings_b: np.ndarray,  # [N, D]
    labels: np.ndarray,  # [N] 1 = same speaker
) -> dict:
    a = embeddings_a / np.maximum(np.linalg.norm(embeddings_a, axis=1, keepdims=True), 1e-12)
    b = embeddings_b / np.maximum(np.linalg.norm(embeddings_b, axis=1, keepdims=True), 1e-12)
    scores = np.sum(a * b, axis=1)
    return {"eer": equal_error_rate(scores, labels), "scores": scores.tolist()}


def equal_error_rate(scores: np.ndarray, labels: np.ndarray) -> float:
    """EER: threshold where false-accept rate == false-reject rate."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    pos = labels.sum()
    neg = len(labels) - pos
    if pos == 0 or neg == 0:
        return 0.0
    # Threshold sweep: EER = point minimizing |FAR - FRR|.
    fars, frrs = [], []
    for thr in np.unique(scores):
        fars.append(np.sum((scores >= thr) & ~labels) / neg)
        frrs.append(np.sum((scores < thr) & labels) / pos)
    fars, frrs = np.asarray(fars), np.asarray(frrs)
    i = int(np.argmin(np.abs(fars - frrs)))
    return float((fars[i] + frrs[i]) / 2)


def evaluate_pairs(embed_fn, trial_pairs) -> dict:
    """trial_pairs: iterable of (audio_a, audio_b, same_speaker_bool)."""
    ea, eb, labels = [], [], []
    for a, b, same in trial_pairs:
        ea.append(embed_fn(a))
        eb.append(embed_fn(b))
        labels.append(1 if same else 0)
    out = score_trials(np.stack(ea), np.stack(eb), np.asarray(labels))
    out["trials"] = len(labels)
    return out
