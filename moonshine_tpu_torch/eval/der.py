"""Diarization error rate (DER).

The standard frame-based NIST-RT metric: miss + false alarm + speaker
confusion over total reference speech, with an optional forgiveness
collar around reference boundaries and an optimal one-to-one mapping
between reference and hypothesis speaker labels.

The reference judges its diarization quality through the cpp-annote
pipeline's clustering output (reference: core/cpp-annote/src/
clustering_vbx.cpp, parity_log.cpp; core/transcriber-test.cpp asserts
speaker turns on the labeled two-speaker fixture endgame_nagg_nell.wav).
This module supplies the missing *scored* form of that judgement so
trained diarization models get a real number (see train/diarization.py
and docs/EVAL.md).

Turns are ``(speaker, start_sec, end_sec)`` tuples or any object with
``speaker_id`` / ``start_time`` / ``duration`` attributes
(pipeline.diarization.SpeakerTurn).

A copy of the JAX package's ``eval/der.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

from itertools import permutations
from typing import Iterable, Sequence

import numpy as np

__all__ = ["der", "turns_to_tuples"]


def turns_to_tuples(turns: Iterable) -> list[tuple[int, float, float]]:
    """Normalize SpeakerTurn-like objects to (speaker, start, end)."""
    out = []
    for t in turns:
        if isinstance(t, tuple):
            spk, start, end = t
        else:
            spk = t.speaker_id
            start = t.start_time
            end = t.start_time + t.duration
        if end > start:
            out.append((spk, float(start), float(end)))
    return out


def _rasterize(
    turns: Sequence[tuple[int, float, float]], n_frames: int, frame: float
) -> tuple[np.ndarray, list[int]]:
    """[n_speakers, n_frames] bool activity + the speaker label order."""
    speakers = sorted({t[0] for t in turns})
    index = {s: i for i, s in enumerate(speakers)}
    act = np.zeros((len(speakers), n_frames), bool)
    for spk, start, end in turns:
        a = int(round(start / frame))
        b = int(round(end / frame))
        act[index[spk], max(a, 0) : min(b, n_frames)] = True
    return act, speakers


def _optimal_mapping(overlap: np.ndarray) -> dict[int, int]:
    """hyp index -> ref index maximizing matched frames (one-to-one)."""
    n_ref, n_hyp = overlap.shape
    if n_ref == 0 or n_hyp == 0:
        return {}
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-overlap)
        return {int(h): int(r) for r, h in zip(rows, cols)}
    except Exception:  # pragma: no cover - scipy is in the image
        best, best_score = {}, -1
        small, large = min(n_ref, n_hyp), max(n_ref, n_hyp)
        for perm in permutations(range(large), small):
            if n_ref <= n_hyp:
                m = {int(h): r for r, h in enumerate(perm)}
            else:
                m = {h: int(r) for h, r in enumerate(perm)}
            score = sum(overlap[r, h] for h, r in m.items())
            if score > best_score:
                best, best_score = m, score
        return best


def der(
    reference: Iterable,
    hypothesis: Iterable,
    *,
    frame: float = 0.01,
    collar: float = 0.25,
) -> dict:
    """Score a diarization hypothesis against a reference.

    Frame-based at ``frame`` resolution; frames within ``collar`` seconds
    of any reference turn boundary are excluded (the conventional 0.25 s
    NIST collar).  Returns miss / false-alarm / confusion rates as
    fractions of total scored reference speech, plus their sum ``der``.
    Overlapping speech is supported (per-frame speaker multisets).
    """
    ref = turns_to_tuples(reference)
    hyp = turns_to_tuples(hypothesis)
    end = max([e for _, _, e in ref + hyp] or [0.0])
    n_frames = int(np.ceil(end / frame)) + 1
    ref_act, _ = _rasterize(ref, n_frames, frame)
    hyp_act, _ = _rasterize(hyp, n_frames, frame)

    scored = np.ones(n_frames, bool)
    if collar > 0:
        c = int(round(collar / frame))
        for _, start, stop in ref:
            for edge in (start, stop):
                k = int(round(edge / frame))
                scored[max(k - c, 0) : k + c + 1] = False

    ra = ref_act[:, scored] if len(ref_act) else np.zeros((0, scored.sum()), bool)
    ha = hyp_act[:, scored] if len(hyp_act) else np.zeros((0, scored.sum()), bool)

    overlap = (ra[:, None, :] & ha[None, :, :]).sum(-1).astype(np.float64) if (
        len(ra) and len(ha)
    ) else np.zeros((len(ra), len(ha)))
    mapping = _optimal_mapping(overlap)

    n_ref = ra.sum(0).astype(np.int64) if len(ra) else np.zeros(scored.sum(), np.int64)
    n_hyp = ha.sum(0).astype(np.int64) if len(ha) else np.zeros(scored.sum(), np.int64)
    matched = np.zeros(scored.sum(), np.int64)
    for h, r in mapping.items():
        matched += (ra[r] & ha[h]).astype(np.int64)

    total_speech = int(n_ref.sum())
    miss = int(np.maximum(n_ref - n_hyp, 0).sum())
    false_alarm = int(np.maximum(n_hyp - n_ref, 0).sum())
    confusion = int((np.minimum(n_ref, n_hyp) - matched).sum())
    denom = max(total_speech, 1)
    return {
        "der": (miss + false_alarm + confusion) / denom,
        "miss": miss / denom,
        "false_alarm": false_alarm / denom,
        "confusion": confusion / denom,
        "total_speech_sec": total_speech * frame,
        "mapping": mapping,
    }
