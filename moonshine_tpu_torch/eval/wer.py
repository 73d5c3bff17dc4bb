"""Corpus WER with Open ASR Leaderboard methodology.

Mirrors the reference's eval protocol (reference: scripts/
eval-librispeech.py:87-155: corpus-level WER over summed edit distances,
Whisper English normalizer, VAD disabled).  The normalizer is the
transformers implementation of Whisper's EnglishTextNormalizer when
available, with a basic fallback.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence


def _basic_normalize(text: str) -> str:
    text = text.lower()
    text = re.sub(r"[\(\[].*?[\)\]]", "", text)  # bracketed noise
    text = re.sub(r"[^a-z0-9' ]+", " ", text)
    return " ".join(text.split())


_NORMALIZER = None


def english_normalizer():
    global _NORMALIZER
    if _NORMALIZER is None:
        try:
            from transformers.models.whisper.english_normalizer import (
                EnglishTextNormalizer,
            )

            _NORMALIZER = EnglishTextNormalizer({})
        except Exception:  # pragma: no cover - fallback path
            _NORMALIZER = _basic_normalize
    return _NORMALIZER


def normalize(text: str) -> str:
    return english_normalizer()(text)


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Word-level Levenshtein distance (two-row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def corpus_wer(
    references: Iterable[str],
    hypotheses: Iterable[str],
    use_normalizer: bool = True,
) -> dict:
    """Summed-edit-distance corpus WER (not averaged per-utterance)."""
    total_errors = 0
    total_words = 0
    count = 0
    norm = english_normalizer() if use_normalizer else (lambda s: s)
    for ref, hyp in zip(references, hypotheses):
        r = norm(ref).split()
        h = norm(hyp).split()
        total_errors += edit_distance(r, h)
        total_words += len(r)
        count += 1
    wer = total_errors / max(total_words, 1)
    return {
        "wer": wer,
        "errors": total_errors,
        "words": total_words,
        "utterances": count,
    }
