"""Word-level timestamps from decoder cross-attention (Whisper-style DTW).

Host-side port of the reference algorithm with identical semantics
(reference: core/word-alignment.cpp): per-(head, token) z-score
normalization over encoder frames, width-7 reflect-padded median filter,
head averaging, DTW over the negated matrix with the reference's exact
tie-breaking (diagonal <= vertical <= horizontal), SentencePiece "▁"
word grouping, and overlap snapping to midpoints.

The expensive part — collecting attention — happens on device during the
decode pass (``collect_cross_attention`` in the models); this module only
post-processes small [tokens x frames] matrices, vectorized with numpy.
"""

from __future__ import annotations

import numpy as np

from ..core.tokenizer import BinTokenizer
from ..core.types import TranscriptWord

_WORD_BOUNDARY = "▁".encode("utf-8")  # U+2581, 0xE2 0x96 0x81


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """DTW over an [N, M] cost matrix.

    Returns (text_indices, time_indices) along the optimal monotonic path,
    matching the reference's predecessor preference diagonal > vertical >
    horizontal on ties (reference: word-alignment.cpp:14-95).
    """
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf, np.float32)
    D[0, 0] = 0.0
    trace = np.zeros((n, m), np.int8)
    for i in range(n):
        # Vectorized row update: candidates from the previous row are fixed,
        # but the horizontal predecessor D[i+1, j] depends on j-1 within the
        # row, so walk the row (m is encoder frames; n*m stays small).
        ci = cost[i]
        prev_diag = D[i, :m]
        prev_vert = D[i, 1 : m + 1]
        row = D[i + 1]
        for j in range(m):
            c0, c1, c2 = prev_diag[j], prev_vert[j], row[j]
            if c0 <= c1 and c0 <= c2:
                trace[i, j] = 0
                row[j + 1] = ci[j] + c0
            elif c1 <= c0 and c1 <= c2:
                trace[i, j] = 1
                row[j + 1] = ci[j] + c1
            else:
                trace[i, j] = 2
                row[j + 1] = ci[j] + c2
    # Backtrace
    i, j = n - 1, m - 1
    ti, fi = [], []
    while i >= 0 or j >= 0:
        ti.append(i)
        fi.append(j)
        if i == 0 and j == 0:
            break
        d = trace[i, j]
        if d == 0:
            i -= 1
            j -= 1
        elif d == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(fi[::-1])


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Reflect-padded median filter along the last axis (reference:
    word-alignment.cpp:98-160)."""
    if width <= 1:
        return x
    if width % 2 == 0:
        width += 1
    pad = width // 2
    w = x.shape[-1]
    # Reference reflect indexing: left pad p -> index (pad - p) clamped,
    # right pad p -> index (w - 2 - p) clamped.
    left_idx = np.clip(pad - np.arange(pad), 0, w - 1)
    right_idx = np.clip(w - 2 - np.arange(pad), 0, w - 1)
    padded = np.concatenate([x[..., left_idx], x, x[..., right_idx]], axis=-1)
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1).astype(x.dtype)


def token_starts_new_word(tokenizer: BinTokenizer, token_id: int) -> bool:
    if token_id < 0 or token_id >= tokenizer.vocab_size:
        return False
    return tokenizer.tokens_to_bytes[token_id][:3] == _WORD_BOUNDARY


def align_words(
    cross_attention: np.ndarray,  # [total_heads, n_steps, encoder_frames]
    tokens: list[int],  # [BOS, t0..tN-1, EOS]
    time_per_frame: float,
    tokenizer: BinTokenizer,
) -> list[TranscriptWord]:
    """Cross-attention + tokens -> per-word timings (reference:
    word-alignment.cpp align_words)."""
    if cross_attention.size == 0 or cross_attention.shape[1] == 0:
        return []
    w = np.asarray(cross_attention, np.float32)

    # Z-score per (head, token) over frames.
    mean = w.mean(axis=-1, keepdims=True)
    std = w.std(axis=-1, keepdims=True)
    std = np.where(std == 0.0, 1e-10, std)
    w = (w - mean) / std

    w = median_filter(w, 7)
    matrix = w.mean(axis=0)  # [n_steps, frames]

    text_idx, time_idx = dtw(-matrix)

    text_tokens = tokens[1:-1] if len(tokens) >= 2 else []
    if not text_tokens:
        return []

    # Group tokens into words at "▁" boundaries.
    groups: list[tuple[list[int], list[int]]] = []
    cur_toks: list[int] = []
    cur_steps: list[int] = []
    for i, tok in enumerate(text_tokens):
        if token_starts_new_word(tokenizer, tok) and cur_toks:
            groups.append((cur_toks, cur_steps))
            cur_toks, cur_steps = [], []
        cur_toks.append(tok)
        cur_steps.append(i)
    if cur_toks:
        groups.append((cur_toks, cur_steps))

    words: list[TranscriptWord] = []
    for tok_ids, steps in groups:
        text = tokenizer.tokens_to_text(tok_ids).strip()
        if not text:
            continue
        step_set = set(steps)
        on_path = np.isin(text_idx, list(step_set))
        frames = time_idx[on_path]
        if frames.size == 0:
            start = end = 0.0
        else:
            start = float(frames.min()) * time_per_frame
            end = float(frames.max() + 1) * time_per_frame
        words.append(TranscriptWord(text=text, start=start, end=end, confidence=1.0))

    # Snap overlapping boundaries to midpoints.
    for i in range(1, len(words)):
        if words[i - 1].end > words[i].start:
            mid = (words[i - 1].end + words[i].start) * 0.5
            words[i - 1].end = mid
            words[i].start = mid
    return words
