"""Speaker diarization pipeline: windows -> activities -> embeddings ->
clustering -> stable turns.

Capability mirror of the reference's SpeakerDiarizer + cpp-annote pipeline
(reference: core/speaker-diarizer.{h,cpp}, core/cpp-annote/src/): streaming
sessions re-cluster a bounded sliding window of recent audio on a cadence
with older turns frozen (reference: speaker-diarizer.h:36-51); one-shot
``diarize`` clusters full history; stable speaker IDs are carried across
re-clustering passes by speech-time overlap (reference:
speaker-diarizer.h:17-21).  Clustering is agglomerative over cosine
distance (the reference's VBx refinement slot is pluggable here).

Model functions are injected so the pipeline logic tests run with synthetic
oracles and production uses models/diarization.py.

A copy of the JAX package's ``pipeline/diarization.py``: the port keeps its own copy so that
it never imports the JAX package.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.types import SpeakerSpan

SAMPLE_RATE = 16000
WINDOW_SECONDS = 10.0
STEP_SECONDS = 1.0
FRAMES_PER_SECOND = 25
ACTIVITY_THRESHOLD = 0.5
MIN_SPEECH_SECONDS = 0.4  # minimum local speech to embed a speaker


@dataclass
class SpeakerTurn:
    """One contiguous single-speaker span (reference: speaker-diarizer.h:12-24)."""

    start_time: float
    duration: float
    speaker_id: int
    speaker_index: int


# activities_fn: [B, window_samples] -> [B, T, S] per-speaker probabilities
ActivitiesFn = Callable[[np.ndarray], np.ndarray]
# embedding_fn: ([B, window_samples], [B, T_mel] weights) -> [B, D]
EmbeddingFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def cluster_embeddings(
    embeddings: np.ndarray, threshold: float = 0.7
) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance.

    Returns integer labels.  threshold is the maximum merge distance
    (1 - cosine similarity), the scipy_linkage analog in cpp-annote.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    e = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    dist = 1.0 - e @ e.T
    clusters: list[list[int]] = [[i] for i in range(n)]
    while len(clusters) > 1:
        best = (None, None, np.inf)
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = float(np.mean([dist[a, b] for a in clusters[i] for b in clusters[j]]))
                if d < best[2]:
                    best = (i, j, d)
        i, j, d = best
        if d > threshold:
            break
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]
    labels = np.zeros(n, np.int32)
    for lbl, members in enumerate(clusters):
        for m in members:
            labels[m] = lbl
    return labels


@dataclass
class _LocalSegment:
    """One (window, local-speaker) speech region with its embedding."""

    start: float
    end: float
    embedding: np.ndarray
    activity: np.ndarray  # [T] binarized frames within the window
    window_start: float


class _StreamState:
    def __init__(self) -> None:
        self.audio = np.zeros(0, np.float32)
        self.analyzed_until = 0.0  # seconds of audio already segmented
        self.segments: list[_LocalSegment] = []
        self.turns: list[SpeakerTurn] = []
        self.frozen_turns: list[SpeakerTurn] = []
        self.last_cluster_at = 0.0
        self.id_registry: dict[int, int] = {}  # stable id -> speaker_index
        self.next_stable_id = 0
        self.prev_assignment: list[SpeakerTurn] = []
        self.finished = False


class SpeakerDiarizer:
    def __init__(
        self,
        activities_fn: ActivitiesFn,
        embedding_fn: EmbeddingFn,
        cluster_cadence: float = 2.0,
        analyze_cadence: float = 1.0,
        cluster_window_sec: float = 120.0,
        cluster_threshold: float = 0.7,
        plda=None,  # vbx.PldaModel -> VBx clustering (the reference's
        # quality core, cpp-annote clustering_vbx); None -> plain AHC
        vbx_params=None,
    ):
        self.activities_fn = activities_fn
        self.embedding_fn = embedding_fn
        self.cluster_cadence = cluster_cadence
        self.analyze_cadence = max(analyze_cadence, 0.1)
        self.cluster_window_sec = cluster_window_sec
        self.cluster_threshold = cluster_threshold
        self.plda = plda
        self.vbx_params = vbx_params
        self._streams: dict[int, _StreamState] = {}
        self._next_id = 0

    # -- stream lifecycle (reference: speaker-diarizer.h:73-90) -------------

    def create_stream(self) -> int:
        sid = self._next_id
        self._next_id += 1
        self._streams[sid] = _StreamState()
        return sid

    def start_stream(self, stream_id: int) -> None:
        self._streams[stream_id] = _StreamState()

    def free_stream(self, stream_id: int) -> None:
        self._streams.pop(stream_id, None)

    def add_audio(self, stream_id: int, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
        st = self._streams.setdefault(stream_id, _StreamState())
        if sample_rate != SAMPLE_RATE:
            from ..audio.resample import resample_audio

            audio = resample_audio(audio, sample_rate, SAMPLE_RATE)
        st.audio = np.concatenate([st.audio, np.asarray(audio, np.float32)])
        self._analyze_new(st)
        now = len(st.audio) / SAMPLE_RATE
        if now - st.last_cluster_at >= self.cluster_cadence:
            self._recluster(st)
            st.last_cluster_at = now

    def get_turns(self, stream_id: int) -> list[SpeakerTurn]:
        st = self._streams.get(stream_id)
        if st is None:
            return []
        return list(st.frozen_turns) + list(st.turns)

    def finish_stream(self, stream_id: int) -> list[SpeakerTurn]:
        st = self._streams.get(stream_id)
        if st is None:
            return []
        if not st.finished:
            self._analyze_new(st, final=True)
            self._recluster(st)
            st.finished = True
        return self.get_turns(stream_id)

    def diarize(self, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> list[SpeakerTurn]:
        """One-shot full-history diarization (reference: h:92-95)."""
        sid = self.create_stream()
        try:
            saved = self.cluster_window_sec
            self.cluster_window_sec = 0.0  # unlimited
            self.add_audio(sid, audio, sample_rate)
            return self.finish_stream(sid)
        finally:
            self.cluster_window_sec = saved
            self.free_stream(sid)

    # -- analysis ------------------------------------------------------------

    def _analyze_new(self, st: _StreamState, final: bool = False) -> None:
        total = len(st.audio) / SAMPLE_RATE
        window = WINDOW_SECONDS
        starts = []
        t = st.analyzed_until
        while t + window <= total:
            starts.append(t)
            t += self.analyze_cadence
        if final and total > st.analyzed_until and not starts:
            starts.append(max(0.0, total - window))
        if not starts:
            return
        st.analyzed_until = starts[-1] + self.analyze_cadence

        batch = np.zeros((len(starts), int(window * SAMPLE_RATE)), np.float32)
        for i, s in enumerate(starts):
            a = st.audio[int(s * SAMPLE_RATE) : int((s + window) * SAMPLE_RATE)]
            batch[i, : len(a)] = a
        acts = np.asarray(self.activities_fn(batch))  # [B, T, S]
        n_frames = acts.shape[1]

        embed_batch: list[np.ndarray] = []
        embed_weights: list[np.ndarray] = []
        embed_meta: list[tuple[float, np.ndarray]] = []
        mel_frames_per_window = int(window * SAMPLE_RATE) // 160 + 1
        for i, s in enumerate(starts):
            for spk in range(acts.shape[2]):
                act = (acts[i, :, spk] > ACTIVITY_THRESHOLD).astype(np.float32)
                speech = act.sum() / FRAMES_PER_SECOND
                if speech < MIN_SPEECH_SECONDS:
                    continue
                # Upsample activity (25fps) to mel frame weights (100fps).
                w = np.repeat(act, mel_frames_per_window // n_frames + 1)[:mel_frames_per_window]
                embed_batch.append(batch[i])
                embed_weights.append(w)
                embed_meta.append((s, act))
        if embed_batch:
            embs = np.asarray(
                self.embedding_fn(np.stack(embed_batch), np.stack(embed_weights))
            )
            for (s, act), emb in zip(embed_meta, embs):
                frames = np.flatnonzero(act)
                st.segments.append(
                    _LocalSegment(
                        start=s + frames[0] / FRAMES_PER_SECOND,
                        end=s + (frames[-1] + 1) / FRAMES_PER_SECOND,
                        embedding=emb,
                        activity=act,
                        window_start=s,
                    )
                )

    # -- clustering + stable IDs ---------------------------------------------

    def _recluster(self, st: _StreamState) -> None:
        if not st.segments:
            return
        total = len(st.audio) / SAMPLE_RATE
        if self.cluster_window_sec > 0:
            cutoff = max(0.0, total - self.cluster_window_sec)
        else:
            cutoff = 0.0
        # Freeze turns fully before the cutoff once, keep clustering the rest
        # (reference: 120 s VBx window with frozen older turns).
        if cutoff > 0 and st.turns:
            newly_frozen = [t for t in st.turns if t.start_time + t.duration <= cutoff]
            st.frozen_turns.extend(newly_frozen)
        active = [seg for seg in st.segments if seg.end > cutoff]
        if not active:
            return
        embs = np.stack([seg.embedding for seg in active])
        if self.plda is not None:
            from .vbx import vbx_labels

            labels = vbx_labels(embs, self.plda, self.vbx_params)
        else:
            labels = cluster_embeddings(embs, self.cluster_threshold)

        # Merge per-cluster segments into turns on the stream timeline.
        # Turns are built from the binarized per-frame activity runs, not
        # the window hull (first..last active frame): a 10 s analysis
        # window usually contains several disjoint speech runs of a local
        # speaker, and bridging the silence/other-speaker gaps between
        # them would charge the whole window to one speaker (the
        # community-1 pipeline also binarizes frames into regions).
        new_turns: list[tuple[int, float, float]] = []  # (label, start, end)
        for lbl in sorted(set(labels)):
            spans = []
            for seg, l in zip(active, labels):
                if l != lbl:
                    continue
                frames = np.flatnonzero(seg.activity)
                if len(frames) == 0:
                    continue
                breaks = np.flatnonzero(np.diff(frames) > 1)
                run_starts = np.concatenate([[0], breaks + 1])
                run_ends = np.concatenate([breaks, [len(frames) - 1]])
                for a, b in zip(run_starts, run_ends):
                    spans.append(
                        (
                            seg.window_start + frames[a] / FRAMES_PER_SECOND,
                            seg.window_start + (frames[b] + 1) / FRAMES_PER_SECOND,
                        )
                    )
            spans.sort()
            if not spans:
                continue
            cur_s, cur_e = spans[0]
            for s, e in spans[1:]:
                if s <= cur_e + 0.5:
                    cur_e = max(cur_e, e)
                else:
                    new_turns.append((lbl, cur_s, cur_e))
                    cur_s, cur_e = s, e
            new_turns.append((lbl, cur_s, cur_e))

        # Stable-ID remapping by speech-time overlap with the previous
        # assignment (reference: speaker-diarizer.h:17-21).
        label_overlap: dict[int, dict[int, float]] = {}
        for lbl, s, e in new_turns:
            for prev in st.prev_assignment:
                ps, pe = prev.start_time, prev.start_time + prev.duration
                ov = max(0.0, min(e, pe) - max(s, ps))
                if ov > 0:
                    label_overlap.setdefault(lbl, {})[prev.speaker_id] = (
                        label_overlap.get(lbl, {}).get(prev.speaker_id, 0.0) + ov
                    )
        label_to_stable: dict[int, int] = {}
        used: set[int] = set()
        # Greedy best-overlap assignment (Hungarian analog at this scale).
        candidates = sorted(
            (
                (ov, lbl, sid)
                for lbl, m in label_overlap.items()
                for sid, ov in m.items()
            ),
            reverse=True,
        )
        for ov, lbl, sid in candidates:
            if lbl in label_to_stable or sid in used:
                continue
            label_to_stable[lbl] = sid
            used.add(sid)
        for lbl, _, _ in new_turns:
            if lbl not in label_to_stable:
                sid = st.next_stable_id
                st.next_stable_id += 1
                label_to_stable[lbl] = sid
                st.id_registry[sid] = len(st.id_registry)

        turns = [
            SpeakerTurn(
                start_time=s,
                duration=e - s,
                speaker_id=label_to_stable[lbl],
                speaker_index=st.id_registry.setdefault(
                    label_to_stable[lbl], len(st.id_registry)
                ),
            )
            for lbl, s, e in new_turns
        ]
        turns.sort(key=lambda t: t.start_time)
        st.turns = [t for t in turns if t.start_time + t.duration > cutoff]
        st.prev_assignment = turns


# -- span application (reference: transcriber.cpp apply_speaker_turns) ------

def apply_speaker_turns_to_lines(turns: Sequence[SpeakerTurn], output) -> bool:
    """Clip turns to each line's time range and store spans on the lines.

    Char offsets are filled from word timings when present (reference:
    transcriber.cpp fill_speaker_span_char_indices).  Returns True if any
    line's spans changed beyond the 0.1 s jitter tolerance.
    """
    changed = False
    for line_id in output.ordered_line_ids:
        line = output.get_line(line_id)
        if line is None:
            continue
        spans = []
        line_start, line_end = line.start_time, line.end_time
        for t in turns:
            s = max(t.start_time, line_start)
            e = min(t.start_time + t.duration, line_end)
            if e <= s:
                continue
            start_char, end_char = _span_char_range(line, s, e - s)
            spans.append(
                SpeakerSpan(
                    start_time=s,
                    duration=e - s,
                    speaker_id=t.speaker_id,
                    speaker_index=t.speaker_index,
                    start_char=start_char,
                    end_char=end_char,
                )
            )
        if output.set_speaker_spans(line_id, spans):
            changed = True
    return changed


def _span_char_range(line, span_start: float, span_duration: float) -> tuple[int, int]:
    if not line.text or not line.words:
        return 0, 0
    span_end = span_start + span_duration
    search_from = 0
    found = False
    start_char = end_char = 0
    for w in line.words:
        pos = line.text.find(w.text, search_from)
        if pos < 0 or not w.text:
            continue
        lo, hi = pos, pos + len(w.text)
        search_from = hi
        if w.start < span_end and w.end > span_start:
            if not found:
                start_char, end_char, found = lo, hi, True
            else:
                start_char = min(start_char, lo)
                end_char = max(end_char, hi)
    return (start_char, end_char) if found else (0, 0)
