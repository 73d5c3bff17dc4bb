"""Arithmetic the per-layer metric readers share (each reader is a file of
its own under ``metrics/``, named as its metric).  A reader returns None
where its run has nothing to read."""

from __future__ import annotations

import numpy as np

from . import trace
from .flops import attention_bound


def span_ms(record, name: str) -> list[float]:
    return [(end - start) * 1e3 for _, start, end, _ in record.spans_named(name)]


def percentile_ms(record, name: str, q: float):
    ms = span_ms(record, name)
    return float(np.percentile(ms, q)) if ms else None


def idle_percent(record):
    share = trace.idle_share(record.sessions)
    return None if share is None else 100.0 * share


def window_rate(record, key: str = "audio_s"):
    """The window's ``key`` counter (its completed work) over its wall."""
    if not record.window_s or not record.counters.get(key):
        return None
    return record.counters[key] / record.window_s


def device_ms_per_audio_s(record):
    """Device time of the traced work (the union of its operations'
    intervals) per second of the audio it transcribed."""
    busy, audio = trace.busy_s(record.sessions), record.counters.get("traced_audio_s")
    if busy <= 0 or not audio:
        return None
    return 1e3 * busy / audio


def mfu_percent(record):
    """Model FLOPs of the traced work over its device time times the
    data-sheet peak of the cell's precision."""
    busy, c = trace.busy_s(record.sessions), record.counters
    if busy <= 0 or not c.get("traced_model_flops"):
        return None
    return 100.0 * c["traced_model_flops"] / (busy * c["peak_flops"])


def k1_roofline_percent(record):
    """K1's least time (``flops.attention_bound`` of each call, for the
    rows' valid lengths) over its device time in the traced encodes."""
    sessions = [s for s in record.sessions if "k1" in s.info]
    if not sessions:
        return None
    bound = 0.0
    for s in sessions:
        k = s.info["k1"]
        one = attention_bound(len(k["lengths"]), k["lengths"], k["heads"], k["head_dim"],
                              k["elt_bytes"], k["peak"])
        bound += k["calls"] * one["bound_s"]
    kernel = trace.op_seconds(sessions, sessions[0].info["k1"]["kernel"])
    return 100.0 * bound / kernel if kernel > 0 else None


def copy_percent(record, match: str = "direct_copy_kernel"):
    busy = trace.busy_s(record.sessions)
    if busy <= 0:
        return None
    return 100.0 * trace.op_seconds(record.sessions, match) / busy
