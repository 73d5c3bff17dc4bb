"""The program's own spans (``moonshine_tpu_torch.profiling``), as the
per-layer readers see them.

The program keeps its spans in memory for the whole run.  A reader picks
the window's by containment in the benchmark's own spans (both are on the
clock of ``time.perf_counter()``), and places the traced calls' spans on
``torch.profiler``'s clock to set them against the device's operations.
A program without the recorder has no spans: the readers return None.
"""

from __future__ import annotations

import bisect


def _recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from moonshine_tpu_torch import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def program_spans(name: str) -> list:
    """The program's recorded spans called ``name``, by start."""
    rec = _recorder()
    return [] if rec is None else rec.spans(name)


def profiler_offset_ns() -> int | None:
    rec = _recorder()
    return None if rec is None else rec.profiler_offset_ns()


def within(spans: list, windows: list) -> list:
    """The ``spans`` that lie inside one of ``windows``, (start, end) in
    seconds of ``time.perf_counter()`` that do not overlap."""
    windows = sorted(windows)
    starts = [w[0] for w in windows]
    out = []
    for s in spans:
        i = bisect.bisect_right(starts, s.start_ns / 1e9) - 1
        if i >= 0 and s.end_ns / 1e9 <= windows[i][1]:
            out.append(s)
    return out


def window_spans(record, name: str, bench_span: str) -> list:
    """The program's ``name`` spans inside the window's ``bench_span``
    spans (the benchmark's own, around each call it times)."""
    return within(program_spans(name), [(a, b) for _, a, b, _ in record.spans_named(bench_span)])


def host_work_percent(spans: list):
    """The share of the spans' wall in which the host was not blocked on
    the device: 1 - sum ``read_ns`` / sum wall."""
    wall = sum(s.end_ns - s.start_ns for s in spans)
    if not spans or wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s.attrs["read_ns"] for s in spans) / wall)


def device_gaps(session) -> list[tuple[float, float]]:
    """The idle gaps between a traced session's device operations (in
    microseconds on the profiler's clock): where none of them ran, from
    the first's start to the last's end."""
    gaps, end = [], None
    for _, s, e in session.device_ops:  # by start
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def self_intervals(spans: list, children: list, offset_ns: int) -> list[tuple[float, float]]:
    """Each span's interval less those of its ``children``, in microseconds
    on the profiler's clock (``offset_ns`` added), by start."""
    by_parent: dict[int, list] = {}
    for c in children:
        by_parent.setdefault(c.parent, []).append((c.start_ns, c.end_ns))
    out = []
    for s in sorted(spans, key=lambda s: s.start_ns):
        at = s.start_ns
        for a, b in sorted(by_parent.get(s.id, [])):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if s.end_ns > at:
            out.append((at, s.end_ns))
    return [((a + offset_ns) / 1e3, (b + offset_ns) / 1e3) for a, b in out]


def overlap(xs: list, ys: list) -> float:
    """The length of the intersection of two lists of disjoint intervals,
    each sorted by start."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_covered_percent(sessions: list, steps: list, reads: list, offset_ns: int | None):
    """The share of the sessions' idle gaps (between their device
    operations) in which the host was in a decoder step's self time
    (``steps`` less their ``reads``): enqueuing the step's launches.  None
    without a device operation or a step."""
    gaps = sorted(g for s in sessions for g in device_gaps(s))
    idle = sum(b - a for a, b in gaps)
    if idle <= 0 or not steps or offset_ns is None:
        return None
    return 100.0 * overlap(gaps, self_intervals(steps, reads, offset_ns)) / idle
