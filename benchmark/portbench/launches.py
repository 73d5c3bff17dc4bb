"""Device operations matched to the host's launch of each, so that the
program's spans (host intervals) can claim the device time of what they
launched.

``traced_launches`` is ``trace.traced`` that also keeps, for each device
operation, when the host launched it: the start of the CUDA runtime call
that shares its correlation id, else of the host operation its linked
correlation id names (``info["launch_us"]``, in the order of
``device_ops``; None where neither was recorded, and no list at all
without the host's events).  Times are microseconds on the profiler's
clock, where ``program_spans.profiler_offset_ns`` places the program's
spans.
"""

from __future__ import annotations

import time

import torch

from .program_spans import profiler_offset_ns, program_spans
from .trace import Session


def traced_launches(name: str, fn, host: bool = True):
    """Run ``fn()`` under the profiler; returns (its result, Session)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host_ops, runtime, ops = [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), start, end, e.correlation_id(), e.linked_correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host_ops.append((e.name(), start, end))
            (runtime if e.name().startswith("cu") else ops)[e.correlation_id()] = start
    device.sort(key=lambda r: r[1])
    sess = Session(name, wall, [r[:3] for r in device], host_ops)
    if host:
        sess.info["launch_us"] = [runtime.get(c, ops.get(linked)) for *_, c, linked in device]
    return out, sess


def span_intervals_us(name: str) -> list[tuple[float, float]]:
    """The program's ``name`` spans as (start, end) on the profiler's
    clock, in microseconds, by start; none where the program records none."""
    offset = profiler_offset_ns()
    if offset is None:
        return []
    return [((s.start_ns + offset) / 1e3, (s.end_ns + offset) / 1e3) for s in program_spans(name)]


def launched_within_s(sessions, intervals: list) -> float | None:
    """Device seconds (the union of their intervals) of the operations whose
    launch lies inside one of ``intervals`` (sorted, disjoint); None where
    no session knows its launches or nothing was launched there."""
    import bisect

    starts = [a for a, _ in intervals]
    picked, known = [], False
    for sess in sessions:
        launches = sess.info.get("launch_us")
        if launches is None:
            continue
        known = True
        for (_, s, e), at in zip(sess.device_ops, launches):
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= intervals[i][1]:
                picked.append((s, e))
    if not known or not picked:
        return None
    busy, end = 0.0, float("-inf")
    for s, e in sorted(picked):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6
