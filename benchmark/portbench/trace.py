"""Device traces: a call run under ``torch.profiler``, reduced to the
device operations it ran.

A ``Session`` keeps the wall of the traced call (ended by a synchronise),
every device operation (kernels, copies and sets, not the profiler's own
annotations) with its start and end in microseconds, and the host's
operations, which name the idle gaps.  The profiler's host cost per launch
lengthens the wall of a traced call, so an idle share read from it
overstates the idle of an untraced one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Session:
    name: str
    wall_s: float
    device_ops: list = field(default_factory=list)  # (name, start_us, end_us), by start
    host_ops: list = field(default_factory=list)  # (name, start_us, end_us) of host ops
    info: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their
        intervals)."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.device_ops:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6


def traced(name: str, fn, host: bool = True):
    """Run ``fn()`` under the profiler; returns (its result, Session).
    With ``host`` false only the device's operations are recorded (the
    host's, which name the idle gaps, are left out)."""
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
    # The raw events, not prof.events(): building the profiler's event
    # tree for some 10^5 launches takes minutes.
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        row = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(row)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(row)
    device.sort(key=lambda r: r[1])
    return out, Session(name, wall, device, host)


def busy_s(sessions) -> float:
    return sum(s.busy_s for s in sessions)


def wall_s(sessions) -> float:
    return sum(s.wall_s for s in sessions)


def idle_share(sessions) -> float | None:
    """1 - device busy / traced wall over ``sessions``; None without one."""
    wall = wall_s(sessions)
    if not sessions or wall <= 0:
        return None
    return 1.0 - busy_s(sessions) / wall


def op_seconds(sessions, match) -> float:
    """Device seconds of the operations whose names contain ``match``."""
    return sum(e - s for sess in sessions for n, s, e in sess.device_ops if match in n) / 1e6


def breakdown(sessions, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by what the host had started last before the gap closed
    (the latest host operation that began inside the gap)."""
    ops: dict[str, float] = {}
    gaps: dict[str, float] = {}
    for sess in sessions:
        for n, s, e in sess.device_ops:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        host = sorted(sess.host_ops, key=lambda r: r[1])
        starts = [r[1] for r in host]
        end = None
        for n, s, e in sess.device_ops:
            if end is not None and s > end:
                label = _host_label(host, starts, end, s)
                gaps[label] = gaps.get(label, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
    first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], v] for n, v in first],
            "idle_gaps": [[n[:120], v] for n, v in longest]}


def _host_label(host, starts, lo: float, hi: float) -> str:
    import bisect

    i = bisect.bisect_left(starts, hi) - 1
    while i >= 0 and host[i][1] >= lo:
        name = host[i][0]
        if not name.startswith("cu"):  # the CUDA runtime's and driver's own calls
            return "host: " + name
        i -= 1
    return "host: (no operation began in the gap)"
