"""The port's span and counter recorder, API-call logging and profiler capture.

The reference's observability is in-band: ``log_ort_run`` prints every ORT
session run with its duration (reference: core/transcriber.h:184,
README.md "log_ort_run"), ``log_api_calls`` traces the ABI surface, and
per-line latency travels inside the transcript itself.  Here:

- **Spans.**  A span is a named interval of the host's work: its start and
  end (``time.perf_counter_ns()``), the span it runs under (``parent``, an
  explicit handle, so that a span can end in another call than the one that
  opened it), the trace it belongs to (the id of its root: every span of
  one call shares it) and a few integer attributes.  Closed spans go to a
  ring buffer of the newest :data:`RING_SPANS` in memory; :func:`spans`
  reads them back.  Nothing is written while the program runs.
- **Two tiers.**  Coarse spans (:func:`span`, :func:`begin`) are one per
  call of ``greedy_decode``, ``models.moonshine.encode``,
  ``models.canary.encode``, ``models.canary_qwen.encode``, a service update
  and a backend call, always
  recorded: two clock reads and an append a call, with counters the host
  already knows as attributes.  Fine spans (:func:`child`, :func:`record`:
  the steps of a decode loop, the phases of an update, the parts of a
  Canary encoder layer, Canary-Qwen's ``salm.adapter``, ``salm.project``
  and ``salm.prefill``) are recorded only under a coarse span that opened
  while ``torch.profiler`` was recording or while
  :func:`enable_device_run_log` was on (``TranscriberOptions.log_model_run``
  turns it on).
- **The device runs on.**  PyTorch returns once CUDA work is enqueued, so
  a span times the host's part of the call.  A span that ends without
  waiting for its device work is marked ``enqueued``; one that ends with a
  read of the device (a decode loop's last check, a service update's token
  copy) covers the device's work too.
- **One clock with the profiler.**  :func:`profiler_offset_ns` places a
  span on ``torch.profiler``'s clock (Unix-epoch ns, the clock of its
  events), so that spans can be set against the device's operations; the
  stamps themselves are on the clock of ``time.perf_counter()``.
- **Counters** (:func:`count`, :func:`counter`): process-wide integers, such
  as the launches of the port's own kernels (``launches.<wrapper>``).
- :func:`profiler_trace` captures a ``torch.profiler`` trace and writes the
  program's spans into its ``trace.json`` as a track of their own.

With :func:`enable_device_run_log` on, each coarse span also prints a
``[model-run]`` line on stderr.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import sys
import threading
import time

from torch.autograd import _profiler_enabled

RING_SPANS = 1 << 15  # closed spans kept; the oldest go first
SPAN_TRACK_PID = 1 << 30  # the process id of the spans' track in trace.json

_enabled = False
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=RING_SPANS)
_counters: dict[str, int] = {}
_ids = itertools.count(1)


def enable_device_run_log(on: bool = True) -> None:
    """Globally enable/disable fine spans and the stderr ``[model-run]``
    line of every coarse span."""
    global _enabled
    _enabled = on


def device_run_log_enabled() -> bool:
    return _enabled


class Span:
    """One named interval of host work; see the module docstring."""

    __slots__ = ("name", "id", "parent", "trace", "start_ns", "end_ns", "attrs", "fine",
                 "detail", "enqueued")

    def __init__(self, name: str, parent: Span | None, fine: bool, detail: bool, attrs: dict,
                 start_ns: int | None = None):
        self.name = name
        self.id = next(_ids)
        self.parent = 0 if parent is None else parent.id
        self.trace = self.id if parent is None else parent.trace
        self.attrs = attrs
        self.fine = fine
        self.detail = detail  # fine spans are recorded under this one
        self.enqueued = False
        self.end_ns = 0
        self.start_ns = time.perf_counter_ns() if start_ns is None else start_ns

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, trace={self.trace}, "
                f"{self.wall_ns / 1e6:.3f} ms, {self.attrs})")


def begin(name: str, parent: Span | None = None, **attrs: int) -> Span:
    """Open a coarse span (always recorded); close it with :func:`end`.
    Whether fine spans are recorded under it is decided here, once."""
    return Span(name, parent, False, _enabled or _profiler_enabled(), attrs)


def child(name: str, parent: Span | None) -> Span | None:
    """Open a fine span under ``parent``; None (and nothing recorded)
    unless ``parent`` records detail."""
    if parent is None or not parent.detail:
        return None
    return Span(name, parent, True, True, {})


def record(name: str, parent: Span | None, start_ns: int, end_ns: int) -> None:
    """Record a finished fine span from stamps the caller already read."""
    if parent is not None and parent.detail:
        s = Span(name, parent, True, True, {}, start_ns)
        s.end_ns = end_ns
        _append(s)


def timed_read(read, owner: Span | None, name: str, parent: Span | None):
    """``read()``, a host read that waits for the device, its blocked time
    added to ``owner``'s ``read_ns`` (where ``owner`` is a span) and
    recorded as a fine span ``name`` under ``parent``."""
    t0 = time.perf_counter_ns()
    value = read()
    t1 = time.perf_counter_ns()
    if owner is not None:
        owner.attrs["read_ns"] += t1 - t0
    record(name, parent, t0, t1)
    return value


def end(s: Span | None, **attrs: int) -> None:
    """Close ``s`` (None: nothing) with its final attributes."""
    if s is None:
        return
    s.end_ns = time.perf_counter_ns()
    if attrs:
        s.attrs.update(attrs)
    _append(s)
    if _enabled and not s.fine:
        extra = "".join(f" {k}={v}" for k, v in s.attrs.items())
        state = " enqueued" if s.enqueued else ""
        print(f"[model-run] {s.name} {s.wall_ns / 1e6:.1f} ms{state}{extra}", file=sys.stderr)


def _append(s: Span) -> None:
    with _lock:
        _ring.append(s)


@contextlib.contextmanager
def span(name: str, parent: Span | None = None, **attrs: int):
    """A coarse span around a ``with`` block; yields it, so that the block
    can set attributes, mark it ``enqueued`` and name it as a parent."""
    s = begin(name, parent, **attrs)
    try:
        yield s
    finally:
        end(s)


def spans(name: str | None = None) -> list[Span]:
    """The recorded spans (all, or those called ``name``), by start."""
    with _lock:
        out = list(_ring)
    if name is not None:
        out = [s for s in out if s.name == name]
    return sorted(out, key=lambda s: s.start_ns)


def clear() -> None:
    """Forget every recorded span."""
    with _lock:
        _ring.clear()


def profiler_offset_ns() -> int:
    """What to add to a span's stamps to place them on torch.profiler's
    clock (Unix-epoch ns, as ``time.time_ns()``): the tightest of a few
    brackets of the two clocks' reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def count(name: str) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + 1


def counter(name: str) -> int:
    return _counters.get(name, 0)


def reset_counter(name: str) -> None:
    with _lock:
        _counters.pop(name, None)


def log_api_call(enabled: bool, name: str, **args) -> None:
    """stderr trace of a public-API entry with its arguments — the
    ``log_api_calls`` analog (reference: moonshine-c-api.cpp:99-128)."""
    if enabled:
        rendered = ", ".join(f"{k}={_short(v)}" for k, v in args.items())
        print(f"[api-call] {name}({rendered})", file=sys.stderr)


def _short(v) -> str:
    shape = getattr(v, "shape", None)
    if shape is not None and getattr(v, "ndim", 0) > 0:
        return f"array{tuple(shape)}"
    s = repr(v)
    return s if len(s) <= 60 else s[:57] + "..."


def _chrome_events(recorded: list[Span], base_ns: int = 0) -> list[dict]:
    """``recorded`` as Chrome-trace events on torch.profiler's clock, in
    microseconds after ``base_ns`` (a trace's ``baseTimeNanoseconds``): one
    row a trace, under a process of its own."""
    off = profiler_offset_ns() - base_ns
    out = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK_PID, "tid": 0,
            "args": {"name": "moonshine_tpu_torch spans"}}]
    for s in recorded:
        args = dict(s.attrs, id=s.id, parent=s.parent)
        if s.enqueued:
            args["enqueued"] = 1
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": SPAN_TRACK_PID,
                    "tid": s.trace, "ts": (s.start_ns + off) / 1e3, "dur": s.wall_ns / 1e3,
                    "args": args})
    return out


@contextlib.contextmanager
def profiler_trace(logdir: str, with_stack: bool = False):
    """Capture a host and CUDA trace into ``logdir/trace.json`` (Chrome
    trace format; Perfetto and chrome://tracing read it), the program's
    spans of the capture beside the profiler's events.  Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` give the
    time by operator and kernel.

    Usage::

        with profiling.profiler_trace("traces/transcribe"):
            transcriber.transcribe(audio)
    """
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
    t1 = time.perf_counter_ns()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    during = [s for s in spans() if s.start_ns < t1 and s.end_ns > t0]
    trace["traceEvents"] += _chrome_events(during, int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
