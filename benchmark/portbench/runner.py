"""One run of one cell: set-up, the measured window, the traced call, the
check against the plain reference, and the result line.

A driver (``portbench/drivers/<name>.py``, named by the cell's traffic
mix) provides ``setup(ctx)``, ``window(ctx, seconds)``, ``trace(ctx)``,
``release(ctx)`` (frees the program, keeping what the check compares) and
``check(ctx)``, and ``control(ctx, mode)`` for ``tools/calibrate.py``;
everything else here is the same for every cell.  The traced call runs
after the window in every run, so that the profiler's after-effects on the
host stay out of the window's spans: it does a fixed amount of work drawn
from the seed, whose device time the end-to-end metrics of source
``device_trace`` read; ``--trace 1`` also records the host's operations.

An end-to-end metric that the window does not return, and every per-layer
metric, is read from the run by ``metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field

from . import spec as specmod
from .trace import busy_s as trace_busy_s

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "moonshine_tpu")


@dataclass
class RunRecord:
    """What a run measured, as the metric readers see it."""

    cell: str
    precision: dict
    window_s: float = 0.0
    spans: list = field(default_factory=list)  # (name, start_s, end_s, info)
    counters: dict = field(default_factory=dict)
    sessions: list = field(default_factory=list)  # trace.Session

    def span(self, name: str, start: float, end: float, **info) -> None:
        self.spans.append((name, start, end, info))

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]


@dataclass
class Context:
    """A run's inputs and state, shared by a driver's four phases."""

    cell: specmod.Cell
    seed: int
    device: object  # torch.device
    record: RunRecord
    state: dict = field(default_factory=dict)
    marks: list = field(default_factory=list)  # (phase, seconds since the run began)
    t0: float = field(default_factory=time.perf_counter)

    def mark(self, phase: str) -> None:
        """Note when a phase of set-up ended (printed on standard error)."""
        self.marks.append((phase, round(time.perf_counter() - self.t0, 3)))


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def stderr(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(cell: specmod.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, card: str = "") -> dict:
    """Run ``cell`` once; returns the result object (not yet printed)."""
    import torch

    record = RunRecord(cell.name, cell.precision)
    ctx = Context(cell, seed, torch.device(device), record, t0=t_start)
    ctx.mark("imports and kernel build")
    drv = specmod.driver(cell.traffic["driver"])
    drv.setup(ctx)
    setup_s = time.perf_counter() - t_start
    # Set-up's objects are kept out of the collector's passes: a full pass
    # inside the window would cost in proportion to them.
    gc.collect()
    gc.freeze()
    e2e = drv.window(ctx, seconds)
    gc.unfreeze()
    t_window = time.perf_counter()
    drv.trace(ctx, host=trace)
    t_trace = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    drv.release(ctx)
    checks = drv.check(ctx)
    stderr(f"set-up marks {ctx.marks}")
    stderr(f"window spans (ms) {span_walls(record)}")
    stderr(f"set-up {setup_s:.3f} s, window {record.window_s:.3f} s, trace "
           f"{t_trace - t_window:.3f} s (device busy {trace_busy_s(record.sessions):.6f} s), "
           f"check {time.perf_counter() - t_trace:.3f} s; counters {json.dumps(record.counters)}")
    correct = record.counters.get("failed", 0) == 0 and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    e2e["setup_s"] = setup_s
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        name = m["name"]
        value = e2e[name] if name in e2e else specmod.metric_reader(name)(record)
        if value is not None:  # a reader that finds nothing to read
            metrics[name] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": card, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": record.counters.get("attempted", 0),
           "failed": record.counters.get("failed", 0), "metrics": metrics, "device": dev}
    if trace:
        from .trace import breakdown, wall_s

        dev["busy_s"] = trace_busy_s(record.sessions)
        dev["window_s"] = wall_s(record.sessions)
        out["breakdown"] = breakdown(record.sessions)
    out["checks"] = checks
    return out


def span_walls(record: RunRecord, most: int = 200) -> dict:
    """Each span name's walls in the order they ran, in ms (at most
    ``most`` a name): how steady the window's calls were."""
    out: dict[str, list] = {}
    for name, start, end, _ in record.spans:
        if len(out.setdefault(name, [])) < most:
            out[name].append(round((end - start) * 1e3, 1))
    return out


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        stderr(f"check {name}: {c['value']} limit {c['limit']}")


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = specmod.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        stderr(f"{args.workload} needs {cell.chips} CUDA device(s); "
               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    from moonshine_tpu_torch.ops import _build

    _build.build()  # kept in moonshine_tpu_torch/csrc/build/ between runs
    card = torch.cuda.get_device_name(0)
    seed = args.seed % 2**63
    out = run_cell(cell, seed, args.seconds, bool(args.trace), "cuda", t_start, card)
    bad = forbidden_loaded()
    if bad:
        stderr(f"a run may not load {bad}: found in sys.modules after the window")
        return 3
    print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0
