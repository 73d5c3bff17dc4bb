"""The per-layer metrics that read the program's own spans
(``portbench/program_spans.py``): the tiny traced runs of both cells report
the window's, the device-trace ones find nothing to read on the CPU, and
the idle attribution's arithmetic on synthetic sessions and spans."""

from types import SimpleNamespace

import pytest
from portbench import program_spans as ps
from portbench.trace import Session
from tiny import run_tiny

WINDOW = {"base_offline_b64": {"host_work_share.offline"},
          "medium_streaming_serve64": {"decoder_calls_per_update.serve", "draft_accepted.serve",
                                       "host_work_share.serve"}}
TRACE = {"base_offline_b64": "idle_in_step_enqueue.offline",
         "medium_streaming_serve64": "idle_in_step_enqueue.serve"}


@pytest.mark.parametrize("cell", sorted(WINDOW))
def test_a_tiny_traced_run_reports_the_window_metrics(cell):
    out = run_tiny(cell, trace=True)
    m = out["metrics"]
    assert WINDOW[cell] <= set(m)
    for name in WINDOW[cell] - {"decoder_calls_per_update.serve"}:
        assert 0 <= m[name]["value"] <= 100, (name, m[name])
    if "decoder_calls_per_update.serve" in m:
        assert m["decoder_calls_per_update.serve"]["value"] >= 1
    # No device operation is traced on the CPU: no idle to attribute.
    assert TRACE[cell] not in m


def _span(id_, start, end, parent=0, **attrs):
    return SimpleNamespace(id=id_, parent=parent, start_ns=start, end_ns=end, attrs=attrs)


def test_idle_attribution_arithmetic():
    """Two sessions whose device operations leave gaps of 40, 30 and 30 us
    (100 in all); steps whose own time (less their reads) covers 20 + 10 of
    the first gap, 30 of the second and none of the third: 60 %."""
    off = 5_000  # ns added to the spans' stamps to reach the profiler's clock
    one = Session("a", 1.0, [("k", 0.0, 10.0), ("k", 5.0, 20.0), ("k", 60.0, 70.0),
                             ("k", 100.0, 110.0)])
    two = Session("b", 1.0, [("k", 1000.0, 1010.0), ("k", 1040.0, 1050.0)])
    assert ps.device_gaps(one) == [(20.0, 60.0), (70.0, 100.0)]
    us = lambda x: int(x * 1e3) - off  # noqa: E731  microseconds -> the spans' ns
    steps = [_span(1, us(15.0), us(65.0)), _span(2, us(70.0), us(120.0))]
    reads = [_span(3, us(40.0), us(50.0), parent=1), _span(4, us(10.0), us(12.0), parent=2)]
    assert ps.self_intervals(steps, reads, off) == [(15.0, 40.0), (50.0, 65.0), (70.0, 120.0)]
    # Gap 20-60: 20-40 and 50-60 are a step's own time (30); gap 70-100: 30;
    # the second session's gap 1010-1040: none.
    assert ps.idle_covered_percent([one, two], steps, reads, off) == pytest.approx(60.0)
    assert ps.idle_covered_percent([Session("c", 1.0, [])], steps, reads, off) is None
    assert ps.idle_covered_percent([one], [], reads, off) is None
    assert ps.idle_covered_percent([one], steps, reads, None) is None


def test_window_containment_and_host_share():
    """A span counts where it lies inside one of the benchmark's spans, and
    the host's share is 1 - blocked reads over walls."""
    record = SimpleNamespace(spans_named=lambda name: [("update", 1.0, 2.0, {}),
                                                       ("update", 3.0, 4.0, {})])
    inside = [_span(1, 1_100_000_000, 1_900_000_000, read_ns=200_000_000),
              _span(2, 3_000_000_000, 3_400_000_000, read_ns=0)]
    across = _span(3, 1_500_000_000, 3_500_000_000, read_ns=0)
    before = _span(4, 500_000_000, 900_000_000, read_ns=0)
    picked = ps.within(inside + [across, before],
                       [(a, b) for _, a, b, _ in record.spans_named("update")])
    assert picked == inside
    assert ps.host_work_percent(picked) == pytest.approx(100.0 * (1 - 0.2 / 1.2))
    assert ps.host_work_percent([]) is None
