"""Device: the share of the traced updates' idle (the gaps between their
device operations) in which the host was inside a greedy continuation
step's own time (the program's ``service.step`` spans less their
``service.read``), enqueuing the step's launches.  The profiler's host
cost per launch lengthens those spans, as it lengthens the idle that
``device_idle.serve`` reads."""

from portbench.program_spans import idle_covered_percent, profiler_offset_ns, program_spans


def read(record):
    return idle_covered_percent(record.sessions, program_spans("service.step"),
                                program_spans("service.read"), profiler_offset_ns())
