"""Device: the share of the traced decodes' idle (the gaps between their
device operations) in which the host was inside a decoder step's own time
(the program's ``greedy.step`` spans less their ``greedy.read``),
enqueuing the step's launches.  The profiler's host cost per launch
lengthens those spans, as it lengthens the idle that
``device_idle.offline`` reads."""

from portbench.program_spans import idle_covered_percent, profiler_offset_ns, program_spans


def read(record):
    decodes = [s for s in record.sessions if "steps" in s.info]
    return idle_covered_percent(decodes, program_spans("greedy.step"),
                                program_spans("greedy.read"), profiler_offset_ns())
