"""Device: the share of the traced wall in which no device operation ran
(traced encodes and decodes; the profiler's host cost per launch lengthens
that wall, so this overstates the idle of an untraced run)."""

from portbench.readers import idle_percent


def read(record):
    return idle_percent(record)
