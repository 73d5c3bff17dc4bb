"""Device: the share of the traced cohort update's wall in which no device
operation ran (the profiler's host cost per launch lengthens that wall)."""

from portbench.readers import idle_percent


def read(record):
    return idle_percent(record)
