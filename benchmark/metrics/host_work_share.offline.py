"""Decoding: the share of the window's greedy_decode walls in which the
host was not blocked reading the device (1 - sum ``read_ns`` / sum wall of
the program's ``greedy.decode`` spans; ``read_ns`` is the time in each
step's read of whether every row is done)."""

from portbench.program_spans import host_work_percent, window_spans


def read(record):
    return host_work_percent(window_spans(record, "greedy.decode", "decode"))
