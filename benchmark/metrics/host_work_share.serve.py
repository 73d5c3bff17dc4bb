"""Serving: the share of the window's update walls in which the host was
not blocked reading the device (1 - sum ``read_ns`` / sum wall of the
program's ``service.update`` spans: the reads of each continuation step
and of the tokens at the end).  Near 100 % the update is bound by the
host's enqueue; the reads wait only for each step's last kernels."""

from portbench.program_spans import host_work_percent, window_spans


def read(record):
    return host_work_percent(window_spans(record, "service.update", "update"))
