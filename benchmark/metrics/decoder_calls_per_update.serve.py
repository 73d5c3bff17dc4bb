"""Decoding: the mean decoder calls of the window's decoding updates (the
verify and each greedy continuation step), the ``decoder_calls`` of the
program's ``service.update`` spans inside the benchmark's spans around
``update(cohort=c)``."""

from portbench.program_spans import window_spans


def read(record):
    ups = [s for s in window_spans(record, "service.update", "update") if s.attrs["decode"]]
    return sum(s.attrs["decoder_calls"] for s in ups) / len(ups) if ups else None
