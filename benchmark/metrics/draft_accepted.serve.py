"""Serving: the share of the drafts' tokens that the speculative verify
accepted over the window's updates, the ``accepted_tokens`` over the
``draft_tokens`` of the program's ``service.update`` spans (each slot's
previous hypothesis is its draft; the accepted count is found on the host
as the prefix that the new hypothesis shares with it)."""

from portbench.program_spans import window_spans


def read(record):
    ups = window_spans(record, "service.update", "update")
    drafted = sum(s.attrs["draft_tokens"] for s in ups)
    return 100.0 * sum(s.attrs["accepted_tokens"] for s in ups) / drafted if drafted else None
