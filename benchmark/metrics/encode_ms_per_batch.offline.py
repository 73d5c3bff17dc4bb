"""Model: ms per batch of models.moonshine.encode, from the spans around
each encode (ended by a synchronise)."""

from portbench.readers import span_ms


def read(record):
    ms = span_ms(record, "encode")
    return sum(ms) / len(ms) if ms else None
