"""Decoding: ms per decoder step of greedy_decode, from the benchmark's
spans around each batch's decode (ended by reading its tokens back), over
the decoder calls the batch made."""


def read(record):
    spans = record.spans_named("decode")
    steps = sum(info["steps"] for *_, info in spans)
    if not steps:
        return None
    return sum(end - start for _, start, end, _ in spans) * 1e3 / steps
