"""Whole step: model FLOPs of the traced updates (the frames ingested
through frontend, encoder, adapter and cross K/V, and each decoding slot's
hypothesis tokens over its memory) over their device time times the
data-sheet peak of the cell's precision (bf16 dense: 989 TFLOP/s)."""

from portbench.readers import mfu_percent


def read(record):
    return mfu_percent(record)
