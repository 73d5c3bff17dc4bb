"""Whole step: model FLOPs of the traced batch (each clip's frames and
decoder positions, no padding) over its device time times the data-sheet
peak of the cell's precision (bf16 dense: 989 TFLOP/s)."""

from portbench.readers import mfu_percent


def read(record):
    return mfu_percent(record)
