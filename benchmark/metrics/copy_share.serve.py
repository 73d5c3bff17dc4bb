"""Kernels: the share of the traced update's device time spent in
direct_copy_kernel (the dtype copies: the int8 caches upcast to float
before the attention products)."""

from portbench.readers import copy_percent


def read(record):
    return copy_percent(record, "direct_copy_kernel")
