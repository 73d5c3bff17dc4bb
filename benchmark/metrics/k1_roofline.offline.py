"""Kernels: K1 (encoder_attention_mma_kernel, bf16) at its roofline: the
least time of its calls (bytes and operations for the clips' valid
lengths, 989 TFLOP/s, 3.35 TB/s) over its device time in the trace."""

from portbench.readers import k1_roofline_percent


def read(record):
    return k1_roofline_percent(record)
