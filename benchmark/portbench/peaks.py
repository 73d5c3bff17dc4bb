"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
700 W limit), the table every roofline and mfu share is taken against.

A float32-exact product on the bf16 tensor cores (the port's float32 K1
splits each float32 operand into three bf16 parts and takes six passes) is
bounded at a sixth of the bf16 rate, as ``chip_smoke.attention_bound``
bounds it.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,  # dense tensor cores
    "float32": 67e12,  # outside the tensor cores (TF32 off)
    "float32_six_pass": 989e12 / 6,  # six bf16 passes per float32 product
}
