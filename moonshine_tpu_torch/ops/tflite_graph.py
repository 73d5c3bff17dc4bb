"""Execute a parsed TFLite graph as float PyTorch ops.

Counterpart of the JAX package's ``ops/tflite_graph.py``, for the
``.tflite`` graphs embedded in the reference's voice packs (reference:
micro/neural-tts/src/pb_decoder.cc runs them with TFLM in s16x8).  The
quantized graph is DEQUANTIZED once at load (int8 weights x per-channel
scales, int64 biases x bias scales, int16 constants x their scales), the
float constants are copied to ``device`` once, and the graph runs in float
there.

Supported ops: TRANSPOSE, RESHAPE, CONV_2D (dilated, SAME/VALID), ADD,
MUL, GELU (exact + tanh-approximate), TRANSPOSE_CONV, FULLY_CONNECTED.
Tensors keep TFLite's NHWC layout between ops; a convolution permutes to
torch's NCHW and back.

Where a straight translation would part from JAX's results:

- CONV_2D ``SAME`` is XLA's SAME padding, uneven at stride 2
  (``models/layers.same_pads``); ``F.conv2d(padding="same")`` refuses
  strides.
- TRANSPOSE_CONV is ``lax.conv_transpose(padding="SAME",
  transpose_kernel=True)`` on NHWC/OHWI: the input has ``w.shape[0]``
  channels and the output ``w.shape[3]``.  That is
  ``F.conv_transpose2d`` with the weight ``w.permute(0, 3, 1, 2)`` and no
  padding (the input dilated by the stride and padded by k - 1 on each
  side), then padded or cropped to ``lax``'s own padding
  (``_conv_transpose_padding``).  The ``output_shape`` operand is ignored,
  as JAX ignores it.
- Biases are added after the product is rounded, as JAX adds them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..core.tflite_io import TfliteModel, TfliteTensor
from ..models.layers import same_pads

__all__ = ["TfliteExecutor", "conv_transpose_padding"]


def _dequant(t: TfliteTensor) -> np.ndarray:
    """Constant tensor -> float32 (or raw ints for shape/perm operands)."""
    a = t.data
    if a is None:
        raise ValueError(f"tensor {t.name} has no constant data")
    if a.dtype in (np.int32,) and t.scale is None:
        return a  # shape / permutation operand
    if t.scale is None:
        return a.astype(np.float32)
    scale = t.scale.astype(np.float32)
    if a.dtype == np.int8 and len(scale) > 1:
        # per-channel (quantized_dimension is the output-channel axis 0
        # for conv weights in the packs we load)
        shape = [1] * a.ndim
        shape[t.quantized_dimension] = len(scale)
        return a.astype(np.float32) * scale.reshape(shape)
    return a.astype(np.float32) * scale[0]


def conv_transpose_padding(k: int, s: int, padding: str) -> tuple[int, int]:
    """``lax``'s padding (before, after) of the stride-dilated input of a
    transposed convolution with kernel ``k`` and stride ``s``: SAME gives
    ``n * s`` outputs from ``n`` inputs, VALID ``(n - 1) * s + max(k, s)``."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"Invalid padding mode: {padding}")
    return pad_a, pad_len - pad_a


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv2d(x: torch.Tensor, w: torch.Tensor, options: dict) -> torch.Tensor:
    """CONV_2D: x ``[N, H, W, Cin]``, w ``[Cout, KH, KW, Cin]``."""
    stride = (options.get("stride_h", 1), options.get("stride_w", 1))
    dilation = (options.get("dilation_h", 1), options.get("dilation_w", 1))
    xc = _nchw(x)
    if options.get("padding", 0) == 0:  # SAME
        ph = same_pads(xc.shape[2], w.shape[1], stride[0], dilation[0])
        pw = same_pads(xc.shape[3], w.shape[2], stride[1], dilation[1])
        xc = F.pad(xc, (*pw, *ph))
    out = F.conv2d(xc, w.permute(0, 3, 1, 2), stride=stride, dilation=dilation)
    return _nhwc(out)


def _transpose_conv(x: torch.Tensor, w: torch.Tensor, options: dict) -> torch.Tensor:
    """TRANSPOSE_CONV as JAX runs it: x ``[N, H, W, w.shape[0]]`` ->
    ``[N, H', W', w.shape[3]]``."""
    stride = (options.get("stride_h", 1), options.get("stride_w", 1))
    pad = "SAME" if options.get("padding", 0) == 0 else "VALID"
    # padding=0: the dilated input padded by k - 1 on each side.
    full = F.conv_transpose2d(_nchw(x), w.permute(0, 3, 1, 2), stride=stride)
    pads: list[int] = []
    for axis in (1, 0):  # F.pad lists the last axis first
        k = w.shape[1 + axis]
        before, after = conv_transpose_padding(k, stride[axis], pad)
        pads += [before - (k - 1), after - (k - 1)]  # negative: crop
    return _nhwc(F.pad(full, pads))


def _fused_act(x: torch.Tensor, code: int) -> torch.Tensor:
    if code == 0:
        return x
    if code == 1:  # RELU
        return torch.clamp(x, min=0)
    if code == 3:  # RELU6
        return torch.clamp(x, 0, 6)
    raise NotImplementedError(f"fused activation {code}")


class TfliteExecutor:
    """Float executor on ``device`` (CUDA unless named): ``run(x)`` maps
    the graph's single input to its single output, both as float tensors
    in DEQUANTIZED units (the caller never sees the int16 wire scales)."""

    def __init__(self, model: TfliteModel, device=None):
        if len(model.inputs) != 1 or len(model.outputs) != 1:
            raise ValueError("expected a single-input single-output graph")
        self.model = model
        self.device = resolve_device(device)
        self.ints: dict[int, np.ndarray] = {}  # shape / permutation operands
        self.consts: dict[int, torch.Tensor] = {}
        for i, t in enumerate(model.tensors):
            if t.data is not None:
                a = _dequant(t)
                if a.dtype == np.int32:
                    self.ints[i] = a
                else:
                    self.consts[i] = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        tin = model.tensors[model.inputs[0]]
        tout = model.tensors[model.outputs[0]]
        self.input_shape = tin.shape
        self.input_scale = float(tin.scale[0]) if tin.scale is not None else 1.0
        self.output_scale = float(tout.scale[0]) if tout.scale is not None else 1.0

    @torch.inference_mode()
    def run(self, x: torch.Tensor) -> torch.Tensor:
        """x: float tensor on the executor's device, shaped like the graph
        input (dequantized units), optionally with a LARGER leading batch
        than the graph declares.  Returns the float output.

        Batch support: the graphs we load declare batch 1 and every
        TRANSPOSE keeps axis 0 in place while every RESHAPE target keeps
        a leading 1; substituting the actual batch into those reshape
        targets batches the whole graph (asserted per-op below).
        """
        batch = int(x.shape[0])
        env: dict[int, torch.Tensor] = {self.model.inputs[0]: x}

        def val(i):
            if i in env:
                return env[i]
            if i in self.consts:
                return self.consts[i]
            return self.ints[i]

        for op in self.model.ops:
            ins = op.inputs
            o = op.outputs[0]
            if op.name == "TRANSPOSE":
                perm = tuple(int(p) for p in np.asarray(val(ins[1])))
                if batch > 1 and perm[0] != 0:
                    raise NotImplementedError("batched transpose moves axis 0")
                env[o] = val(ins[0]).permute(perm)
            elif op.name == "RESHAPE":
                if len(ins) > 1 and ins[1] >= 0:
                    shape = [int(s) for s in np.asarray(val(ins[1]))]
                else:
                    shape = list(op.options["new_shape"])
                if batch > 1:
                    if shape[0] != 1:
                        raise NotImplementedError("batched reshape folds axis 0")
                    shape[0] = batch
                env[o] = val(ins[0]).reshape(shape)
            elif op.name == "ADD":
                env[o] = val(ins[0]) + val(ins[1])
            elif op.name == "MUL":
                env[o] = val(ins[0]) * val(ins[1])
            elif op.name == "GELU":
                approximate = "tanh" if op.options.get("approximate") else "none"
                env[o] = F.gelu(val(ins[0]), approximate=approximate)
            elif op.name == "CONV_2D":
                out = _conv2d(val(ins[0]), val(ins[1]), op.options)
                if len(ins) > 2 and ins[2] >= 0:
                    out = out + val(ins[2])
                env[o] = _fused_act(out, op.options.get("fused_activation", 0))
            elif op.name == "TRANSPOSE_CONV":
                # inputs: output_shape (ignored), weights, x, (bias); JAX's
                # conv_transpose reads the weights' axis 0 as x's channels
                out = _transpose_conv(val(ins[2]), val(ins[1]), op.options)
                if len(ins) > 3 and ins[3] >= 0:
                    out = out + val(ins[3])
                env[o] = _fused_act(out, op.options.get("fused_activation", 0))
            elif op.name == "FULLY_CONNECTED":
                out = F.linear(val(ins[0]), val(ins[1]))  # w [out, in]
                if len(ins) > 2 and ins[2] >= 0:
                    out = out + val(ins[2])
                env[o] = _fused_act(out, op.options.get("fused_activation", 0))
            else:
                raise NotImplementedError(f"tflite op {op.name}")
        return env[self.model.outputs[0]]
