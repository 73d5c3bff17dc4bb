"""Minimal TFLite flatbuffer reader (no TFLite/TensorFlow dependency).

A copy of the JAX package's ``core/tflite_io.py`` (it needs only ``struct``
and numpy), so that the port reads the voice pack's decoder graph without
importing the JAX package.

The reference's neural-TTS voice pack embeds its RVQ decoder as an s16x8
``.tflite`` graph (reference: micro/neural-tts/src/pb_decoder.cc loads it
with TFLM; pack layout at micro/neural-tts/include/neural_tts/
pack_format.h:63).  This environment has no TFLite runtime, so — exactly
like ``core/onnx_io.py`` does for ``.onnx`` — this module parses the
flatbuffer wire format directly and exposes tensors/operators for the
executor in ``ops/tflite_graph.py``.

Only the schema subset those graphs need is implemented (the standard
TFLite schema field ids; stable since schema v3):

  Model:    version(0) operator_codes(1) subgraphs(2) description(3)
            buffers(4)
  SubGraph: tensors(0) inputs(1) outputs(2) operators(3) name(4)
  Tensor:   shape(0) type(1) buffer(2) name(3) quantization(4)
  Operator: opcode_index(0) inputs(1) outputs(2) builtin_options_type(3)
            builtin_options(4)
  OperatorCode: deprecated_builtin_code(0) custom_code(1) version(2)
            builtin_code(3)
  QuantizationParameters: min(0) max(1) scale(2) zero_point(3)
            details_type(4) details(5) quantized_dimension(6)
  Buffer:   data(0)

Flatbuffer primitives: little-endian; root = u32 offset to root table;
table = i32 soffset to vtable, vtable = [u16 vtable_bytes, u16
table_bytes, u16 field_offsets...]; vectors = u32 length then elements;
strings = u32 length then bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["TfliteModel", "TfliteTensor", "TfliteOp", "parse_tflite", "BUILTIN_NAMES"]


# Builtin operator codes (schema enum values) for the ops our graphs use,
# plus common neighbors for error messages.
BUILTIN_NAMES = {
    0: "ADD", 1: "AVERAGE_POOL_2D", 2: "CONCATENATION", 3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D", 9: "FULLY_CONNECTED", 14: "LOGISTIC",
    17: "MAX_POOL_2D", 18: "MUL", 22: "RESHAPE", 25: "SOFTMAX",
    28: "TANH", 34: "PAD", 39: "TRANSPOSE", 40: "MEAN", 41: "SUB",
    42: "DIV", 49: "SPLIT", 53: "CAST", 65: "TRANSPOSE_CONV",
    67: "SLICE", 83: "PACK", 97: "RESIZE_NEAREST_NEIGHBOR",
    114: "QUANTIZE", 115: "DEQUANTIZE", 150: "GELU",
}

# TensorType enum -> numpy dtype.
_DTYPES = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64,
}


class _Reader:
    """Positioned flatbuffer accessors over one bytes object."""

    def __init__(self, buf: bytes):
        self.buf = buf

    def u8(self, off):
        return self.buf[off]

    def u16(self, off):
        return struct.unpack_from("<H", self.buf, off)[0]

    def i32(self, off):
        return struct.unpack_from("<i", self.buf, off)[0]

    def u32(self, off):
        return struct.unpack_from("<I", self.buf, off)[0]

    def i64(self, off):
        return struct.unpack_from("<q", self.buf, off)[0]

    def f32(self, off):
        return struct.unpack_from("<f", self.buf, off)[0]

    # -- table navigation ---------------------------------------------------

    def field_off(self, table_off: int, field_id: int) -> int:
        """Absolute offset of a table field's inline data, or 0 if absent."""
        vt = table_off - self.i32(table_off)
        vt_size = self.u16(vt)
        slot = 4 + 2 * field_id
        if slot + 2 > vt_size:
            return 0
        rel = self.u16(vt + slot)
        return table_off + rel if rel else 0

    def table(self, table_off: int, field_id: int) -> int:
        """Follow a table/struct-offset field; 0 if absent."""
        f = self.field_off(table_off, field_id)
        return f + self.u32(f) if f else 0

    def scalar(self, table_off: int, field_id: int, kind: str, default=0):
        f = self.field_off(table_off, field_id)
        if not f:
            return default
        return getattr(self, kind)(f)

    def vector(self, table_off: int, field_id: int) -> tuple[int, int]:
        """(element base offset, length) of a vector field; (0, 0) if absent."""
        f = self.field_off(table_off, field_id)
        if not f:
            return 0, 0
        v = f + self.u32(f)
        return v + 4, self.u32(v)

    def ivec(self, table_off: int, field_id: int, kind="i32", width=4) -> list[int]:
        base, n = self.vector(table_off, field_id)
        fn = getattr(self, kind)
        return [fn(base + i * width) for i in range(n)]

    def fvec(self, table_off: int, field_id: int) -> np.ndarray:
        base, n = self.vector(table_off, field_id)
        return np.frombuffer(self.buf, np.float32, n, base).copy()

    def string(self, table_off: int, field_id: int) -> str:
        f = self.field_off(table_off, field_id)
        if not f:
            return ""
        v = f + self.u32(f)
        n = self.u32(v)
        return self.buf[v + 4 : v + 4 + n].decode("utf-8", "replace")

    def ovec(self, table_off: int, field_id: int) -> list[int]:
        """Vector of table offsets."""
        base, n = self.vector(table_off, field_id)
        return [base + i * 4 + self.u32(base + i * 4) for i in range(n)]


@dataclass
class TfliteTensor:
    name: str
    shape: tuple[int, ...]
    dtype: np.dtype
    data: np.ndarray | None  # constant data (dequantized NOT applied), or None
    scale: np.ndarray | None  # per-tensor [1] or per-channel quant scales
    zero_point: np.ndarray | None
    quantized_dimension: int = 0


@dataclass
class TfliteOp:
    name: str  # builtin name, e.g. "CONV_2D"
    inputs: list[int] = field(default_factory=list)
    outputs: list[int] = field(default_factory=list)
    options: dict = field(default_factory=dict)


@dataclass
class TfliteModel:
    tensors: list[TfliteTensor]
    ops: list[TfliteOp]
    inputs: list[int]
    outputs: list[int]
    description: str = ""


# BuiltinOptions decoding for the option tables we need.  Each entry maps
# builtin op name -> (field_id, reader-kind, option-name, default) tuples.
_OPTION_FIELDS = {
    "CONV_2D": [
        (0, "i32", "padding", 0),  # 0 SAME, 1 VALID
        (1, "i32", "stride_w", 1),
        (2, "i32", "stride_h", 1),
        (3, "i32", "fused_activation", 0),
        (4, "i32", "dilation_w", 1),
        (5, "i32", "dilation_h", 1),
    ],
    "TRANSPOSE_CONV": [
        (0, "i32", "padding", 0),
        (1, "i32", "stride_w", 1),
        (2, "i32", "stride_h", 1),
        (3, "i32", "fused_activation", 0),
    ],
    "FULLY_CONNECTED": [
        (0, "i32", "fused_activation", 0),
        (1, "i32", "weights_format", 0),
        (2, "u8", "keep_num_dims", 0),
    ],
    "ADD": [(0, "i32", "fused_activation", 0)],
    "MUL": [(0, "i32", "fused_activation", 0)],
    "RESHAPE": [],  # new_shape also arrives as input tensor 1
    "TRANSPOSE": [],
    "GELU": [(0, "u8", "approximate", 0)],
}

# ReshapeOptions.new_shape is field 0 (an int vector).
_RESHAPE_NEW_SHAPE_FIELD = 0


def parse_tflite(data: bytes) -> TfliteModel:
    """Parse a .tflite blob into tensors + op list (subgraph 0)."""
    if len(data) < 8 or data[4:8] != b"TFL3":
        raise ValueError("not a TFLite flatbuffer (missing TFL3 identifier)")
    r = _Reader(data)
    model = r.u32(0)

    # operator_codes
    op_names = []
    for oc in r.ovec(model, 1):
        code = r.scalar(oc, 3, "i32", 0)  # builtin_code (new field)
        if code == 0:
            code = r.scalar(oc, 0, "u8", 0)  # deprecated_builtin_code
        op_names.append(BUILTIN_NAMES.get(code, f"BUILTIN_{code}"))

    # buffers
    buffers: list[bytes | None] = []
    for b in r.ovec(model, 4):
        base, n = r.vector(b, 0)
        buffers.append(data[base : base + n] if n else None)

    sub = r.ovec(model, 2)[0]  # subgraph 0

    tensors: list[TfliteTensor] = []
    for t in r.ovec(sub, 0):
        shape = tuple(r.ivec(t, 0))
        ttype = r.scalar(t, 1, "u8", 0)
        dtype = np.dtype(_DTYPES.get(ttype, np.float32))
        buf_idx = r.scalar(t, 2, "u32", 0)
        name = r.string(t, 3)
        raw = buffers[buf_idx] if buf_idx < len(buffers) else None
        arr = None
        if raw:
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        scale = zp = None
        qdim = 0
        q = r.table(t, 4)
        if q:
            s = r.fvec(q, 2)
            if len(s):
                scale = s
            zps = r.ivec(q, 3, "i64", 8)
            if zps:
                zp = np.asarray(zps, np.int64)
            qdim = r.scalar(q, 6, "i32", 0)
        tensors.append(TfliteTensor(name, shape, dtype, arr, scale, zp, qdim))

    ops: list[TfliteOp] = []
    for o in r.ovec(sub, 3):
        idx = r.scalar(o, 0, "u32", 0)
        name = op_names[idx] if idx < len(op_names) else f"OP_{idx}"
        op = TfliteOp(name, r.ivec(o, 1), r.ivec(o, 2))
        bo = r.table(o, 4)
        if bo:
            for fid, kind, oname, default in _OPTION_FIELDS.get(name, []):
                op.options[oname] = r.scalar(bo, fid, kind, default)
            if name == "RESHAPE":
                ns = r.ivec(bo, _RESHAPE_NEW_SHAPE_FIELD)
                if ns:
                    op.options["new_shape"] = ns
        ops.append(op)

    return TfliteModel(
        tensors=tensors,
        ops=ops,
        inputs=r.ivec(sub, 1),
        outputs=r.ivec(sub, 2),
        description=r.string(model, 3),
    )
