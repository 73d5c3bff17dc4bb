"""Minimal ONNX protobuf reader/writer (no `onnx` dependency).

A copy of the JAX package's ``core/onnx_io.py`` (it needs only ``struct``
and numpy), so that the port reads the streaming family's ONNX checkpoints
without importing the JAX package.

The environment has no onnx/onnxruntime packages, but the reference ships
real fp32 ONNX weights in-tree (reference: micro/models/spelling_cnn_mel.onnx,
micro/models/tinyvad_cnn_speech_mel.onnx — see micro/models/README.md).
This module decodes the protobuf wire format directly for the small subset
of onnx.proto3 we need: graph topology (nodes + attributes), initializers
(weight tensors) and graph input/output value infos.

It also *writes* minimal ONNX files (graph + initializers) so importer
round-trip tests can synthesize checkpoint files in the reference's layout
(reference: scripts/convert-models-to-ort.py exports ONNX before .ort
conversion; our streaming importer consumes that ONNX stage).

Only plain-old-data containers are produced — no protobuf classes leak out.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# onnx TensorProto.DataType values we support.
DTYPE_TO_NP = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
NP_TO_DTYPE = {np.dtype(v): k for k, v in DTYPE_TO_NP.items()}


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.

    value is: int for varint(0), bytes for length-delimited(2),
    4/8-byte bytes for fixed32(5)/fixed64(1).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 0x7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos : pos + 4]
            pos += 4
        elif wtype == 1:
            val = buf[pos : pos + 8]
            pos += 8
        else:  # pragma: no cover - groups are not used by onnx
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _packed_varints(val: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _zigzag64(v: int) -> int:
    """Interpret a varint as a signed two's-complement int64 (protobuf int64)."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


# ---------------------------------------------------------------------------
# Decoded containers
# ---------------------------------------------------------------------------


@dataclass
class OnnxNode:
    op_type: str
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: list[OnnxNode] = field(default_factory=list)
    initializers: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: list[tuple[str, list]] = field(default_factory=list)  # (name, dims)
    outputs: list[tuple[str, list]] = field(default_factory=list)
    name: str = ""


def _parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    double_data: list[float] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:  # dims
            if wtype == 0:
                dims.append(_zigzag64(val))
            else:
                dims.extend(_zigzag64(v) for v in _packed_varints(val))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:  # float_data
            if wtype == 5:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(struct.unpack(f"<{len(val)//4}f", val))
        elif fnum == 5:  # int32_data
            if wtype == 0:
                int32_data.append(val)
            else:
                int32_data.extend(_packed_varints(val))
        elif fnum == 7:  # int64_data
            if wtype == 0:
                int64_data.append(_zigzag64(val))
            else:
                int64_data.extend(_zigzag64(v) for v in _packed_varints(val))
        elif fnum == 8:
            name = val.decode("utf-8")
        elif fnum == 9:
            raw = val
        elif fnum == 11:  # double_data
            if wtype == 1:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(struct.unpack(f"<{len(val)//8}d", val))
    np_dtype = DTYPE_TO_NP.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype).reshape(dims)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np_dtype).reshape(dims)
    elif int32_data:
        a = np.asarray(int32_data, dtype=np.int64)
        if np_dtype == np.int8:  # int8 stored sign-extended in int32_data
            a = ((a + 128) % 256) - 128
        arr = a.astype(np_dtype).reshape(dims)
    elif double_data:
        arr = np.asarray(double_data, dtype=np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=np_dtype)
    return name, arr


def _parse_attr(buf: bytes) -> tuple[str, object]:
    name = ""
    value: object = None
    floats: list[float] = []
    ints: list[int] = []
    strings: list[bytes] = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode("utf-8")
        elif fnum == 2:  # f
            value = struct.unpack("<f", val)[0]
        elif fnum == 3:  # i
            value = _zigzag64(val)
        elif fnum == 4:  # s
            value = val
        elif fnum == 5:  # t
            value = _parse_tensor(val)[1]
        elif fnum == 7:  # floats
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
        elif fnum == 8:  # ints
            if wtype == 0:
                ints.append(_zigzag64(val))
            else:
                ints.extend(_zigzag64(v) for v in _packed_varints(val))
        elif fnum == 9:
            strings.append(val)
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = strings
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="")
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode("utf-8"))
        elif fnum == 2:
            node.outputs.append(val.decode("utf-8"))
        elif fnum == 3:
            node.name = val.decode("utf-8")
        elif fnum == 4:
            node.op_type = val.decode("utf-8")
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: bytes) -> tuple[str, list]:
    name = ""
    dims: list = []
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            name = val.decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _w3, v3 in _iter_fields(v2):
                        if f3 == 2:  # shape
                            for f4, _w4, v4 in _iter_fields(v3):
                                if f4 == 1:  # dim
                                    d: object = None
                                    for f5, _w5, v5 in _iter_fields(v4):
                                        if f5 == 1:
                                            d = _zigzag64(v5)
                                        elif f5 == 2:
                                            d = v5.decode("utf-8")
                                    dims.append(d)
    return name, dims


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode("utf-8")
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            g.inputs.append(_parse_value_info(val))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(val))
    return g


def load_onnx(path: str) -> OnnxGraph:
    """Parse an .onnx file into an OnnxGraph (topology + weights)."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for fnum, _wtype, val in _iter_fields(buf):
        if fnum == 7:  # ModelProto.graph
            graph = _parse_graph(val)
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    # Graph inputs include initializers in some exporters; keep only real inputs.
    graph.inputs = [(n, d) for (n, d) in graph.inputs if n not in graph.initializers]
    return graph


# ---------------------------------------------------------------------------
# Minimal writer (for importer round-trip tests)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    key = _varint((fnum << 3) | wtype)
    if wtype == 2:
        return key + _varint(len(payload)) + payload
    return key + payload


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dtype_code = NP_TO_DTYPE[arr.dtype]
    out = b""
    for d in arr.shape:
        out += _field(1, 0, _varint(d))
    out += _field(2, 0, _varint(dtype_code))
    out += _field(8, 2, name.encode("utf-8"))
    out += _field(9, 2, arr.tobytes())
    return out


def save_onnx(path: str, tensors: dict[str, np.ndarray], graph_name: str = "g") -> None:
    """Write a minimal ONNX ModelProto holding only named initializers.

    Enough for weight distribution / round-trip tests: readers that only
    consume `initializers` (like our importers) see the same dict back.
    """
    g = _field(2, 2, graph_name.encode("utf-8"))
    for name, arr in tensors.items():
        g += _field(5, 2, _tensor_bytes(name, arr))
    model = _field(1, 0, _varint(8))  # ir_version
    model += _field(7, 2, g)
    with open(path, "wb") as f:
        f.write(model)
