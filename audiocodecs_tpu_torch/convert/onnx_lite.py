"""Minimal ONNX reader (protobuf wire format, no onnx/protobuf deps).

Parses just enough of ``ModelProto`` to recover a small inference graph:
node list (op_type, inputs, outputs, attributes) and initializer tensors.
Used to convert the reference's DNSMOS ``model_v8.onnx`` (reference
``metrics/dnsmos.py:45-152`` runs it via onnxruntime, which does not exist
in this environment) into native JAX parameters.

Wire format: each field is a (tag = field_number << 3 | wire_type) varint
followed by a varint (type 0), fixed64 (1), length-delimited bytes (2), or
fixed32 (5) payload. Messages are length-delimited fields parsed
recursively with per-message field maps.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["OnnxGraph", "OnnxNode", "read_onnx"]


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # fixed64
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # fixed32
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


@dataclass
class OnnxNode:
    op_type: str
    inputs: list
    outputs: list
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: list
    initializers: dict  # name -> np.ndarray
    inputs: list  # graph input names (excluding initializers)
    outputs: list


# TensorProto.DataType → numpy dtype (the small subset small CNNs use)
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
           9: np.bool_, 10: np.float16, 11: np.float64}


def _parse_tensor(buf: bytes):
    dims, dtype, raw, name = [], 1, b"", ""
    int_data, float_data, int64_data = [], [], []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            dims.append(val)
        elif fnum == 2:
            dtype = val
        elif fnum == 4 and wtype == 2:  # packed float_data
            float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 4 and wtype == 5:
            float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 5 and wtype == 2:  # packed int32_data
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                int_data.append(v)
        elif fnum == 5 and wtype == 0:
            int_data.append(val)
        elif fnum == 7 and wtype == 2:  # packed int64_data
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                int64_data.append(v)
        elif fnum == 7 and wtype == 0:
            int64_data.append(val)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64)
    elif int_data:
        arr = np.asarray(int_data, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_attr(buf: bytes):
    name, atype = "", 0
    f_val: Optional[float] = None
    i_val: Optional[int] = None
    s_val: Optional[bytes] = None
    t_val = None
    floats, ints = [], []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 20:
            atype = val
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = val
        elif fnum == 4:
            s_val = val
        elif fnum == 5:
            t_val = _parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(v)
            else:
                ints.append(val)
    # AttributeProto.AttributeType: 1 FLOAT, 2 INT, 3 STRING, 4 TENSOR,
    # 6 FLOATS, 7 INTS
    if atype == 1:
        return name, f_val
    if atype == 2:
        return name, i_val
    if atype == 3:
        return name, s_val.decode() if s_val is not None else ""
    if atype == 4:
        return name, t_val
    if atype == 6:
        return name, list(floats)
    if atype == 7:
        return name, list(ints)
    # untyped fallback: first non-None
    for v in (f_val, i_val, s_val, t_val):
        if v is not None:
            return name, v
    return name, ints or floats


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> OnnxGraph:
    nodes, inits, inputs, outputs = [], {}, [], []
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:
            inputs.append(_value_info_name(val))
        elif fnum == 12:
            outputs.append(_value_info_name(val))
    inputs = [i for i in inputs if i not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs)


def read_onnx(path: str) -> OnnxGraph:
    """Parse an .onnx file into an :class:`OnnxGraph`."""
    with open(path, "rb") as f:
        buf = f.read()
    for fnum, _, val in _fields(buf):
        if fnum == 7:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
