"""Dependency-free ONNX protobuf reader and writer at the wire-format level
(a copy of ``kiri_tpu/utils/onnx_pb.py``).

ONNX files are plain protobuf, so a small wire-format codec reads every
tensor and node of a PP-OCR DB graph (and writes small .onnx files for the
tests and the smoke fixture) without the ``onnx`` package. It covers the
message subset the importer (``onnx_import.py``) needs:

  ModelProto{ir_version=1, graph=7, opset_import=8}
  GraphProto{node=1, name=2, initializer=5, input=11, output=12}
  NodeProto{input=1, output=2, name=3, op_type=4, attribute=5}
  AttributeProto{name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20}
  TensorProto{dims=1, data_type=2, float_data=4, int32_data=5,
              int64_data=7, name=8, raw_data=9}
  ValueInfoProto{name=1, type=2} / TypeProto.tensor_type.shape.dim
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ONNX TensorProto.DataType values we support.
DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
DTYPE_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


# --------------------------------------------------------------- wire reader
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) for every field in buf.

    value is int for varint/fixed, bytes for length-delimited.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:  # pragma: no cover - groups (wt 3/4) don't appear in ONNX
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _packed(val: Any, wt: int, fmt: str, size: int) -> List:
    """Decode a possibly-packed repeated scalar field occurrence."""
    if wt == 2:  # packed
        k = len(val) // size
        return list(struct.unpack(f"<{k}{fmt}", val[:k * size]))
    if isinstance(val, bytes):
        return [struct.unpack(f"<{fmt}", val)[0]]
    return [val]


def _varints(val: Any, wt: int) -> List[int]:
    if wt == 2:
        out, pos = [], 0
        while pos < len(val):
            v, pos = _read_varint(val, pos)
            out.append(v)
        return out
    return [val]


def _signed(v: int) -> int:
    """Interpret a 64-bit varint as two's-complement int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_tensor(buf: bytes) -> Dict[str, Any]:
    """TensorProto -> {'name', 'array'} with a real numpy array."""
    dims: List[int] = []
    data_type = 1
    name = ""
    raw = b""
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            dims.extend(_signed(v) for v in _varints(val, wt))
        elif field == 2:
            data_type = val
        elif field == 4:
            float_data.extend(_packed(val, wt, "f", 4))
        elif field == 5:
            int32_data.extend(_signed(v) & 0xFFFFFFFF for v in _varints(val, wt))
        elif field == 7:
            int64_data.extend(_signed(v) for v in _varints(val, wt))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
        elif field == 13:
            double_data.extend(_packed(val, wt, "d", 8))
    np_dtype = DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {data_type}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif double_data:
        arr = np.asarray(double_data, np.float64)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.uint32).astype(np.int32)
    else:
        arr = np.zeros(0, np_dtype)
    arr = arr.astype(np_dtype, copy=False).reshape(dims if dims else ())
    return {"name": name, "array": arr}


def _parse_attribute(buf: bytes) -> Tuple[str, Any]:
    name = ""
    out: Any = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:
            out = struct.unpack("<f", val)[0]
        elif field == 3:
            out = _signed(val)
        elif field == 4:
            out = val  # bytes; caller decodes if needed
        elif field == 5:
            out = parse_tensor(val)["array"]
        elif field == 7:
            floats.extend(_packed(val, wt, "f", 4))
        elif field == 8:
            ints.extend(_signed(v) for v in _varints(val, wt))
        elif field == 9:
            strings.append(val)
    if floats:
        out = floats
    elif ints:
        out = ints
    elif strings:
        out = strings
    return name, out


def _parse_node(buf: bytes) -> Dict[str, Any]:
    node = {"input": [], "output": [], "name": "", "op_type": "", "attrs": {}}
    for field, wt, val in _fields(buf):
        if field == 1:
            node["input"].append(val.decode("utf-8"))
        elif field == 2:
            node["output"].append(val.decode("utf-8"))
        elif field == 3:
            node["name"] = val.decode("utf-8")
        elif field == 4:
            node["op_type"] = val.decode("utf-8")
        elif field == 5:
            k, v = _parse_attribute(val)
            node["attrs"][k] = v
    return node


def _parse_value_info(buf: bytes) -> Dict[str, Any]:
    name = ""
    shape: List[Optional[int]] = []
    for field, wt, val in _fields(buf):
        if field == 1:
            name = val.decode("utf-8")
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dim: Optional[int] = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1:
                                            dim = _signed(v5)
                                    shape.append(dim)
    return {"name": name, "shape": shape}


def parse_graph(buf: bytes) -> Dict[str, Any]:
    g = {"nodes": [], "initializers": {}, "inputs": [], "outputs": [],
         "name": ""}
    for field, wt, val in _fields(buf):
        if field == 1:
            g["nodes"].append(_parse_node(val))
        elif field == 2:
            g["name"] = val.decode("utf-8")
        elif field == 5:
            t = parse_tensor(val)
            g["initializers"][t["name"]] = t["array"]
        elif field == 11:
            g["inputs"].append(_parse_value_info(val))
        elif field == 12:
            g["outputs"].append(_parse_value_info(val))
    return g


def parse_model(data: bytes) -> Dict[str, Any]:
    """ModelProto bytes -> {'graph', 'ir_version', 'opset'}."""
    model = {"graph": None, "ir_version": None, "opset": None}
    for field, wt, val in _fields(data):
        if field == 1:
            model["ir_version"] = val
        elif field == 7:
            model["graph"] = parse_graph(val)
        elif field == 8:
            for f2, _, v2 in _fields(val):
                if f2 == 2:
                    model["opset"] = _signed(v2)
    if model["graph"] is None:
        raise ValueError("no GraphProto found — not an ONNX model?")
    return model


def load_model(path) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return parse_model(f.read())


# --------------------------------------------------------------- wire writer
# Enough of a writer to synthesize test models (and document the format by
# construction). Mirrors the reader's field numbers.
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & ((1 << 64) - 1))


def write_tensor(name: str, arr: np.ndarray) -> bytes:
    shape = np.shape(arr)  # before ascontiguousarray, which promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    code = DTYPE_CODES[arr.dtype]
    out = b"".join(_int_field(1, int(d)) for d in shape)
    out += _int_field(2, code)
    out += _len_field(8, name.encode("utf-8"))
    out += _len_field(9, arr.tobytes())
    return out


def _write_attr(name: str, value: Any) -> bytes:
    out = _len_field(1, name.encode("utf-8"))
    if isinstance(value, bool):
        out += _int_field(3, int(value)) + _int_field(20, 2)
    elif isinstance(value, int):
        out += _int_field(3, value & ((1 << 64) - 1)) + _int_field(20, 2)
    elif isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _int_field(20, 1)
    elif isinstance(value, (str, bytes)):
        b = value.encode("utf-8") if isinstance(value, str) else value
        out += _len_field(4, b) + _int_field(20, 3)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, write_tensor("", value)) + _int_field(20, 4)
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        out += _len_field(7, struct.pack(f"<{len(value)}f", *value))
        out += _int_field(20, 6)
    elif isinstance(value, (list, tuple)):
        payload = b"".join(_varint(int(v) & ((1 << 64) - 1)) for v in value)
        out += _len_field(8, payload) + _int_field(20, 7)
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return out


def write_node(op_type: str, inputs: List[str], outputs: List[str],
               name: str = "", **attrs) -> bytes:
    out = b"".join(_len_field(1, s.encode("utf-8")) for s in inputs)
    out += b"".join(_len_field(2, s.encode("utf-8")) for s in outputs)
    if name:
        out += _len_field(3, name.encode("utf-8"))
    out += _len_field(4, op_type.encode("utf-8"))
    out += b"".join(_len_field(5, _write_attr(k, v)) for k, v in attrs.items())
    return out


def _write_value_info(name: str, shape: List[Optional[int]],
                      elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        dims += _len_field(1, _int_field(1, int(d)) if d is not None
                           else _len_field(2, b"N"))
    shape_proto = dims
    tensor_type = _int_field(1, elem_type) + _len_field(2, shape_proto)
    type_proto = _len_field(1, tensor_type)
    return _len_field(1, name.encode("utf-8")) + _len_field(2, type_proto)


def write_model(nodes: List[bytes], initializers: Dict[str, np.ndarray],
                inputs: List[Tuple[str, List[Optional[int]]]],
                outputs: List[Tuple[str, List[Optional[int]]]],
                graph_name: str = "g", opset: int = 13) -> bytes:
    g = b"".join(_len_field(1, n) for n in nodes)
    g += _len_field(2, graph_name.encode("utf-8"))
    g += b"".join(_len_field(5, write_tensor(k, v))
                  for k, v in initializers.items())
    g += b"".join(_len_field(11, _write_value_info(n, s)) for n, s in inputs)
    g += b"".join(_len_field(12, _write_value_info(n, s)) for n, s in outputs)
    opset_proto = _len_field(1, b"") + _int_field(2, opset)
    return (_int_field(1, 8)            # ir_version
            + _len_field(7, g)          # graph
            + _len_field(8, opset_proto))
