"""Minimal protobuf wire-format writer + the ONNX message subset (the
port's copy of `tpu_yolo/utils/onnx/wire.py`: the same calls write the
same bytes).

Implements just enough of protobuf serialization (varint / length-
delimited / 32-bit fields; see the protobuf encoding spec) to emit a
valid ONNX ModelProto, with field numbers taken from the public
onnx.proto schema. Files written here parse with stock `onnx.load` /
onnxruntime unchanged; neither package is needed to write them.

Messages are modeled as plain classes collecting (field_number,
wire_value) pairs; `bytes(msg)` serializes. Only the fields the
exporter uses are modeled.
"""
from __future__ import annotations

import struct

import numpy as np

# ONNX TensorProto.DataType values (onnx.proto)
F32, U8, I8, U16, I16, I32, I64, STR, BOOL, F16, F64, U32, U64 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)
BF16 = 16

NP_TO_ONNX = {
    np.dtype(np.float32): F32, np.dtype(np.uint8): U8,
    np.dtype(np.int8): I8, np.dtype(np.int32): I32,
    np.dtype(np.int64): I64, np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): F16, np.dtype(np.float64): F64,
}


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # protobuf encodes negative int64 as 10-byte varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


class Msg:
    """A protobuf message under construction."""

    def __init__(self):
        self._buf = bytearray()

    def uint(self, field: int, value: int):
        self._buf += _tag(field, 0) + _varint(int(value))
        return self

    def float32(self, field: int, value: float):
        self._buf += _tag(field, 5) + struct.pack("<f", float(value))
        return self

    def bytes_(self, field: int, value: bytes):
        self._buf += _tag(field, 2) + _varint(len(value)) + value
        return self

    def string(self, field: int, value: str):
        return self.bytes_(field, value.encode("utf-8"))

    def msg(self, field: int, value: "Msg"):
        return self.bytes_(field, bytes(value))

    def packed_ints(self, field: int, values):
        payload = b"".join(_varint(int(v)) for v in values)
        return self.bytes_(field, payload)

    def __bytes__(self):
        return bytes(self._buf)


# -- ONNX messages ---------------------------------------------------------

def tensor(name: str, arr: np.ndarray) -> Msg:
    """TensorProto with raw_data payload (little-endian, C order)."""
    arr = np.ascontiguousarray(arr)
    dt = NP_TO_ONNX[arr.dtype]
    m = Msg()
    m.packed_ints(1, arr.shape)          # dims
    m.uint(2, dt)                        # data_type
    m.string(8, name)                    # name
    m.bytes_(9, arr.tobytes())           # raw_data
    return m


def attr_int(name: str, v: int) -> Msg:
    return Msg().string(1, name).uint(3, v).uint(20, 2)          # INT

def attr_float(name: str, v: float) -> Msg:
    return Msg().string(1, name).float32(2, v).uint(20, 1)       # FLOAT

def attr_ints(name: str, vs) -> Msg:
    return Msg().string(1, name).packed_ints(8, vs).uint(20, 7)  # INTS

def attr_string(name: str, v: str) -> Msg:
    return Msg().string(1, name).string(4, v).uint(20, 3)        # STRING

def attr_tensor(name: str, t: Msg) -> Msg:
    return Msg().string(1, name).msg(5, t).uint(20, 4)           # TENSOR


def node(op_type: str, inputs, outputs, name: str = "", attrs=()) -> Msg:
    m = Msg()
    for i in inputs:
        m.string(1, i)
    for o in outputs:
        m.string(2, o)
    if name:
        m.string(3, name)
    m.string(4, op_type)
    for a in attrs:
        m.msg(5, a)
    return m


def value_info(name: str, elem_type: int, shape) -> Msg:
    shp = Msg()
    for d in shape:
        dim = Msg()
        if isinstance(d, str):
            dim.string(2, d)             # dim_param (symbolic)
        else:
            dim.uint(1, int(d))          # dim_value
        shp.msg(1, dim)
    tt = Msg().uint(1, elem_type).msg(2, shp)   # TypeProto.Tensor
    tp = Msg().msg(1, tt)                        # TypeProto.tensor_type
    return Msg().string(1, name).msg(2, tp)


def graph(name: str, nodes, inputs, outputs, initializers) -> Msg:
    m = Msg()
    for n in nodes:
        m.msg(1, n)
    m.string(2, name)
    for t in initializers:
        m.msg(5, t)
    for vi in inputs:
        m.msg(11, vi)
    for vi in outputs:
        m.msg(12, vi)
    return m


def model(g: Msg, opset: int = 17, ir_version: int = 8,
          producer: str = "tpu-yolo") -> bytes:
    op = Msg().string(1, "").uint(2, opset)      # OperatorSetIdProto
    m = Msg()
    m.uint(1, ir_version)
    m.string(2, producer)
    m.string(3, "1.0")
    m.msg(7, g)
    m.msg(8, op)
    return bytes(m)
