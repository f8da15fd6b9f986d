"""Protobuf wire-format parser for the emitted ONNX subset (the port's
copy of `tpu_yolo/utils/onnx/parse.py`).

Independent of wire.py's writer state (it decodes raw bytes per the
protobuf encoding spec), so round-trip tests exercise real
serialization: file bytes -> messages -> numpy. Field numbers are the
public onnx.proto schema, the same contract onnx.load uses.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

ONNX_TO_NP = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    9: np.bool_, 10: np.float16, 11: np.float64,
}


def _read_varint(buf, i):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) triples."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wt == 1:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"wire type {wt}")
        yield fnum, wt, v


def _packed_i64(buf):
    out, i = [], 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        if v >= 1 << 63:
            v -= 1 << 64
        out.append(v)
    return out


def _tensor(buf) -> tuple[str, np.ndarray]:
    dims, dt, name, raw = [], 1, "", b""
    for f, wt, v in _fields(buf):
        if f == 1:
            dims += _packed_i64(v) if wt == 2 else [v]
        elif f == 2:
            dt = v
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
    arr = np.frombuffer(raw, dtype=ONNX_TO_NP[dt]).reshape(dims)
    return name, arr


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


def _attr(buf):
    name, typ, val = "", None, None
    fields = dict()
    for f, wt, v in _fields(buf):
        fields.setdefault(f, []).append((wt, v))
    name = fields[1][0][1].decode()
    typ = fields[20][0][1]
    if typ == 1:                      # FLOAT
        val = fields[2][0][1]
    elif typ == 2:                    # INT
        v = fields[3][0][1]
        val = v - (1 << 64) if v >= 1 << 63 else v
    elif typ == 3:                    # STRING
        val = fields[4][0][1].decode()
    elif typ == 4:                    # TENSOR
        val = _tensor(fields[5][0][1])[1]
    elif typ == 7:                    # INTS
        val = []
        for wt, v in fields.get(8, []):
            val += _packed_i64(v) if wt == 2 else [v]
    else:
        raise ValueError(f"attr type {typ}")
    return name, val


def _node(buf) -> Node:
    n = Node()
    for f, wt, v in _fields(buf):
        if f == 1:
            n.inputs.append(v.decode())
        elif f == 2:
            n.outputs.append(v.decode())
        elif f == 3:
            n.name = v.decode()
        elif f == 4:
            n.op_type = v.decode()
        elif f == 5:
            k, av = _attr(v)
            n.attrs[k] = av
    return n


@dataclass
class Graph:
    nodes: list
    initializers: dict
    inputs: list
    outputs: list


def _value_info_name(buf) -> str:
    for f, _, v in _fields(buf):
        if f == 1:
            return v.decode()
    return ""


def parse_model(blob: bytes) -> tuple[Graph, dict]:
    meta = {}
    gbuf = None
    for f, _, v in _fields(blob):
        if f == 1:
            meta["ir_version"] = v
        elif f == 2:
            meta["producer"] = v.decode()
        elif f == 7:
            gbuf = v
        elif f == 8:
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    meta["opset"] = v2
    nodes, inits, ins, outs = [], {}, [], []
    for f, _, v in _fields(gbuf):
        if f == 1:
            nodes.append(_node(v))
        elif f == 5:
            name, arr = _tensor(v)
            inits[name] = arr
        elif f == 11:
            ins.append(_value_info_name(v))
        elif f == 12:
            outs.append(_value_info_name(v))
    return Graph(nodes, inits, ins, outs), meta
