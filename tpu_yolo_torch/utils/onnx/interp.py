"""Reference interpreter for the emitted ONNX op subset (the port's
copy of `tpu_yolo/utils/onnx/interp.py`; the same op set, nothing more).

Executes a parse.Graph in numpy following each op's ONNX-spec
semantics (NCHW Conv/MaxPool, pads = [begin..., end...], numpy-style
broadcasting). Conv and MaxPool run in torch on the CPU in f32
(`F.conv2d`, `F.max_pool2d` behind an explicit pad) but read their
configuration strictly from the parsed ONNX attributes: what is
validated is the file, its serialization, graph topology and attribute
semantics. Tests check bytes -> parse -> run against the model's
forward; on a machine with onnxruntime the same file runs there too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_yolo_torch.utils.onnx.parse import Graph


def _explicit_pads(x, pads, value):
    """x padded by ONNX [top, left, bottom, right] pads with `value`."""
    pt, pl, pb, pr = pads
    if not (pt or pl or pb or pr):
        return x
    return F.pad(x, (pl, pr, pt, pb), value=value)


def _f32(a) -> torch.Tensor:
    """A C-contiguous, writable f32 copy of `a` where it is not one
    already (initializers are views of the file's bytes)."""
    return torch.from_numpy(np.require(a, np.float32, ["C", "W"]))


def _conv(x, w, attrs):
    x = _explicit_pads(_f32(x), attrs.get("pads", [0, 0, 0, 0]), 0.0)
    out = F.conv2d(x, _f32(w), stride=attrs.get("strides", [1, 1]),
                   dilation=attrs.get("dilations", [1, 1]),
                   groups=attrs.get("group", 1))
    return out.numpy()


def _maxpool(x, attrs):
    x = _explicit_pads(_f32(x), attrs.get("pads", [0, 0, 0, 0]), float("-inf"))
    out = F.max_pool2d(x, attrs["kernel_shape"], stride=attrs.get("strides", [1, 1]))
    return out.numpy()


def _slice(env, n):
    x = env[n.inputs[0]]
    starts, ends = env[n.inputs[1]], env[n.inputs[2]]
    axes = (env[n.inputs[3]] if len(n.inputs) > 3
            else np.arange(len(starts)))
    steps = (env[n.inputs[4]] if len(n.inputs) > 4
             else np.ones(len(starts), np.int64))
    idx = [slice(None)] * x.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        lim = x.shape[a]
        s, e = int(s), int(e)
        # ONNX clamps out-of-range starts/ends
        e = None if (st < 0 and e < -lim) else e
        idx[int(a)] = slice(s, e, int(st))
    return x[tuple(idx)]


_ELEM = {
    "Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
    "Div": np.divide, "Max": np.maximum, "Min": np.minimum,
    "Pow": np.power, "Equal": np.equal, "Less": np.less,
    "Greater": np.greater, "GreaterOrEqual": np.greater_equal,
    "LessOrEqual": np.less_equal, "And": np.logical_and,
    "Or": np.logical_or,
}
_UNARY = {
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "Tanh": np.tanh, "Exp": np.exp, "Log": np.log, "Neg": np.negative,
    "Sqrt": np.sqrt, "Reciprocal": np.reciprocal, "Abs": np.abs,
    "Floor": np.floor, "Sign": np.sign, "Not": np.logical_not,
    "Identity": lambda x: x,
}
# ONNX dtype enum -> numpy, for Cast
_CAST = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
         7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def run_graph(g: Graph, feeds: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    env = dict(g.initializers)
    env.update(feeds)
    for n in g.nodes:
        i = [env[x] for x in n.inputs]
        t = n.op_type
        if t in _ELEM:
            out = _ELEM[t](i[0], i[1])
        elif t in _UNARY:
            out = _UNARY[t](i[0])
        elif t == "Conv":
            out = _conv(i[0], i[1], n.attrs)
        elif t == "MaxPool":
            out = _maxpool(i[0], n.attrs)
        elif t == "MatMul":
            out = np.matmul(i[0], i[1])
        elif t == "Transpose":
            out = np.transpose(i[0], n.attrs["perm"])
        elif t == "Reshape":
            out = i[0].reshape([int(d) for d in i[1]])
        elif t == "Expand":
            out = np.broadcast_to(
                i[0], np.broadcast_shapes(i[0].shape,
                                          tuple(int(d) for d in i[1])))
        elif t == "Concat":
            out = np.concatenate(i, axis=n.attrs["axis"])
        elif t == "Slice":
            out = _slice(env, n)
        elif t == "Where":
            out = np.where(i[0], i[1], i[2])
        elif t == "Cast":
            out = i[0].astype(_CAST[n.attrs["to"]])
        elif t == "ReduceSum":
            axes = tuple(int(a) for a in i[1])
            out = i[0].sum(axis=axes,
                           keepdims=bool(n.attrs.get("keepdims", 1)))
        elif t == "ReduceMax":
            out = i[0].max(axis=tuple(n.attrs["axes"]),
                           keepdims=bool(n.attrs.get("keepdims", 1)))
        elif t == "ReduceMin":
            out = i[0].min(axis=tuple(n.attrs["axes"]),
                           keepdims=bool(n.attrs.get("keepdims", 1)))
        elif t == "Split":
            sizes = [int(s) for s in i[1]]
            pieces = np.split(i[0], np.cumsum(sizes)[:-1],
                              axis=n.attrs["axis"])
            for name, piece in zip(n.outputs, pieces):
                env[name] = piece
            continue
        elif t == "Shape":
            out = np.asarray(i[0].shape, np.int64)
        elif t == "Gather":
            out = np.take(i[0], i[1].astype(np.int64),
                          axis=n.attrs.get("axis", 0))
        elif t == "Pad":
            pads = [int(p) for p in i[1]]
            k = len(pads) // 2
            out = np.pad(i[0], list(zip(pads[:k], pads[k:])),
                         constant_values=i[2] if len(i) > 2 else 0)
        else:
            raise NotImplementedError(f"interp: op {t}")
        env[n.outputs[0]] = np.asarray(out)
    return {o: env[o] for o in g.outputs}
