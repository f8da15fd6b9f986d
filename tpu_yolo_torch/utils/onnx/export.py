"""torch.export graph -> ONNX converter (the port's counterpart of
`tpu_yolo/utils/onnx/export.py`, which walks a jaxpr).

The model is copied to the host in f32 with BatchNorm folded, its eval
forward (decode included, no NMS) is exported with `torch.export`,
decomposed to core ATen (`run_decompositions()`) and converted node by
node into a stock opset-17 graph, written by wire.py.

Conventions, as in the JAX package's file:
  * The ONNX input is NCHW float32 in [0, 1] ("images"); a Transpose
    feeds the NHWC model. The output is the decoded (B, A, 4+nc) tensor
    ("output"): pixel xywh boxes and class probabilities.
  * Parameters become initializers named by their state-dict key, the
    lifted constants (the anchor grid, the strides) by theirs.
  * Every node whose inputs are all static (parameters, constants,
    literals) is folded with torch on the CPU into a new initializer:
    the DFL's `arange`, casts of weights and the like never become nodes.
  * The symbolic batch is a `torch.export.Dim`. A SymInt becomes
    Shape(images) -> Gather, arithmetic on SymInts i64 Mul/Add, and a
    shape holding one a Concat of static and runtime pieces, so one file
    runs at any batch.
  * The PSA attention op `tpu_yolo_torch::psa_attention` is lowered to
    `attention_plain`'s arithmetic: MatMul(q, kᵀ), Mul(scale), softmax as
    ReduceMax/Sub/Exp/ReduceSum/Div, MatMul with v. The folded conv's
    epilogue `tpu_yolo_torch::bias_act` (in a program traced on the card)
    is Add/Sigmoid/Mul/Add (and a Split for its halves). The nearest 2x
    upsample is Reshape -> Expand -> Reshape. Only ops that both
    packages' interpreters execute are emitted (no Softmax, no Resize),
    so each interpreter runs the other's file.

Supported-op contract: `supported_ops()` is the sorted list of graph
targets with a handler. A graph outside it fails before any bytes are
written, with one error naming every unsupported target; a higher-order
op (`cond`, `while_loop`, `wrap_*`) is itself an unsupported target, and
its body is not searched.
"""
from __future__ import annotations

import operator

import numpy as np
import sympy
import torch
from torch import nn
from torch.export.graph_signature import InputKind

from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.ops import attention_cuda, bias_act_cuda  # noqa: F401  (registers the ops)
from tpu_yolo_torch.ops.anchors import device_anchors
from tpu_yolo_torch.utils.onnx import wire
from tpu_yolo_torch.utils.onnx.wire import (attr_int, attr_ints, node, tensor,
                                            value_info)

aten = torch.ops.aten
_INT64_MAX = 2 ** 63 - 1


class _Graph:
    """Accumulates ONNX nodes/initializers with fresh value names."""

    def __init__(self):
        self.nodes = []
        self.inits = []
        self._n = 0
        self.names = set()      # initializer names

    def fresh(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def add(self, op, inputs, outputs=None, attrs=(), hint=None):
        out = outputs or [self.fresh(hint or op.lower())]
        self.nodes.append(node(op, inputs, out, name=self.fresh("n"),
                               attrs=attrs))
        return out[0]

    def init(self, arr, name=None, hint="c"):
        name = name or self.fresh(hint)
        assert name not in self.names, name
        self.names.add(name)
        self.inits.append(tensor(name, np.asarray(arr)))
        return name

    def const_i64(self, values, hint="i"):
        return self.init(np.asarray(values, np.int64), hint=hint)


def _target_name(target) -> str:
    """A graph target as `supported_ops()` and the errors name it."""
    if isinstance(target, torch._ops.OpOverload):
        return str(target)
    if getattr(target, "__module__", None) == "_operator":
        return f"operator.{target.__name__}"
    return getattr(target, "__name__", str(target))


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _val(n):
    """The example value torch.export recorded for node n."""
    return n.meta.get("val")


def _arg(n, i: int, name: str, default=None):
    """Argument `name` of node n: positional i, a keyword, or the
    schema's default."""
    if len(n.args) > i:
        return n.args[i]
    return n.kwargs.get(name, default)


class _Unsupported(Exception):
    """A node the converter has a handler for, in a form it refuses."""


class _Converter:
    """Walks one decomposed ExportedProgram; `run()` returns the graph
    and the output's ONNX name, or raises NotImplementedError naming
    every unsupported target."""

    def __init__(self, ep: torch.export.ExportedProgram):
        self.ep = ep
        self.g = _Graph()
        self.values = {}       # fx node -> ONNX name, or list of names
        self.consts = {}       # fx node -> static value (tensor on the CPU, scalar, ...)
        self.hints = {}        # fx node -> initializer name of a static tensor
        self.symbols = {}      # sympy symbol -> (ONNX input name, dim)
        self._sym = {}         # sympy expression -> ONNX i64[1] name
        self._shape = {}       # ONNX input name -> its Shape node
        self.missing = {}      # unsupported target -> one node's text
        self.poisoned = set()  # nodes downstream of an unsupported one

    # -- static values -----------------------------------------------------
    def operand(self, a, dtype: torch.dtype | None = None) -> str:
        """ONNX name of an input: a dynamic value, a static tensor
        (materialized once as an initializer, named by its key where it
        has one) or a Python scalar (an initializer of `dtype`)."""
        if isinstance(a, torch.fx.Node):
            if a not in self.consts:
                return self.values[a]
            if a not in self.values:
                v = self.consts[a]
                arr = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v, _np_dtype(dtype)))
                name = self.hints.get(a)
                self.values[a] = self.g.init(
                    arr, name=None if name in self.g.names else name)
            return self.values[a]
        return self.g.init(np.asarray(a, _np_dtype(dtype)), hint="lit")

    def fold(self, n):
        """Evaluate an all-static node on the CPU and record the result."""
        def cpu(kw):
            return {k: (torch.device("cpu") if k == "device" else v)
                    for k, v in kw.items()}
        args = torch.fx.node.map_arg(n.args, lambda a: self.consts[a])
        kwargs = cpu(torch.fx.node.map_arg(n.kwargs, lambda a: self.consts[a]))
        with torch.no_grad():
            self.consts[n] = n.target(*args, **kwargs)
        ins = n.all_input_nodes
        if n.target in _COPIES and ins[0] in self.hints:  # a copy keeps its key
            self.hints[n] = self.hints[ins[0]]

    # -- symbolic sizes ----------------------------------------------------
    def sym(self, expr) -> str:
        """i64[1] ONNX value of a SymInt's expression: an input dimension
        (Shape -> Gather), an integer, or sums and products of those."""
        expr = sympy.sympify(expr)
        if expr in self._sym:
            return self._sym[expr]
        if expr.is_Integer:
            out = self.g.const_i64([int(expr)])
        elif expr.is_Symbol and expr in self.symbols:
            inp, dim = self.symbols[expr]
            if inp not in self._shape:
                self._shape[inp] = self.g.add("Shape", [inp], hint="shp")
            out = self.g.add("Gather", [self._shape[inp], self.g.const_i64([dim])],
                             attrs=[attr_int("axis", 0)], hint="dim")
        elif expr.is_Mul or expr.is_Add:
            op = "Mul" if expr.is_Mul else "Add"
            parts = [self.sym(a) for a in expr.args]
            out = parts[0]
            for p in parts[1:]:
                out = self.g.add(op, [out, p], hint="sym")
        else:
            raise _Unsupported(f"symbolic size {expr}")
        self._sym[expr] = out
        return out

    def shape_operand(self, dims) -> str:
        """i64 shape tensor for Reshape/Expand from ints, SymInts and
        graph nodes of SymInt value: a constant when every entry is
        static, else a Concat of static runs and runtime pieces."""
        pieces = []
        for d in dims:
            if isinstance(d, torch.fx.Node):
                d = self.consts[d] if d in self.consts else _val(d)
            if isinstance(d, torch.SymInt) and d.node.expr.is_Integer:
                d = int(d.node.expr)
            pieces.append(d)
        if all(isinstance(d, int) for d in pieces):
            return self.g.const_i64(pieces, hint="shape")
        parts, run = [], []
        for d in pieces:
            if isinstance(d, int):
                run.append(d)
                continue
            if run:
                parts.append(self.g.const_i64(run))
                run = []
            parts.append(self.sym(d.node.expr))
        if run:
            parts.append(self.g.const_i64(run))
        if len(parts) == 1:
            return parts[0]
        return self.g.add("Concat", parts, attrs=[attr_int("axis", 0)],
                          hint="dynshape")

    def dim_param(self, d):
        """A value_info dim: an int, or the symbol's name ("batch")."""
        if isinstance(d, torch.SymInt):
            expr = d.node.expr
            if expr.is_Integer:
                return int(expr)
            return str(expr.subs({s: sympy.Symbol("batch") for s in self.symbols}))
        return int(d)

    # -- the walk ----------------------------------------------------------
    def run(self):
        sig = self.ep.graph_signature
        kinds = {s.arg.name: s for s in sig.input_specs}
        for n in self.ep.graph.nodes:
            if n.op == "placeholder":
                spec = kinds[n.name]
                if spec.kind == InputKind.USER_INPUT:
                    self.values[n] = "images"
                    for dim, d in enumerate(_val(n).shape):
                        if isinstance(d, torch.SymInt) and d.node.expr.is_Symbol:
                            self.symbols.setdefault(d.node.expr, ("images", dim))
                elif spec.kind in (InputKind.PARAMETER, InputKind.BUFFER):
                    self.consts[n] = self.ep.state_dict[spec.target]
                    self.hints[n] = spec.target.removeprefix("model.")
                elif spec.kind == InputKind.CONSTANT_TENSOR:
                    self.consts[n] = self.ep.constants[spec.target]
                    self.hints[n] = spec.target.removeprefix("model.")
                else:
                    self.missing.setdefault(f"input of kind {spec.kind.name}",
                                            n.format_node())
                    self.poisoned.add(n)
            elif n.op == "get_attr":
                self.consts[n] = getattr(self.ep.graph_module, n.target)
            elif n.op == "call_function":
                self.call(n)
            elif n.op == "output":
                (out,) = n.args[0]
                return out
        raise ValueError("graph without an output")

    def call(self, n):
        target = n.target
        ins = n.all_input_nodes
        hop = isinstance(target, torch._ops.HigherOrderOperator)
        if not hop and all(a in self.consts for a in ins):
            self.fold(n)
            return
        handler = _HANDLERS.get(target)
        label = _target_name(target)
        refusal = None
        if handler is not None and not hop:
            refusal = _REFUSALS.get(target, lambda c, n: None)(self, n)
        if handler is None or hop or refusal:
            self.missing.setdefault(label + (f" ({refusal})" if refusal else ""),
                                    n.format_node())
            self.poisoned.add(n)
            return
        if any(a in self.poisoned for a in ins):
            self.poisoned.add(n)
            return
        try:
            handler(self, n)
        except _Unsupported as e:
            self.missing.setdefault(f"{label} ({e})", n.format_node())
            self.poisoned.add(n)

    # -- handlers ----------------------------------------------------------
    def _binary(self, n, op):
        dtype = _val(n).dtype
        a, b = (self.operand(x, dtype) for x in n.args[:2])
        self.values[n] = self.g.add(op, [a, b])

    def _unary(self, n, op):
        self.values[n] = self.g.add(op, [self.operand(n.args[0])])

    def _alias(self, n):
        self.values[n] = self.operand(n.args[0])

    def _nothing(self, n):
        pass

    def _symint(self, n):
        self.values[n] = self.sym(_val(n).node.expr)

    def _getitem(self, n):
        src, i = n.args
        self.values[n] = self.values[src][i]

    def _rank_axis(self, n, dim):
        rank = len(_val(n.args[0]).shape)
        return dim % rank if rank else 0

    def _channel_bias(self, b) -> str:
        """A per-channel bias as a (C, 1, 1) operand: an initializer where
        it is static, else a Reshape."""
        if b in self.consts:
            name = self.hints.get(b)
            return self.g.init(self.consts[b].detach().cpu().numpy()[:, None, None],
                               name=None if name in self.g.names else name)
        return self.g.add("Reshape", [self.operand(b), self.g.const_i64([-1, 1, 1])],
                          hint="rs")

    def _convolution(self, n):
        """Conv, and the bias as an Add of a (C, 1, 1) initializer (both
        interpreters read Conv's first two inputs only)."""
        x, w, b, stride, padding, dilation, _, _, groups = n.args
        ph, pw = padding
        y = self.g.add("Conv", [self.operand(x), self.operand(w)], attrs=[
            attr_ints("strides", stride), attr_ints("pads", [ph, pw, ph, pw]),
            attr_ints("dilations", dilation), attr_int("group", groups)],
            hint="conv")
        if b is not None:
            y = self.g.add("Add", [y, self._channel_bias(b)])
        self.values[n] = y

    def _bias_act(self, n):
        """The folded conv's epilogue, `bias_act_plain`'s arithmetic: Add
        of the (C, 1, 1) bias, SiLU as Mul(v, Sigmoid(v)), Add of the
        residual; with `halves`, a Split of the channels in two."""
        y, b, act, residual, halves = n.args[:5]
        if _arg(n, 5, "scale") is not None:
            raise NotImplementedError("ONNX export: YOLO12's layer-scaled epilogue has no "
                                      "handler")
        g = self.g
        v = g.add("Add", [self.operand(y), self._channel_bias(b)])
        if act == "silu":
            v = g.add("Mul", [v, g.add("Sigmoid", [v])])
        if residual is not None:
            v = g.add("Add", [self.operand(residual), v])
        if not halves:
            self.values[n] = [v]
            return
        half = _val(y).shape[1] // 2
        outs = [g.fresh("sp"), g.fresh("sp")]
        g.add("Split", [v, g.const_i64([half, half])], outputs=outs,
              attrs=[attr_int("axis", 1)])
        self.values[n] = outs

    def _max_pool(self, n):
        x, kernel = n.args[:2]
        stride = _arg(n, 2, "stride") or kernel
        padding = list(_arg(n, 3, "padding", [0]))
        ph, pw = (padding * 2) if len(padding) == 1 else padding
        y = self.g.add("MaxPool", [self.operand(x)], attrs=[
            attr_ints("kernel_shape", kernel), attr_ints("strides", stride),
            attr_ints("pads", [ph, pw, ph, pw])], hint="pool")
        self.values[n] = [y, None]   # the indices are never read (_REFUSALS)

    def _cat(self, n):
        tensors, dim = n.args[0], _arg(n, 1, "dim", 0)
        rank = len(_val(n).shape)
        self.values[n] = self.g.add(
            "Concat", [self.operand(t) for t in tensors],
            attrs=[attr_int("axis", dim % rank)], hint="cat")

    def _split(self, n):
        x, sizes = n.args[:2]
        axis = self._rank_axis(n, _arg(n, 2, "dim", 0))
        outs = [self.g.fresh("sp") for _ in sizes]
        self.g.add("Split", [self.operand(x), self.g.const_i64(sizes)],
                   outputs=outs, attrs=[attr_int("axis", axis)])
        self.values[n] = outs

    def _view(self, n):
        x, shape = n.args
        self.values[n] = self.g.add(
            "Reshape", [self.operand(x), self.shape_operand(shape)], hint="rs")

    def _permute(self, n):
        x, perm = n.args
        rank = len(perm)
        self.values[n] = self.g.add(
            "Transpose", [self.operand(x)],
            attrs=[attr_ints("perm", [p % rank for p in perm])], hint="tr")

    def _slice(self, n):
        x, dim = n.args[0], _arg(n, 1, "dim", 0)
        start, end, step = (_arg(n, 2, "start"), _arg(n, 3, "end"),
                            _arg(n, 4, "step", 1))
        if any(isinstance(v, torch.fx.Node) for v in (start, end, step)):
            raise _Unsupported("symbolic bounds")
        axis = self._rank_axis(n, dim)
        size = _val(x).shape[axis]
        start = start or 0
        if end is None or (isinstance(size, int) and end >= size):
            end = size if isinstance(size, int) else _INT64_MAX
        self.values[n] = self.g.add("Slice", [
            self.operand(x), self.g.const_i64([start]), self.g.const_i64([end]),
            self.g.const_i64([axis]), self.g.const_i64([step or 1])], hint="sl")

    def _axes(self, n, dims):
        rank = len(_val(n.args[0]).shape)
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            return list(range(rank))
        dims = [dims] if isinstance(dims, int) else dims
        return [d % rank for d in dims]

    def _amax(self, n):
        x, dims, keep = n.args[0], _arg(n, 1, "dim", []), _arg(n, 2, "keepdim", False)
        self.values[n] = self.g.add("ReduceMax", [self.operand(x)], attrs=[
            attr_ints("axes", self._axes(n, dims)), attr_int("keepdims", int(keep))],
            hint="rmax")

    def _sum(self, n):
        x, dims, keep = n.args[0], _arg(n, 1, "dim"), _arg(n, 2, "keepdim", False)
        self.values[n] = self.g.add(
            "ReduceSum", [self.operand(x), self.g.const_i64(self._axes(n, dims))],
            attrs=[attr_int("keepdims", int(keep))], hint="rsum")

    def _upsample_nearest(self, n):
        """(N, C, H, W) -> (N, C, sH, sW) at integer scales: Reshape to
        (N, C, H, 1, W, 1), Expand to (N, C, H, s, W, s), Reshape."""
        x = n.args[0]
        bsz, ch, h, w = _val(x).shape
        oh, ow = _val(n).shape[2:]
        sh, sw = int(oh) // int(h), int(ow) // int(w)
        y = self.g.add("Reshape", [self.operand(x),
                                   self.shape_operand([bsz, ch, h, 1, w, 1])], hint="rs")
        y = self.g.add("Expand", [y, self.shape_operand([bsz, ch, h, sh, w, sw])],
                       hint="ex")
        self.values[n] = self.g.add("Reshape", [y, self.shape_operand(_val(n).shape)],
                                    hint="rs")

    def _constant_pad(self, n):
        x, pad, value = n.args[0], n.args[1], _arg(n, 2, "value", 0.0)
        rank = len(_val(x).shape)
        begins, ends = [0] * rank, [0] * rank
        for i in range(len(pad) // 2):   # pairs from the last dim backwards
            begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
        self.values[n] = self.g.add("Pad", [
            self.operand(x), self.g.const_i64(begins + ends),
            self.operand(value, _val(n).dtype)], hint="pad")

    def _attention(self, n):
        """softmax(q·kᵀ·scale)·v in f32, attention_plain's arithmetic."""
        q, k, v, scale = n.args
        g = self.g
        kt = g.add("Transpose", [self.operand(k)], attrs=[attr_ints("perm", [0, 2, 1])],
                   hint="tr")
        s = g.add("MatMul", [self.operand(q), kt], hint="mm")
        s = g.add("Mul", [s, self.operand(scale, _val(n).dtype)])
        m = g.add("ReduceMax", [s], attrs=[attr_ints("axes", [2]),
                                            attr_int("keepdims", 1)], hint="rmax")
        e = g.add("Exp", [g.add("Sub", [s, m])])
        z = g.add("ReduceSum", [e, g.const_i64([2])], attrs=[attr_int("keepdims", 1)],
                  hint="rsum")
        p = g.add("Div", [e, z])
        self.values[n] = g.add("MatMul", [p, self.operand(v)], hint="mm")


def _refuse_conv(c, n):
    if n.args[6]:
        return "transposed=True"
    return None


def _refuse_pool(c, n):
    if any(u.target is not operator.getitem or u.args[1] != 0 for u in n.users):
        return "its indices are used"
    dilation, ceil = _arg(n, 4, "dilation", [1]), _arg(n, 5, "ceil_mode", False)
    if ceil or any(d != 1 for d in dilation):
        return "ceil_mode or dilation"
    return None


def _refuse_alpha(c, n):
    return "alpha" if n.kwargs.get("alpha", 1) != 1 else None


def _refuse_upsample(c, n):
    shape_in, shape_out = _val(n.args[0]).shape, _val(n).shape
    try:
        ok = all(int(o) % int(i) == 0 for i, o in zip(shape_in[2:], shape_out[2:]))
    except TypeError:   # symbolic spatial size
        ok = False
    return None if ok else "non-integer or symbolic scale"


def _refuse_pad(c, n):
    return "negative pad" if any(p < 0 for p in n.args[1]) else None


def _refuse_float(c, n):
    """A custom op at any dtype but f32, read from its first input."""
    dtype = _val(n.args[0]).dtype
    return None if dtype == torch.float32 else f"dtype {dtype}"


_COPIES = (aten.clone.default, aten.alias.default, aten._to_copy.default)
_H = _Converter
_HANDLERS = {
    aten.convolution.default: _H._convolution,
    aten.add.Tensor: lambda c, n: c._binary(n, "Add"),
    aten.sub.Tensor: lambda c, n: c._binary(n, "Sub"),
    aten.mul.Tensor: lambda c, n: c._binary(n, "Mul"),
    aten.div.Tensor: lambda c, n: c._binary(n, "Div"),
    aten.sigmoid.default: lambda c, n: c._unary(n, "Sigmoid"),
    aten.exp.default: lambda c, n: c._unary(n, "Exp"),
    aten.cat.default: _H._cat,
    aten.split_with_sizes.default: _H._split,
    aten.view.default: _H._view,
    aten.permute.default: _H._permute,
    aten.clone.default: _H._alias,
    aten.alias.default: _H._alias,
    aten.slice.Tensor: _H._slice,
    aten.amax.default: _H._amax,
    aten.sum.dim_IntList: _H._sum,
    aten.max_pool2d_with_indices.default: _H._max_pool,
    aten.upsample_nearest2d.vec: _H._upsample_nearest,
    aten.constant_pad_nd.default: _H._constant_pad,
    aten._assert_tensor_metadata.default: _H._nothing,
    aten.sym_size.int: _H._symint,
    operator.mul: _H._symint,
    operator.add: _H._symint,
    operator.getitem: _H._getitem,
    torch.ops.tpu_yolo_torch.psa_attention.default: _H._attention,
    torch.ops.tpu_yolo_torch.bias_act.default: _H._bias_act,
}
_REFUSALS = {
    aten.convolution.default: _refuse_conv,
    aten.max_pool2d_with_indices.default: _refuse_pool,
    aten.add.Tensor: _refuse_alpha,
    aten.sub.Tensor: _refuse_alpha,
    aten.upsample_nearest2d.vec: _refuse_upsample,
    aten.constant_pad_nd.default: _refuse_pad,
    torch.ops.tpu_yolo_torch.psa_attention.default: _refuse_float,
    torch.ops.tpu_yolo_torch.bias_act.default: _refuse_float,
}


def supported_ops() -> list[str]:
    """The export contract: the sorted graph targets (core ATen ops after
    `run_decompositions()`, SymInt arithmetic, `getitem`, the PSA
    attention op and the conv epilogue's) that the converter maps to ONNX
    nodes. Any node whose
    inputs are all static folds away whatever its target."""
    return sorted(_target_name(t) for t in _HANDLERS)


def convert(ep: torch.export.ExportedProgram):
    """(converter, output value name, output fx node) of a decomposed
    program with one user input ("images") and one output; raises
    NotImplementedError naming every unsupported target before anything
    is written. Initializers keep their keys, less _OnnxForward's
    "model." prefix."""
    conv = _Converter(ep)
    out = conv.run()
    if conv.missing:
        detail = "\n".join(f"  {k}: {v[:200]}" for k, v in sorted(conv.missing.items()))
        raise NotImplementedError(
            f"ONNX export: {len(conv.missing)} unsupported target(s) in the "
            f"graph:\n{detail}")
    return conv, conv.operand(out), out


class _OnnxForward(nn.Module):
    """NCHW f32 images in [0, 1] -> the model's decoded eval forward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        return self.model(images.permute(0, 2, 3, 1))


def _host_f32_copy(model, cfg: ModelConfig):
    """A new f32 model on the host, BatchNorm folded, from `model` (a
    YOLO or a state dict, folded or not, on any device); the caller's
    model is left as it is."""
    from tpu_yolo_torch.models.yolov11 import YOLO

    state = model.state_dict() if isinstance(model, nn.Module) else model
    if any(k.endswith(".w_q") for k in state):
        raise ValueError("export_onnx: an int8 model; export its float weights")
    state = {k: v.detach().to("cpu", torch.float32) for k, v in state.items()}
    return YOLO.from_state_dict(cfg, state).fold_batchnorm().eval()


def export_onnx(model, cfg: ModelConfig, input_size: int, path: str,
                batch: int = 1, dynamic_batch: bool = True) -> dict:
    """Export the BN-folded f32 eval forward of `model` (a YOLO or its
    state dict, on any device; decode included, no NMS) to an ONNX file
    at `path`. Input "images": (batch, 3, S, S) f32 in [0, 1]; output
    "output": (batch, A, 4+nc) pixel xywh + class probabilities. Returns
    the metadata dict of the JAX package's export_onnx.

    dynamic_batch=True (the default) gives the batch axis as a dim_param
    and rebuilds every batch-dependent shape at run time from
    Shape(images), so one file serves any batch; `batch` then only
    matters for dynamic_batch=False."""
    module = _OnnxForward(_host_f32_copy(model, cfg))
    # the anchor grid is a constant of the graph: made here, outside the
    # trace, so that the cache keeps a real tensor
    device_anchors((input_size, input_size), tuple(cfg.strides), torch.device("cpu"))
    example = torch.zeros((2 if dynamic_batch else batch, 3, input_size, input_size))
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if dynamic_batch else None
    with torch.no_grad():
        ep = torch.export.export(module, (example,), dynamic_shapes=dynamic,
                                 strict=False).run_decompositions()
    conv, out_name, out = convert(ep)
    conv.g.add("Identity", [out_name], outputs=["output"])

    out_dims = [conv.dim_param(d) for d in _val(out).shape]
    in_dims = (["batch", 3, input_size, input_size] if dynamic_batch
               else [batch, 3, input_size, input_size])
    g = wire.graph("tpu_yolo_torch", conv.g.nodes,
                   inputs=[value_info("images", wire.F32, in_dims)],
                   outputs=[value_info("output", wire.F32, out_dims)],
                   initializers=conv.g.inits)
    blob = wire.model(g, producer="tpu-yolo-torch")
    with open(path, "wb") as f:
        f.write(blob)
    return {
        "path": path, "bytes": len(blob), "opset": 17,
        "input": f"float32[{','.join(str(d) for d in in_dims)}]",
        "output": f"float32{out_dims}",
        "nodes": len(conv.g.nodes), "initializers": len(conv.g.inits),
    }
