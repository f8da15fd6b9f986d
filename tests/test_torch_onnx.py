"""The port's ONNX export (tpu_yolo_torch/utils/onnx) against tpu_yolo's
on the CPU: file bytes -> the port's wire parser -> its numpy
interpreter, against `tpu_yolo.models.yolov11.forward` at the JAX
package's tolerances (tests/test_onnx_export.py: 2e-4, 3e-4 with
attention and at 1280 px); each package's interpreter on the other's
file; the symbolic batch; folding; the supported-op contract and its
one error; and the writer's bytes against JAX's writer's."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxModelConfig
from tpu_yolo.core.config import get_model_config as jax_get_model_config
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.utils.onnx import export_onnx as jax_export_onnx
from tpu_yolo.utils.onnx import wire as jax_wire
from tpu_yolo.utils.onnx.interp import run_graph as jax_run_graph
from tpu_yolo.utils.onnx.parse import parse_model as jax_parse_model
from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.utils.onnx import export as onnx_export
from tpu_yolo_torch.utils.onnx import export_onnx, wire
from tpu_yolo_torch.utils.onnx.interp import run_graph
from tpu_yolo_torch.utils.onnx.parse import parse_model

torch.set_num_threads(1)

_TINY = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
             num_classes=3)
TINY, JAX_TINY = ModelConfig(**_TINY), JaxModelConfig(**_TINY)


def _jax_params(jcfg):
    return jax.tree_util.tree_map(np.asarray, jax_yolo.init_params(0, jcfg))


def _jax_forward(params, jcfg, x_nchw):
    """JAX's eval forward of the folded params, jitted (one XLA program
    compiles faster than the eager forward's per-op programs)."""
    fwd = jax.jit(lambda p, x: jax_yolo.forward(p, x, jcfg, train=False))
    return np.asarray(fwd(jax_yolo.fold_batchnorm(params),
                          jnp.transpose(jnp.asarray(x_nchw), (0, 2, 3, 1))))


class _Case:
    """One dynamic-batch file of the port and JAX's forward on `batch`
    seeded images (rows of a smaller batch are the first rows)."""

    def __init__(self, tmp, cfg, jcfg, size, batch, seed):
        self.cfg, self.jcfg, self.size = cfg, jcfg, size
        self.params = _jax_params(jcfg)
        self.path = str(tmp / "model.onnx")
        self.meta = export_onnx(from_jax_params(self.params, cfg), cfg, size, self.path)
        self.graph, self.header = parse_model(open(self.path, "rb").read())
        self.x = np.random.default_rng(seed).random((batch, 3, size, size), np.float32)
        self.want = _jax_forward(self.params, jcfg, self.x)

    def run(self, b, interpreter=run_graph):
        return interpreter(self.graph, {"images": self.x[:b]})["output"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _Case(tmp_path_factory.mktemp("tiny"), TINY, JAX_TINY, 64, 4, 1)


@pytest.fixture(scope="module")
def v11n(tmp_path_factory):
    return _Case(tmp_path_factory.mktemp("v11n"), get_model_config("n", num_classes=4),
                 jax_get_model_config("n", num_classes=4), 96, 3, 2)


def test_roundtrip_tiny(tiny):
    """TINY at 64 px, batch 2: the file's header, a real conv graph, and
    the port's interpreter against JAX's forward at 2e-4."""
    assert tiny.header == {"ir_version": 8, "producer": "tpu-yolo-torch", "opset": 17}
    assert tiny.graph.inputs == ["images"] and tiny.graph.outputs == ["output"]
    assert len(tiny.graph.nodes) == tiny.meta["nodes"]
    assert len(tiny.graph.initializers) == tiny.meta["initializers"]
    assert {"Conv", "Sigmoid", "Concat", "MaxPool", "Split"} <= {
        n.op_type for n in tiny.graph.nodes}
    # parameters keep their state-dict keys, the lifted constants theirs
    assert {"net.p1.0.w", "head.cls.2.4.b"} <= set(tiny.graph.initializers)
    got = tiny.run(2)
    assert got.shape == tiny.want[:2].shape == (2, 84, 7)
    np.testing.assert_allclose(got, tiny.want[:2], rtol=2e-4, atol=2e-4)


def test_roundtrip_tiny_through_the_conv_epilogue_op(tiny, tmp_path, monkeypatch):
    """A folded forward traced through `tpu_yolo_torch::bias_act` (the
    card's path, routed here by the seam): every folded conv's epilogue
    lowered to Add/Sigmoid/Mul/Add, and the file against the model's own
    forward and JAX's at 2e-4."""
    from tpu_yolo_torch.ops import nn as port_nn

    monkeypatch.setattr(port_nn, "epilogue_on_card", lambda x: True)
    target = torch.ops.tpu_yolo_torch.bias_act.default
    lowered = []
    handler = onnx_export._HANDLERS[target]
    monkeypatch.setitem(onnx_export._HANDLERS, target,
                        lambda c, n: (lowered.append(n), handler(c, n)))
    path = str(tmp_path / "epilogue.onnx")
    state = from_jax_params(tiny.params, TINY)
    export_onnx(state, TINY, 64, path)
    graph, _ = parse_model(open(path, "rb").read())
    model = YOLO.from_state_dict(TINY, state).fold_batchnorm().eval()
    assert len(lowered) == sum(isinstance(m, port_nn.ConvBN) for m in model.modules())
    got = run_graph(graph, {"images": tiny.x[:2]})["output"]
    with torch.no_grad():
        own = model(torch.from_numpy(tiny.x[:2]).permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(got, own, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, tiny.want[:2], rtol=2e-4, atol=2e-4)


def test_roundtrip_v11n_96(v11n):
    """The full v11-n graph, PSA attention lowered to MatMul and the
    softmax's ReduceMax/Exp/ReduceSum/Div, batch 1, at 2e-4."""
    ops = [n.op_type for n in v11n.graph.nodes]
    assert ops.count("MatMul") == 2 and "Softmax" not in ops
    np.testing.assert_allclose(v11n.run(1), v11n.want[:1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("case,batches,tol", [("tiny", (1, 4), 2e-4),
                                              ("v11n", (1, 3), 3e-4)])
def test_dynamic_batch_one_file_many_batches(case, batches, tol, request):
    """One file, the batch a dim_param rebuilt from Shape(images), at two
    batches (attention merges the batch with the heads: batch*2)."""
    c = request.getfixturevalue(case)
    assert c.meta["input"] == f"float32[batch,3,{c.size},{c.size}]"
    assert c.meta["output"].startswith("float32['batch', ")
    assert sum(n.op_type == "Shape" for n in c.graph.nodes) == 1
    for b in batches:
        got = c.run(b)
        assert got.shape == c.want[:b].shape
        np.testing.assert_allclose(got, c.want[:b], rtol=tol, atol=tol)


@pytest.mark.parametrize("case,tol", [("tiny", 2e-4), ("v11n", 3e-4)])
def test_jax_interpreter_runs_the_ports_file(case, tol, request):
    """tpu_yolo's own interpreter executes the port's file (every op the
    port emits is in its op set) and agrees with JAX's forward."""
    c = request.getfixturevalue(case)
    np.testing.assert_allclose(c.run(1, jax_run_graph), c.want[:1], rtol=tol, atol=tol)


def test_port_reads_the_jax_file(tiny, tmp_path):
    """The port's parser reads tpu_yolo's file as tpu_yolo's does, and
    the port's interpreter agrees with tpu_yolo's on it."""
    path = str(tmp_path / "jax.onnx")
    jax_export_onnx(tiny.params, JAX_TINY, 64, path)
    blob = open(path, "rb").read()
    ours, header = parse_model(blob)
    theirs, jheader = jax_parse_model(blob)
    assert header == jheader and header["producer"] == "tpu-yolo"
    assert [(n.op_type, n.inputs, n.outputs) for n in ours.nodes] == [
        (n.op_type, n.inputs, n.outputs) for n in theirs.nodes]
    assert ours.initializers.keys() == theirs.initializers.keys()
    feeds = {"images": tiny.x[:2]}
    got = run_graph(ours, feeds)["output"]
    np.testing.assert_allclose(got, jax_run_graph(theirs, feeds)["output"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tiny.want[:2], rtol=2e-4, atol=2e-4)


def test_constants_are_folded(tiny, v11n):
    """The anchor grid, the strides, the DFL's arange and every cast of a
    weight fold into initializers: no Cast or Range node."""
    for c in (tiny, v11n):
        ops = {n.op_type for n in c.graph.nodes}
        assert not ops & {"Cast", "Range", "ConstantOfShape"}


def test_tiny_1280(tmp_path):
    """The high-resolution point (1280 px, 33,600 anchors), dynamic, at 3e-4."""
    c = _Case(tmp_path, TINY, JAX_TINY, 1280, 1, 3)
    assert c.meta["input"] == "float32[batch,3,1280,1280]"
    got = c.run(1)
    assert got.shape == (1, 33600, 7)
    np.testing.assert_allclose(got, c.want, rtol=3e-4, atol=3e-4)


def test_s2d_stem_and_the_callers_model(tmp_path):
    """An unfolded model with the space-to-depth stem exports through
    Reshape/Transpose/Pad and agrees with the port's own forward; the
    caller's model is left as it was (the export folds a host copy)."""
    cfg = TINY
    model = YOLO.from_state_dict(cfg, from_jax_params(_jax_params(JAX_TINY), cfg))
    model.fold_stem_space_to_depth()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "s2d.onnx")
    export_onnx(model, cfg, 64, path)
    after = model.state_dict()
    assert before.keys() == after.keys() and "net.p1.0.gamma" in after
    assert all(torch.equal(before[k], after[k]) for k in before)
    g, _ = parse_model(open(path, "rb").read())
    assert g.initializers["net.p1.0.w"].shape == (8, 12, 2, 2)
    assert "Pad" in {n.op_type for n in g.nodes}
    x = np.random.default_rng(4).random((2, 3, 64, 64), np.float32)
    with torch.no_grad():
        want = model.fold_batchnorm()(torch.from_numpy(x).permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(run_graph(g, {"images": x})["output"], want,
                               rtol=2e-4, atol=2e-4)


def test_static_batch_file(tmp_path):
    """dynamic_batch=False pins the batch: no Shape node, plain dims."""
    path = str(tmp_path / "static.onnx")
    meta = export_onnx(from_jax_params(_jax_params(JAX_TINY), TINY), TINY, 64, path,
                       batch=2, dynamic_batch=False)
    assert meta["input"] == "float32[2,3,64,64]" and meta["output"] == "float32[2, 84, 7]"
    g, _ = parse_model(open(path, "rb").read())
    assert not any(n.op_type == "Shape" for n in g.nodes)
    assert run_graph(g, {"images": np.zeros((2, 3, 64, 64), np.float32)})[
        "output"].shape == (2, 84, 7)


def _convert(module, *example):
    ep = torch.export.export(module, example, strict=False).run_decompositions()
    return onnx_export.convert(ep)


class _Lambda(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def test_error_lists_every_unsupported_target():
    """One error names every unsupported target, not just the first."""
    bad = _Lambda(lambda x: torch.cumsum(torch.sort(x, 0).values, 0))
    with pytest.raises(NotImplementedError) as ei:
        _convert(bad, torch.ones(4, 4))
    msg = str(ei.value)
    assert "2 unsupported target(s)" in msg
    assert "aten.sort.default" in msg and "aten.cumsum.default" in msg


def test_higher_order_op_is_an_unsupported_target():
    """torch.cond is refused as itself; its branches are not searched."""
    def fn(x):
        return torch.cond(x.sum() > 0, lambda y: y.sigmoid(), lambda y: y.exp(), (x,))
    with pytest.raises(NotImplementedError) as ei:
        _convert(_Lambda(fn), torch.ones(2, 3))
    assert "cond" in str(ei.value)


def test_refused_forms_of_handled_targets():
    """A transposed convolution and a max pool whose indices are read
    are refused by name."""
    with pytest.raises(NotImplementedError, match=r"convolution.*transposed=True"):
        _convert(nn.ConvTranspose2d(3, 4, 2, stride=2), torch.ones(1, 3, 8, 8))

    def pool(x):
        y, idx = F.max_pool2d(x, 2, return_indices=True)
        return y + idx.float()
    with pytest.raises(NotImplementedError, match="its indices are used"):
        _convert(_Lambda(pool), torch.ones(1, 3, 8, 8))


def test_unsupported_graph_writes_nothing(tmp_path, monkeypatch):
    """The model's export with one handler taken away fails before any
    bytes are written, naming the target."""
    monkeypatch.delitem(onnx_export._HANDLERS, torch.ops.aten.sigmoid.default)
    path = tmp_path / "m.onnx"
    with pytest.raises(NotImplementedError, match="aten.sigmoid.default"):
        export_onnx(from_jax_params(_jax_params(JAX_TINY), TINY), TINY, 64, str(path))
    assert not path.exists()


def test_int8_model_is_refused():
    state = from_jax_params(_jax_params(JAX_TINY), TINY)
    state["net.p1.0.w_q"] = torch.zeros(1, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        export_onnx(state, TINY, 64, "unused.onnx")


def test_supported_ops_contract():
    ops = onnx_export.supported_ops()
    assert ops == sorted(ops) and len(ops) == len(set(ops)) == 26
    for needed in ("aten.convolution.default", "aten.max_pool2d_with_indices.default",
                   "aten.upsample_nearest2d.vec", "aten.split_with_sizes.default",
                   "aten.view.default", "aten.permute.default", "aten.cat.default",
                   "aten.sigmoid.default", "aten.constant_pad_nd.default",
                   "aten.sym_size.int", "operator.mul", "operator.getitem",
                   "tpu_yolo_torch.psa_attention.default",
                   "tpu_yolo_torch.bias_act.default"):
        assert needed in ops, needed
    emitted = {"Add", "Sub", "Mul", "Div", "Sigmoid", "Exp", "Conv", "MaxPool",
               "MatMul", "Transpose", "Reshape", "Expand", "Concat", "Slice",
               "ReduceSum", "ReduceMax", "Split", "Shape", "Gather", "Pad", "Identity"}
    # every op the converter emits is one both interpreters execute
    import inspect

    from tpu_yolo.utils.onnx import interp as jax_interp
    from tpu_yolo_torch.utils.onnx import interp
    for module in (interp, jax_interp):
        src = inspect.getsource(module)
        assert all(f'"{op}"' in src for op in emitted), module.__name__


def test_wire_bytes_equal_jax():
    """The same calls to the port's writer and tpu_yolo's give the same
    bytes: every message type and field the exporters use."""
    def build(w):
        rng = np.random.default_rng(0)
        inits = [w.tensor("w", rng.random((2, 3, 1, 1), np.float32)),
                 w.tensor("shape", np.asarray([-1, 6], np.int64)),
                 w.tensor("flag", np.asarray([True, False]))]
        nodes = [w.node("Conv", ["x", "w"], ["y"], name="n1",
                        attrs=[w.attr_ints("pads", [0, 0, 0, 0]), w.attr_int("group", 1)]),
                 w.node("Mul", ["y", "y"], ["z"], attrs=[w.attr_float("alpha", 0.5)]),
                 w.node("Reshape", ["z", "shape"], ["out"],
                        attrs=[w.attr_string("mode", "x"),
                               w.attr_tensor("t", w.tensor("c", np.float32(2)))])]
        g = w.graph("g", nodes, inputs=[w.value_info("x", w.F32, ["batch", 3, 4, 4])],
                    outputs=[w.value_info("out", w.F32, ["batch", 6])],
                    initializers=inits)
        return w.model(g)
    blob = build(wire)
    assert blob == build(jax_wire)
    graph, header = parse_model(blob)
    assert header == {"ir_version": 8, "producer": "tpu-yolo", "opset": 17}
    assert [n.op_type for n in graph.nodes] == ["Conv", "Mul", "Reshape"]
    assert graph.nodes[2].attrs["t"] == np.float32(2)


@pytest.mark.slow
@pytest.mark.parametrize("size_key", list("ntsmlx"))
def test_zoo_export_roundtrip_matrix(size_key, tmp_path):
    """Every zoo size at 64 px, dynamic, batch 2, against JAX's forward."""
    c = _Case(tmp_path, get_model_config(size_key, num_classes=3),
              jax_get_model_config(size_key, num_classes=3), 64, 2, 5)
    np.testing.assert_allclose(c.run(2), c.want, rtol=5e-4, atol=5e-4)
