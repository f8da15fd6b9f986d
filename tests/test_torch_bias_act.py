"""The folded conv's epilogue pass (ops/bias_act_cuda.py) on the CPU: its
plain version and the op against PyTorch's own passes, the wrapper's
refusals, the folded forward through the pass against the forward
without it, bit for bit, the op in an exported program, and the
`conv.folded` / `conv.fused` counters.

On the card a folded conv is cuDNN's convolution without its bias, then
`add_` of the bias, the activation and the residual's add, each a pass of
its own; here the fixture `cudnn_order` gives F.conv2d that order, and the seam
`nn.epilogue_on_card` is set to route CPU tensors through the op (whose
CPU form is the plain version), so that the card's arithmetic and its
plumbing can be held to each other without a card."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from tpu_yolo_torch.core.config import get_model_config
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops import nn
from tpu_yolo_torch.ops.bias_act_cuda import bias_act, bias_act_plain
from tpu_yolo_torch.utils import telemetry
from tpu_yolo_torch.utils.export import export_program, load_program

torch.set_num_threads(1)
DTYPES = [torch.bfloat16, torch.float32]
ACT_FN = {"silu": F.silu, "identity": nn.identity}
CL = torch.channels_last


def _card_passes(y, b, act, residual, halves=False):
    """PyTorch's passes after cuDNN's bias-less conv: add_, act, residual
    (and `chunk(2, 1)` for the halves)."""
    out = ACT_FN[act](y.clone().add_(b.view(1, -1, 1, 1)))
    out = out if residual is None else residual + out
    return out.chunk(2, 1) if halves else out


def _equal(got, want):
    if isinstance(want, tuple):
        return len(got) == len(want) and all(map(torch.equal, got, want))
    return torch.equal(got, want)


def _case(dtype, c, residual, h=9, w=11, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 24, h, w, generator=g).to(dtype).contiguous(memory_format=CL)
    wt = (torch.randn(c, 24, 3, 3, generator=g) * 0.2).to(dtype)
    b = torch.randn(c, generator=g).to(dtype)
    r = None
    if residual == "contiguous":
        r = torch.randn(2, c, h, w, generator=g).to(dtype).contiguous(memory_format=CL)
    elif residual == "chunk":   # the second half of a channels_last map, as `chunk` gives
        r = torch.randn(2, 2 * c, h, w, generator=g).to(dtype).contiguous(
            memory_format=CL).chunk(2, 1)[1]
    return x, wt, b, r


@pytest.mark.parametrize("residual", [None, "contiguous", "chunk"])
@pytest.mark.parametrize("act", ["silu", "identity"])
@pytest.mark.parametrize("c", [16, 80, 1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plain_and_op_equal_pytorchs_passes(dtype, c, act, residual):
    x, wt, b, r = _case(dtype, c, residual)
    y = F.conv2d(x, wt, None, padding=1)
    want = _card_passes(y, b, act, r)
    got_plain = bias_act_plain(y, b, act, r)
    got_op = bias_act(y, b, act, r)
    assert torch.equal(got_plain, want) and torch.equal(got_op, want)
    assert got_op.is_contiguous(memory_format=CL) and got_op.dtype == dtype
    if c % 2 == 0:   # the halves: chunk(2, 1)'s values, each a map of its own
        halves = bias_act(y, b, act, r, halves=True)
        assert _equal(halves, _card_passes(y, b, act, r, halves=True))
        assert _equal(bias_act_plain(y, b, act, r, halves=True), halves)
        assert all(h.is_contiguous(memory_format=CL) for h in halves)
        assert halves[0].untyped_storage().data_ptr() != halves[1].untyped_storage().data_ptr()
    if dtype == torch.float32 and r is None:
        # in f32 the CPU's conv with its bias rounds as the bias-less conv
        # and an add: the op is the module's whole folded conv there
        assert torch.equal(got_op, ACT_FN[act](F.conv2d(x, wt, b, padding=1)))


@pytest.mark.parametrize("residual", [None, "chunk"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_zero_row_map(dtype, residual):
    """A spatial rank that holds no row of a map: an empty output."""
    _, _, b, r = _case(dtype, 16, residual, h=0)
    y = torch.empty(2, 16, 0, 11, dtype=dtype).contiguous(memory_format=CL)
    got = bias_act(y, b, "silu", r)
    assert got.shape == y.shape and got.numel() == 0


@pytest.mark.parametrize("what", ["act", "dtype", "bias_shape", "residual_shape", "device",
                                  "odd_halves"])
def test_wrapper_refuses(what):
    _, _, b, r = _case(torch.float32, 16, "contiguous")
    y = torch.zeros(2, 16, 9, 11).contiguous(memory_format=CL)
    act = "silu"
    err = ValueError
    if what == "act":
        act = "relu"
    elif what == "dtype":
        b, err = b.bfloat16(), TypeError
    elif what == "bias_shape":
        b = torch.zeros(8)
    elif what == "residual_shape":
        r = r[:, :8]
    elif what == "device":
        y, b, r = y.to("meta"), b.to("meta"), r.to("meta")
    elif what == "odd_halves":
        y, b, r = y[:, :15], b[:15], r[:, :15]
    with pytest.raises(err):
        bias_act(y, b, act, r, halves=what == "odd_halves")


@pytest.mark.parametrize("layout", ["y_nchw", "residual_nchw", "residual_sliced_rows"])
def test_other_layouts_equal_pytorchs_passes(layout):
    """Where y or the residual is not in the kernel's layout it is copied
    there: the values are PyTorch's passes', the output channels_last."""
    x, wt, b, r = _case(torch.bfloat16, 16, "contiguous")
    y = F.conv2d(x, wt, None, padding=1)
    if layout == "y_nchw":
        y = y.contiguous()
    elif layout == "residual_nchw":
        r = r.contiguous()
    else:   # every other row: pixels not one stride apart
        r = torch.cat([r, r], 2)[:, :, ::2]
    got = bias_act(y, b, "silu", r)
    assert torch.equal(got, _card_passes(y, b, "silu", r))
    assert got.is_contiguous(memory_format=CL)


@pytest.fixture
def on_card(monkeypatch):
    """CPU tensors through the op, as CUDA tensors go."""
    monkeypatch.setattr(nn, "epilogue_on_card", lambda x: True)


@pytest.fixture
def cudnn_order(monkeypatch):
    """F.conv2d as PyTorch runs it on cuDNN: the conv without its bias,
    then the bias added in place."""
    conv = F.conv2d

    def conv2d(x, w, b=None, *args, **kw):
        y = conv(x, w, None, *args, **kw)
        return y if b is None else y.add_(b.view(1, -1, 1, 1))

    monkeypatch.setattr(F, "conv2d", conv2d)


def _folded(size="n"):
    cfg = get_model_config(size)
    model = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg))
    return cfg, model.fold_batchnorm().eval().to(memory_format=CL)


def _images(b, size, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).random((b, size, size, 3),
                                                               np.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_folded_v11n_forward_same_bits(dtype, cudnn_order, monkeypatch):
    """v11-n's folded forward through the pass equals, bit for bit, the
    forward that adds the bias, applies the activation and adds each
    residual in passes of their own; 87 convs take the pass, 14 with a
    residual, 9 (the C3k2 and PSA blocks' first convs) writing two halves,
    so that no residual is a `chunk` slice."""
    _, model = _folded()
    model = model.to(dtype)
    x = _images(2, 64).to(dtype)
    with torch.inference_mode():
        before = model.forward_raw(x)
    calls = []

    def tap(y, b, act, residual=None, halves=False):
        calls.append((residual, halves))
        return bias_act(y, b, act, residual, halves)

    monkeypatch.setattr(nn, "bias_act", tap)
    monkeypatch.setattr(nn, "epilogue_on_card", lambda x: True)
    with torch.inference_mode():
        after = model.forward_raw(x)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    residuals = [r for r, _ in calls if r is not None]
    assert (len(calls), len(residuals), sum(h for _, h in calls)) == (87, 14, 9)
    assert all(r.is_contiguous(memory_format=CL) for r in residuals)


def test_export_holds_the_op(on_card, tmp_path):
    """The folded forward exported with a symbolic batch calls the op
    (through its fake implementation while tracing), once a folded conv,
    and runs at two batches as the live model does."""
    cfg, model = _folded()
    export_program(model, cfg, 64, str(tmp_path), batch=None, compute_dtype=torch.float32)
    program = torch.export.load(str(tmp_path / "program.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("tpu_yolo_torch.bias_act.default") == 87
    run = load_program(str(tmp_path))
    for b in (1, 3):
        imgs = torch.from_numpy(np.random.default_rng(b).integers(0, 256, (b, 64, 64, 3),
                                                                  np.uint8))
        with torch.inference_mode():
            want = model(imgs.float() / 255)
        assert torch.equal(run(model, imgs), want)


def _count_convs(model, x, **profiled):
    telemetry.reset()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            model.forward_raw(x)
    else:
        model.forward_raw(x)
    snap = telemetry.snapshot()
    return snap.get("conv.folded"), snap.get("conv.fused")


def test_counters_only_while_a_profiler_records(on_card):
    _, model = _folded()
    x = _images(1, 64)
    with torch.no_grad():
        assert _count_convs(model, x) == (None, None)
        assert _count_convs(model, x, profiled=True) == (87, 87)
    # autograd recording through the input: PyTorch's own passes, counted
    # as folded and not fused
    with torch.enable_grad():
        assert _count_convs(model, x.requires_grad_(), profiled=True) == (87, None)


def test_f64_takes_pytorchs_passes(on_card, monkeypatch):
    """The pass has no f64 form: an f64 forward on the card (a witness of
    the exact result) keeps PyTorch's passes, counted as folded only."""
    from tpu_yolo_torch.ops import blocks
    from tpu_yolo_torch.ops.attention_cuda import attention_plain

    _, model = _folded()
    model = model.double()
    monkeypatch.setattr(blocks, "fused_attention", attention_plain)   # f32/bf16 only too
    monkeypatch.setattr(nn, "bias_act", None)   # never reached
    with torch.no_grad():
        assert _count_convs(model, _images(1, 64).double(), profiled=True) == (87, None)


def test_counters_leave_the_cpu_path_alone():
    """On the CPU (no seam) no folded conv counts: the pass is the card's."""
    _, model = _folded()
    with torch.no_grad():
        assert _count_convs(model, _images(1, 64), profiled=True) == (None, None)
