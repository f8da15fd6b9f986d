"""YOLO12 in the port (models/yolov12.py, ops/blocks.py) on the CPU: the
forward and the detections against the benchmark's plain reference
(card_bench/reference/yolo12.py) at n's widths and 128 px, the area
attention's strips and channel order, the kernel wrappers' 32-wide
values and the epilogue pass's layer scale, the padded MLP's fold, the
parameter count of every size, and the entry points that build YOLO12
from a size key. Seeded random weights, calibrated as the benchmark's
(card_bench/drivers/serve_yolo12.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from card_bench.drivers.serve_yolo12 import make
from card_bench.reference.detect import decode, nms
from card_bench.reference.yolo12 import Net12, Spec12, layout, parameters
from tpu_yolo_torch import YOLO, Detector, get_model_config, init_params
from tpu_yolo_torch.core.config import YOLO12_CONFIGS
from tpu_yolo_torch.io.checkpoint import save_checkpoint
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import model_class
from tpu_yolo_torch.models.yolov12 import AREA, YOLO12
from tpu_yolo_torch.ops.attention_cuda import (area_attention, area_attention_plain,
                                               attention_plain, fused_attention)
from tpu_yolo_torch.ops.bias_act_cuda import bias_act
from tpu_yolo_torch.ops.blocks import ABlock, AreaAttention

torch.set_num_threads(1)
SIZE = 128


def _spec(size: str, input_size: int = SIZE) -> Spec12:
    cfg = get_model_config(size)
    return Spec12(dict(width=cfg.width, depth=cfg.depth, c3k=list(cfg.csp), num_classes=80,
                       reg_max=16, strides=list(cfg.strides), input_size=input_size,
                       area=list(AREA), mlp_ratio=cfg.mlp_ratio,
                       layer_scale=cfg.layer_scale))


def _images(seed: int, n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    blocks = torch.randint(0, 256, (n, SIZE // 8, SIZE // 8, 3), generator=g, dtype=torch.uint8)
    return blocks.repeat_interleave(8, 1).repeat_interleave(8, 2).contiguous()


@pytest.fixture(scope="module")
def seeded():
    """12n's reference weights calibrated on two images, two more images
    to run, and the reference's raw maps of them."""
    spec = _spec("12n")
    imgs = _images(12, 4)
    W = make(spec, 12, imgs[:2], gamma=0.2, class_bias=-5.0)
    x = imgs[2:].float() / 255
    with torch.no_grad():
        want = Net12(spec, W).forward(x.permute(0, 3, 1, 2))
    return spec, W, x, want


def test_forward_raw_matches_reference(seeded):
    """Unfolded, the port computes the reference's operations in its order:
    the same bits. Folded (the serving form), each conv's kernel is
    W·gamma/sqrt(var + eps), one f32 rounding a weight that the reference
    does not take, carried through some 60 convs: within 1e-4 abs + 1e-5
    rel of logits that spread about 3 (2e-5 measured)."""
    spec, W, x, want = seeded
    cfg = get_model_config("12n")
    with torch.no_grad():
        model = YOLO.from_state_dict(cfg, {k: v.clone() for k, v in W.items()})
        unfolded = model.forward_raw(x)
        folded = model.fold_batchnorm().forward_raw(x)
    for u, f, w in zip(unfolded, folded, want):
        assert torch.equal(u, w)
        torch.testing.assert_close(f, w, atol=1e-4, rtol=1e-5)


def test_forward_nms_matches_reference(seeded):
    """The folded port's detections (its NMS kernel's plain version, f32)
    are the reference's decode and NMS of the same images: the same counts,
    and one to one the same detections, each of the same class with its
    box within 1e-2 px and its score within 1e-5 (the logits' 2e-5 fold
    rounding, through DFL's softmax times the stride). Near-equal scores
    may rank in another order."""
    spec, W, x, want = seeded
    model = YOLO.from_state_dict(get_model_config("12n"), {k: v.clone() for k, v in W.items()})
    with torch.no_grad():
        ref = nms(*decode(spec, want)[:2], 0.25, 0.65, 300, 1024)
        got = model.fold_batchnorm().forward_nms(x, conf_thres=0.25, iou_thres=0.65,
                                                 max_det=300, max_nms=1024)
    assert torch.equal(got["count"].long(), ref["count"].long())
    assert 20 <= int(ref["count"].min()) and int(ref["count"].max()) < 300
    for i, n in enumerate(ref["count"].tolist()):
        gap = (got["boxes"][i, :n, None] - ref["boxes"][i, None, :n]).abs().amax(-1)
        gap[got["classes"][i, :n, None].long() != ref["classes"][i, None, :n].long()] = 1e9
        j = gap.argmin(1)
        assert sorted(j.tolist()) == list(range(n))
        assert float(gap.min(1).values.max()) <= 1e-2
        torch.testing.assert_close(got["scores"][i, :n], ref["scores"][i, j], atol=1e-5, rtol=0)


def _attention_block(seed=3, ch=64, area=4):
    g = torch.Generator().manual_seed(seed)
    block = AreaAttention(ch, area)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.5 if name.endswith(".w") else 0.1) + (
                1.0 if name.endswith("gamma") else 0.0))
    return block.eval()


def test_strips_attend_apart():
    """P4 of 12n at 128 px: 8x8 tokens in 4 strips of 16 (two rows each).
    A token of strip 0 changed changes the attention's output (before pe)
    in strip 0 alone: strips 1-3 keep their bits."""
    block = _attention_block()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 64, 8, 8, generator=g)
    x2 = x.clone()
    x2[:, :, 1, 5] += 3.0   # token 13: strip 0 holds rows 0 and 1
    with torch.no_grad():
        o, o2 = (area_attention(block.qkv(v), block.num_head, block.area, 32 ** -0.5)
                 for v in (x, x2))
    assert not torch.equal(o[:, :, :2], o2[:, :, :2])
    assert torch.equal(o[:, :, 2:], o2[:, :, 2:])


def test_channel_order_is_per_head_q_k_v():
    """The qkv conv's channel j is of head j // 96, whose [0, 32) are q,
    [32, 64) k and [64, 96) v; the output's channel head·32 + i. A map with
    k zero gives every token equal weight, so the output is the strip's
    mean of that head's v channels; and a hand-written per-head attention
    over the strips gives the plain version's output."""
    g = torch.Generator().manual_seed(5)
    heads, area, h, w = 3, 2, 4, 6
    qkv = torch.randn(2, 96 * heads, h, w, generator=g)
    per_head = qkv.view(2, heads, 3, 32, h, w)
    flat = qkv.clone()
    flat.view(2, heads, 3, 32, h, w)[:, :, 1] = 0
    o = area_attention(flat, heads, area, 32 ** -0.5)
    v = per_head[:, :, 2].reshape(2, heads * 32, area, h * w // area)
    torch.testing.assert_close(o.reshape(2, heads * 32, area, -1),
                               v.mean(-1, keepdim=True).expand_as(v), atol=1e-6, rtol=1e-6)
    q, k, v = (per_head[:, :, i].reshape(2, heads, 32, area, -1).permute(0, 3, 1, 4, 2)
               for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) * 32 ** -0.5, -1)
    want = (p @ v).permute(0, 2, 4, 1, 3).reshape(2, heads * 32, h, w)
    torch.testing.assert_close(area_attention(qkv, heads, area, 32 ** -0.5), want,
                               atol=1e-6, rtol=1e-6)
    assert torch.equal(area_attention(qkv, heads, area, 32 ** -0.5),
                       area_attention_plain(qkv, heads, area, 32 ** -0.5))


def test_kernel_counter_counts_launches(monkeypatch):
    """While a profiler records, `attn.area.calls` counts AreaAttention's
    forwards and `attn.area.kernel` the kernel's launches, at the launch:
    on CPU tensors the plain op runs and the kernel count stays 0; the
    CUDA implementation (its launch stubbed) counts one a call."""
    from tpu_yolo_torch.ops import attention_cuda
    from tpu_yolo_torch.utils import telemetry

    block = _attention_block()
    qkv = torch.randn(2, 192, 8, 8)
    monkeypatch.setattr(attention_cuda, "_launch", lambda *args: None)
    telemetry.reset()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        block(torch.randn(2, 64, 8, 8))
        attention_cuda._area_attention_cuda(qkv, 2, 4, 0.2)
        snap = telemetry.snapshot()
    telemetry.reset()
    assert snap["attn.area.calls"] == 1
    assert snap["attn.area.kernel"] == 1
    assert snap["launches.area_attention"] == 1


def test_area_attention_refuses():
    qkv = torch.randn(1, 192, 4, 6)
    for call in (lambda: area_attention(qkv, 3, 2, 0.2),            # 192 is not 3·32·3
                 lambda: area_attention(qkv, 2, 5, 0.2),            # 24 tokens in 5 strips
                 lambda: area_attention(qkv.half(), 2, 2, 0.2)):
        with pytest.raises((TypeError, ValueError)):
            call()


@pytest.mark.parametrize("dh", [32, 64])
def test_fused_attention_takes_32_and_64_wide_values(dh):
    g = torch.Generator().manual_seed(dh)
    q, k = torch.randn(3, 40, 32, generator=g), torch.randn(3, 40, 32, generator=g)
    v = torch.randn(3, 40, dh, generator=g)
    assert torch.equal(fused_attention(q, k, v, 0.2), attention_plain(q, k, v, 0.2))
    with pytest.raises(ValueError):
        fused_attention(q, k, v[..., :16].contiguous(), 0.2)
    with pytest.raises(ValueError):
        fused_attention(q, k, torch.randn(3, 40, 48), 0.2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["silu", "identity"])
def test_bias_act_scale_is_torchs_passes(dtype, act):
    """residual + scale · act(y + b) as PyTorch's passes round it, bit for
    bit, in the map's dtype; a scale with halves, or of another shape, is
    refused."""
    g = torch.Generator().manual_seed(7)
    y, r = (torch.randn(2, 24, 5, 7, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    b, s = torch.randn(24, generator=g).to(dtype), (0.01 * torch.randn(24, generator=g)).to(dtype)
    fn = F.silu if act == "silu" else (lambda t: t)
    want = r + s.view(1, -1, 1, 1) * fn(y.clone().add_(b.view(1, -1, 1, 1)))
    assert torch.equal(bias_act(y, b, act, r, scale=s), want)
    assert torch.equal(bias_act(y, b, act, scale=s), s.view(1, -1, 1, 1) * fn(y + b.view(1, -1, 1, 1)))
    with pytest.raises(ValueError):
        bias_act(y, b, act, r, halves=True, scale=s)
    with pytest.raises(ValueError):
        bias_act(y, b, act, r, scale=s[:12])


def test_padded_mlp_fold_is_exact():
    """v12-x's MLP, 384 -> 460 -> 384, folded and padded to 464: the four
    added channels are SiLU(0 + 0) = 0 exactly and meet zero weights; the
    block's output is the unpadded one's. In f64, where the reordered sums
    of the wider conv differ at 1e-16, within 1e-12."""
    g = torch.Generator().manual_seed(9)
    block = ABlock(384, 1.2, 1).double()
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.rand(p.shape, generator=g, dtype=torch.float64) * 0.1
                    + (0.5 if name.endswith(("gamma", "var")) else 0.0))
        for m in block.modules():
            if hasattr(m, "fold_"):
                m.fold_()
        x = torch.randn(2, 384, 4, 5, generator=g, dtype=torch.float64)
        want = block(x)
        hidden = block.mlp[0](x)
        block.pad_mlp_()
        assert block.mlp[0].w.shape[0] == block.mlp[1].w.shape[1] == 464
        padded = block.mlp[0](x)
        assert torch.equal(padded[:, 460:], torch.zeros_like(padded[:, 460:]))
        torch.testing.assert_close(padded[:, :460], hidden, atol=1e-12, rtol=1e-12)
        torch.testing.assert_close(block(x), want, atol=1e-12, rtol=1e-12)
        block.pad_mlp_()   # a second pad is none
        assert block.mlp[0].w.shape[0] == 464


@pytest.mark.parametrize("size", sorted(YOLO12_CONFIGS))
def test_parameter_count(size):
    """Every size's state dict has the reference's leaves and shapes, and
    its folded parameters (before the MLP's padding) are the reference's
    count: at x 59,135,728, the paper's 59.1M."""
    cfg = get_model_config(size)
    model = model_class(cfg)(cfg)
    assert type(model) is YOLO12
    spec = _spec(size, 640)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        n: tuple(s) for n, s, _ in layout(spec)}
    YOLO.fold_batchnorm(model)   # the fold alone, no padding
    count = sum(p.numel() for p in model.parameters())
    assert count == parameters(spec)
    if size == "12x":
        assert abs(count - 59.1e6) <= 0.2e6
        padded = sum(p.numel() for p in model.fold_batchnorm().parameters())
        assert padded - count == 16 * 4 * (2 * 384 + 1)   # 16 ABlocks, 460 -> 464


def test_entry_points_build_yolo12(tmp_path, seeded, capsys):
    """`YOLO.from_state_dict(get_model_config("12x"), ...)` and the size
    keys of `Detector.from_checkpoint` and the CLI's `--model-size` give
    YOLO12; a `.ckpt` of its tree loads back bit for bit."""
    from tpu_yolo_torch.cli import main as cli

    spec, W, x, _ = seeded
    cfg_x = get_model_config("12x")
    assert type(YOLO.from_state_dict(cfg_x, YOLO12(cfg_x).state_dict())) is YOLO12
    cfg = get_model_config("12n")
    state = from_jax_params(init_params(0, cfg), cfg)   # every leaf, strictly
    assert float(state["head.box.0.2.b"][0]) == 1.0
    assert float(from_jax_params(init_params(0, cfg_x), cfg_x)["net.p5.1.scale"][0]) == np.float32(0.01)
    path = str(tmp_path / "v12n.ckpt")
    save_checkpoint(path, {"params": to_jax_params({k: v.clone() for k, v in W.items()})})
    det = Detector.from_checkpoint(path, size="12n", input_size=SIZE, device="cpu",
                                   compute_dtype=torch.float32)
    assert type(det.model) is YOLO12
    want = YOLO.from_state_dict(cfg, {k: v.clone() for k, v in W.items()}).fold_batchnorm()
    assert all(torch.equal(a, b) for a, b in zip(det.model.state_dict().values(),
                                                 want.state_dict().values()))
    res = det.detect_batch((x[:1] * 255).round().to(torch.uint8))
    assert int(res["count"][0]) > 0
    cli.main(["--profile", "--model-size", "12n", "--device", "cpu", "--input-size", "64"])
    assert "param" in capsys.readouterr().out.lower()
    with pytest.raises(SystemExit):
        cli.main(["--train", "--model-size", "12n", "--device", "cpu"])


def test_int8_detector_runs_yolo12(tmp_path, seeded):
    """`Detector.quantize` (the limits' control) takes YOLO12: every folded
    conv, the 7x7 depthwise pe among them, is int8 and the batch serves."""
    import cv2

    spec, W, x, _ = seeded
    model = YOLO.from_state_dict(get_model_config("12n"), {k: v.clone() for k, v in W.items()})
    det = Detector(model, input_size=SIZE, device="cpu", conf_thres=0.25)
    paths = []
    for i, img in enumerate((x * 255).round().to(torch.uint8).numpy()):
        paths.append(str(tmp_path / f"{i}.jpg"))
        cv2.imwrite(paths[-1], np.ascontiguousarray(img[..., ::-1]))
    det.quantize(paths)
    assert all(m.quantized for m in det.model.modules() if hasattr(m, "quantized"))
    res = det.detect_batch((x * 255).round().to(torch.uint8))
    assert res["count"].shape == (2,)
