"""YOLOv11 (n/t/s/m/l/x): backbone -> FPN -> decoupled head, as a torch
module (counterpart of `tpu_yolo/models/yolov11.py`).

Module attribute paths mirror the JAX param tree (`net.p1.0`,
`net.p5.3.m.0.attn.qkv`, `head.cls.2.4`, ...), so a state-dict key is a
JAX tree path joined with dots (io/weights.py::from_jax_params).

Public functions keep the JAX layout: images are NHWC, `forward_raw`
returns three (B, H/s, W/s, 4·reg_max + nc) maps.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.ops.anchors import device_anchors
from tpu_yolo_torch.ops.blocks import CSP, PSA, SPPF
from tpu_yolo_torch.ops.boxes import dfl_decode
from tpu_yolo_torch.ops.nn import ConvBN, ckpt_region, identity, upsample2x
from tpu_yolo_torch.parallel import spatial
from tpu_yolo_torch.utils import telemetry

# ---------------------------------------------------------------------------
# Initialization: a numpy copy of the JAX package's init_params. The same
# np.random.default_rng draws in the same order give bit-identical arrays
# (HWIO kernels, as in the JAX tree) for the same integer seed.
# ---------------------------------------------------------------------------


def _init_conv(rng: np.random.Generator, in_ch, out_ch, k=1, groups=1, bias=False):
    fan_in = (in_ch // groups) * k * k
    bound = 1.0 / math.sqrt(fan_in)
    p = {"w": rng.uniform(-bound, bound,
                          (k, k, in_ch // groups, out_ch)).astype(np.float32)}
    if bias:
        p["b"] = rng.uniform(-bound, bound, out_ch).astype(np.float32)
    return p


def _init_conv_bn(rng, in_ch, out_ch, k=1, groups=1):
    p = _init_conv(rng, in_ch, out_ch, k, groups)
    p.update(
        gamma=np.ones(out_ch, np.float32),
        beta=np.zeros(out_ch, np.float32),
        mean=np.zeros(out_ch, np.float32),
        var=np.ones(out_ch, np.float32),
    )
    return p


def _init_residual(rng, ch, e=0.5):
    mid = int(ch * e)
    return {"conv1": _init_conv_bn(rng, ch, mid, k=3),
            "conv2": _init_conv_bn(rng, mid, ch, k=3)}


def _init_csp_module(rng, in_ch, out_ch):
    half = out_ch // 2
    return {
        "conv1": _init_conv_bn(rng, in_ch, half),
        "conv2": _init_conv_bn(rng, in_ch, half),
        "conv3": _init_conv_bn(rng, 2 * half, out_ch),
        "m": [_init_residual(rng, half, e=1.0), _init_residual(rng, half, e=1.0)],
    }


def _init_csp(rng, in_ch, out_ch, n, use_csp_module, r):
    hidden = out_ch // r
    return {
        "conv1": _init_conv_bn(rng, in_ch, 2 * hidden),
        "conv2": _init_conv_bn(rng, (2 + n) * hidden, out_ch),
        "m": [(_init_csp_module(rng, hidden, hidden) if use_csp_module
               else _init_residual(rng, hidden)) for _ in range(n)],
    }


def _init_sppf(rng, in_ch, out_ch):
    return {"conv1": _init_conv_bn(rng, in_ch, in_ch // 2),
            "conv2": _init_conv_bn(rng, in_ch * 2, out_ch)}


def _init_attention(rng, ch, num_head):
    dh = ch // num_head
    dk = dh // 2
    return {
        "qkv": _init_conv_bn(rng, ch, ch + 2 * dk * num_head),
        "pe": _init_conv_bn(rng, ch, ch, k=3, groups=ch),
        "proj": _init_conv_bn(rng, ch, ch),
    }


def _init_psa_block(rng, ch, num_head):
    return {
        "attn": _init_attention(rng, ch, num_head),
        "ffn": [_init_conv_bn(rng, ch, ch * 2), _init_conv_bn(rng, ch * 2, ch)],
    }


def _init_psa(rng, ch, n):
    half = ch // 2
    return {
        "conv1": _init_conv_bn(rng, ch, 2 * half),
        "conv2": _init_conv_bn(rng, 2 * half, ch),
        "m": [_init_psa_block(rng, half, max(ch // 128, 1)) for _ in range(n)],
    }


def init_params(seed: int, cfg: ModelConfig):
    """The full parameter tree of one model size, in the JAX layout
    (nested dicts/lists of float32 numpy arrays, HWIO kernels): its
    architecture's (`model_class(cfg).init_params`)."""
    return model_class(cfg).init_params(seed, cfg)


def _init_yolo11(seed: int, cfg: ModelConfig):
    """YOLO11's parameter tree (`YOLO.init_params`)."""
    rng = np.random.default_rng(int(seed))
    w, d, csp_flags = cfg.width, cfg.depth, cfg.csp

    net = {
        "p1": [_init_conv_bn(rng, w[0], w[1], k=3)],
        "p2": [_init_conv_bn(rng, w[1], w[2], k=3),
               _init_csp(rng, w[2], w[3], d[0], csp_flags[0], r=4)],
        "p3": [_init_conv_bn(rng, w[3], w[3], k=3),
               _init_csp(rng, w[3], w[4], d[1], csp_flags[0], r=4)],
        "p4": [_init_conv_bn(rng, w[4], w[4], k=3),
               _init_csp(rng, w[4], w[4], d[2], csp_flags[1], r=2)],
        "p5": [_init_conv_bn(rng, w[4], w[5], k=3),
               _init_csp(rng, w[5], w[5], d[3], csp_flags[1], r=2),
               _init_sppf(rng, w[5], w[5]),
               _init_psa(rng, w[5], d[4])],
    }
    fpn = {
        "h1": _init_csp(rng, w[4] + w[5], w[4], d[5], csp_flags[0], r=2),
        "h2": _init_csp(rng, w[4] + w[4], w[3], d[5], csp_flags[0], r=2),
        "h3": _init_conv_bn(rng, w[3], w[3], k=3),
        "h4": _init_csp(rng, w[3] + w[4], w[4], d[5], csp_flags[0], r=2),
        "h5": _init_conv_bn(rng, w[4], w[4], k=3),
        "h6": _init_csp(rng, w[4] + w[5], w[5], d[5], csp_flags[1], r=2),
    }

    nc, reg = cfg.num_classes, cfg.reg_max
    filters = cfg.head_filters
    box_ch = max(64, filters[0] // 4)
    cls_ch = max(80, filters[0], nc)
    head = {"box": [], "cls": []}
    for i, f in enumerate(filters):
        head["box"].append([
            _init_conv_bn(rng, f, box_ch, k=3),
            _init_conv_bn(rng, box_ch, box_ch, k=3),
            _init_conv(rng, box_ch, 4 * reg, bias=True),
        ])
        head["cls"].append([
            _init_conv_bn(rng, f, f, k=3, groups=f),
            _init_conv_bn(rng, f, cls_ch),
            _init_conv_bn(rng, cls_ch, cls_ch, k=3, groups=cls_ch),
            _init_conv_bn(rng, cls_ch, cls_ch),
            _init_conv(rng, cls_ch, nc, bias=True),
        ])
        # prior-aware bias init (reference Head.initialize_biases)
        s = cfg.strides[i]
        head["box"][i][2]["b"] = np.ones(4 * reg, np.float32)
        head["cls"][i][4]["b"] = np.full(nc, math.log(5 / nc / (640 / s) ** 2),
                                         np.float32)

    return {"net": net, "fpn": fpn, "head": head}


# ---------------------------------------------------------------------------
# The space-to-depth stem (an inference-graph transform).
# ---------------------------------------------------------------------------


def _stem_s2d_weight(w3: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) stride-2 kernel -> the equal (O, 4C, 2, 2) stride-1
    kernel over a space-to-depth(2) input. Output (i, j) of the 3x3/s2
    conv reads input pixels 2i-1..2i+1; in s2d coordinates those are
    cells i-1..i at offsets di in {0, 1}, so
    W2[o, (di, dj, c), a, b] = W3[o, c, 2a+di-1, 2b+dj-1], zero where that
    index falls outside the 3x3 kernel, with a top/left pad of 1."""
    cout, cin = w3.shape[:2]
    w2 = torch.zeros((cout, 4 * cin, 2, 2), dtype=w3.dtype, device=w3.device)
    for a in range(2):
        for b in range(2):
            for di in range(2):
                for dj in range(2):
                    ki, kj = 2 * a + di - 1, 2 * b + dj - 1
                    if 0 <= ki < 3 and 0 <= kj < 3:
                        ch = (di * 2 + dj) * cin
                        w2[:, ch:ch + cin, a, b] = w3[:, :, ki, kj]
    return w2


def fold_stem_space_to_depth(state_dict: dict) -> dict:
    """A state dict (folded or not) whose stem's 3x3/s2 conv is rewritten
    as the exactly equal 2x2/s1 conv over a space-to-depth(2) input (the
    JAX package's transform of the same name). The key stays
    `net.p1.0.w`, with shape (O, 4C, 2, 2); a stem already rewritten is
    left as it is. Apply after BatchNorm folding or weight loading."""
    w = state_dict["net.p1.0.w"]
    if w.shape[-1] != 3:
        return dict(state_dict)
    return {**state_dict, "net.p1.0.w": _stem_s2d_weight(w)}


def _space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channels ordered (di, dj, c)."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, w // 2, 4 * c))


def space_to_depth_host(x: np.ndarray) -> np.ndarray:
    """numpy mirror of the stem's device rearrange: (B, H, W, C) ->
    (B, H/2, W/2, 4C), channel layout (di, dj, c). A staging side can
    ship batches already in the s2d-stem layout (the same bytes,
    permuted on the host), and the s2d model takes them as they are."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return np.ascontiguousarray(
        x.transpose(0, 1, 3, 2, 4, 5)).reshape(b, h // 2, w // 2, 4 * c)


def has_s2d_stem(state_dict) -> bool:
    """Whether a state dict holds the space-to-depth stem (its 2x2
    kernel, float or int8; fold_stem_space_to_depth)."""
    w = state_dict.get("net.p1.0.w", state_dict.get("net.p1.0.w_q"))
    return w is not None and w.shape[-1] == 2


def _input_hw(x, cfg: ModelConfig) -> tuple[int, int]:
    """Image-space (H, W) of an NHWC model input: a pre-rearranged s2d
    batch (4·C_in channels, space_to_depth_host) covers twice its array
    size per axis."""
    if x.shape[-1] == 4 * cfg.width[0]:
        return 2 * x.shape[1], 2 * x.shape[2]
    return x.shape[1], x.shape[2]


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------


def _down(cin, cout):
    return ConvBN(cin, cout, 3, stride=2, padding=1)


class YOLO(nn.Module):
    """YOLOv11 of one size. Built with unfolded BatchNorm; `fold_batchnorm`
    folds it in place. A new model is in eval mode, since serving is the
    common use; in training mode (`model.train()`) BatchNorm uses batch
    statistics and the attention takes its differentiable form.

    `from_state_dict` and `shaped_like` build the class of the
    configuration's architecture (`model_class`), so every entry point
    that builds a model from a configuration (`Detector.from_checkpoint`,
    the CLIs' `--model-size`) serves YOLO12 (models/yolov12.py) too.

    After `parallel.spatial.partition_spatial(model, mesh)` (`spatial` set)
    the forward takes this rank's rows of its images and returns the
    whole outputs of the unsharded forward."""

    spatial = None
    init_params = staticmethod(_init_yolo11)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.net, self.fpn = self._stages(cfg)
        nc, reg = cfg.num_classes, cfg.reg_max
        filters = cfg.head_filters
        box_ch = max(64, filters[0] // 4)
        cls_ch = max(80, filters[0], nc)
        self.head = nn.ModuleDict({
            "box": nn.ModuleList([nn.ModuleList([
                ConvBN(f, box_ch, 3, padding=1),
                ConvBN(box_ch, box_ch, 3, padding=1),
                ConvBN(box_ch, 4 * reg, act=identity, folded=True),
            ]) for f in filters]),
            "cls": nn.ModuleList([nn.ModuleList([
                ConvBN(f, f, 3, padding=1, groups=f),
                ConvBN(f, cls_ch),
                ConvBN(cls_ch, cls_ch, 3, padding=1, groups=cls_ch),
                ConvBN(cls_ch, cls_ch),
                ConvBN(cls_ch, nc, act=identity, folded=True),
            ]) for f in filters]),
        })
        self.eval()

    @staticmethod
    def _stages(cfg: ModelConfig) -> tuple[nn.ModuleDict, nn.ModuleDict]:
        """The backbone (`net`: p1..p5, each a strided conv and its
        blocks) and the FPN (`fpn`: h1..h6) of the architecture."""
        w, d, (csp0, csp1) = cfg.width, cfg.depth, cfg.csp
        net = nn.ModuleDict({
            "p1": nn.ModuleList([_down(w[0], w[1])]),
            "p2": nn.ModuleList([_down(w[1], w[2]),
                                 CSP(w[2], w[3], d[0], csp0, r=4)]),
            "p3": nn.ModuleList([_down(w[3], w[3]),
                                 CSP(w[3], w[4], d[1], csp0, r=4)]),
            "p4": nn.ModuleList([_down(w[4], w[4]),
                                 CSP(w[4], w[4], d[2], csp1, r=2)]),
            "p5": nn.ModuleList([_down(w[4], w[5]),
                                 CSP(w[5], w[5], d[3], csp1, r=2),
                                 SPPF(w[5], w[5]),
                                 PSA(w[5], d[4])]),
        })
        fpn = nn.ModuleDict({
            "h1": CSP(w[4] + w[5], w[4], d[5], csp0, r=2),
            "h2": CSP(w[4] + w[4], w[3], d[5], csp0, r=2),
            "h3": _down(w[3], w[3]),
            "h4": CSP(w[3] + w[4], w[4], d[5], csp0, r=2),
            "h5": _down(w[4], w[4]),
            "h6": CSP(w[4] + w[5], w[5], d[5], csp1, r=2),
        })
        return net, fpn

    @classmethod
    def shaped_like(cls, cfg: ModelConfig, state_dict) -> "YOLO":
        """A model of `cfg` in the form `state_dict` has (BatchNorm folded
        or not, the s2d stem, int8 convs where it has `w_q` leaves), its
        weights not loaded."""
        model = model_class(cfg)(cfg)
        if not any(k.endswith(".gamma") for k in state_dict):
            model.fold_batchnorm()
        if has_s2d_stem(state_dict):
            model.fold_stem_space_to_depth()
        for name, m in model.named_modules():
            if f"{name}.w_q" in state_dict:
                m.quantize_()
        return model

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state_dict) -> "YOLO":
        """A model holding `state_dict` (folded, unfolded or quantized),
        loaded strictly: every key must be used and every weight filled."""
        model = cls.shaped_like(cfg, state_dict)
        model.load_state_dict(state_dict, strict=True)
        return model

    @property
    def s2d_stem(self) -> bool:
        """Whether the stem is the space-to-depth one
        (fold_stem_space_to_depth), float or int8."""
        stem = self.net["p1"][0]
        return (stem.w_q if stem.quantized else stem.w).shape[-1] == 2

    def _stem_input(self, x):
        """NHWC images -> the stem's NCHW input. With the s2d stem an
        image batch is rearranged on the device (a batch that already has
        4·C_in channels is taken as it is); the stem pads it top and left
        by one (its padding ((1, 0), (1, 0))). With `spatial` this rank's
        rows are first moved to the forward's block layout."""
        if self.spatial is not None:
            x = spatial.to_blocks(x.permute(0, 3, 1, 2), self.spatial).permute(0, 2, 3, 1)
        if self.s2d_stem and x.shape[-1] != 4 * self.cfg.width[0]:
            x = _space_to_depth2(x)
        return x.permute(0, 3, 1, 2)

    def forward_raw(self, x, remat=False):
        """NHWC images -> list of 3 NHWC maps (B, H/s, W/s, 4*reg_max + nc).

        `remat` (used when gradients are recorded): True or "stage"
        checkpoints the graph per stage (5 backbone stages, 2 FPN halves,
        3 head levels), so the forward keeps only the stages' boundaries
        and the backward recomputes each interior; "blocks" also nests a
        region around every CSP inner block and PSA block (lowest peak
        memory, interiors recompute twice). The same regions as the JAX
        package's `forward_raw(remat=)`."""
        if self.spatial is None:
            return self._forward_raw(x, remat)
        self._check_spatial(x)
        with spatial.sharded(spatial.Shards.of(*self._image_hw(x), self.spatial.size)):
            return self._forward_raw(x, remat)

    def _forward_raw(self, x, remat):
        net, fpn = self.net, self.fpn
        stage = bool(remat) and torch.is_grad_enabled()
        inner = stage and remat == "blocks"
        run = ckpt_region if stage else (lambda fn, *args: fn(*args))

        def top_down(p3, p4, p5):
            h4 = fpn["h1"](torch.cat((upsample2x(p5), p4), 1), remat=inner)
            h3 = fpn["h2"](torch.cat((upsample2x(h4), p3), 1), remat=inner)
            return h3, h4

        def bottom_up(h3, h4, p5):
            h4b = fpn["h4"](torch.cat((fpn["h3"](h3), h4), 1), remat=inner)
            h5b = fpn["h6"](torch.cat((fpn["h5"](h4b), p5), 1), remat=inner)
            return h4b, h5b

        def level(feat, box, cls):
            b, c = feat, feat
            for conv in box:
                b = conv(b)
            for conv in cls:
                c = conv(c)
            return torch.cat((b, c), 1)

        x = run(net["p1"][0], self._stem_input(x))
        x = run(lambda xx: net["p2"][1](net["p2"][0](xx), remat=inner), x)
        p3 = run(lambda xx: net["p3"][1](net["p3"][0](xx), remat=inner), x)
        p4 = run(lambda xx: net["p4"][1](net["p4"][0](xx), remat=inner), p3)
        p5 = run(lambda xx: self._p5(xx, inner), p4)
        h3, h4 = run(top_down, p3, p4, p5)
        h4b, h5b = run(bottom_up, h3, h4, p5)
        maps = [run(lambda f, b=box, c=cls: level(f, b, c), feat)
                for feat, box, cls in zip((h3, h4b, h5b), self.head["box"],
                                          self.head["cls"])]
        if self.spatial is not None:   # the whole maps, for the global anchors
            maps = [spatial.gather_rows(m, self.spatial) for m in maps]
        return [m.permute(0, 2, 3, 1) for m in maps]

    def _p5(self, x, remat=False):
        """The P5 stage: its strided conv, C3k2, SPPF and PSA."""
        p5 = self.net["p5"]
        x = p5[1](p5[0](x), remat=remat)
        return p5[3](p5[2](x), remat=remat)

    def _check_spatial(self, x):
        """Refuse what the height-sharded forward cannot take."""
        if self.training:
            raise ValueError("the spatial forward is for inference: put the model "
                             "in eval mode")
        h, w = self._image_hw(x)
        if h % 32 or w % 32:
            raise ValueError(f"a spatial forward takes images whose height and width "
                             f"are multiples of 32: this rank holds {x.shape[1]} of "
                             f"H = {h} rows, W = {w}")

    def _image_hw(self, x) -> tuple[int, int]:
        """The whole images' (H, W) of this rank's input."""
        h, w = _input_hw(x, self.cfg)
        return (h * self.spatial.size if self.spatial is not None else h), w

    def decode_predictions(self, raw_maps, input_hw):
        """(B, A, 4+nc): pixel-space xywh boxes + sigmoid class scores."""
        cfg = self.cfg
        b = raw_maps[0].shape[0]
        flat = torch.cat([m.reshape(b, -1, cfg.no) for m in raw_maps], 1)
        dist, cls = flat.split((4 * cfg.reg_max, cfg.num_classes), -1)
        anchors, stride_t = device_anchors(tuple(input_hw), tuple(cfg.strides),
                                          flat.device)
        box = dfl_decode(dist, anchors, cfg.reg_max, xywh=True) * stride_t
        return torch.cat((box, torch.sigmoid(cls.float())), -1)

    def forward(self, x):
        """NHWC images -> decoded (B, A, 4+nc)."""
        return self.decode_predictions(self.forward_raw(x), self._image_hw(x))

    def forward_nms(self, x, **nms_kwargs):
        """One-call inference: forward -> fused decode + NMS
        (ops/nms.py::nms_from_raw)."""
        from tpu_yolo_torch.ops.nms import nms_from_raw

        with telemetry.span("layer.serve.forward"):
            raw = self.forward_raw(x)
        return nms_from_raw(raw, self.cfg, self._image_hw(x), **nms_kwargs)

    @torch.no_grad()
    def fold_batchnorm(self) -> "YOLO":
        """Fold every BatchNorm into its conv, in place (saves the BN
        buffers and their per-forward scale/shift)."""
        for m in self.modules():
            if isinstance(m, ConvBN):
                m.fold_()
        return self

    @torch.no_grad()
    def fold_stem_space_to_depth(self) -> "YOLO":
        """Rewrite the stem in place as the exactly equal 2x2/s1 conv over
        a space-to-depth input (module-level `fold_stem_space_to_depth`);
        `forward_raw` then rearranges image inputs on the device or takes
        pre-rearranged 4·C_in-channel ones."""
        stem = self.net["p1"][0]
        if stem.quantized and not self.s2d_stem:
            raise ValueError("fold_stem_space_to_depth: the stem is int8 "
                             "already; rewrite it before quantizing")
        if not self.s2d_stem:
            stem.w = nn.Parameter(_stem_s2d_weight(stem.w),
                                  requires_grad=stem.w.requires_grad)
        stem.stride, stem.padding = 1, ((1, 0), (1, 0))
        return self

    @torch.no_grad()
    def fold_input_scale(self, scale: float = 1.0 / 255.0) -> "YOLO":
        """Fold the input normalization into the stem conv, in place:
        conv(s·x, W) == conv(x, s·W), so callers can feed 0..255 images.
        Raises ValueError on an int8 stem, as the JAX package does."""
        if self.net["p1"][0].quantized:
            raise ValueError("fold_input_scale requires an unquantized stem")
        self.net["p1"][0].w.mul_(scale)
        return self


def model_class(cfg: ModelConfig) -> type[YOLO]:
    """The model class of a configuration's architecture: YOLO (YOLO11),
    or YOLO12 (models/yolov12.py) where `cfg.arch` is "yolo12"."""
    if cfg.arch == "yolo12":
        from tpu_yolo_torch.models.yolov12 import YOLO12

        return YOLO12
    return YOLO
