"""YOLOv11 written out in plain PyTorch: the benchmark's reference model.

The graph is Ultralytics' YOLO11 (`ultralytics/cfg/models/11/yolo11.yaml`)
as the program under test lays it out: a backbone of strided 3x3 convs and
C3k2 stages (C3k inner blocks at m/l/x), SPPF and C2PSA; a top-down and a
bottom-up FPN path; a decoupled head per level (box: two 3x3 convs and a
1x1 to 4·reg_max DFL logits; class: depthwise 3x3, 1x1, depthwise 3x3,
1x1, 1x1 to the class logits). Every conv is followed by BatchNorm
(eps 1e-3, momentum 0.03) and SiLU unless noted.

Weights live in one flat dict under the names of the program's state
dict (`net.p5.3.m.0.attn.qkv.w`: OIHW kernels, and `gamma`, `beta`,
`mean`, `var` of the BatchNorm, `b` of the two plain output convs), so
that one set of seeded tensors can be handed to both sides. Nothing here
imports the program: this file is what the program's outputs are
judged against.

Modes: "eval" normalizes with the running statistics; "calibrate" sets
each BatchNorm's running statistics to those of its conv's output on the
input, layer by layer, which makes seeded weights behave like trained
ones.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


def _conv_leaves(name, cin, cout, k, groups=1, plain=False):
    """Leaves of one conv: (name, shape, fan_in) rows."""
    rows = [(f"{name}.w", (cout, cin // groups, k, k), (cin // groups) * k * k)]
    if plain:
        return rows + [(f"{name}.b", (cout,), 0)]
    return rows + [(f"{name}.{leaf}", (cout,), 0) for leaf in ("gamma", "beta", "mean", "var")]


class Spec:
    """The architecture of one configuration: widths, depths, C3k flags,
    classes, DFL bins and strides, read from its file."""

    def __init__(self, cfg: dict):
        self.width = tuple(cfg["width"])
        self.depth = tuple(cfg["depth"])
        self.csp = tuple(cfg["c3k"])
        self.num_classes = cfg["num_classes"]
        self.reg_max = cfg["reg_max"]
        self.strides = tuple(cfg["strides"])
        self.input_size = cfg["input_size"]

    @property
    def no(self):
        return 4 * self.reg_max + self.num_classes

    def head_channels(self):
        filters = self.width[3:6]
        return filters, max(64, filters[0] // 4), max(80, filters[0], self.num_classes)

    def psa_heads(self):
        return max(self.width[5] // 128, 1)


def _residual(n, ch, e):
    mid = int(ch * e)
    return _conv_leaves(f"{n}.conv1", ch, mid, 3) + _conv_leaves(f"{n}.conv2", mid, ch, 3)


def _c3k(n, cin, cout):
    half = cout // 2
    return (_conv_leaves(f"{n}.conv1", cin, half, 1) + _conv_leaves(f"{n}.conv2", cin, half, 1)
            + _conv_leaves(f"{n}.conv3", 2 * half, cout, 1)
            + _residual(f"{n}.m.0", half, 1.0) + _residual(f"{n}.m.1", half, 1.0))


def _c3k2(n, cin, cout, reps, c3k, r):
    h = cout // r
    rows = _conv_leaves(f"{n}.conv1", cin, 2 * h, 1) + _conv_leaves(f"{n}.conv2", (2 + reps) * h, cout, 1)
    for i in range(reps):
        rows += _c3k(f"{n}.m.{i}", h, h) if c3k else _residual(f"{n}.m.{i}", h, 0.5)
    return rows


def layout(spec: Spec):
    """Every leaf of the model: (name, shape, fan_in), fan_in 0 for the
    per-channel vectors."""
    w, d, (c0, c1) = spec.width, spec.depth, spec.csp
    rows = _conv_leaves("net.p1.0", w[0], w[1], 3)
    rows += _conv_leaves("net.p2.0", w[1], w[2], 3) + _c3k2("net.p2.1", w[2], w[3], d[0], c0, 4)
    rows += _conv_leaves("net.p3.0", w[3], w[3], 3) + _c3k2("net.p3.1", w[3], w[4], d[1], c0, 4)
    rows += _conv_leaves("net.p4.0", w[4], w[4], 3) + _c3k2("net.p4.1", w[4], w[4], d[2], c1, 2)
    rows += _conv_leaves("net.p5.0", w[4], w[5], 3) + _c3k2("net.p5.1", w[5], w[5], d[3], c1, 2)
    rows += _conv_leaves("net.p5.2.conv1", w[5], w[5] // 2, 1)
    rows += _conv_leaves("net.p5.2.conv2", w[5] * 2, w[5], 1)
    half, heads = w[5] // 2, spec.psa_heads()
    dk = half // heads // 2
    rows += _conv_leaves("net.p5.3.conv1", w[5], 2 * half, 1)
    rows += _conv_leaves("net.p5.3.conv2", 2 * half, w[5], 1)
    for i in range(d[4]):
        n = f"net.p5.3.m.{i}"
        rows += _conv_leaves(f"{n}.attn.qkv", half, half + 2 * dk * heads, 1)
        rows += _conv_leaves(f"{n}.attn.pe", half, half, 3, groups=half)
        rows += _conv_leaves(f"{n}.attn.proj", half, half, 1)
        rows += _conv_leaves(f"{n}.ffn.0", half, 2 * half, 1)
        rows += _conv_leaves(f"{n}.ffn.1", 2 * half, half, 1)
    rows += _c3k2("fpn.h1", w[4] + w[5], w[4], d[5], c0, 2)
    rows += _c3k2("fpn.h2", w[4] + w[4], w[3], d[5], c0, 2)
    rows += _conv_leaves("fpn.h3", w[3], w[3], 3)
    rows += _c3k2("fpn.h4", w[3] + w[4], w[4], d[5], c0, 2)
    rows += _conv_leaves("fpn.h5", w[4], w[4], 3)
    rows += _c3k2("fpn.h6", w[4] + w[5], w[5], d[5], c1, 2)
    filters, box_ch, cls_ch = spec.head_channels()
    for i, f in enumerate(filters):
        rows += _conv_leaves(f"head.box.{i}.0", f, box_ch, 3)
        rows += _conv_leaves(f"head.box.{i}.1", box_ch, box_ch, 3)
        rows += _conv_leaves(f"head.box.{i}.2", box_ch, 4 * spec.reg_max, 1, plain=True)
        rows += _conv_leaves(f"head.cls.{i}.0", f, f, 3, groups=f)
        rows += _conv_leaves(f"head.cls.{i}.1", f, cls_ch, 1)
        rows += _conv_leaves(f"head.cls.{i}.2", cls_ch, cls_ch, 3, groups=cls_ch)
        rows += _conv_leaves(f"head.cls.{i}.3", cls_ch, cls_ch, 1)
        rows += _conv_leaves(f"head.cls.{i}.4", cls_ch, spec.num_classes, 1, plain=True)
    return rows


class Net:
    """The forward over a flat weight dict `W`.

    `mode` "eval" or "calibrate" (module docstring); in "calibrate" mode
    `W`'s `mean` and `var` are set in place. `convs` (optional) collects a
    (name, input shape, weight shape, output shape, stride, groups) row
    for every conv it runs, and `products` the attention products'
    (batch·heads, tokens, dk, dh)."""

    def __init__(self, spec: Spec, W: dict, mode: str = "eval"):
        self.spec, self.W, self.mode = spec, W, mode
        self.convs: list | None = None
        self.products: list | None = None

    # -- one conv + BatchNorm + activation ------------------------------
    def conv(self, name, x, stride=1, padding=0, groups=1, act=True):
        w = self.W[f"{name}.w"]
        y = F.conv2d(x, w, None, stride, padding, 1, groups)
        if self.convs is not None:
            self.convs.append((name, tuple(x.shape), tuple(w.shape), tuple(y.shape), stride, groups))
        if f"{name}.b" in self.W and self.mode == "calibrate":
            with torch.no_grad():
                inv = 1.0 / y.std()
                w.mul_(inv)
                y = y * inv
        if f"{name}.b" in self.W:
            y = y + self.W[f"{name}.b"].view(1, -1, 1, 1)
        else:
            y = self._norm(name, y)
        return F.silu(y) if act else y

    def _norm(self, name, y):
        W = self.W
        gamma, beta = W[f"{name}.gamma"], W[f"{name}.beta"]
        if self.mode == "eval":
            mean, var = W[f"{name}.mean"], W[f"{name}.var"]
        else:
            mean = y.mean((0, 2, 3))
            var = y.var((0, 2, 3), unbiased=False)
            with torch.no_grad():
                W[f"{name}.mean"].copy_(mean)
                W[f"{name}.var"].copy_(y.var((0, 2, 3)))
        scale = gamma * torch.rsqrt(var + BN_EPS)
        return y * scale.view(1, -1, 1, 1) + (beta - mean * scale).view(1, -1, 1, 1)

    # -- blocks ----------------------------------------------------------
    def residual(self, n, x):
        return x + self.conv(f"{n}.conv2", self.conv(f"{n}.conv1", x, padding=1), padding=1)

    def c3k(self, n, x):
        y = self.conv(f"{n}.conv1", x)
        y = self.residual(f"{n}.m.1", self.residual(f"{n}.m.0", y))
        return self.conv(f"{n}.conv3", torch.cat((y, self.conv(f"{n}.conv2", x)), 1))

    def c3k2(self, n, x, reps, c3k):
        parts = list(self.conv(f"{n}.conv1", x).chunk(2, 1))
        for i in range(reps):
            blk = f"{n}.m.{i}"
            parts.append(self.c3k(blk, parts[-1]) if c3k else self.residual(blk, parts[-1]))
        return self.conv(f"{n}.conv2", torch.cat(parts, 1))

    def sppf(self, n, x):
        x = self.conv(f"{n}.conv1", x)
        y1 = F.max_pool2d(x, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        y3 = F.max_pool2d(y2, 5, 1, 2)
        return self.conv(f"{n}.conv2", torch.cat((x, y1, y2, y3), 1))

    def attention(self, n, x, heads):
        b, c, h, w = x.shape
        dh = c // heads
        dk = dh // 2
        t = h * w
        qkv = self.conv(f"{n}.qkv", x, act=False).permute(0, 2, 3, 1).reshape(b, t, heads, 2 * dk + dh)
        q, k, v = qkv.split((dk, dk, dh), -1)
        if self.products is not None:
            self.products.append((b * heads, t, dk, dh))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * dk ** -0.5
        p = torch.softmax(s, -1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, h, w, c)
        pos = self.conv(f"{n}.pe", v.reshape(b, h, w, c).permute(0, 3, 1, 2), padding=1,
                        groups=c, act=False)
        return self.conv(f"{n}.proj", out.permute(0, 3, 1, 2) + pos, act=False)

    def psa(self, n, x, reps, heads):
        a, y = self.conv(f"{n}.conv1", x).chunk(2, 1)
        for i in range(reps):
            blk = f"{n}.m.{i}"
            y = y + self.attention(f"{blk}.attn", y, heads)
            y = y + self.conv(f"{blk}.ffn.1", self.conv(f"{blk}.ffn.0", y), act=False)
        return self.conv(f"{n}.conv2", torch.cat((a, y), 1))

    # -- the whole forward ------------------------------------------------
    def forward(self, x):
        """x (B, 3, H, W) float in [0, 1] -> three NHWC maps (B, H/s, W/s,
        4·reg_max + classes) of raw box and class logits."""
        sp = self.spec
        d, (c0, c1) = sp.depth, sp.csp
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x = self.conv("net.p1.0", x, 2, 1)
        x = self.c3k2("net.p2.1", self.conv("net.p2.0", x, 2, 1), d[0], c0)
        p3 = self.c3k2("net.p3.1", self.conv("net.p3.0", x, 2, 1), d[1], c0)
        p4 = self.c3k2("net.p4.1", self.conv("net.p4.0", p3, 2, 1), d[2], c1)
        p5 = self.c3k2("net.p5.1", self.conv("net.p5.0", p4, 2, 1), d[3], c1)
        p5 = self.psa("net.p5.3", self.sppf("net.p5.2", p5), d[4], sp.psa_heads())
        h4 = self.c3k2("fpn.h1", torch.cat((up(p5), p4), 1), d[5], c0)
        h3 = self.c3k2("fpn.h2", torch.cat((up(h4), p3), 1), d[5], c0)
        h4b = self.c3k2("fpn.h4", torch.cat((self.conv("fpn.h3", h3, 2, 1), h4), 1), d[5], c0)
        h5b = self.c3k2("fpn.h6", torch.cat((self.conv("fpn.h5", h4b, 2, 1), p5), 1), d[5], c1)
        maps = []
        for i, feat in enumerate((h3, h4b, h5b)):
            bx = self.conv(f"head.box.{i}.1", self.conv(f"head.box.{i}.0", feat, padding=1), padding=1)
            bx = self.conv(f"head.box.{i}.2", bx, act=False)
            c = feat
            c = self.conv(f"head.cls.{i}.0", c, padding=1, groups=c.shape[1])
            c = self.conv(f"head.cls.{i}.1", c)
            c = self.conv(f"head.cls.{i}.2", c, padding=1, groups=c.shape[1])
            c = self.conv(f"head.cls.{i}.3", c)
            c = self.conv(f"head.cls.{i}.4", c, act=False)
            maps.append(torch.cat((bx, c), 1).permute(0, 2, 3, 1))
        return maps


def prior_biases(spec: Spec, W: dict):
    """The detection head's prior output biases, as Ultralytics'
    `Detect.bias_init` sets them before training: box logits 1, class
    logits log(5 / classes / (640 / stride)²)."""
    for i, s in enumerate(spec.strides):
        W[f"head.box.{i}.2.b"].fill_(1.0)
        W[f"head.cls.{i}.4.b"].fill_(math.log(5 / spec.num_classes / (640 / s) ** 2))
