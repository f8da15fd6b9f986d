"""YOLO12 written out in plain PyTorch: the reference of the `yolo12x`
configuration.

The graph is Ultralytics' YOLO12 (`ultralytics/cfg/models/12/yolo12.yaml`
with the blocks `AAttn`, `ABlock` and `A2C2f` of
`ultralytics/nn/modules/block.py`; Tian, Ye and Doermann, "YOLOv12:
Attention-Centric Real-Time Object Detectors", arXiv:2502.12524), laid out
as the program under test lays it out:

  backbone  conv 3x3/s2; conv 3x3/s2, C3k2 (e 0.25); conv 3x3/s2, C3k2
            (e 0.25); conv 3x3/s2, A2C2f with area attention in 4 strips
            (P4); conv 3x3/s2, A2C2f with attention over the whole map (P5)
  neck      upsample, cat P4, A2C2f of C3k blocks; upsample, cat P3, the
            same; conv 3x3/s2, cat, the same; conv 3x3/s2, cat P5, C3k2
            with C3k blocks
  head      YOLO11's decoupled head (reference/model.py) on the neck's
            P3, P4 and P5 outputs

A2C2f(c1, c2): cv1 (c1 -> c_ = c2/2), n blocks chained on it (two ABlocks
each, or a C3k), cv2 over the concat of cv1's output and every block's,
and where the configuration has `layer_scale` (l, x) x + scale * cv2(...)
at P4 and P5, `scale` a learned per-channel vector (Ultralytics' `gamma`,
initialised at 0.01). ABlock(C): x + AAttn(x), then x + mlp(x) with mlp a
1x1 conv to int(C * mlp_ratio) (SiLU) and a 1x1 conv back (no
activation). AAttn(C, heads = C / 32, area): qkv = 1x1 conv to 3C (no
activation); channel j belongs to head j // 96, whose [0, 32) are q,
[32, 64) k and [64, 96) v; the H·W tokens in row-major order are cut
into `area` runs of H·W / area consecutive tokens, each its own
sequence; o = softmax(q·kᵀ / sqrt(32))·v per head and strip; the result
is proj(o + pe(v)), pe a depthwise 7x7 conv (no activation), proj a 1x1
conv (no activation), o and v with channel head·32 + i.

The two strided convs of P2 and P3 (layers 1 and 3) are dense, as in the
model the paper measured: with them the folded parameters and the convs'
operations (`parameters`, `model_flops`) come to the paper's Table 1 at
every size (x: 59,135,728 and 199.02 GFLOP at 640 px against 59.1M and
199.0; n 6.49, s 21.37, m 67.45, l 88.88 against 6.5, 21.4, 67.5, 88.9),
and the unfolded count to the yaml's own summary less the DFL conv's 16
(x: 59,210,768 against 59,210,784). The yaml of Ultralytics' main
branch splits them into 2 and 4 groups, which gives 58.06M and 182.0 at
x: that model is not the one served (the config's `not_served`).

Departures from Ultralytics: the weights are seeded, not trained
(card_bench/drivers/serve_yolo12.py); BatchNorm's eps is the repo's
1e-3, which is the value Ultralytics' `initialize_weights` gives every
BatchNorm of a detection model (`nn.BatchNorm2d` alone defaults to
1e-5). Weights live in one flat dict under the names of the program's
state dict, as in reference/model.py, whose conv, BatchNorm, C3k, C3k2
and head this file takes over; nothing here imports the program.

Modes: "eval" and "calibrate", as reference/model.py's. "calibrate" sets
the BatchNorm statistics and leaves the layer scale as it is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from card_bench.costs import conv_cost
from card_bench.reference.model import Net, Spec, _c3k, _c3k2, _conv_leaves

HEAD_DIM = 32   # AAttn's per-head width: heads = channels / 32


class Spec12(Spec):
    """A YOLO12 configuration: Spec's keys (`depth` the repeats of p2, p3,
    p4, p5, the top-down and the bottom-up stages) and `area` (the strips
    of the P4 and P5 attention), `mlp_ratio`, `layer_scale`."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.area = tuple(cfg["area"])
        self.mlp_ratio = cfg["mlp_ratio"]
        self.layer_scale = cfg["layer_scale"]


def _ablock(n, ch, mlp_ratio):
    hidden = int(ch * mlp_ratio)
    return (_conv_leaves(f"{n}.attn.qkv", ch, 3 * ch, 1)
            + _conv_leaves(f"{n}.attn.pe", ch, ch, 7, groups=ch)
            + _conv_leaves(f"{n}.attn.proj", ch, ch, 1)
            + _conv_leaves(f"{n}.mlp.0", ch, hidden, 1)
            + _conv_leaves(f"{n}.mlp.1", hidden, ch, 1))


def _a2c2f(n, cin, cout, reps, a2, spec: Spec12):
    c_ = cout // 2
    rows = _conv_leaves(f"{n}.conv1", cin, c_, 1) + _conv_leaves(f"{n}.conv2", (1 + reps) * c_,
                                                                 cout, 1)
    for i in range(reps):
        if a2:
            rows += _ablock(f"{n}.m.{i}.0", c_, spec.mlp_ratio)
            rows += _ablock(f"{n}.m.{i}.1", c_, spec.mlp_ratio)
        else:
            rows += _c3k(f"{n}.m.{i}", c_, c_)
    if a2 and spec.layer_scale:
        rows.append((f"{n}.scale", (cout,), 0))
    return rows


def layout(spec: Spec12):
    """Every leaf of the model: (name, shape, fan_in), fan_in 0 for the
    per-channel vectors (the layer scale among them)."""
    w, d, (c0, c1) = spec.width, spec.depth, spec.csp
    rows = _conv_leaves("net.p1.0", w[0], w[1], 3)
    rows += _conv_leaves("net.p2.0", w[1], w[2], 3) + _c3k2("net.p2.1", w[2], w[3], d[0], c0, 4)
    rows += _conv_leaves("net.p3.0", w[3], w[3], 3)
    rows += _c3k2("net.p3.1", w[3], w[4], d[1], c0, 4)
    rows += _conv_leaves("net.p4.0", w[4], w[4], 3) + _a2c2f("net.p4.1", w[4], w[4], d[2], True, spec)
    rows += _conv_leaves("net.p5.0", w[4], w[5], 3) + _a2c2f("net.p5.1", w[5], w[5], d[3], True, spec)
    rows += _a2c2f("fpn.h1", w[5] + w[4], w[4], d[4], False, spec)
    rows += _a2c2f("fpn.h2", w[4] + w[4], w[3], d[4], False, spec)
    rows += _conv_leaves("fpn.h3", w[3], w[3], 3)
    rows += _a2c2f("fpn.h4", w[3] + w[4], w[4], d[5], False, spec)
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


class Net12(Net):
    """YOLO12's forward over a flat weight dict `W`; `mode`, `convs` and
    `products` as reference/model.py's Net (`products` the area
    attention's (batch·strips·heads, tokens, 32, 32))."""

    def area_attention(self, n, x, area):
        b, c, h, w = x.shape
        heads, d = c // HEAD_DIM, HEAD_DIM
        t = h * w // area
        qkv = self.conv(f"{n}.qkv", x, act=False).permute(0, 2, 3, 1).reshape(b * area, t, heads,
                                                                               3 * d)
        q, k, v = qkv.split((d, d, d), -1)
        if self.products is not None:
            self.products.append((b * area * heads, t, d, d))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        o = o.reshape(b, h, w, c).permute(0, 3, 1, 2)
        pos = self.conv(f"{n}.pe", v.reshape(b, h, w, c).permute(0, 3, 1, 2), padding=3,
                        groups=c, act=False)
        return self.conv(f"{n}.proj", o + pos, act=False)

    def ablock(self, n, x, area):
        x = x + self.area_attention(f"{n}.attn", x, area)
        return x + self.conv(f"{n}.mlp.1", self.conv(f"{n}.mlp.0", x), act=False)

    def a2c2f(self, n, x, reps, area=None):
        """area None: C3k blocks; else two ABlocks a repeat, attending in
        `area` strips."""
        y = [self.conv(f"{n}.conv1", x)]
        for i in range(reps):
            blk = f"{n}.m.{i}"
            if area is None:
                y.append(self.c3k(blk, y[-1]))
            else:
                y.append(self.ablock(f"{blk}.1", self.ablock(f"{blk}.0", y[-1], area), area))
        out = self.conv(f"{n}.conv2", torch.cat(y, 1))
        scale = self.W.get(f"{n}.scale")
        return out if scale is None else x + scale.view(1, -1, 1, 1) * out

    def forward(self, x):
        """x (B, 3, H, W) float in [0, 1] -> three NHWC maps (B, H/s, W/s,
        4·reg_max + classes) of raw box and class logits."""
        sp = self.spec
        d, (c0, c1), (a4, a5) = sp.depth, sp.csp, sp.area
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x = self.conv("net.p1.0", x, 2, 1)
        x = self.c3k2("net.p2.1", self.conv("net.p2.0", x, 2, 1), d[0], c0)
        p3 = self.c3k2("net.p3.1", self.conv("net.p3.0", x, 2, 1), d[1], c0)
        p4 = self.a2c2f("net.p4.1", self.conv("net.p4.0", p3, 2, 1), d[2], a4)
        p5 = self.a2c2f("net.p5.1", self.conv("net.p5.0", p4, 2, 1), d[3], a5)
        h4 = self.a2c2f("fpn.h1", torch.cat((up(p5), p4), 1), d[4])
        h3 = self.a2c2f("fpn.h2", torch.cat((up(h4), p3), 1), d[4])
        h4b = self.a2c2f("fpn.h4", torch.cat((self.conv("fpn.h3", h3, 2, 1), h4), 1), d[5])
        h5b = self.c3k2("fpn.h6", torch.cat((self.conv("fpn.h5", h4b, 2, 1), p5), 1), d[5], c1)
        maps = []
        for i, feat in enumerate((h3, h4b, h5b)):
            bx = self.conv(f"head.box.{i}.1", self.conv(f"head.box.{i}.0", feat, padding=1),
                           padding=1)
            bx = self.conv(f"head.box.{i}.2", bx, act=False)
            c = self.conv(f"head.cls.{i}.0", feat, padding=1, groups=feat.shape[1])
            c = self.conv(f"head.cls.{i}.1", c)
            c = self.conv(f"head.cls.{i}.2", c, padding=1, groups=c.shape[1])
            c = self.conv(f"head.cls.{i}.3", c)
            c = self.conv(f"head.cls.{i}.4", c, act=False)
            maps.append(torch.cat((bx, c), 1).permute(0, 2, 3, 1))
        return maps


def model_flops(spec: Spec12, batch: int) -> dict:
    """Operations of one forward of `batch` images at the configuration's
    input size, as costs.model_flops counts them for YOLO11: {"conv",
    "attention" (flops), "attention_calls" [(bh, t, 32, 32), ...]}."""
    with torch.device("meta"):
        W = {n: torch.empty(s) for n, s, _ in layout(spec)}
        net = Net12(spec, W)
        net.convs, net.products = [], []
        s = spec.input_size
        net.forward(torch.empty(batch, spec.width[0], s, s))
    conv = sum(conv_cost(x, w, y)[0] for _, x, w, y, _, _ in net.convs)
    attn = sum(2 * bh * t * t * (dk + dh) for bh, t, dk, dh in net.products)
    return {"conv": conv, "attention": attn, "attention_calls": net.products}


def parameters(spec: Spec12) -> int:
    """Parameters with BatchNorm folded: each conv's kernel and one bias a
    output channel, and the layer scales."""
    rows = layout(spec)
    kernels = sum(torch.Size(s).numel() for n, s, f in rows if f)
    biases = sum(s[0] for n, s, f in rows if n.endswith((".mean", ".b")))
    scales = sum(s[0] for n, s, f in rows if n.endswith(".scale"))
    return kernels + biases + scales
