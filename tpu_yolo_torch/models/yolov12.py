"""YOLO12 (n/s/m/l/x), Ultralytics' `cfg/models/12/yolo12.yaml` (Tian, Ye
and Doermann, "YOLOv12: Attention-Centric Real-Time Object Detectors",
arXiv:2502.12524), as a torch module. The JAX package has no YOLO12.

It is YOLO11's model (models/yolov11.py) with other stages: the stem, the
FPN's wiring, the decoupled head, NMS, decode, the s2d stem and the
public functions are YOLO11's. In Ultralytics' layer indices:

  net.p1  0 conv 3x3/s2
  net.p2  1 conv 3x3/s2, 2 C3k2 (e 0.25; C3k blocks at m/l/x)
  net.p3  3 conv 3x3/s2, 4 C3k2 (e 0.25)
  net.p4  5 conv 3x3/s2, 6 A2C2f of ABlocks, area attention in 4 strips
  net.p5  7 conv 3x3/s2, 8 A2C2f of ABlocks, attention over the whole map
  fpn.h1  11 A2C2f of C3k blocks on cat(up(p5), p4)
  fpn.h2  14 the same on cat(up(h1), p3)
  fpn.h3, fpn.h4  15 conv 3x3/s2, 17 A2C2f of C3k blocks on cat(h3, h1)
  fpn.h5, fpn.h6  18 conv 3x3/s2, 20 C3k2 (C3k blocks) on cat(h5, p5)
  head    Detect on 14, 17, 20

The strided convs of layers 1 and 3 are dense: the model the paper
measured (59.1M parameters and 199.0 GFLOP at x), which the yaml of
Ultralytics' main branch splits into 2 and 4 groups. At l and x the attention stages
add their output to their input through a learned per-channel scale
(`A2C2f.scale`, Ultralytics' `gamma`). Folding BatchNorm for serving also
pads each ABlock's MLP to a multiple of 8 channels (`ABlock.pad_mlp_`),
so a folded state dict holds the padded widths.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.models.yolov11 import YOLO, _down
from tpu_yolo_torch.ops.blocks import CSP, A2C2f, ABlock
from tpu_yolo_torch.ops.nn import ConvBN

AREA = (4, 1)   # the strips of P4's and P5's area attention, at every size


def _init_yolo12(seed: int, cfg: ModelConfig) -> dict:
    """A fresh YOLO12's parameter tree in the JAX layout
    (`YOLO12.init_params`), as models/yolov11.py's gives YOLO11's: every
    conv kernel Kaiming-uniform, U(±1/sqrt(fan_in)), drawn from numpy's
    generator of `seed` in the order of the state dict; BatchNorm the
    identity; the two plain output convs' biases at the head's priors
    (box 1, class log(5 / classes / (640 / stride)²)); the layer scales
    0.01."""
    from tpu_yolo_torch.io.weights import to_jax_params

    rng = np.random.default_rng(int(seed))
    state = {}
    for name, m in YOLO12(cfg).named_modules():
        if not isinstance(m, ConvBN):
            continue
        o, i, kh, kw = m.w.shape
        bound = 1.0 / math.sqrt(i * kh * kw)
        state[f"{name}.w"] = rng.uniform(-bound, bound, (o, i, kh, kw)).astype(np.float32)
        if m.folded:
            state[f"{name}.b"] = rng.uniform(-bound, bound, o).astype(np.float32)
        else:
            state.update({f"{name}.{leaf}": np.full(o, fill, np.float32) for leaf, fill
                          in (("gamma", 1), ("beta", 0), ("mean", 0), ("var", 1))})
    for i, s in enumerate(cfg.strides):
        state[f"head.box.{i}.2.b"][:] = 1.0
        state[f"head.cls.{i}.4.b"][:] = math.log(5 / cfg.num_classes / (640 / s) ** 2)
    if cfg.layer_scale:
        for stage in ("p4", "p5"):
            state[f"net.{stage}.1.scale"] = np.full(cfg.width[4 if stage == "p4" else 5],
                                                    0.01, np.float32)
    return to_jax_params({k: torch.from_numpy(v) for k, v in state.items()})


class YOLO12(YOLO):
    """YOLO12 of one size (`cfg.arch` "yolo12"); `model_class(cfg)` of a
    YOLO12 configuration."""

    init_params = staticmethod(_init_yolo12)

    @staticmethod
    def _stages(cfg: ModelConfig) -> tuple[nn.ModuleDict, nn.ModuleDict]:
        w, d, (c3k, c3k_head) = cfg.width, cfg.depth, cfg.csp
        a4, a5 = AREA
        attn = dict(mlp_ratio=cfg.mlp_ratio, layer_scale=cfg.layer_scale)
        net = nn.ModuleDict({
            "p1": nn.ModuleList([_down(w[0], w[1])]),
            "p2": nn.ModuleList([_down(w[1], w[2]), CSP(w[2], w[3], d[0], c3k, r=4)]),
            "p3": nn.ModuleList([_down(w[3], w[3]), CSP(w[3], w[4], d[1], c3k, r=4)]),
            "p4": nn.ModuleList([_down(w[4], w[4]), A2C2f(w[4], w[4], d[2], a4, **attn)]),
            "p5": nn.ModuleList([_down(w[4], w[5]), A2C2f(w[5], w[5], d[3], a5, **attn)]),
        })
        fpn = nn.ModuleDict({
            "h1": A2C2f(w[4] + w[5], w[4], d[4]),
            "h2": A2C2f(w[4] + w[4], w[3], d[4]),
            "h3": _down(w[3], w[3]),
            "h4": A2C2f(w[3] + w[4], w[4], d[5]),
            "h5": _down(w[4], w[4]),
            "h6": CSP(w[4] + w[5], w[5], d[5], c3k_head, r=2),
        })
        return net, fpn

    def _p5(self, x, remat=False):
        """The P5 stage: its strided conv and attention stage alone."""
        return self.net["p5"][1](self.net["p5"][0](x), remat=remat)

    @torch.no_grad()
    def fold_batchnorm(self) -> "YOLO12":
        """Fold every BatchNorm into its conv and pad each ABlock's MLP to
        a multiple of 8 channels, in place."""
        super().fold_batchnorm()
        for m in self.modules():
            if isinstance(m, ABlock):
                m.pad_mlp_()
        return self
