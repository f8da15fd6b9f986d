"""Seeded weights, made on the device in a few large draws.

Every conv kernel is Kaiming-uniform, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
as Ultralytics and the program's own `init_params` draw them, cut from
one uniform draw; BatchNorm's beta 0, mean 0, var 1; the head's prior
biases (reference/model.py::prior_biases). Two settings, from the
traffic file:

  gamma       BatchNorm's scale. Ultralytics starts at 1, where a random
              net of this depth is chaotic: a bf16 rounding grows to
              6-9% of a logit's spread at v11-n against float32. At 0.3
              the calibrated net still amplifies what an image outside
              the calibration set brings, layer by layer through the PSA
              block and the FPN: class logits of 1e3 to 6e8 at v11-x,
              where bf16 and float32 part whatever the arithmetic. At
              0.2 such images stay in the calibrated range, as a trained
              net's do.
  class_bias  the class biases are drawn from N(class_bias, 0.5), then
              each BatchNorm's running statistics set from its conv's
              output on a few of the cell's images and the head's two
              output convs scaled to logits of unit spread there (the
              reference's "calibrate" pass, in float32): weights that
              serve, whose NMS sees some tens to a hundred and more
              candidates an image above a threshold of 0.25.
"""
from __future__ import annotations

import torch

from card_bench.reference.model import Net, Spec, layout, prior_biases
from card_bench.reference.precision import exact_f32


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def init_weights(spec: Spec, seed: int, device) -> dict:
    """{leaf name: float32 tensor on `device`} of a fresh model."""
    gen = _generator(seed, device)
    rows = layout(spec)
    convs = [(n, s, f) for n, s, f in rows if f]
    total = sum(torch.Size(s).numel() for _, s, _ in convs)
    flat = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    W, off = {}, 0
    for name, shape, fan_in in convs:
        n = torch.Size(shape).numel()
        W[name] = flat[off:off + n].view(shape).mul_(fan_in ** -0.5)
        off += n
    for name, shape, fan_in in rows:
        if fan_in:
            continue
        leaf = name.rsplit(".", 1)[1]
        fill = 1.0 if leaf in ("gamma", "var") else 0.0
        W[name] = torch.full(shape, fill, device=device)
    prior_biases(spec, W)
    return W


def make(spec: Spec, seed: int, calib_u8: torch.Tensor, gamma: float,
         class_bias: float) -> dict:
    """Seeded weights on `calib_u8`'s device (module docstring);
    `calib_u8` (N, H, W, 3) uint8 are the images the weights calibrate
    on."""
    device = calib_u8.device
    W = init_weights(spec, seed, device)
    for k, v in W.items():
        if k.endswith(".gamma"):
            v.fill_(gamma)
    gen = _generator(seed + 1, device)
    for i in range(len(spec.strides)):
        W[f"head.cls.{i}.4.b"] = torch.randn(spec.num_classes, generator=gen,
                                             device=device).mul_(0.5).add_(class_bias)
    with torch.no_grad(), exact_f32():
        Net(spec, W, mode="calibrate").forward(calib_u8.permute(0, 3, 1, 2).float() / 255)
    return W
