"""Seeded random weights that behave like trained ones, for smoke runs and
profiles of the serving path (chip_smoke.py, profile_serve.py).

The seeded Kaiming-uniform weights of `init_params` shrink activations
about 3x per layer, so a model built from them alone outputs its head
biases, the same for every image. `serving_state` sets each BatchNorm's
statistics from one pass over seeded images and draws the class biases
around -3, so the head's outputs depend on the image and NMS sees some
tens to hundreds of candidates per image above the serving conf (0.25);
around -1, a third of all (anchor, class) pairs would clear it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.nn import ConvBN


def seeded_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) uint8 images of 8x8-pixel random blocks."""
    blocks = rng.integers(0, 256, (n, size // 8, size // 8, 3), dtype=np.uint8)
    return np.ascontiguousarray(blocks.repeat(8, 1).repeat(8, 2))


def serving_state(cfg, seed: int, imgs: np.ndarray, device) -> dict:
    """Unfolded state dict: `init_params(seed)` weights, class biases drawn
    from N(-3, 0.5), and every BatchNorm's mean/var set to those of its
    conv's output on `imgs` (one f32 pass on `device`)."""
    rng = np.random.default_rng(seed)
    params = init_params(seed, cfg)
    for level in params["head"]["cls"]:
        level[4]["b"] = rng.normal(-3.0, 0.5, cfg.num_classes).astype(np.float32)
    model = YOLO.from_state_dict(cfg, from_jax_params(params, cfg)).to(device)

    def set_stats(m, args):
        y = F.conv2d(args[0], m.w, stride=m.stride, padding=m.padding,
                     groups=m.groups)
        m.mean.copy_(y.mean((0, 2, 3)))
        m.var.copy_(y.var((0, 2, 3)))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, ConvBN) and not m.folded]
    try:
        with torch.no_grad():
            model.forward_raw(torch.from_numpy(imgs).to(device).float() / 255)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.cpu() for k, v in model.state_dict().items()}
