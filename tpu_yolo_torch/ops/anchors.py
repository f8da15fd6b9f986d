"""Static anchor-grid generation (numpy; a copy of the JAX package's
`tpu_yolo/ops/anchors.py::make_anchors`)."""
from __future__ import annotations

import functools

import numpy as np
import torch


def make_anchors(input_hw: tuple[int, int], strides=(8, 16, 32), offset: float = 0.5):
    """Per-level grid centers (+offset) and stride tensor.

    Returns:
      anchors: (A, 2) float32 — (x, y) grid-cell centers in feature units,
        level-major, rows y-outer x-inner.
      stride_t: (A, 1) float32.
    """
    h, w = input_hw
    anchor_list, stride_list = [], []
    for s in strides:
        fh, fw = h // s, w // s
        sx = np.arange(fw, dtype=np.float32) + offset
        sy = np.arange(fh, dtype=np.float32) + offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        anchor_list.append(np.stack((gx, gy), axis=-1).reshape(-1, 2))
        stride_list.append(np.full((fh * fw, 1), s, dtype=np.float32))
    return np.concatenate(anchor_list), np.concatenate(stride_list)


def num_anchors(input_hw: tuple[int, int], strides=(8, 16, 32)) -> int:
    """The number of anchors of make_anchors(input_hw, strides)."""
    h, w = input_hw
    return sum((h // s) * (w // s) for s in strides)


@functools.lru_cache(maxsize=16)
def device_anchors(input_hw: tuple[int, int], strides, device: torch.device):
    """make_anchors as tensors on `device`, built once per (input_hw,
    strides, device): a copy from pageable host memory waits for the
    stream, so rebuilding per batch would stall the host behind the
    forward pass. Built outside inference mode, so that autograd may
    save them whichever mode made the cache entry."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device)
                     for t in make_anchors(input_hw, strides))
