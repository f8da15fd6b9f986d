"""Box geometry: format conversion, pairwise IoU, DFL distribution decode
(counterpart of `tpu_yolo/ops/boxes.py`)."""
from __future__ import annotations

import torch


def xywh_to_xyxy(box):
    """(cx, cy, w, h) -> (x1, y1, x2, y2), any leading dims."""
    cx, cy, w, h = box.unbind(-1)
    return torch.stack((cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2), -1)


def box_iou_pairwise(a, b, eps: float = 1e-7):
    """Plain IoU between all pairs: a (..., N, 4) x b (..., M, 4) -> (..., N, M)."""
    a1, a2 = a[..., :, None, :2], a[..., :, None, 2:]
    b1, b2 = b[..., None, :, :2], b[..., None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area_a = (a2 - a1).clamp(min=0).prod(-1)
    area_b = (b2 - b1).clamp(min=0).prod(-1)
    return inter / (area_a + area_b - inter + eps)


def dfl_expectation(dist_logits, reg_max: int = 16):
    """Distribution Focal Loss decode: softmax expectation over bins,
    as Σ eⱼ·j / Σ eⱼ. dist_logits: (..., 4, reg_max) -> (..., 4)."""
    x = dist_logits.float()
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return (e * proj).sum(-1) / e.sum(-1)


def dfl_decode(dist_logits, anchors, reg_max: int = 16, xywh: bool = True):
    """Decode (..., A, 4*reg_max) DFL logits to boxes at `anchors` (A, 2),
    in feature-grid units (multiply by stride for pixels)."""
    shape = dist_logits.shape[:-1]
    d = dfl_expectation(dist_logits.reshape(*shape, 4, reg_max), reg_max)
    x1y1 = anchors - d[..., :2]
    x2y2 = anchors + d[..., 2:]
    if xywh:
        return torch.cat(((x1y1 + x2y2) / 2, x2y2 - x1y1), -1)
    return torch.cat((x1y1, x2y2), -1)
