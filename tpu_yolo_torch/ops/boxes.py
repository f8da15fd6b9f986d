"""Box geometry: format conversion, IoU / CIoU, DFL distribution decode
(counterpart of `tpu_yolo/ops/boxes.py`)."""
from __future__ import annotations

import math

import torch


def xywh_to_xyxy(box):
    """(cx, cy, w, h) -> (x1, y1, x2, y2), any leading dims."""
    cx, cy, w, h = box.unbind(-1)
    return torch.stack((cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2), -1)


def xyxy_to_xywh(box):
    """(x1, y1, x2, y2) -> (cx, cy, w, h), any leading dims."""
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack(((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1), -1)


def box_iou_pairwise(a, b, eps: float = 1e-7):
    """Plain IoU between all pairs: a (..., N, 4) x b (..., M, 4) -> (..., N, M)."""
    a1, a2 = a[..., :, None, :2], a[..., :, None, 2:]
    b1, b2 = b[..., None, :, :2], b[..., None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area_a = (a2 - a1).clamp(min=0).prod(-1)
    area_b = (b2 - b1).clamp(min=0).prod(-1)
    return inter / (area_a + area_b - inter + eps)


def ciou(box1, box2, eps: float = 1e-7):
    """Complete IoU between aligned xyxy boxes (last dims broadcast):
    IoU - center distance / diagonal - aspect-consistency term, in the JAX
    function's order of operations. Returns shape [..., 1]. `alpha` takes
    no gradient."""
    b1x1, b1y1, b1x2, b1y2 = box1.split(1, -1)
    b2x1, b2y1, b2x2, b2y2 = box2.split(1, -1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps

    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * torch.square(torch.atan(w2 / h2) - torch.atan(w1 / h1))
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def dfl_expectation(dist_logits, reg_max: int = 16):
    """Distribution Focal Loss decode: softmax expectation over bins,
    as Σ eⱼ·j / Σ eⱼ. dist_logits: (..., 4, reg_max) -> (..., 4)."""
    x = dist_logits.float()
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    # the shift cancels in the ratio, so it takes no gradient
    e = torch.exp(x - x.detach().amax(dim=-1, keepdim=True))
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
