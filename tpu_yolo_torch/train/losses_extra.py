"""Alternative classification losses: focal, quality-focal, varifocal
(counterpart of `tpu_yolo/train/losses_extra.py`). The main loss path does
not use them; they swap into `detection_loss`'s BCE slot for experiments.
All take raw logits and return elementwise losses of the input's shape;
reduction is the caller's business."""
from __future__ import annotations

import torch


def bce_with_logits(logits, targets):
    """Numerically stable elementwise binary cross-entropy."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 1.5):
    """BCE modulated by (1 - p_t)^gamma with alpha class balancing."""
    loss = bce_with_logits(logits, targets)
    prob = torch.sigmoid(logits)
    p_t = targets * prob + (1.0 - targets) * (1.0 - prob)
    loss = loss * (1.0 - p_t) ** gamma
    if alpha > 0:
        alpha_t = targets * alpha + (1.0 - targets) * (1.0 - alpha)
        loss = loss * alpha_t
    return loss


def quality_focal_loss(logits, targets, beta: float = 2.0):
    """BCE weighted by |target - sigmoid(logit)|^beta, for IoU-soft
    targets."""
    prob = torch.sigmoid(logits)
    return bce_with_logits(logits, targets) * (targets - prob).abs() ** beta


def varifocal_loss(logits, targets, alpha: float = 0.75, gamma: float = 2.0):
    """Positives weighted by the target quality, negatives by
    alpha * p^gamma."""
    prob = torch.sigmoid(logits)
    weight = torch.where(targets > 0, targets, alpha * prob ** gamma)
    return bce_with_logits(logits, targets) * weight
