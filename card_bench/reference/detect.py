"""Decode and non-max suppression, written out plainly: the reference
for what a serving batch returns.

Every (anchor, class) pair is a candidate (multi-label); the K best by
logit, ties to the lower flat index anchor·classes + class, are ranked;
those whose score sigmoid(logit) passes the confidence threshold are
walked greedily in score order, each kept unless a kept candidate of its
class overlaps it by an IoU above the threshold; the first `max_det`
kept are the detections. Boxes are the DFL expectation over reg_max bins
of each side's distance from the anchor's centre, times the stride.
"""
from __future__ import annotations

import torch


def anchors(spec, hw):
    """(A, 2) anchor centres in grid units and (A,) strides, level-major,
    rows y-outer x-inner."""
    pts, strides = [], []
    for s in spec.strides:
        h, w = hw[0] // s, hw[1] // s
        ys, xs = torch.meshgrid(torch.arange(h) + 0.5, torch.arange(w) + 0.5, indexing="ij")
        pts.append(torch.stack((xs, ys), -1).reshape(-1, 2))
        strides.append(torch.full((h * w,), float(s)))
    return torch.cat(pts), torch.cat(strides)


def dfl(dist_logits, reg_max):
    """(..., 4·reg_max) -> (..., 4): each side's expected bin."""
    p = dist_logits.reshape(*dist_logits.shape[:-1], 4, reg_max).softmax(-1)
    return p @ torch.arange(reg_max, dtype=p.dtype, device=p.device)


def decode(spec, maps):
    """Three NHWC maps -> (B, A, 4) xyxy pixel boxes, (B, A, classes)
    logits, (A,) strides, (A, 2) anchor centres in pixels."""
    b = maps[0].shape[0]
    hw = (maps[0].shape[1] * spec.strides[0], maps[0].shape[2] * spec.strides[0])
    pts, strides = anchors(spec, hw)
    pts, strides = pts.to(maps[0].device), strides.to(maps[0].device)
    flat = torch.cat([m.reshape(b, -1, spec.no) for m in maps], 1).float()
    d = dfl(flat[..., :4 * spec.reg_max], spec.reg_max)
    boxes = torch.cat((pts - d[..., :2], pts + d[..., 2:]), -1) * strides[:, None]
    return boxes, flat[..., 4 * spec.reg_max:], strides, pts * strides[:, None]


def iou(a, b):
    """IoU of xyxy boxes a (..., N, 4) against b (..., M, 4)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2]).clamp(min=0).prod(-1)
    area_b = (b[..., 2:] - b[..., :2]).clamp(min=0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-12)


def nms(boxes, logits, conf_thres, iou_thres, max_det, max_nms):
    """Detections of a decoded batch: {"boxes" (B, max_det, 4), "scores",
    "logits" (the scores' float32 logits), "classes" (-1 where empty),
    "count" (B,)}, and under "candidates" the greedy walk's input: the
    ranked candidates' (B, K, 4) boxes, (B, K) classes and (B, K) whether
    each passes the confidence threshold."""
    b, a, nc = logits.shape
    k = min(max_nms, a * nc)
    flat = logits.reshape(b, -1)
    order = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :k]
    top = flat.gather(1, order)
    scores = torch.sigmoid(top)
    cls = order % nc
    cand = boxes.gather(1, (order // nc)[..., None].expand(b, k, 4))
    valid = scores > conf_thres
    n = int(valid.sum(1).max()) if valid.any() else 0
    # kill[b, i, j]: candidate i suppresses a later candidate j of its class
    kill = ((iou(cand[:, :n], cand[:, :n]) > iou_thres)
            & (cls[:, :n, None] == cls[:, None, :n])
            & torch.ones(n, n, dtype=torch.bool, device=cand.device).triu(1))
    keep = torch.zeros(b, k, dtype=torch.bool, device=cand.device)
    suppressed = torch.zeros(b, n, dtype=torch.bool, device=cand.device)
    for i in range(n):
        keep_i = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = keep_i
        suppressed |= keep_i[:, None] & kill[:, i]
    rank = keep.cumsum(1)
    out_boxes = torch.zeros(b, max_det, 4, device=cand.device)
    out_scores = torch.zeros(b, max_det, device=cand.device)
    out_logits = torch.full((b, max_det), -torch.inf, device=cand.device)
    out_cls = torch.full((b, max_det), -1, dtype=torch.long, device=cand.device)
    sel = keep & (rank <= max_det)
    img, pos = sel.nonzero(as_tuple=True)
    slot = rank[img, pos] - 1
    out_boxes[img, slot] = cand[img, pos]
    out_scores[img, slot] = scores[img, pos]
    out_logits[img, slot] = top[img, pos]
    out_cls[img, slot] = cls[img, pos]
    return {"boxes": out_boxes, "scores": out_scores, "logits": out_logits, "classes": out_cls,
            "count": sel.sum(1), "candidates": (cand, cls, valid)}
