"""Task-aligned assignment + detection loss (BCE cls / CIoU box / DFL).

Counterpart of `tpu_yolo/train/loss.py`: full-shape masked arithmetic
over (B, N, A) tensors, no boolean indexing and no host sync, so the
whole loss queues on the device behind the forward pass.

  * align metric = score^0.5 * CIoU^6, top-k 10 through the `topk_mask`
    kernel (ops/topk_cuda.py), masked by row validity: a padded GT row
    selects anchors 0..k-1 and is dropped whole, which is the reference's
    duplicate-count rule;
  * multi-GT anchors resolved to the max-overlap GT;
  * target scores one-hot * normalized align metric;
  * DFL is weighted two-hot cross-entropy over 16 bins with targets
    clamped to reg_max-1-0.01;
  * losses are sum-reduced / max(target_scores.sum(), 1) with the gains
    of the hyperparameter file (box 7.5 / cls 0.5 / dfl 1.5).
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_yolo_torch import parallel
from tpu_yolo_torch.core.config import ModelConfig
from tpu_yolo_torch.ops.anchors import device_anchors
from tpu_yolo_torch.ops.boxes import ciou, dfl_expectation
from tpu_yolo_torch.ops.topk_cuda import topk_mask


def build_padded_targets(targets: dict, batch_size: int, max_gt: int,
                         input_hw) -> np.ndarray:
    """Host-side: flat ragged targets -> padded (B, max_gt, 5) array of
    [cls, x1, y1, x2, y2] in pixels.

    `targets` is the collate output: cls (T,1), box (T,4) normalized
    cxcywh, idx (T,). Rows beyond an image's count are zero (masked by
    box-sum > 0); rows beyond max_gt are dropped.
    """
    h, w = input_hw
    out = np.zeros((batch_size, max_gt, 5), dtype=np.float32)
    idx = np.asarray(targets["idx"]).astype(np.int32).reshape(-1)
    cls = np.asarray(targets["cls"], dtype=np.float32).reshape(-1)
    box = np.asarray(targets["box"], dtype=np.float32).reshape(-1, 4)
    if len(idx) == 0:
        return out
    scale = np.array([w, h, w, h], dtype=np.float32)
    px = box * scale
    xy1 = px[:, :2] - px[:, 2:] / 2
    xy2 = px[:, :2] + px[:, 2:] / 2
    for b in range(batch_size):
        rows = np.nonzero(idx == b)[0][:max_gt]
        n = len(rows)
        out[b, :n, 0] = cls[rows]
        out[b, :n, 1:3] = xy1[rows]
        out[b, :n, 3:5] = xy2[rows]
    return out


# Memory governor for the assigner's dense (B, N, A) planes: above this
# many elements per plane (f32: 640 MiB) the batch is processed in image
# chunks. The assignment is per image, so the result is the same.
ASSIGN_ELEM_BUDGET = 160 * 1024 * 1024


@torch.no_grad()
def task_aligned_assigner(pd_scores, pd_bboxes, anchors_px, gt_labels,
                          gt_bboxes, mask_gt, *, num_classes: int,
                          top_k: int = 10, alpha: float = 0.5,
                          beta: float = 6.0, eps: float = 1e-9,
                          elem_budget: int | None = None):
    """Assign GT boxes to anchors by task-aligned metric. No gradient.

    Args:
      pd_scores: (B, A, nc) sigmoid class scores.
      pd_bboxes: (B, A, 4) predicted xyxy, pixels.
      anchors_px: (A, 2) anchor centers, pixels.
      gt_labels: (B, N, 1); gt_bboxes: (B, N, 4) xyxy pixels (zero rows pad);
      mask_gt: (B, N, 1) 1.0 for real boxes.
      elem_budget: override ASSIGN_ELEM_BUDGET (tests force tiny values
        to run the chunked path on small shapes).
    Returns:
      target_bboxes (B, A, 4), target_scores (B, A, nc), fg_mask (B, A) bool.
    """
    b, n, _ = gt_bboxes.shape
    a = anchors_px.shape[0]

    budget = ASSIGN_ELEM_BUDGET if elem_budget is None else elem_budget
    if b * n * a > budget:
        chunk = max(min(budget // (n * a), b), 1)
        while b % chunk:  # largest divisor of b under the budget
            chunk -= 1
        outs = [task_aligned_assigner(
            pd_scores[i:i + chunk], pd_bboxes[i:i + chunk], anchors_px,
            gt_labels[i:i + chunk], gt_bboxes[i:i + chunk],
            mask_gt[i:i + chunk], num_classes=num_classes, top_k=top_k,
            alpha=alpha, beta=beta, eps=eps,
            elem_budget=b * n * a)  # no re-chunk
            for i in range(0, b, chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    # anchors strictly inside each gt box: the least of the four distances
    # to the box's sides, taken plane by plane (no (B, N, A, 4) tensor)
    ax, ay = anchors_px[:, 0], anchors_px[:, 1]
    x1, y1, x2, y2 = (gt_bboxes[:, :, None, i] for i in range(4))
    mask_in_gts = torch.minimum(torch.minimum(ax - x1, ay - y1),
                                torch.minimum(x2 - ax, y2 - ay)) > eps
    gt_mask = mask_in_gts & (mask_gt > 0)                     # (B, N, A)

    # per-gt class scores at every anchor
    labels = gt_labels[..., 0].long().clamp(0, num_classes - 1)
    scores_t = pd_scores.transpose(1, 2).contiguous()         # (B, nc, A)
    rows = torch.arange(b, device=labels.device)[:, None]
    bbox_scores = scores_t[rows, labels]                      # (B, N, A)
    bbox_scores = torch.where(gt_mask, bbox_scores, 0.0)

    # CIoU overlap of every (gt, anchor-pred) pair, clamped to >= 0
    overlaps = ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])[..., 0]
    overlaps = torch.where(gt_mask, overlaps.clamp(min=0.0), 0.0)

    align = (bbox_scores ** alpha) * (overlaps ** beta)       # (B, N, A)

    # top-k anchors per gt: the hand-written kernel on the card, its plain
    # version on the CPU. For a real GT row the k picks are distinct, so
    # the reference's "count == 1" set is the mask itself; a padded row
    # goes out whole by `& mask_gt`.
    selected = topk_mask(align.contiguous(), top_k)
    mask_topk = (selected & (mask_gt > 0)).to(align.dtype)

    mask_pos = mask_topk * mask_in_gts.to(align.dtype) * mask_gt  # (B, N, A)

    # anchors claimed by several gts -> keep the max-overlap gt
    fg_count = mask_pos.sum(-2)                               # (B, A)
    best_gt = overlaps.argmax(1)                              # (B, A)
    is_best = (torch.arange(n, device=best_gt.device)[None, :, None]
               == best_gt[:, None, :]).to(mask_pos.dtype)
    mask_pos = torch.where(fg_count[:, None, :] > 1, is_best, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0                            # (B, A) bool

    # Each anchor's gt through mask_pos (exactly one 1.0 per fg anchor)
    # instead of argmax + gather; non-fg anchors get zeros. Masked sums in
    # f32, coordinate by coordinate, are exact (x*1 + zeros): a matrix
    # product in TF32 would round pixel coordinates.
    tgt_labels = (mask_pos * labels[:, :, None].to(mask_pos.dtype)) \
        .sum(-2).long()                                       # (B, A)
    target_bboxes = torch.stack(
        [(mask_pos * gt_bboxes[:, :, None, i]).sum(-2) for i in range(4)], -1)

    target_scores = torch.nn.functional.one_hot(tgt_labels, num_classes).float()
    target_scores = torch.where(fg_mask[..., None], target_scores, 0.0)

    # normalize by per-gt peak alignment
    align = align * mask_pos
    pos_align = align.amax(-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align * pos_overlap / (pos_align + eps)).amax(-2)[..., None]  # (B, A, 1)
    target_scores = target_scores * norm

    return target_bboxes, target_scores, fg_mask


def _dfl_loss(dist_logits, target, reg_max: int):
    """Weighted two-hot cross-entropy over distance bins, in f32.

    dist_logits: (B, A, 4, reg_max); target: (B, A, 4) in [0, reg_max-1).
    Returns (B, A) mean over the 4 coordinates.
    """
    logp = torch.log_softmax(dist_logits.float(), -1)
    tl = target.floor().long()
    wr = target - tl
    wl = 1.0 - wr
    # dense two-hot weights: a mask-and-reduce over reg_max lanes instead
    # of two gathers (the same weights at the same bins, plus exact zeros)
    k = torch.arange(reg_max, device=target.device)
    w = (wl[..., None] * (tl[..., None] == k)
         + wr[..., None] * (tl[..., None] + 1 == k))
    return -(logp * w).sum(-1).mean(-1)


def detection_loss(raw_maps, gt, hyp: dict, cfg: ModelConfig):
    """Full training loss from raw per-level maps.

    Args:
      raw_maps: list of 3 NHWC maps (B, H/s, W/s, 4*reg_max + nc).
      gt: (B, N, 5) padded [cls, x1, y1, x2, y2] pixel targets.
      hyp: dict with 'box'/'cls'/'dfl' gains.
    Returns:
      (loss_box, loss_cls, loss_dfl) scalars (sum / max(target_scores_sum,
      1), gains applied). In a process group the sums are this rank's and
      target_scores_sum is the global batch's, so the ranks' losses sum
      to the global batch's.
    """
    nc, reg = cfg.num_classes, cfg.reg_max
    bsz = raw_maps[0].shape[0]
    input_hw = (raw_maps[0].shape[1] * cfg.strides[0],
                raw_maps[0].shape[2] * cfg.strides[0])

    # Split in the compute dtype, then ONE f32 cast per half. The cast of
    # pred_dist is shared by the decode and the DFL loss: with a cast per
    # consumer, their backward gradients would each be rounded to bf16 and
    # summed in bf16 at the fan-out, which the JAX package found to
    # destabilize training.
    levels = [m.reshape(bsz, -1, cfg.no) for m in raw_maps]
    nd = 4 * reg
    pred_dist = torch.cat([m[..., :nd] for m in levels], 1).float()
    pred_cls = torch.cat([m[..., nd:] for m in levels], 1).float()

    anchors, stride_t = device_anchors(tuple(input_hw), tuple(cfg.strides),
                                       pred_dist.device)      # grid units

    # decode boxes in grid units (expectation over the bin distribution)
    dist = dfl_expectation(pred_dist.reshape(bsz, -1, 4, reg), reg)
    lt, rb = dist.chunk(2, -1)
    pred_boxes = torch.cat((anchors - lt, anchors + rb), -1)  # (B, A, 4)

    gt_labels = gt[..., :1]
    gt_bboxes = gt[..., 1:5]
    mask_gt = (gt_bboxes.sum(-1, keepdim=True) > 0).float()

    target_bboxes, target_scores, fg_mask = task_aligned_assigner(
        torch.sigmoid(pred_cls.detach()), pred_boxes.detach() * stride_t,
        anchors * stride_t, gt_labels, gt_bboxes, mask_gt, num_classes=nc)

    # over the global batch in a process group: the clamp is the global
    # sum's, summed over the data axis (parallel/mesh.py); no gradient
    # flows, the assigner's inputs are detached
    tss = parallel.all_reduce_sum(target_scores.sum()).clamp(min=1.0)

    # classification: BCE with logits, sum over everything
    bce = (pred_cls.clamp(min=0) - pred_cls * target_scores
           + torch.log1p(torch.exp(-pred_cls.abs())))
    loss_cls = bce.sum() / tss

    # box + dfl on foreground anchors (masked; zero when no fg)
    weight = target_scores.sum(-1) * fg_mask.float()          # (B, A)
    tb_grid = target_bboxes / stride_t                        # grid units

    iou = ciou(pred_boxes, tb_grid)[..., 0]                   # (B, A)
    loss_box = (torch.where(fg_mask, 1.0 - iou, 0.0) * weight).sum() / tss

    tlt = anchors - tb_grid[..., :2]
    trb = tb_grid[..., 2:] - anchors
    dfl_target = torch.cat((tlt, trb), -1).clamp(0, reg - 1 - 0.01)
    dfl = _dfl_loss(pred_dist.reshape(bsz, -1, 4, reg), dfl_target, reg)
    loss_dfl = (torch.where(fg_mask, dfl, 0.0) * weight).sum() / tss

    return loss_box * hyp["box"], loss_cls * hyp["cls"], loss_dfl * hyp["dfl"]
