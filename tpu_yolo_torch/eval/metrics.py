"""Detection metrics: TP matching and COCO-style mAP (the port's own copy
of `tpu_yolo/eval/metrics.py`, numpy only, bit-equal to it).

These run on the host, once per image and once per eval, on small
arrays; the forward and NMS run on the device.

  * matching: greedy per-threshold IoU matching with the "double unique"
    dedup (first by detection, then by ground truth, in descending-IoU
    order);
  * AP: 101-point interpolated AP over the precision envelope
    (`np.trapezoid`, numpy >= 2.0).
"""
from __future__ import annotations

import numpy as np


def box_iou_np(a, b, eps: float = 1e-7):
    """IoU between all pairs of xyxy boxes: (N,4) x (M,4) -> (N,M)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def match_predictions(det, gt, iou_thresholds):
    """Per-image true-positive matrix.

    Args:
      det: (N, 6) [x1,y1,x2,y2,conf,cls] detections.
      gt:  (M, 5) [cls,x1,y1,x2,y2] ground truth.
      iou_thresholds: (T,) ascending IoU thresholds.
    Returns:
      (N, T) bool — det i is a TP at threshold t.
    """
    det = np.asarray(det, np.float32)
    gt = np.asarray(gt, np.float32)
    n, t = det.shape[0], len(iou_thresholds)
    correct = np.zeros((n, t), dtype=bool)
    if n == 0 or gt.shape[0] == 0:
        return correct

    iou = box_iou_np(gt[:, 1:], det[:, :4])          # (M, N)
    cls_match = gt[:, 0:1] == det[None, :, 5]        # (M, N)

    for ti, thr in enumerate(iou_thresholds):
        gi, di = np.nonzero((iou >= thr) & cls_match)
        if gi.size == 0:
            continue
        pair_iou = iou[gi, di]
        if gi.size > 1:
            order = np.argsort(-pair_iou, kind="stable")
            gi, di = gi[order], di[order]
            # keep best match per detection, then per ground truth
            _, first = np.unique(di, return_index=True)
            gi, di = gi[first], di[first]
            _, first = np.unique(gi, return_index=True)
            gi, di = gi[first], di[first]
        correct[di, ti] = True
    return correct


def smooth(y, f: float = 0.1):
    """Box-filter smoothing over fraction f."""
    nf = round(len(y) * f * 2) // 2 + 1
    pad = np.ones(nf // 2)
    yp = np.concatenate((pad * y[0], y, pad * y[-1]))
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def average_precision(tp, conf, pred_cls, target_cls, eps: float = 1e-16,
                      plot_dir: str | None = None, names=()):
    """COCO-style AP over all classes.

    Args:
      tp: (N, T) bool TP matrix (T IoU thresholds).
      conf: (N,) confidences; pred_cls: (N,); target_cls: (M,).
      plot_dir: also write the PR/F1/P/R curves there (eval/plots.py);
        without matplotlib they are skipped with a message.
    Returns:
      dict with tp/fp counts, precision, recall, map50, map (mAP@.5:.95),
      and the per-class ap matrix.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    classes, n_gt = np.unique(target_cls, return_counts=True)
    nc = classes.shape[0]

    grid = np.linspace(0, 1, 1000)
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    ap = np.zeros((nc, tp.shape[1]))
    pr_curves = []

    for ci, c in enumerate(classes):
        mask = pred_cls == c
        nl = n_gt[ci]
        if mask.sum() == 0 or nl == 0:
            continue
        fp_cum = (1 - tp[mask]).cumsum(0)
        tp_cum = tp[mask].cumsum(0)

        recall = tp_cum / (nl + eps)
        r_curve[ci] = np.interp(-grid, -conf[mask], recall[:, 0], left=0)

        precision = tp_cum / (tp_cum + fp_cum)
        p_curve[ci] = np.interp(-grid, -conf[mask], precision[:, 0], left=1)

        for ti in range(tp.shape[1]):
            m_rec = np.concatenate(([0.0], recall[:, ti], [1.0]))
            m_pre = np.concatenate(([1.0], precision[:, ti], [0.0]))
            m_pre = np.flip(np.maximum.accumulate(np.flip(m_pre)))
            x101 = np.linspace(0, 1, 101)
            ap[ci, ti] = np.trapezoid(np.interp(x101, m_rec, m_pre), x101)
            if plot_dir and ti == 0:
                pr_curves.append(np.interp(grid, m_rec, m_pre))

    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    if plot_dir:
        from tpu_yolo_torch.eval.plots import plot_all_curves
        shown = [names[int(c)] for c in classes] if len(names) else []
        try:
            plot_all_curves(grid, pr_curves, ap, p_curve, r_curve, f1, shown,
                            plot_dir)
        except ImportError as e:  # matplotlib is optional
            print(f"eval curves not plotted: {e}")

    best = smooth(f1.mean(0), 0.1).argmax()
    p, r, f1_b = p_curve[:, best], r_curve[:, best], f1[:, best]
    tp_count = (r * n_gt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return {
        "tp": tp_count,
        "fp": fp_count,
        "precision": float(p.mean()),
        "recall": float(r.mean()),
        "map50": float(ap[:, 0].mean()),
        "map": float(ap.mean(1).mean()),
        "ap_per_class": ap,
        "classes": classes,
    }
