"""First-party COCO-protocol detection evaluator (bbox): the port's own
copy of `tpu_yolo/eval/coco_eval.py` (numpy only), for
`--test --coco-metrics`.

eval/metrics.py reports mAP/mAP50/P/R under the reference's simpler
protocol; this module computes the COCO-API 12-metric table (AP@[.5:.95],
AP50, AP75, AP_small/medium/large, AR@1/10/100) without pycocotools:

  * 10 IoU thresholds 0.50:0.05:0.95, 101 recall points 0:0.01:1;
  * area ranges all / small(<32^2) / medium(32^2..96^2) / large(>96^2);
  * maxDets 1 / 10 / 100 (score-descending truncation per image+class);
  * COCOeval's greedy matcher: detections in score order claim the
    highest-IoU unmatched GT above threshold; GTs outside the area
    range are IGNORE (matches to them don't count either way), and
    unmatched detections whose own area falls outside the range are
    ignored rather than counted as false positives;
  * accumulation: per (class, IoU, area, maxDets) cumulative TP/FP in
    global score order, precision made monotone from the right, sampled
    at the 101 recall points; AP averages over classes with at least
    one non-ignored GT; AR is the mean max recall per class.

Known divergence from pycocotools: COCO annotations carry a
segmentation-mask `area` used for the area buckets; YOLO-txt labels have
no mask, so bbox area w*h is used. There is also no iscrowd handling.

Coordinates: the area buckets are defined in ORIGINAL image pixels, so
callers feed original-space boxes (eval/evaluator.py::evaluate with
coco_ctx un-letterboxes detections via data/image.py::eval_geometry),
unlike the reference-parity mAP, which is computed in letterboxed space.
"""
from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _box_area(xyxy):
    return (np.clip(xyxy[:, 2] - xyxy[:, 0], 0, None)
            * np.clip(xyxy[:, 3] - xyxy[:, 1], 0, None))


def _iou(det_boxes, gt_boxes):
    # exact, like pycocotools' maskUtils.iou (no epsilon: an eps in the
    # denominator shifts boundary cases — IoU exactly at a threshold
    # must match); degenerate/degenerate pairs get 0
    lt = np.maximum(det_boxes[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(det_boxes[:, None, 2:], gt_boxes[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    ua = (_box_area(det_boxes)[:, None] + _box_area(gt_boxes)[None, :]
          - inter)
    return np.where(ua > 0, inter / np.maximum(ua, 1e-12), 0.0)


def _match_one(det_boxes, det_scores, gt_boxes, gt_ignore, iou_thrs):
    """COCOeval.evaluateImg's matcher for one (image, class, area range).

    det_* are score-descending. Returns (dt_matched, dt_ignore), each
    (T, N) — matched flags and ignore flags per IoU threshold.
    """
    t_n = len(iou_thrs)
    n_d, n_g = len(det_boxes), len(gt_boxes)
    dtm = np.zeros((t_n, n_d), bool)
    dtig = np.zeros((t_n, n_d), bool)
    if n_g == 0:
        return dtm, dtig
    # ignored GTs last (stable), as COCOeval sorts by _ignore
    order = np.argsort(gt_ignore, kind="stable")
    gt_boxes = gt_boxes[order]
    gt_ig = gt_ignore[order]
    ious = _iou(det_boxes, gt_boxes) if n_d else np.zeros((0, n_g))
    for ti, thr in enumerate(iou_thrs):
        gtm = np.full(n_g, False)
        for d in range(n_d):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for g in range(n_g):
                if gtm[g]:
                    continue
                # GTs are sorted non-ignored first: once a real match
                # exists, stop at the first ignored GT
                if best > -1 and not gt_ig[best] and gt_ig[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best = g
            if best == -1:
                continue
            gtm[best] = True
            dtm[ti, d] = True
            dtig[ti, d] = gt_ig[best]
    return dtm, dtig


class CocoEvaluator:
    """Accumulates per-image detections/GT, then computes the standard
    COCO 12-metric table. All arrays are numpy on host (the per-eval
    work is tiny next to the device forward, like eval/metrics.py)."""

    def __init__(self, iou_thrs=IOU_THRS, rec_thrs=REC_THRS,
                 area_rng=None, max_dets=MAX_DETS):
        self.iou_thrs = np.asarray(iou_thrs)
        self.rec_thrs = np.asarray(rec_thrs)
        self.area_rng = dict(area_rng or AREA_RNG)
        self.max_dets = tuple(max_dets)
        self._images = []  # (det (N,6) [xyxy, conf, cls], gt (M,5) [cls, xyxy])

    def add_image(self, det, gt):
        """det: (N, 6) [x1,y1,x2,y2,conf,cls]; gt: (M, 5) [cls,x1,y1,x2,y2].
        Original-image pixel coordinates (see module docstring)."""
        det = np.asarray(det, np.float32).reshape(-1, 6)
        gt = np.asarray(gt, np.float32).reshape(-1, 5)
        # score-descending once; all downstream slicing assumes it
        det = det[np.argsort(-det[:, 4], kind="stable")]
        self._images.append((det, gt))

    def accumulate(self):
        """Returns {metric: value} for the standard table, plus
        per-class AP under 'ap_per_class' ({cls: ap})."""
        cats = sorted({int(c) for det, gt in self._images
                       for c in np.concatenate([det[:, 5], gt[:, 0]])})
        t_n, r_n = len(self.iou_thrs), len(self.rec_thrs)
        a_names = list(self.area_rng)
        md = max(self.max_dets)

        # precision[T, R, K, A, M], recall[T, K, A, M]; -1 = undefined
        prec = -np.ones((t_n, r_n, len(cats), len(a_names),
                         len(self.max_dets)))
        rec = -np.ones((t_n, len(cats), len(a_names), len(self.max_dets)))

        for ki, cat in enumerate(cats):
            # per-image per-area matches at maxDet=md; smaller maxDets
            # are prefixes (detections are score-sorted per image)
            per_area = {a: [] for a in a_names}  # (scores, dtm, dtig, npig)
            for det, gt in self._images:
                d = det[det[:, 5] == cat][:md]
                g = gt[gt[:, 0] == cat]
                g_area = _box_area(g[:, 1:5])
                d_area = _box_area(d[:, :4])
                for a in a_names:
                    lo, hi = self.area_rng[a]
                    g_ig = (g_area < lo) | (g_area > hi)
                    dtm, dtig = _match_one(d[:, :4], d[:, 4], g[:, 1:5],
                                           g_ig, self.iou_thrs)
                    # unmatched dets outside the range are ignored too
                    out = ((d_area < lo) | (d_area > hi))[None, :] & ~dtm
                    per_area[a].append(
                        (d[:, 4], dtm, dtig | out, int((~g_ig).sum())))

            for ai, a in enumerate(a_names):
                rows = per_area[a]
                npig = sum(r[3] for r in rows)
                if npig == 0:
                    continue
                for mi, m in enumerate(self.max_dets):
                    scores = np.concatenate([r[0][:m] for r in rows])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([r[1][:, :m] for r in rows],
                                         axis=1)[:, order]
                    dtig = np.concatenate([r[2][:, :m] for r in rows],
                                          axis=1)[:, order]
                    tps = dtm & ~dtig
                    fps = ~dtm & ~dtig
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(t_n):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        rec[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        # monotone-from-the-right envelope (COCOeval)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, self.rec_thrs,
                                               side="left")
                        q = np.zeros(r_n)
                        valid = inds < len(pr)
                        q[valid] = pr[inds[valid]]
                        prec[ti, :, ki, ai, mi] = q

        def _ap(t=None, area="all", max_det=100):
            ai = a_names.index(area)
            mi = self.max_dets.index(max_det)
            p = prec[:, :, :, ai, mi] if t is None else \
                prec[[np.argmin(np.abs(self.iou_thrs - t))], :, :, ai, mi]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(area="all", max_det=100):
            ai = a_names.index(area)
            mi = self.max_dets.index(max_det)
            r = rec[:, :, ai, mi]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        ap_per_class = {}
        ai, mi = a_names.index("all"), self.max_dets.index(100)
        for ki, cat in enumerate(cats):
            p = prec[:, :, ki, ai, mi]
            p = p[p > -1]
            ap_per_class[cat] = float(p.mean()) if p.size else -1.0

        return {
            "AP": _ap(), "AP50": _ap(t=0.5), "AP75": _ap(t=0.75),
            "AP_small": _ap(area="small"), "AP_medium": _ap(area="medium"),
            "AP_large": _ap(area="large"),
            "AR@1": _ar(max_det=1), "AR@10": _ar(max_det=10),
            "AR@100": _ar(max_det=100),
            "AR_small": _ar(area="small"), "AR_medium": _ar(area="medium"),
            "AR_large": _ar(area="large"),
            "ap_per_class": ap_per_class,
        }


def summarize(results: dict) -> str:
    """The COCO-API summary table, line for line."""
    rows = [
        ("Average Precision  (AP)", "0.50:0.95", "   all", 100, "AP"),
        ("Average Precision  (AP)", "0.50     ", "   all", 100, "AP50"),
        ("Average Precision  (AP)", "0.75     ", "   all", 100, "AP75"),
        ("Average Precision  (AP)", "0.50:0.95", " small", 100, "AP_small"),
        ("Average Precision  (AP)", "0.50:0.95", "medium", 100, "AP_medium"),
        ("Average Precision  (AP)", "0.50:0.95", " large", 100, "AP_large"),
        ("Average Recall     (AR)", "0.50:0.95", "   all", 1, "AR@1"),
        ("Average Recall     (AR)", "0.50:0.95", "   all", 10, "AR@10"),
        ("Average Recall     (AR)", "0.50:0.95", "   all", 100, "AR@100"),
        ("Average Recall     (AR)", "0.50:0.95", " small", 100, "AR_small"),
        ("Average Recall     (AR)", "0.50:0.95", "medium", 100, "AR_medium"),
        ("Average Recall     (AR)", "0.50:0.95", " large", 100, "AR_large"),
    ]
    return "\n".join(
        f" {name} @[ IoU={iou} | area={area} | maxDets={md:3d} ] "
        f"= {results[key]:0.3f}" for name, iou, area, md, key in rows)
