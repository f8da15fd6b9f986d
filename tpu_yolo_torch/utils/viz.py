"""Detection drawing: boxes and class labels on images (the port's copy
of `tpu_yolo/utils/viz.py`). Pairs with `serve.Detector` results:

    det = Detector.from_checkpoint("yolo11n.pt")
    for r in det.stream(paths):
        img = draw_detections(cv2.imread(r["path"]), r["boxes"],
                              r["scores"], r["classes"], names=COCO_NAMES)
"""
from __future__ import annotations

import numpy as np


def _palette(i: int):
    """Deterministic bright BGR color per class index."""
    import cv2

    rng = np.random.default_rng(i * 7919 + 11)
    h = rng.integers(0, 180)
    swatch = np.uint8([[[h, 220, 255]]])
    return tuple(int(c) for c in cv2.cvtColor(swatch, cv2.COLOR_HSV2BGR)[0, 0])


def draw_detections(image_bgr: np.ndarray, boxes, scores, classes,
                    names=None, line_width: int | None = None):
    """Draw xyxy `boxes` with per-class colors and `cls score` labels.

    Args:
      image_bgr: HWC uint8 (OpenCV convention); a modified copy is returned.
      boxes: (N, 4) xyxy pixels; scores: (N,); classes: (N,) int.
      names: optional {id: name} mapping or sequence.
    """
    import cv2

    img = image_bgr.copy()
    h, w = img.shape[:2]
    lw = line_width or max(round((h + w) / 2 * 0.003), 2)

    for box, score, cls in zip(np.asarray(boxes), np.asarray(scores),
                               np.asarray(classes)):
        c = int(cls)
        color = _palette(c)
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, lw)

        label = str(names[c]) if names is not None else str(c)
        label = f"{label} {float(score):.2f}"
        ts = cv2.getTextSize(label, 0, lw / 3, max(lw - 1, 1))[0]
        outside = y1 - ts[1] - 3 >= 0
        ty = y1 - 2 if outside else y1 + ts[1] + 2
        cv2.rectangle(img, (x1, y1 - ts[1] - 4 if outside else y1),
                      (x1 + ts[0], y1 if outside else y1 + ts[1] + 4),
                      color, -1)
        cv2.putText(img, label, (x1, ty), 0, lw / 3, (255, 255, 255),
                    max(lw - 1, 1), lineType=cv2.LINE_AA)
    return img
