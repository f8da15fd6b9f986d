"""Training-time augmentations (host, numpy/OpenCV): the port's own copy
of `tpu_yolo/data/augment.py`. With `random` and `np.random` seeded alike
it draws the same numbers in the same order and gives the same pixels
and labels. Mosaic, box conversions, HSV jitter, random affine and mixup
are ragged and branchy, so they stay on the host; the device sees
fixed-shape uint8 batches.

Box helpers here operate on normalized [cls, cx, cy, w, h] label rows
and pixel-space corner boxes, matching the reference conventions so
the pipelines produce identical geometry.
"""
from __future__ import annotations

import math
import random

import cv2
import numpy as np


def denorm_corners(label_xywh, w, h, pad_w=0.0, pad_h=0.0):
    """Normalized cxcywh -> pixel xyxy (+pad). (reference dataset.py:239-247)"""
    out = label_xywh.copy()
    cx, cy, bw, bh = label_xywh[:, 0], label_xywh[:, 1], label_xywh[:, 2], label_xywh[:, 3]
    out[:, 0] = w * (cx - bw / 2) + pad_w
    out[:, 1] = h * (cy - bh / 2) + pad_h
    out[:, 2] = w * (cx + bw / 2) + pad_w
    out[:, 3] = h * (cy + bh / 2) + pad_h
    return out


def corners_to_norm(box_xyxy, w, h):
    """Pixel xyxy (clipped in-place like the reference, dataset.py:250-262)
    -> normalized cxcywh."""
    box_xyxy[:, [0, 2]] = box_xyxy[:, [0, 2]].clip(0, w - 1e-3)
    box_xyxy[:, [1, 3]] = box_xyxy[:, [1, 3]].clip(0, h - 1e-3)
    out = box_xyxy.copy()
    out[:, 0] = ((box_xyxy[:, 0] + box_xyxy[:, 2]) / 2) / w
    out[:, 1] = ((box_xyxy[:, 1] + box_xyxy[:, 3]) / 2) / h
    out[:, 2] = (box_xyxy[:, 2] - box_xyxy[:, 0]) / w
    out[:, 3] = (box_xyxy[:, 3] - box_xyxy[:, 1]) / h
    return out


def hsv_apply(img, r):
    """In-place HSV jitter with GIVEN per-channel gains r (the LUT half
    of hsv_jitter; reference dataset.py:274-289). Split out so loaders
    that pre-draw per-sample parameters replay the exact host pixel
    math. `img` is BGR uint8."""
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(256, dtype=np.asarray(r).dtype)
    lut_h = ((x * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s), cv2.LUT(val, lut_v)))
    cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR, dst=img)
    return img


def hsv_jitter(img, gain_h: float, gain_s: float, gain_v: float):
    """In-place HSV color jitter via uint8 LUTs (reference dataset.py:274-289)."""
    r = np.random.uniform(-1, 1, 3) * [gain_h, gain_s, gain_v] + 1
    return hsv_apply(img, r)


def draw_photometric(rng, p: float = 0.01) -> dict:
    """Pre-draw the photometric_jitter decisions (same draw order) so a
    producer thread with its own RNG can replay them via
    photometric_apply. `rng` is a random.Random."""
    d = {}
    if rng.random() < p:
        d["blur"] = rng.choice((3, 5, 7))
    if rng.random() < p:
        d["clahe"] = True
    if rng.random() < p:
        d["gray"] = True
    if rng.random() < p:
        d["median"] = rng.choice((3, 5))
    return d


def photometric_apply(img, d: dict):
    """Apply pre-drawn photometric decisions (the deterministic half of
    photometric_jitter; same op order and parameters). BGR uint8."""
    if "blur" in d:
        img = cv2.blur(img, (d["blur"],) * 2)
    if d.get("clahe"):
        lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
        lab[..., 0] = cv2.createCLAHE(2.0, (8, 8)).apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)
    if d.get("gray"):
        img = cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY),
                           cv2.COLOR_GRAY2BGR)
    if "median" in d:
        img = cv2.medianBlur(img, d["median"])
    return img


def photometric_jitter(img, p: float = 0.01):
    """Rare photometric perturbations: blur / CLAHE / grayscale / median
    blur, each with probability p. Native-OpenCV counterpart of the
    reference's optional Albumentations hook (dataset.py:390-414 —
    Blur/CLAHE/ToGray/MedianBlur at p=0.01), without the optional
    dependency. Purely photometric: boxes are unaffected."""
    return photometric_apply(img, draw_photometric(random, p))


def _box_survives(before, after):
    """Keep boxes that stay big and sane after warp (reference
    dataset.py:316-321): >2px sides, >10% area kept, aspect < 100."""
    w1, h1 = before[2] - before[0], before[3] - before[1]
    w2, h2 = after[2] - after[0], after[3] - after[1]
    aspect = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 + 1e-16) > 0.1) & (aspect < 100)


def random_affine(img, label, hyp, border=(0, 0)):
    """Random scale/rotate/shear/translate with label warp + survival filter
    (reference random_perspective, dataset.py:324-379). `label` rows are
    [cls, x1, y1, x2, y2] in pixels."""
    out_h = img.shape[0] + border[0] * 2
    out_w = img.shape[1] + border[1] * 2

    center = np.eye(3)
    center[0, 2] = -img.shape[1] / 2
    center[1, 2] = -img.shape[0] / 2

    rot = np.eye(3)
    angle = random.uniform(-hyp["degrees"], hyp["degrees"])
    scale = random.uniform(1 - hyp["scale"], 1 + hyp["scale"])
    rot[:2] = cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale)

    shear = np.eye(3)
    shear[0, 1] = math.tan(random.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)
    shear[1, 0] = math.tan(random.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)

    trans = np.eye(3)
    trans[0, 2] = random.uniform(0.5 - hyp["translate"], 0.5 + hyp["translate"]) * out_w
    trans[1, 2] = random.uniform(0.5 - hyp["translate"], 0.5 + hyp["translate"]) * out_h

    matrix = trans @ shear @ rot @ center
    if border != (0, 0) or (matrix != np.eye(3)).any():
        img = cv2.warpAffine(img, matrix[:2], dsize=(out_w, out_h), borderValue=(0, 0, 0))

    return img, warp_labels_affine(label, matrix, scale, out_w, out_h)


def warp_labels_affine(label, matrix, scale, out_w, out_h):
    """Warp [cls, x1, y1, x2, y2] rows through a 3x3 affine + the
    survival filter (the label half of random_affine; reference
    dataset.py:352-378). Shared with the device-augment sampler so both
    paths use identical label math."""
    n = len(label)
    if n:
        pts = np.ones((n * 4, 3))
        pts[:, :2] = label[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        pts = (pts @ matrix.T)[:, :2].reshape(n, 8)
        xs, ys = pts[:, 0::2], pts[:, 1::2]
        warped = np.stack((xs.min(1), ys.min(1), xs.max(1), ys.max(1)), axis=1)
        warped[:, [0, 2]] = warped[:, [0, 2]].clip(0, out_w)
        warped[:, [1, 3]] = warped[:, [1, 3]].clip(0, out_h)

        keep = _box_survives(label[:, 1:5].T * scale, warped.T)
        label = label[keep]
        label[:, 1:5] = warped[keep]

    return label


def mosaic4(dataset, index: int, hyp):
    """Four-image mosaic at 2x canvas then random affine back to size
    (reference load_mosaic, dataset.py:105-176)."""
    size = dataset.input_size
    border = (-size // 2, -size // 2)
    canvas = np.zeros((size * 2, size * 2, 3), dtype=np.uint8)
    merged = []

    xc = int(random.uniform(-border[0], 2 * size + border[1]))
    yc = int(random.uniform(-border[0], 2 * size + border[1]))

    indices = [index] + random.choices(dataset.indices, k=3)
    random.shuffle(indices)

    for quadrant, idx in enumerate(indices):
        img, _ = dataset.read_image(idx)
        h, w = img.shape[:2]
        if quadrant == 0:    # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif quadrant == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, size * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif quadrant == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(size * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:                # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, size * 2), min(size * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)

        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]

        label = dataset.labels[idx].copy()
        if len(label):
            label[:, 1:] = denorm_corners(label[:, 1:], w, h, x1a - x1b, y1a - y1b)
        merged.append(label)

    label4 = np.concatenate(merged, 0)
    np.clip(label4[:, 1:], 0, 2 * size, out=label4[:, 1:])

    return random_affine(canvas, label4, hyp, border)


def mixup(img1, label1, img2, label2):
    """Beta(32,32) image blend, labels concatenated (reference
    dataset.py:382-387)."""
    alpha = np.random.beta(32.0, 32.0)
    img = (img1 * alpha + img2 * (1 - alpha)).astype(np.uint8)
    return img, np.concatenate((label1, label2), 0)
