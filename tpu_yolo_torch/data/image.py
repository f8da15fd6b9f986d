"""Host-side image decode and letterbox geometry (counterpart of
`tpu_yolo/data/image.py`). The rounding conventions (the ±0.1 center-pad
split, "never upscale at eval") match it exactly, and with `random`
seeded alike the training forms draw the same interpolations.
`cv2` is imported only by the functions that decode or resize."""
from __future__ import annotations

import random

import numpy as np


def _interp(augment: bool):
    """Bilinear, or for training a random choice of five interpolations."""
    import cv2

    if not augment:
        return cv2.INTER_LINEAR
    return random.choice((cv2.INTER_AREA, cv2.INTER_CUBIC, cv2.INTER_LINEAR,
                          cv2.INTER_NEAREST, cv2.INTER_LANCZOS4))


def load_image(path: str, input_size: int, augment: bool = False):
    """Decode BGR and pre-scale so the long side is input_size.

    Returns (image, (orig_h, orig_w))."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot decode image: {path}")
    h, w = img.shape[:2]
    r = input_size / max(h, w)
    if r != 1:
        img = cv2.resize(img, (int(w * r), int(h * r)),
                         interpolation=_interp(augment))
    return img, (h, w)


def letterbox(img: np.ndarray, input_size: int, augment: bool = False):
    """Scale-preserving resize (never up, unless `augment`) + center pad
    to (input_size, input_size).

    Returns (padded_image, (rw, rh) scale ratios, (pad_w, pad_h) in px)."""
    import cv2

    h, w = img.shape[:2]
    r = min(input_size / h, input_size / w)
    if not augment:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    pad_w = (input_size - new_w) / 2
    pad_h = (input_size - new_h) / 2

    if (w, h) != (new_w, new_h):
        img = cv2.resize(img, (new_w, new_h), interpolation=_interp(augment))

    top, bottom = int(round(pad_h - 0.1)), int(round(pad_h + 0.1))
    left, right = int(round(pad_w - 0.1)), int(round(pad_w + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT)
    return img, (r, r), (pad_w, pad_h)


def eval_geometry(orig_hw, input_size: int):
    """Original-image -> letterboxed-pixel mapping of the eval decode
    path (load_image prescale, then letterbox, augment=False), without
    decoding the image.

    Returns (gain (gx, gy), pad (pad_w, pad_h)) such that
    x_lb = x_orig * gx + pad_w: the mapping DetectionDataset applies to
    GT labels, so detections are un-letterboxed with its exact inverse
    (the COCO-protocol metrics, eval/coco_eval.py, whose area buckets
    are defined in original-image pixels)."""
    h, w = orig_hw
    r1 = input_size / max(h, w)
    w1, h1 = (int(w * r1), int(h * r1)) if r1 != 1 else (w, h)
    r2 = min(input_size / h1, input_size / w1, 1.0)
    new_w, new_h = int(round(w1 * r2)), int(round(h1 * r2))
    pad_w = (input_size - new_w) / 2
    pad_h = (input_size - new_h) / 2
    return (r2 * w1 / w, r2 * h1 / h), (pad_w, pad_h)


def bgr_hwc_to_rgb(img: np.ndarray) -> np.ndarray:
    """HWC BGR (OpenCV) -> HWC RGB contiguous uint8."""
    return np.ascontiguousarray(img[:, :, ::-1])
