"""YOLO-format label parsing, verification and caching (the port's own
copy of `tpu_yolo/data/labels.py`; numpy and PIL only).

Verifies each image with PIL, validates label ranges/shape, drops
corrupt samples and duplicate rows, and caches the result next to the
image directory so repeat runs skip the scan. The cache is a pickle of
{filename: (N,5) float32 [cls, cx, cy, w, h] normalized}, the same file
the JAX package reads and writes.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

IMAGE_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp"}
_CACHE_VERSION = 1


def label_path_for(image_path: str) -> str:
    sep_img = f"{os.sep}images{os.sep}"
    sep_lbl = f"{os.sep}labels{os.sep}"
    base = sep_lbl.join(image_path.rsplit(sep_img, 1))
    return base.rsplit(".", 1)[0] + ".txt"


def _verify_one(image_path: str):
    from PIL import Image

    with open(image_path, "rb") as f:
        im = Image.open(f)
        im.verify()
    w, h = im.size
    if w <= 9 or h <= 9:
        raise ValueError(f"image too small: {w}x{h}")
    if (im.format or "").lower() not in IMAGE_FORMATS:
        raise ValueError(f"unsupported format: {im.format}")

    lp = label_path_for(image_path)
    if not os.path.isfile(lp):
        return np.zeros((0, 5), dtype=np.float32)
    with open(lp) as f:
        rows = [line.split() for line in f.read().strip().splitlines() if line]
    if not rows:
        return np.zeros((0, 5), dtype=np.float32)
    label = np.array(rows, dtype=np.float32)
    if label.shape[1] != 5:
        raise ValueError(f"label must have 5 columns: {lp}")
    if (label < 0).any() or (label[:, 1:] > 1).any():
        raise ValueError(f"label out of range: {lp}")
    label = np.unique(label, axis=0) if len(np.unique(label, axis=0)) < len(label) else label
    return label


def load_labels(filenames, cache_path: str | None = None):
    """Verify images + parse labels with a disk cache.

    Returns an ordered dict {image_path: (N,5) float32}.
    """
    if cache_path is None and filenames:
        cache_path = os.path.dirname(filenames[0]) + ".cache.npz.pkl"
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            payload = pickle.load(f)
        if payload.get("version") == _CACHE_VERSION:
            return payload["labels"]

    labels = {}
    n_bad = 0
    for path in filenames:
        try:
            labels[path] = _verify_one(path)
        except FileNotFoundError:
            labels[path] = np.zeros((0, 5), dtype=np.float32)
        except Exception:
            n_bad += 1
            continue
    if n_bad:
        print(f"load_labels: skipped {n_bad} corrupt samples")

    if cache_path:
        with open(cache_path, "wb") as f:
            pickle.dump({"version": _CACHE_VERSION, "labels": labels}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
    return labels
