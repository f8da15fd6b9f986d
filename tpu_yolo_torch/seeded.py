"""Seeded random weights that behave like trained ones, and a seeded
synthetic mini-COCO, for smoke runs, profiles and tests (chip_smoke.py,
profile_serve.py, profile_train.py).

The seeded Kaiming-uniform weights of `init_params` shrink activations
about 3x per layer, so a model built from them alone outputs its head
biases, the same for every image. `serving_state` sets each BatchNorm's
statistics from one pass over seeded images and draws the class biases
around -3, so the head's outputs depend on the image and NMS sees some
tens to hundreds of candidates per image above the serving conf (0.25);
around -1, a third of all (anchor, class) pairs would clear it.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.nn import ConvBN


def seeded_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """(n, size, size, 3) uint8 images of 8x8-pixel random blocks."""
    blocks = rng.integers(0, 256, (n, size // 8, size // 8, 3), dtype=np.uint8)
    return np.ascontiguousarray(blocks.repeat(8, 1).repeat(8, 2))


def seeded_train_batch(rng: np.random.Generator, n: int, size: int,
                       max_boxes: int = 40, num_classes: int = 80):
    """One training batch: (n, size, size, 3) uint8 images and (n, N, 5)
    f32 padded [cls, x1, y1, x2, y2] pixel targets with 1..max_boxes boxes
    an image, N the smallest of the trainer's buckets (32, 64, ...) that
    holds them."""
    images = seeded_images(rng, n, size)
    counts = rng.integers(1, max_boxes + 1, n)
    bucket = next(b for b in (32, 64, 128, 256, 512) if b >= counts.max())
    gt = np.zeros((n, bucket, 5), np.float32)
    for i, c in enumerate(counts):
        wh = rng.uniform(0.04, 0.5, (c, 2)) * size
        xy1 = rng.uniform(0, 1, (c, 2)) * (size - wh)
        gt[i, :c, 0] = rng.integers(0, num_classes, c)
        gt[i, :c, 1:3] = xy1
        gt[i, :c, 3:5] = xy1 + wh
    return images, gt


NMS_SCENES = ("clustered", "uniform", "disjoint", "identical", "invalid")


def nms_scene(rng: np.random.Generator, scene: str, b: int, k: int):
    """Score-descending NMS candidates for the greedy keep: boxes (b, k, 4)
    f32 xyxy, classes (b, k) int32, valid (b, k) bool.

    clustered: redundant clusters in 8 classes, a tenth invalid (the scenes
    of tests/test_pallas.py); uniform: random boxes in 80 classes, a third
    invalid; disjoint: one class, all valid, no two boxes touch (every
    candidate is kept and is tested against all later ones); identical:
    one box and one class k times (only the first is kept); invalid:
    clustered boxes, none valid."""
    if scene in ("clustered", "invalid"):
        n_obj = max(4, k // 24)
        centers = rng.uniform(40, 600, (b, n_obj, 2))
        sizes = rng.uniform(16, 160, (b, n_obj, 2))
        obj = rng.integers(0, n_obj, (b, k))
        c = np.take_along_axis(centers, obj[..., None], 1) + rng.normal(0, 6, (b, k, 2))
        s = np.take_along_axis(sizes, obj[..., None], 1) * rng.uniform(0.85, 1.15, (b, k, 2))
        boxes = np.concatenate([c - s / 2, c + s / 2], -1)
        cls, valid = rng.integers(0, 8, (b, k)), rng.random((b, k)) > 0.1
        if scene == "invalid":
            valid = np.zeros((b, k), bool)
    elif scene == "uniform":
        xy1 = rng.uniform(0, 600, (b, k, 2))
        boxes = np.concatenate([xy1, xy1 + rng.uniform(4, 200, (b, k, 2))], -1)
        cls, valid = rng.integers(0, 80, (b, k)), rng.random((b, k)) > 0.3
    elif scene == "disjoint":
        side = int(np.ceil(np.sqrt(k)))
        cell = np.stack([np.arange(k) % side, np.arange(k) // side], -1) * 10.0
        xy1 = np.stack([rng.permutation(cell) for _ in range(b)])
        boxes = np.concatenate([xy1, xy1 + rng.uniform(4, 9, (b, k, 2))], -1)
        cls, valid = np.zeros((b, k), int), np.ones((b, k), bool)
    elif scene == "identical":
        boxes = np.tile(np.array([100.0, 120.0, 220.0, 200.0]), (b, k, 1))
        cls, valid = np.full((b, k), 3), np.ones((b, k), bool)
    else:
        raise ValueError(f"nms_scene: {scene!r} is none of {NMS_SCENES}")
    return (np.ascontiguousarray(boxes, np.float32),
            np.ascontiguousarray(cls, np.int32), np.ascontiguousarray(valid))


def serving_state(cfg, seed: int, imgs: np.ndarray, device) -> dict:
    """Unfolded state dict: `init_params(seed)` weights, class biases drawn
    from N(-3, 0.5), and every BatchNorm's mean/var set to those of its
    conv's output on `imgs` (one f32 pass on `device`)."""
    rng = np.random.default_rng(seed)
    params = init_params(seed, cfg)
    for level in params["head"]["cls"]:
        level[4]["b"] = rng.normal(-3.0, 0.5, cfg.num_classes).astype(np.float32)
    model = YOLO.from_state_dict(cfg, from_jax_params(params, cfg)).to(device)

    def set_stats(m, args):
        y = F.conv2d(args[0], m.w, stride=m.stride, padding=m.padding,
                     groups=m.groups)
        m.mean.copy_(y.mean((0, 2, 3)))
        m.var.copy_(y.var((0, 2, 3)))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, ConvBN) and not m.folded]
    try:
        with torch.no_grad():
            model.forward_raw(torch.from_numpy(imgs).to(device).float() / 255)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.cpu() for k, v in model.state_dict().items()}


def eval_state(cfg, seed: int, imgs: np.ndarray, device) -> dict:
    """`serving_state` made for eval runs at 64-128 px on the CPU, set
    from one pass over `imgs`: at each level the head's last class
    weights are scaled so that the logits' image-dependent part has unit
    spread, with biases from N(0, 0.3), so that scores spread over
    (0, 1) and no logit comes near the preimage of conf 0.001 (-6.9),
    where bf16 rounding could move a candidate across the threshold; the
    box weights are scaled to a spread of 0.3 and the bias of one stride
    a side raised by 4, so that boxes of about two strides fit inside
    such images."""
    rng = np.random.default_rng(seed + 1)
    state = serving_state(cfg, seed, imgs, device)
    model = YOLO.from_state_dict(cfg, state).to(device)
    with torch.no_grad():
        raw = model.forward_raw(torch.from_numpy(imgs).to(device).float() / 255)
    reg4 = 4 * cfg.reg_max
    for i, m in enumerate(raw):
        box_w, cls_w = f"head.box.{i}.2.w", f"head.cls.{i}.4.w"
        box_b, cls_b = f"head.box.{i}.2.b", f"head.cls.{i}.4.b"
        box = m[..., :reg4] - state[box_b].to(device)
        cls = m[..., reg4:] - state[cls_b].to(device)
        state[box_w] *= 0.3 / float(box.std())
        state[box_b].view(4, cfg.reg_max)[:, 1] += 4.0
        state[cls_w] /= float(cls.std())
        state[cls_b] = torch.from_numpy(
            rng.normal(0.0, 0.3, cfg.num_classes).astype(np.float32))
    return state


def write_mini_coco(root: str, n_train: int, n_val: int = 0,
                    hw: tuple[int, int] = (120, 160), seed: int = 0,
                    num_classes: int = 2) -> str:
    """A synthetic dataset in the COCO directory layout under `root`:
    images/<split>/*.jpg of random pixels with one bright box each,
    labels/<split>/*.txt with that box in YOLO format, and <split>.txt
    listing the images. The val2017 split is written only when `n_val`
    > 0. Returns `root`."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = hw
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        if n == 0:
            continue
        img_dir = os.path.join(root, "images", split)
        lbl_dir = os.path.join(root, "labels", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        names = []
        for i in range(n):
            img = rng.integers(0, 255, (h, w, 3), np.uint8)
            bw, bh = int(rng.integers(w // 6, w // 2)), int(rng.integers(h // 6, h // 2))
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            cls = i % num_classes
            img[y0:y0 + bh, x0:x0 + bw] = (255, 40 + 60 * cls, 40)
            names.append(os.path.join(img_dir, f"{split}_{i}.jpg"))
            cv2.imwrite(names[-1], img)
            with open(os.path.join(lbl_dir, f"{split}_{i}.txt"), "w") as f:
                f.write(f"{cls} {(x0 + bw / 2) / w:.4f} {(y0 + bh / 2) / h:.4f} "
                        f"{bw / w:.4f} {bh / h:.4f}\n")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def label_from_detections(root: str, model, input_size: int, device="cpu",
                          per_image: int = 30) -> None:
    """Rewrite the val2017 labels under `root` (a `write_mini_coco` tree)
    from `model`'s own detections, so that a mAP over the split is
    far from 0 and moves at every IoU threshold. `model` runs in f32 on
    `device` with the eval settings (conf 0.001, IoU 0.65); per image, its
    `per_image` top-scoring detections that lie inside the image become
    labels: the first of every three as it is, the second shifted right
    by a quarter of its width, the third given the next class. Boxes go
    back to original-image pixels through `eval_geometry`.
    `model` is taken over (folded and moved), as `evaluate` does."""
    from tpu_yolo_torch.data.dataset import split_files
    from tpu_yolo_torch.data.image import (bgr_hwc_to_rgb, eval_geometry,
                                           letterbox, load_image)
    from tpu_yolo_torch.eval.evaluator import predict_step

    files = split_files(root, "val2017")
    nc = model.cfg.num_classes
    model = model.fold_batchnorm().to(device=device, dtype=torch.float32,
                                      memory_format=torch.channels_last).eval()
    for lo in range(0, len(files), 32):
        images, sizes = [], []
        for path in files[lo:lo + 32]:
            img, hw = load_image(path, input_size)
            images.append(bgr_hwc_to_rgb(letterbox(img, input_size)[0]))
            sizes.append(hw)
        res = predict_step(model, torch.from_numpy(np.stack(images)).to(device),
                           compute_dtype=torch.float32)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        for b, (oh, ow) in enumerate(sizes):
            (gx, gy), (pw, ph) = eval_geometry((oh, ow), input_size)
            rows = []
            for x1, y1, x2, y2, cls in zip(*res["boxes"][b].T, res["classes"][b]):
                # to original-image pixels, normalized
                x1, x2 = (x1 - pw) / gx / ow, (x2 - pw) / gx / ow
                y1, y2 = (y1 - ph) / gy / oh, (y2 - ph) / gy / oh
                if len(rows) == per_image or cls < 0:
                    break
                if not (0 <= x1 < x2 <= 1 and 0 <= y1 < y2 <= 1):
                    continue
                if len(rows) % 3 == 1:
                    x1, x2 = x1 + (x2 - x1) / 4, min(x2 + (x2 - x1) / 4, 1.0)
                elif len(rows) % 3 == 2:
                    cls = (cls + 1) % nc
                rows.append(f"{cls} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} "
                            f"{x2 - x1:.6f} {y2 - y1:.6f}\n")
            stem = os.path.splitext(os.path.basename(files[lo + b]))[0]
            with open(os.path.join(root, "labels", "val2017", stem + ".txt"), "w") as f:
                f.writelines(rows)
