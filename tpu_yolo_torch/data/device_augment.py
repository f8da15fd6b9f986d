"""Host side of the device-augment train pipeline (counterpart of
`tpu_yolo/data/device_augment.py`; the draws and the label math are the
JAX package's, call for call, so that both loaders give the same batches
from the same seed).

The host draws the augmentation distributions of the host path
(data/augment.py::mosaic4 + random_affine + hsv_jitter + flips) and
computes the labels with the same code (warp_labels_affine), but ships
only raw staged uint8 sources and per-image transform parameters; all
pixel work runs on the card in ops/augment_device.py.

Per output sample the mosaic placement (integer shift + crop into the 2S
canvas) and the random affine (scale s, translation t; degrees and shear
are 0 by default) compose, per axis, into one map
  x_src = x_out / s + (S - t/s) - shift_k
per quadrant k, with the valid source interval [x1b, x2b) from the crop.
Those (inv_scale, offset, lo, hi) are the device parameters.
"""
from __future__ import annotations

import math
import os
import queue
import random as _random
import threading

import numpy as np
import torch

from tpu_yolo_torch.data.augment import (corners_to_norm, denorm_corners,
                                         warp_labels_affine)
from tpu_yolo_torch.data.labels import load_labels


def _mosaic_placement(quadrant, xc, yc, w, h, size):
    """Quadrant crop/paste rectangles — the exact mosaic4 formulas
    (data/augment.py:148-166; reference dataset.py:124-151)."""
    if quadrant == 0:
        x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
        x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
    elif quadrant == 1:
        x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, size * 2), yc
        x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
    elif quadrant == 2:
        x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(size * 2, yc + h)
        x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
    else:
        x1a, y1a, x2a, y2a = xc, yc, min(xc + w, size * 2), min(size * 2, yc + h)
        x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
    return (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b)


def _draw_rotation_shear(rng: _random.Random, hyp: dict, draw: dict):
    """Conditionally draw rotation/shear (the reference random_affine
    draws, dataset.py:330-343). Only consumes RNG when the hyps are
    nonzero so the default-hyp draw stream (and its scripted parity
    tests) is unchanged."""
    if hyp.get("degrees", 0.0):
        draw["angle"] = rng.uniform(-hyp["degrees"], hyp["degrees"])
    if hyp.get("shear", 0.0):
        draw["shear_x"] = math.tan(
            rng.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)
        draw["shear_y"] = math.tan(
            rng.uniform(-hyp["shear"], hyp["shear"]) * math.pi / 180)


def _compose_affine(s, angle_deg, shear_x, shear_y, tx, ty, cx, cy):
    """trans @ shear @ rot @ center — the exact random_affine matrix
    composition (data/augment.py:94-111; reference dataset.py:330-348).
    cv2.getRotationMatrix2D(angle, (0,0), s) = [[a, b, 0], [-b, a, 0]]
    with a = s*cos, b = s*sin. Reduces bit-exactly to the diagonal
    [[s, 0, tx - s*cx], [0, s, ty - s*cy]] at angle = shear = 0."""
    th = math.radians(angle_deg)
    a, b = s * math.cos(th), s * math.sin(th)
    rot = np.array([[a, b, 0.0], [-b, a, 0.0], [0.0, 0.0, 1.0]])
    shear = np.array([[1.0, shear_x, 0.0], [shear_y, 1.0, 0.0],
                      [0.0, 0.0, 1.0]])
    trans = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]])
    center = np.array([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    return trans @ shear @ rot @ center


def draw_mosaic(rng: _random.Random, np_rng: np.random.Generator,
                index: int, n_images: int, hyp: dict, size: int) -> dict:
    """Consume the RNG for one output image (placement center, source
    picks, affine, flips, HSV gains) — separated from assembly so the
    labels/params can be re-assembled with a quadrant dropped when its
    decode fails at load time."""
    border = size // 2
    draw = {
        "xc": int(rng.uniform(border, 2 * size - border)),
        "yc": int(rng.uniform(border, 2 * size - border)),
    }
    indices = [index] + rng.choices(range(n_images), k=3)
    rng.shuffle(indices)
    draw["indices"] = indices
    draw["s"] = rng.uniform(1 - hyp["scale"], 1 + hyp["scale"])
    _draw_rotation_shear(rng, hyp, draw)
    draw["tx"] = rng.uniform(0.5 - hyp["translate"],
                             0.5 + hyp["translate"]) * size
    draw["ty"] = rng.uniform(0.5 - hyp["translate"],
                             0.5 + hyp["translate"]) * size
    draw["flip_ud"] = rng.random() < hyp["flip_ud"]
    draw["flip_lr"] = rng.random() < hyp["flip_lr"]
    draw["gains"] = (np_rng.uniform(-1, 1, 3)
                     * [hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]] + 1)
    return draw


def assemble_mosaic(draw: dict, dims_of, label_of, size: int,
                    failed=frozenset(), general: bool = False):
    """Turn one draw into device params + labels.

    dims_of(i) -> (staged_h, staged_w); label_of(i) -> (N, 5) normalized
    [cls, cx, cy, w, h]. `failed` quadrant indices get zero taps and
    contribute no labels (load-time decode failures). Returns (device
    params dict, cls (M,1), box (M,4) normalized cxcywh — flips already
    applied, the __getitem__ contract).

    `general`: emit the general-affine param format (minv/shift/bounds
    for ops/augment_device.py::augment_batch_general) — required when
    the draw carries rotation/shear; the default separable format only
    models axis-aligned maps.
    """
    xc, yc = draw["xc"], draw["yc"]
    s, tx, ty = draw["s"], draw["tx"], draw["ty"]

    shift_x, shift_y = np.zeros(4, np.float32), np.zeros(4, np.float32)
    lo_x, hi_x = np.zeros(4, np.float32), np.zeros(4, np.float32)
    lo_y, hi_y = np.zeros(4, np.float32), np.zeros(4, np.float32)
    merged = []
    for q, idx in enumerate(draw["indices"]):
        h, w = dims_of(idx)
        if h <= 0 or q in failed:  # decode failure: empty quadrant
            continue
        (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = _mosaic_placement(
            q, xc, yc, int(w), int(h), size)
        shift_x[q] = x1a - x1b
        shift_y[q] = y1a - y1b
        lo_x[q], hi_x[q] = x1b, x2b
        lo_y[q], hi_y[q] = y1b, y2b

        label = label_of(idx).copy()
        if len(label):
            label[:, 1:] = denorm_corners(label[:, 1:], int(w), int(h),
                                          x1a - x1b, y1a - y1b)
            merged.append(label)

    label4 = (np.concatenate(merged, 0) if merged
              else np.zeros((0, 5), np.float32))
    np.clip(label4[:, 1:], 0, 2 * size, out=label4[:, 1:])

    # label affine: the exact random_affine matrix, border
    # = (-size//2, -size//2) (canvas center = size)
    matrix = _compose_affine(s, draw.get("angle", 0.0),
                             draw.get("shear_x", 0.0),
                             draw.get("shear_y", 0.0), tx, ty, size, size)
    label4 = warp_labels_affine(label4, matrix, s, size, size)

    cls, box = _labels_to_targets(label4, size, draw)

    if general:
        params = {
            "minv": np.linalg.inv(matrix)[:2].astype(np.float32),
            "shift_x": shift_x, "shift_y": shift_y,
            "lo_x": lo_x, "hi_x": hi_x, "lo_y": lo_y, "hi_y": hi_y,
            "hsv_gains": draw["gains"].astype(np.float32),
            "flip_lr": draw["flip_lr"], "flip_ud": draw["flip_ud"],
        }
        return params, cls, box

    # separable fast path: x_src = x_out/s + (size - tx/s) - shift
    params = {
        "inv_scale": np.float32(1.0 / s),
        "off_x": (size - tx / s - shift_x).astype(np.float32),
        "off_y": (size - ty / s - shift_y).astype(np.float32),
        "lo_x": lo_x, "hi_x": hi_x, "lo_y": lo_y, "hi_y": hi_y,
        "hsv_gains": draw["gains"].astype(np.float32),
        "flip_lr": draw["flip_lr"], "flip_ud": draw["flip_ud"],
    }
    return params, cls, box


def _labels_to_targets(lab, size: int, draw: dict):
    """Warped pixel-corner labels -> (cls (M,1), box (M,4) normalized
    cxcywh with flips applied) — the __getitem__ tail (data/dataset.py:
    60-74; reference dataset.py:84-101), shared by both assemble paths."""
    cls = lab[:, 0:1].copy()
    box = (corners_to_norm(lab[:, 1:5], size, size) if len(lab)
           else lab[:, 1:5].copy())
    if draw["flip_ud"] and len(box):
        box[:, 1] = 1 - box[:, 1]
    if draw["flip_lr"] and len(box):
        box[:, 0] = 1 - box[:, 0]
    return cls.astype(np.float32), box.astype(np.float32)


def sample_mosaic(rng: _random.Random, np_rng: np.random.Generator,
                  index: int, n_images: int, dims_of, label_of,
                  size: int, hyp: dict):
    """draw_mosaic + assemble_mosaic in one call (the no-failure path;
    returns (source_indices, params, cls, box))."""
    draw = draw_mosaic(rng, np_rng, index, n_images, hyp, size)
    params, cls, box = assemble_mosaic(draw, dims_of, label_of, size)
    return draw["indices"], params, cls, box


_GEOM_KEYS = ("inv_scale", "off_x", "off_y", "lo_x", "hi_x", "lo_y", "hi_y")
_GEOM_KEYS_GENERAL = ("minv", "shift_x", "shift_y",
                      "lo_x", "hi_x", "lo_y", "hi_y")


def draw_mixup_pair(rng: _random.Random, np_rng: np.random.Generator,
                    index: int, n_images: int, hyp: dict, size: int):
    """Draws for one mixup sample: two full mosaic draws + the
    Beta(32,32) blend (host flow data/dataset.py:44-47; reference
    dataset.py:382-387 — the second mosaic's primary is a uniform
    choice)."""
    d1 = draw_mosaic(rng, np_rng, index, n_images, hyp, size)
    other = rng.randrange(n_images)
    d2 = draw_mosaic(rng, np_rng, other, n_images, hyp, size)
    alpha = float(np_rng.beta(32.0, 32.0))
    return d1, d2, alpha


def assemble_mixup(d1: dict, d2: dict, alpha: float, dims_of, label_of,
                   size: int, failed1=frozenset(), failed2=frozenset(),
                   general: bool = False):
    """Mixup params + labels: both mosaics' labels concatenated, the
    SHARED HSV/flip draws (d1's) applied once after the blend — the
    host order (dataset.py:42-73: mixup happens before HSV/flips)."""
    nf1 = dict(d1, flip_ud=False, flip_lr=False)
    nf2 = dict(d2, flip_ud=False, flip_lr=False)
    p1, cls1, box1 = assemble_mosaic(nf1, dims_of, label_of, size,
                                     failed=failed1, general=general)
    p2, cls2, box2 = assemble_mosaic(nf2, dims_of, label_of, size,
                                     failed=failed2, general=general)
    cls = np.concatenate([cls1, cls2], 0)
    box = np.concatenate([box1, box2], 0)
    if len(box):
        if d1["flip_ud"]:
            box[:, 1] = 1 - box[:, 1]
        if d1["flip_lr"]:
            box[:, 0] = 1 - box[:, 0]
    geom = _GEOM_KEYS_GENERAL if general else _GEOM_KEYS
    params = {
        "a": {k: p1[k] for k in geom},
        "b": {k: p2[k] for k in geom},
        "alpha": np.float32(alpha),
        "hsv_gains": d1["gains"].astype(np.float32),
        "flip_lr": d1["flip_lr"], "flip_ud": d1["flip_ud"],
    }
    return params, cls, box


def draw_plain(rng: _random.Random, np_rng: np.random.Generator,
               hyp: dict, size: int) -> dict:
    """RNG draws for the no-mosaic path (letterbox + affine on one
    source; the host __getitem__ else-branch, data/dataset.py:48-58 —
    reference dataset.py:80-101 with random_perspective
    dataset.py:324-351 at degrees=shear=0)."""
    draw = {"s": rng.uniform(1 - hyp["scale"], 1 + hyp["scale"])}
    _draw_rotation_shear(rng, hyp, draw)
    draw.update(
        tx=rng.uniform(0.5 - hyp["translate"],
                       0.5 + hyp["translate"]) * size,
        ty=rng.uniform(0.5 - hyp["translate"],
                       0.5 + hyp["translate"]) * size,
        flip_ud=rng.random() < hyp["flip_ud"],
        flip_lr=rng.random() < hyp["flip_lr"],
        gains=(np_rng.uniform(-1, 1, 3)
               * [hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]] + 1),
    )
    return draw


def assemble_plain(draw: dict, staged_hw, label, size: int, failed=False,
                   general: bool = False):
    """Plain-path params + labels for one sample.

    Mirrors __getitem__'s else-branch label math: letterbox geometry
    (data/image.py, upscale allowed in train) then the random_affine
    label warp with center -size/2 (letterboxed image is size x size).
    `general` emits the minv format for plain_augment_batch_general
    (rotation/shear draws).
    """
    sh, sw = staged_hw
    s, tx, ty = draw["s"], draw["tx"], draw["ty"]
    matrix = _compose_affine(s, draw.get("angle", 0.0),
                             draw.get("shear_x", 0.0),
                             draw.get("shear_y", 0.0), tx, ty,
                             size / 2, size / 2)
    if general:
        params = {
            "minv": np.linalg.inv(matrix)[:2].astype(np.float32),
            "hsv_gains": draw["gains"].astype(np.float32),
            "flip_lr": draw["flip_lr"], "flip_ud": draw["flip_ud"],
        }
    else:
        params = {
            "inv_scale": np.float32(1.0 / s),
            # x_canvas = (x_out - tx)/s + size/2  (warpAffine inverse)
            "off_x": np.float32(size / 2 - tx / s),
            "off_y": np.float32(size / 2 - ty / s),
            "hsv_gains": draw["gains"].astype(np.float32),
            "flip_lr": draw["flip_lr"], "flip_ud": draw["flip_ud"],
        }
    if failed or sh <= 0 or len(label) == 0:
        z = np.zeros((0, 1), np.float32)
        return params, z, np.zeros((0, 4), np.float32)

    r = min(size / sh, size / sw)
    new_w, new_h = int(round(sw * r)), int(round(sh * r))
    pad_w, pad_h = (size - new_w) / 2, (size - new_h) / 2
    lab = label.copy()
    lab[:, 1:] = denorm_corners(lab[:, 1:], r * sw, r * sh, pad_w, pad_h)

    lab = warp_labels_affine(lab, matrix, s, size, size)
    cls, box = _labels_to_targets(lab, size, draw)
    return params, cls, box


class DeviceAugmentLoader:
    """Train loader for the device-augment path.

    Per-sample mode draws follow the host __getitem__: mosaic with prob
    hyp["mosaic"] (while `mosaic` is True; the trainer clears it for the
    final-10-epochs cutoff), then mixup with prob hyp["mix_up"];
    everything else takes the plain letterbox+affine branch. Samples are
    partitioned into homogeneous per-mode batches (the per-sample
    augmentation distribution is exact, batch composition is shuffled)
    and each epoch yields exactly len(self) batches; partial per-mode
    remainders are topped up with resampled same-mode primaries.

    Yields per batch (staged sources and sizes as CPU tensors, pinned
    when `pin_memory`, so that they go to the card asynchronously):
      mosaic: (staged (B, 4, St, St, 3) uint8, params, targets)
        -> ops/augment_device.py::augment_batch
      mixup:  (staged (B, 2, 4, St, St, 3) uint8, params, targets)
        -> mixup_augment_batch (told from mosaic by its ndim)
      plain:  (staged (B, St, St, 3), hw (B, 2) f32, params, targets)
        -> plain_augment_batch
    params are dicts of numpy arrays (nested for mixup; with "minv" for
    the rotation/shear programs); targets are in the collate() contract.
    Sources are staged by data/native_loader.py's staging pipeline: on a
    CUDA `device` the card's (nvJPEG and the placement kernels, the staged
    sources then on the card), else the native library where it loads,
    cv2 otherwise (`stager` says which: "nvjpeg", "native" or "cv2").
    """

    # the host _TRAIN_INTERPS draw set as cv2 enum codes
    _INTERP_CODES = (3, 2, 1, 0, 4)

    def __init__(self, filenames, input_size: int, hyp: dict,
                 batch_size: int, cache_path: str | None = None,
                 threads: int = 8, seed: int = 0,
                 num_shards: int = 1, shard: int = 0,
                 interp: str = "random", pin_memory: bool = False,
                 device=None):
        """num_shards/shard: multi-host partition (each process sees a
        disjoint slice of the identically shuffled order; batch_size is
        the per-host batch). `interp`: "random" (default) draws the
        per-source prescale interpolation of the host path
        (data/image.py); "bilinear" pins the deterministic mode.
        `pin_memory`: stage into pinned memory (needs a card).
        `device`: a CUDA device stages on the card (a failure to build
        or launch its pipeline raises); None or the CPU on the host."""
        from tpu_yolo_torch.data import native_loader

        if interp not in ("random", "bilinear"):
            raise ValueError(f"interp must be random|bilinear: {interp!r}")
        # rotation/shear make the affine non-separable: those batches
        # use the gather programs (params carry "minv")
        self.general = bool(hyp.get("degrees", 0.0) or hyp.get("shear", 0.0))
        labels = load_labels(list(filenames), cache_path)
        self.filenames = list(labels.keys())
        self.labels = list(labels.values())
        self.input_size = input_size
        self.hyp = hyp
        self.batch_size = batch_size
        self.seed = seed
        self.num_shards = max(num_shards, 1)
        self.shard = shard
        self.interp = interp
        self.pin_memory = pin_memory
        self.mosaic = hyp.get("mosaic", 1.0) > 0
        self._epoch = 0
        self._pipe = native_loader.staging_pipeline(input_size, threads=threads,
                                                    device=device)
        self.stager = self._pipe.stager
        self._staged = self._scan_staged_dims(cache_path)

    def _draw_interps(self, rng, n: int):
        return ([rng.choice(self._INTERP_CODES) for _ in range(n)]
                if self.interp == "random" else None)

    def _scan_staged_dims(self, cache_path):
        """(N, 2) staged [h, w] for every image: the placement and label
        math needs the dims before decode. PIL header reads only (no pixel
        decode), cached in a sidecar next to the label cache."""
        sizes_path = (cache_path + ".sizes.npy") if cache_path else None
        orig = None
        if sizes_path and os.path.exists(sizes_path):
            cached = np.load(sizes_path)
            if len(cached) == len(self.filenames):
                orig = cached
        if orig is None:
            from PIL import Image

            orig = np.zeros((len(self.filenames), 2), np.int32)
            for i, p in enumerate(self.filenames):
                try:
                    with open(p, "rb") as f:
                        w, h = Image.open(f).size
                    orig[i] = (h, w)
                except Exception:  # noqa: BLE001  the decode fails too: empty slot
                    orig[i] = (0, 0)
            if sizes_path:
                np.save(sizes_path, orig)
        # the load_image contract: r = S/max(h,w); r != 1 -> int trunc
        staged = orig.astype(np.int64).copy()
        long_side = orig.max(1)
        scale = np.where(long_side > 0,
                         self.input_size / np.maximum(long_side, 1), 0.0)
        resized = (orig * scale[:, None]).astype(np.int64)
        # per-axis >= 1 clamp, as the native decoder's (`if (sh < 1) sh =
        # 1`): an extreme-aspect image must not be marked failed here
        # while it decodes; long_side == 0 (header-scan failure) stays 0
        resized = np.where((long_side > 0)[:, None],
                           np.maximum(resized, 1), resized)
        staged = np.where((long_side != self.input_size)[:, None],
                          resized, staged)
        return staged

    def __len__(self):
        return (len(self.filenames) // self.num_shards) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _staged_dims(self, idx: int):
        return (int(self._staged[idx, 0]), int(self._staged[idx, 1]))

    def _stage(self, indices, rng, shape):
        """Decode the sources `indices` into a new (len, St, St, 3) uint8
        tensor (on the card with the card's pipeline, else on the host,
        pinned when pin_memory), viewed as `shape`; returns (tensor, dims
        (len, 4), n_failures)."""
        st = self.input_size
        paths = [self.filenames[i] for i in indices]
        interps = self._draw_interps(rng, len(indices))
        if self.stager == "nvjpeg":
            buf, dims, nfail = self._pipe.load_batch_scaled(paths, st, interps=interps)
            return buf.view(shape), dims, nfail
        buf = torch.empty((len(indices), st, st, 3), dtype=torch.uint8,
                          pin_memory=self.pin_memory)
        _, dims, nfail = self._pipe.load_batch_scaled(paths, st, interps=interps,
                                                      out=buf.numpy())
        return buf.view(shape), dims, nfail

    def _make_batch(self, primaries, rng, np_rng):
        bs = self.batch_size
        st = self.input_size
        n = len(self.filenames)

        draws = [draw_mosaic(rng, np_rng, p, n, self.hyp, st)
                 for p in primaries]
        flat_idx = [i for d in draws for i in d["indices"]]
        staged, dims, nfail = self._stage(flat_idx, rng, (bs, 4, st, st, 3))

        # quadrants whose decode failed at load time (header read fine,
        # body corrupt): zero taps, no labels; never train boxes on a
        # black quadrant
        failed_by_sample = [frozenset()] * bs
        if nfail:
            bad = np.flatnonzero(dims[:, 0] < 0)
            failed_by_sample = [
                frozenset(int(j % 4) for j in bad if j // 4 == i)
                for i in range(bs)]

        outs = [assemble_mosaic(d, self._staged_dims,
                                lambda i: self.labels[i], st,
                                failed=failed_by_sample[k],
                                general=self.general)
                for k, d in enumerate(draws)]
        params, targets = self._collate_outs(outs)
        return staged, params, targets

    @staticmethod
    def _stack_params(dicts):
        """Stack per-sample param dicts leaf-wise (nested for mixup)."""
        return {
            k: (DeviceAugmentLoader._stack_params([d[k] for d in dicts])
                if isinstance(dicts[0][k], dict)
                else np.stack([np.asarray(d[k]) for d in dicts]))
            for k in dicts[0]
        }

    @staticmethod
    def _collate_outs(outs):
        params = DeviceAugmentLoader._stack_params([o[0] for o in outs])
        cls = [o[1] for o in outs]
        box = [o[2] for o in outs]
        idx = [np.full(len(c), i, dtype=np.float32)
               for i, c in enumerate(cls)]  # 1-D, the collate() contract
        targets = {
            "cls": (np.concatenate(cls) if cls else np.zeros((0, 1), np.float32)),
            "box": (np.concatenate(box) if box else np.zeros((0, 4), np.float32)),
            "idx": (np.concatenate(idx) if idx else np.zeros((0,), np.float32)),
        }
        return params, targets

    def _make_batch_mixup(self, primaries, rng, np_rng):
        """Mixup batch: 8 staged sources per sample (two mosaics)."""
        bs = len(primaries)
        st = self.input_size
        n = len(self.filenames)

        triples = [draw_mixup_pair(rng, np_rng, p, n, self.hyp, st)
                   for p in primaries]
        flat_idx = [i for (d1, d2, _) in triples
                    for i in d1["indices"] + d2["indices"]]
        staged, dims, nfail = self._stage(flat_idx, rng, (bs, 2, 4, st, st, 3))

        failed = [[frozenset(), frozenset()] for _ in range(bs)]
        if nfail:
            bad = np.flatnonzero(dims[:, 0] < 0)
            for j in bad:
                failed[int(j // 8)][int((j % 8) // 4)] |= {int(j % 4)}

        outs = [assemble_mixup(d1, d2, alpha, self._staged_dims,
                               lambda i: self.labels[i], st,
                               failed1=failed[k][0], failed2=failed[k][1],
                               general=self.general)
                for k, (d1, d2, alpha) in enumerate(triples)]
        params, targets = self._collate_outs(outs)
        return staged, params, targets

    def _make_batch_plain(self, primaries, rng, np_rng):
        """No-mosaic batch: one source per sample; images composed by
        plain_augment_batch(staged, hw, params)."""
        st = self.input_size
        draws = [draw_plain(rng, np_rng, self.hyp, st) for _ in primaries]
        staged, dims, nfail = self._stage(primaries, rng,
                                          (len(primaries), st, st, 3))
        # a sample is bad if either side failed (decode now, or the
        # header scan at init), and then both its pixels and its labels
        # are blanked, never one without the other
        bad = [bool(dims[k, 0] < 0) or self._staged_dims(p)[0] <= 0
               for k, p in enumerate(primaries)]
        for k, b in enumerate(bad):
            if b:
                staged[k] = 0
        outs = [assemble_plain(d, self._staged_dims(p), self.labels[p],
                               st, failed=bad[k], general=self.general)
                for k, (d, p) in enumerate(zip(draws, primaries))]
        params, targets = self._collate_outs(outs)
        hw = torch.from_numpy(np.maximum(dims[:, :2], 1.0).astype(np.float32))
        return staged, hw, params, targets

    def _plan_batches(self, order, rng):
        """Per-sample mode draws (the host __getitem__ Bernoulli flow)
        partitioned into homogeneous batches; exactly len(self) batches
        per epoch (partial per-mode remainders topped up with resampled
        same-mode primaries), emission order shuffled."""
        bs = self.batch_size
        p_mos = float(self.hyp.get("mosaic", 1.0)) if self.mosaic else 0.0
        p_mix = float(self.hyp.get("mix_up", 0.0))

        streams = {"mosaic": [], "mixup": [], "plain": []}
        for p in order:
            if rng.random() < p_mos:
                if p_mix > 0 and rng.random() < p_mix:
                    streams["mixup"].append(p)
                else:
                    streams["mosaic"].append(p)
            else:
                streams["plain"].append(p)

        batches, leftovers = [], {}
        for mode, lst in streams.items():
            nfull = len(lst) // bs
            batches += [(mode, lst[b * bs:(b + 1) * bs])
                        for b in range(nfull)]
            leftovers[mode] = lst[nfull * bs:]
        for _ in range(max(len(self) - len(batches), 0)):
            mode = max(leftovers, key=lambda m: len(leftovers[m]))
            pool = streams[mode] or order
            extra = leftovers[mode]
            leftovers[mode] = []
            batch = (extra + [pool[rng.randrange(len(pool))]
                              for _ in range(bs - len(extra))])[:bs]
            batches.append((mode, batch))
        rng.shuffle(batches)
        return batches[:len(self)]

    def __iter__(self):
        rng = _random.Random(self.seed + self._epoch)
        np_rng = np.random.default_rng(
            (self.seed + self._epoch) * self.num_shards + self.shard)
        order = list(range(len(self.filenames)))
        rng.shuffle(order)          # same order on every host...
        order = order[self.shard::self.num_shards]  # ...disjoint slices
        # decorrelate the per-host draw streams after the shared shuffle
        rng = _random.Random((self.seed + self._epoch) * self.num_shards
                             + self.shard)

        batches = self._plan_batches(order, rng)
        makers = {"mosaic": self._make_batch,
                  "mixup": self._make_batch_mixup,
                  "plain": self._make_batch_plain}

        # one-deep prefetch: stage batch i+1 (the card's pipeline, or the
        # C++ or cv2 pool, GIL-free) while the card trains on batch i
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()

        def produce():
            # a producer failure surfaces in the consumer instead of
            # hanging the training loop on q.get()
            try:
                for mode, primaries in batches:
                    if stop.is_set():
                        return
                    q.put(makers[mode](primaries, rng, np_rng))
                q.put(None)
            except Exception as e:  # noqa: BLE001  re-raised by the consumer
                q.put(e)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early frees the producer's put()
            stop.set()
            while worker.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
