"""Host-augment train loader with native decode (counterpart of
`tpu_yolo/data/native_train.py`; the same draws in the same order, so
both loaders give the same batches from the same seed).

Per batch:
  * decode + long-side == S prescale (the load_image contract): ONE
    `load_batch_scaled(bgr=True)` call of data/native_loader.py over every
    source the batch needs (4 per mosaic sample, 8 per mixup, 1 per
    plain), BGR out: on a CUDA `device` by nvJPEG and the placement
    kernels on the card, then copied down ("nvjpeg"); else libjpeg and
    the resize in the GIL-free C++ pool ("native");
  * draws: data/device_augment.py's `draw_mosaic` / `draw_mixup_pair` /
    `draw_plain` and data/augment.py's `draw_photometric`;
  * label math: device_augment's `assemble_mosaic` / `assemble_mixup` /
    `assemble_plain`;
  * pixel assembly: numpy quadrant paste + cv2.warpAffine + photometric
    + HSV LUT + flips in BGR, the Python dataset's own pixel ops, so that
    given the same decoded sources the samples are the same bits.

`interp="random"` (the default) draws the prescale interpolation per
source from the host path's set (data/image.py), as the Python loader
does; "bilinear" pins the deterministic mode. Geometry (dims, labels)
is the same either way.

Batches are heterogeneous: each sample draws its mode with the host
__getitem__ Bernoulli flow. Yields (images (B, S, S, 3) uint8 RGB,
targets {"cls", "box", "idx"}), the collate() contract, so it takes
data/loader.py::DataLoader's place in train/trainer.py (--native-train).
Off the card it needs the host data library (native_loader.available())
and raises without it: with cv2 decoding it would be the Python loader
again. `stager` names the decode.
"""
from __future__ import annotations

import queue
import random as _random
import threading

import cv2
import numpy as np

from tpu_yolo_torch.data.augment import (draw_photometric, hsv_apply,
                                         photometric_apply)
from tpu_yolo_torch.data.device_augment import (_compose_affine,
                                                _mosaic_placement,
                                                assemble_mixup, assemble_mosaic,
                                                assemble_plain, draw_mixup_pair,
                                                draw_mosaic, draw_plain)
from tpu_yolo_torch.data.labels import load_labels

# the host _TRAIN_INTERPS draw set (data/image.py) as cv2 enum codes:
# (AREA, CUBIC, LINEAR, NEAREST, LANCZOS4)
_INTERP_CODES = (3, 2, 1, 0, 4)


def assemble_pixels_mosaic(draw: dict, staged, dims, size: int,
                           failed=frozenset()):
    """Mosaic pixel assembly from staged sources: the mosaic4 +
    random_affine image ops replayed from a pre-drawn `draw`. `staged`:
    (4, St, St, 3) uint8 BGR, top-left anchored; `dims`: (4, >=2)
    [staged_h, staged_w, ...]. Returns the warped (size, size, 3) BGR
    canvas (flips and HSV come after mixup, in finish_sample)."""
    canvas = np.zeros((size * 2, size * 2, 3), np.uint8)
    for q in range(4):
        h, w = int(dims[q][0]), int(dims[q][1])
        if h <= 0 or q in failed:
            continue
        (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = _mosaic_placement(
            q, draw["xc"], draw["yc"], w, h, size)
        canvas[y1a:y2a, x1a:x2a] = staged[q, y1b:y2b, x1b:x2b]
    matrix = _compose_affine(draw["s"], draw.get("angle", 0.0),
                             draw.get("shear_x", 0.0), draw.get("shear_y", 0.0),
                             draw["tx"], draw["ty"], size, size)
    return cv2.warpAffine(canvas, matrix[:2], dsize=(size, size),
                          borderValue=(0, 0, 0))


def assemble_pixels_plain(draw: dict, staged_img, sh: int, sw: int, size: int):
    """Plain-path pixel assembly: letterbox pad + random_affine warp. The
    prescale already gives long side == size, so the train letterbox is
    the centred round(pad -/+ 0.1) pad of data/image.py. `staged_img` is
    BGR."""
    canvas = np.zeros((size, size, 3), np.uint8)
    if sh > 0:
        top = int(round((size - sh) / 2 - 0.1))
        left = int(round((size - sw) / 2 - 0.1))
        canvas[top:top + sh, left:left + sw] = staged_img[:sh, :sw]
    matrix = _compose_affine(draw["s"], draw.get("angle", 0.0),
                             draw.get("shear_x", 0.0), draw.get("shear_y", 0.0),
                             draw["tx"], draw["ty"], size / 2, size / 2)
    return cv2.warpAffine(canvas, matrix[:2], dsize=(size, size),
                          borderValue=(0, 0, 0))


def finish_sample(img_bgr, draw, photo: dict):
    """The __getitem__ tail on an assembled BGR image: photometric ->
    HSV (pre-drawn float64 gains) -> flips. Boxes are already flipped by
    the assemble_* label math; only pixels flip here. Returns RGB."""
    img_bgr = photometric_apply(img_bgr, photo)
    hsv_apply(img_bgr, draw["gains"])
    if draw["flip_ud"]:
        img_bgr = cv2.flip(img_bgr, 0)
    if draw["flip_lr"]:
        img_bgr = cv2.flip(img_bgr, 1)
    return cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)


class NativeTrainLoader:
    """Train loader: native decode and prescale (on the card with a CUDA
    `device`, else in the C++ pool), host cv2 augment.

    The constructor mirrors DeviceAugmentLoader's (filenames, input_size,
    hyp, per-process batch_size, cache_path, threads, seed,
    num_shards/shard, device). `mosaic` is the trainer's final-10-epochs
    cutoff; `photometric` turns on the p=0.01 photometric extras of the
    Python dataset; `prefetch` batches are made ahead in a thread."""

    def __init__(self, filenames, input_size: int, hyp: dict,
                 batch_size: int, cache_path: str | None = None,
                 threads: int = 8, seed: int = 0,
                 num_shards: int = 1, shard: int = 0,
                 prefetch: int = 2, photometric: bool = True,
                 interp: str = "random", device=None):
        from tpu_yolo_torch.data import native_loader

        card = device is not None and str(device).startswith("cuda")
        if not card and not native_loader.available():
            raise RuntimeError(f"--native-train needs the host data library off "
                               f"the card: {native_loader.why_unavailable()}")
        if interp not in ("random", "bilinear"):
            raise ValueError(f"interp must be random|bilinear: {interp!r}")
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
        self.prefetch = prefetch
        self.photometric = photometric
        self.interp = interp
        self.mosaic = hyp.get("mosaic", 1.0) > 0
        self._epoch = 0
        self._pipe = (native_loader.CardPipeline(input_size, threads=threads,
                                                 device=device) if card
                      else native_loader.NativePipeline(input_size, threads=threads))
        self.stager = self._pipe.stager

    def __len__(self):
        return (len(self.filenames) // self.num_shards) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _plan_sample(self, primary: int, rng, np_rng):
        """Mode and draws of one sample: the host __getitem__ flow."""
        st, n = self.input_size, len(self.filenames)
        if self.mosaic and rng.random() < self.hyp["mosaic"]:
            if rng.random() < self.hyp["mix_up"]:
                d1, d2, alpha = draw_mixup_pair(rng, np_rng, primary, n,
                                                self.hyp, st)
                plan = ("mixup", (d1, d2, alpha), d1["indices"] + d2["indices"])
            else:
                d = draw_mosaic(rng, np_rng, primary, n, self.hyp, st)
                plan = ("mosaic", d, d["indices"])
        else:
            d = draw_plain(rng, np_rng, self.hyp, st)
            plan = ("plain", d, [primary])
        photo = draw_photometric(rng) if self.photometric else {}
        return plan + (photo,)

    def _make_batch(self, primaries, rng, np_rng):
        st = self.input_size
        plans = [self._plan_sample(p, rng, np_rng) for p in primaries]
        flat_idx = [i for (_, _, srcs, _) in plans for i in srcs]
        offs = np.cumsum([0] + [len(srcs) for (_, _, srcs, _) in plans])
        interps = ([rng.choice(_INTERP_CODES) for _ in flat_idx]
                   if self.interp == "random" else None)
        staged, dims, _ = self._pipe.load_batch_scaled(
            [self.filenames[i] for i in flat_idx], st, interps=interps, bgr=True)
        if self.stager == "nvjpeg":   # the cv2 augment runs on the host
            staged = staged.cpu().numpy()

        images, cls_all, box_all, idx_all = [], [], [], []
        for k, (mode, draw, srcs, photo) in enumerate(plans):
            lo = offs[k]
            d_k = dims[lo:lo + len(srcs)]
            s_k = staged[lo:lo + len(srcs)]
            # a slot neither the decoder nor cv2 could read has dims[0] < 0
            dims_of = {}
            failed_q = [frozenset(), frozenset()]
            for j, src in enumerate(srcs):
                if d_k[j][0] < 0:
                    failed_q[j // 4] |= {j % 4}
                else:
                    dims_of[src] = (int(d_k[j][0]), int(d_k[j][1]))

            def get_dims(i):
                return dims_of.get(i, (0, 0))

            def label_of(i):
                return self.labels[i]

            if mode == "mosaic":
                _, cls, box = assemble_mosaic(draw, get_dims, label_of, st,
                                              failed=failed_q[0],
                                              general=self.general)
                img = assemble_pixels_mosaic(draw, s_k, d_k, st, failed=failed_q[0])
            elif mode == "mixup":
                d1, d2, alpha = draw
                _, cls, box = assemble_mixup(d1, d2, alpha, get_dims, label_of, st,
                                             failed1=failed_q[0], failed2=failed_q[1],
                                             general=self.general)
                i1 = assemble_pixels_mosaic(d1, s_k[:4], d_k[:4], st, failed=failed_q[0])
                i2 = assemble_pixels_mosaic(d2, s_k[4:], d_k[4:], st, failed=failed_q[1])
                # the host blend (data/augment.py::mixup): float64
                # product, truncating uint8 cast
                img = (i1 * alpha + i2 * (1 - alpha)).astype(np.uint8)
                draw = d1      # the tail (photometric, HSV, flips) uses d1
            else:
                bad = bool(d_k[0][0] < 0)
                sh, sw = (0, 0) if bad else (int(d_k[0][0]), int(d_k[0][1]))
                _, cls, box = assemble_plain(draw, (sh, sw), self.labels[srcs[0]], st,
                                             failed=bad, general=self.general)
                img = assemble_pixels_plain(draw, s_k[0], sh, sw, st)

            images.append(finish_sample(img, draw, photo))
            cls_all.append(cls)
            box_all.append(box)
            idx_all.append(np.full(len(cls), k, np.float32))

        targets = {
            "cls": np.concatenate(cls_all) if cls_all else np.zeros((0, 1), np.float32),
            "box": np.concatenate(box_all) if box_all else np.zeros((0, 4), np.float32),
            "idx": np.concatenate(idx_all) if idx_all else np.zeros((0,), np.float32),
        }
        return np.stack(images), targets

    def __iter__(self):
        # DeviceAugmentLoader's order, shard and draw-stream scheme: the
        # same shuffle in every process, disjoint slices, decorrelated draws
        rng = _random.Random(self.seed + self._epoch)
        np_rng = np.random.default_rng(
            (self.seed + self._epoch) * self.num_shards + self.shard)
        order = list(range(len(self.filenames)))
        rng.shuffle(order)
        order = order[self.shard::self.num_shards]
        rng = _random.Random((self.seed + self._epoch) * self.num_shards + self.shard)

        bs = self.batch_size
        batches = [order[b * bs:(b + 1) * bs] for b in range(len(self))]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for primaries in batches:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(primaries, rng, np_rng))
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
