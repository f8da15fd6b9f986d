"""Detection dataset: sample assembly for train (mosaic/affine/HSV/flip)
and eval (letterbox) paths. The port's own copy of
`tpu_yolo/data/dataset.py`: samples are numpy, a batch is (images,
targets dict). Images are NHWC uint8 RGB (the /255 runs on the device),
so a batch goes to the card as one copy of raw bytes.
"""
from __future__ import annotations

import os
import random

import numpy as np

from tpu_yolo_torch.data import augment as A
from tpu_yolo_torch.data.image import bgr_hwc_to_rgb, letterbox, load_image
from tpu_yolo_torch.data.labels import load_labels


def split_files(data_dir: str, split: str) -> list[str]:
    """The image paths of a COCO-layout split: the names listed in
    <data_dir>/<split>.txt, under <data_dir>/images/<split>/."""
    with open(os.path.join(data_dir, f"{split}.txt")) as f:
        return [os.path.join(data_dir, "images", split,
                             os.path.basename(line.strip()))
                for line in f if line.strip()]


class DetectionDataset:
    def __init__(self, filenames, input_size: int, hyp: dict, augment: bool,
                 cache_path: str | None = None):
        self.hyp = hyp
        self.augment = augment
        self.mosaic = augment
        self.input_size = input_size

        labels = load_labels(list(filenames), cache_path)
        self.filenames = list(labels.keys())
        self.labels = list(labels.values())
        self.indices = range(len(self.filenames))

    def __len__(self):
        return len(self.filenames)

    def read_image(self, index: int):
        return load_image(self.filenames[index], self.input_size, self.augment)

    def __getitem__(self, index: int):
        """Returns (image uint8 HWC RGB, cls (N,1) f32, box (N,4) f32 norm-cxcywh)."""
        if self.mosaic and random.random() < self.hyp["mosaic"]:
            image, label = A.mosaic4(self, index, self.hyp)
            if random.random() < self.hyp["mix_up"]:
                other = random.choice(self.indices)
                image2, label2 = A.mosaic4(self, other, self.hyp)
                image, label = A.mixup(image, label, image2, label2)
        else:
            image, _ = self.read_image(index)
            h, w = image.shape[:2]
            image, ratio, pad = letterbox(image, self.input_size, self.augment)
            label = self.labels[index].copy()
            if label.size:
                label[:, 1:] = A.denorm_corners(label[:, 1:], ratio[0] * w,
                                                ratio[1] * h, pad[0], pad[1])
            if self.augment:
                image, label = A.random_affine(image, label, self.hyp)

        h, w = image.shape[:2]
        cls = label[:, 0:1].copy()
        box = A.corners_to_norm(label[:, 1:5], w, h) if len(label) else label[:, 1:5].copy()

        if self.augment:
            image = A.photometric_jitter(image)
            A.hsv_jitter(image, self.hyp["hsv_h"], self.hyp["hsv_s"], self.hyp["hsv_v"])
            if random.random() < self.hyp["flip_ud"]:
                image = np.flipud(image)
                if len(box):
                    box[:, 1] = 1 - box[:, 1]
            if random.random() < self.hyp["flip_lr"]:
                image = np.fliplr(image)
                if len(box):
                    box[:, 0] = 1 - box[:, 0]

        return bgr_hwc_to_rgb(np.ascontiguousarray(image)), \
            cls.astype(np.float32), box.astype(np.float32)


def collate(samples):
    """Stack images; flatten ragged targets as (cls, box, image-index)
    (reference collate_fn, dataset.py:178-193)."""
    images = np.stack([s[0] for s in samples])
    cls = np.concatenate([s[1] for s in samples], 0)
    box = np.concatenate([s[2] for s in samples], 0)
    idx = np.concatenate(
        [np.full(len(s[1]), i, dtype=np.float32) for i, s in enumerate(samples)])
    return images, {"cls": cls, "box": box, "idx": idx}
