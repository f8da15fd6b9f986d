"""Model-size and hyperparameter configuration.

The six YOLOv11 sizes are a (width, depth, csp) tuple each; everything
else about the graph derives from these. Same table as the JAX
package's `tpu_yolo/core/config.py`, kept as a copy so this package
imports no JAX.

The five YOLO12 sizes (`12n` ... `12x`, Ultralytics'
`cfg/models/12/yolo12.yaml`) have a table of their own: the JAX package
has no YOLO12, so the tests that hold every YOLOv11 size against it
iterate `MODEL_CONFIGS` alone.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description for one YOLOv11 or YOLO12 size.

    YOLO12 (`arch` "yolo12", models/yolov12.py) reads `depth` as the
    repeats of (p2, p3, p4, p5, the top-down stages, the bottom-up
    stages), and besides: `mlp_ratio`, its attention blocks' MLP width
    over their channels; `layer_scale`, whether the P4/P5 stages add their
    output to their input through a learned per-channel scale (l and x)."""

    width: tuple[int, ...]   # (in_ch, w1, w2, w3, w4, w5)
    depth: tuple[int, ...]   # per-stage block repeat counts (6 entries)
    csp: tuple[bool, bool]   # use CSPModule inner blocks per stage group
    num_classes: int = 80
    reg_max: int = 16        # DFL distribution bins
    strides: tuple[int, ...] = (8, 16, 32)
    arch: str = "yolo11"
    mlp_ratio: float = 0.0
    layer_scale: bool = False

    @property
    def head_filters(self) -> tuple[int, int, int]:
        return (self.width[3], self.width[4], self.width[5])

    @property
    def no(self) -> int:
        """Outputs per anchor: 4*reg_max box logits + num_classes."""
        return 4 * self.reg_max + self.num_classes


MODEL_CONFIGS: Mapping[str, ModelConfig] = {
    "n": ModelConfig(width=(3, 16, 32, 64, 128, 256), depth=(1,) * 6, csp=(False, True)),
    "t": ModelConfig(width=(3, 24, 48, 96, 192, 384), depth=(1,) * 6, csp=(False, True)),
    "s": ModelConfig(width=(3, 32, 64, 128, 256, 512), depth=(1,) * 6, csp=(False, True)),
    "m": ModelConfig(width=(3, 64, 128, 256, 512, 512), depth=(1,) * 6, csp=(True, True)),
    "l": ModelConfig(width=(3, 64, 128, 256, 512, 512), depth=(2,) * 6, csp=(True, True)),
    "x": ModelConfig(width=(3, 96, 192, 384, 768, 768), depth=(2,) * 6, csp=(True, True)),
}



def _yolo12(width, deep: bool, c3k: bool) -> ModelConfig:
    """A YOLO12 size: depth multiple 1.0 (l, x) or 0.5, C3k inner blocks
    in the backbone's C3k2 stages at m/l/x; at l/x the A2C2f stages take
    the layer scale and an MLP ratio of 1.2, else 2.0."""
    return ModelConfig(width=width, depth=(2, 2, 4, 4, 2, 2) if deep else (1, 1, 2, 2, 1, 1),
                       csp=(c3k, True), arch="yolo12", mlp_ratio=1.2 if deep else 2.0,
                       layer_scale=deep)


YOLO12_CONFIGS: Mapping[str, ModelConfig] = {
    "12n": _yolo12((3, 16, 32, 64, 128, 256), deep=False, c3k=False),
    "12s": _yolo12((3, 32, 64, 128, 256, 512), deep=False, c3k=False),
    "12m": _yolo12((3, 64, 128, 256, 512, 512), deep=False, c3k=True),
    "12l": _yolo12((3, 64, 128, 256, 512, 512), deep=True, c3k=True),
    "12x": _yolo12((3, 96, 192, 384, 768, 768), deep=True, c3k=True),
}

SIZES = (*MODEL_CONFIGS, *YOLO12_CONFIGS)
"""Every size key `get_model_config` takes, as the CLIs offer them."""


def get_model_config(size: str, num_classes: int = 80) -> ModelConfig:
    base = MODEL_CONFIGS[size] if size in MODEL_CONFIGS else YOLO12_CONFIGS[size]
    if num_classes != base.num_classes:
        base = dataclasses.replace(base, num_classes=num_classes)
    return base


_DEFAULT_HYP = os.path.join(os.path.dirname(__file__), "hyp.yaml")


def load_hyperparams(path: str | None = None) -> dict:
    """Training hyperparameters + class names from a YAML file."""
    import yaml

    with open(path or _DEFAULT_HYP, errors="ignore") as f:
        return yaml.safe_load(f)


class _LazyNames:
    """The 80 COCO class names of hyp.yaml, read at first use."""

    _cache = None

    def _names(self):
        if type(self)._cache is None:
            type(self)._cache = load_hyperparams()["names"]
        return type(self)._cache

    def __getitem__(self, k):
        return self._names()[k]

    def __len__(self):
        return len(self._names())

    def items(self):
        return self._names().items()


COCO_NAMES = _LazyNames()
