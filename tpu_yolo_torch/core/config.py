"""Model-size and hyperparameter configuration.

The six YOLOv11 sizes are a (width, depth, csp) tuple each; everything
else about the graph derives from these. Same table as the JAX
package's `tpu_yolo/core/config.py`, kept as a copy so this package
imports no JAX.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description for one YOLOv11 size."""

    width: tuple[int, ...]   # (in_ch, w1, w2, w3, w4, w5)
    depth: tuple[int, ...]   # per-stage block repeat counts (6 entries)
    csp: tuple[bool, bool]   # use CSPModule inner blocks per stage group
    num_classes: int = 80
    reg_max: int = 16        # DFL distribution bins
    strides: tuple[int, ...] = (8, 16, 32)

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


def get_model_config(size: str, num_classes: int = 80) -> ModelConfig:
    base = MODEL_CONFIGS[size]
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
