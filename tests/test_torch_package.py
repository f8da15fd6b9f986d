"""The port's package surface against tpu_yolo's: every top-level name of
`tpu_yolo.__all__` resolves in `tpu_yolo_torch`, and the host letterbox
equals tpu_yolo's goldens (tests/golden/letterbox_*.npz)."""
import numpy as np
import pytest

import tpu_yolo
import tpu_yolo_torch
from conftest import load_golden
from tpu_yolo_torch.core import config
from tpu_yolo_torch.data.image import letterbox
from tpu_yolo_torch.io import weights
from tpu_yolo_torch.models.yolov11 import YOLO

# tpu_yolo's functional forward and graph transforms, which the port has
# as methods of its YOLO module
YOLO_METHODS = ("forward", "forward_raw", "forward_nms", "decode_predictions",
                "fold_batchnorm", "fold_stem_space_to_depth")


def test_every_top_level_name_resolves():
    """Each name of tpu_yolo.__all__ is an attribute of tpu_yolo_torch or
    a method of its YOLO; each name of the port's __all__ resolves."""
    missing = [n for n in tpu_yolo.__all__
               if n not in YOLO_METHODS and not hasattr(tpu_yolo_torch, n)]
    assert not missing
    assert set(tpu_yolo.__all__) - set(YOLO_METHODS) <= set(tpu_yolo_torch.__all__)
    assert all(callable(getattr(YOLO, n)) for n in YOLO_METHODS)
    assert all(hasattr(tpu_yolo_torch, n) for n in tpu_yolo_torch.__all__)


@pytest.mark.parametrize("name", ["load_partial", "export_reference_state_dict",
                                  "export_ultralytics_state_dict",
                                  "save_torch_checkpoint"])
def test_weight_functions_are_the_modules(name):
    assert getattr(tpu_yolo_torch, name) is getattr(weights, name)


def test_coco_names_equal_jax():
    assert tpu_yolo_torch.COCO_NAMES is config.COCO_NAMES
    assert len(tpu_yolo_torch.COCO_NAMES) == len(tpu_yolo.COCO_NAMES) == 80
    assert [tpu_yolo_torch.COCO_NAMES[i] for i in range(80)] == [
        tpu_yolo.COCO_NAMES[i] for i in range(80)]


@pytest.mark.parametrize("case", ["tall", "wide", "small"])
def test_letterbox_golden(case):
    """tests/test_data.py's golden case on the port's letterbox: the
    shape, every pixel, the ratio and the pad equal."""
    g = load_golden(f"letterbox_{case}.npz")
    out, ratio, pad = letterbox(g["image"].copy(), 640, augment=False)
    assert out.shape == g["out"].shape
    np.testing.assert_array_equal(out, g["out"])
    np.testing.assert_array_equal(np.asarray(ratio, np.float64), g["ratio"])
    np.testing.assert_array_equal(np.asarray(pad, np.float64), g["pad"])
