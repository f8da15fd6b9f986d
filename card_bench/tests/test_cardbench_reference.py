"""The plain reference against the program on the CPU at a small size:
the same weights give the same leaves, the same raw maps and the same
detections in float32."""
import json
import os

import pytest
import torch

from card_bench import compare, data, weights
from card_bench.harness import ROOT
from card_bench.reference.detect import decode, nms
from card_bench.reference.model import Net, Spec, layout
from tpu_yolo_torch import YOLO, Detector, get_model_config


def spec_of(name, size=None):
    cfg = json.load(open(os.path.join(ROOT, "card_bench", "configs", name + ".json")))
    if size:
        cfg["input_size"] = size
    return cfg, Spec(cfg)


@pytest.mark.parametrize("name", ["yolo11n", "yolo11x"])
def test_layout_is_the_programs_state_dict(name):
    cfg, spec = spec_of(name)
    want = {k: tuple(v.shape) for k, v in YOLO(get_model_config(cfg["program_size"])).state_dict().items()}
    assert {n: tuple(s) for n, s, _ in layout(spec)} == want


def images(n, size, seed=3):
    return data.seeded_images(data.generator(seed, 0, "cpu"), n, size, "cpu")


@pytest.mark.parametrize("name,size", [("yolo11n", 256), ("yolo11x", 128)])
def test_serving_matches_the_program_in_f32(name, size):
    cfg, spec = spec_of(name, size)
    x = images(6, size)
    W = weights.make(spec, 11, x[:4], gamma=0.2, class_bias=-4.5)
    model = YOLO.from_state_dict(get_model_config(cfg["program_size"]), {k: v.clone() for k, v in W.items()})
    with torch.no_grad():
        raw = model.forward_raw(x[4:].float() / 255)
        maps = Net(spec, W).forward(x[4:].permute(0, 3, 1, 2).float() / 255)
    for a, b in zip(raw, maps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    det = Detector(model, input_size=size, device="cpu", compute_dtype=torch.float32)
    prog = {k: v for k, v in det.detect_batch(x[4:]).items()}
    ref = nms(*decode(spec, maps)[:2], 0.25, 0.65, 300, 1024)
    assert torch.equal(prog["count"], ref["count"]) and int(prog["count"].sum()) > 0
    got = compare.serving(prog, ref, 0.25, 300)
    assert int(got["due_ref"].sum()) > 0
    assert int(got["missed"].sum()) == 0 and int(got["extra"].sum()) == 0
    # at the cap, near-equal scores may swap the last kept one
    assert len(got["gaps"]) >= 0.99 * int(ref["count"].sum())
    # logits of tens at this size: float32's own order of operations
    # moves a few by some hundredths
    assert float(got["gaps"].quantile(0.9)) < 1e-3 and float(got["gaps"].max()) < 0.1
