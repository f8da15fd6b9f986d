"""The yardstick's frozen arithmetic equals the program's own copies on
the same shapes: chip_smoke.py's kernel costs and roofline.py's conv
FLOP and byte model."""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from card_bench import costs
from card_bench.harness import ROOT
from card_bench.reference.model import Spec
from tpu_yolo_torch import roofline
from tpu_yolo_torch.seeded import nms_scene


@pytest.mark.parametrize("bh,t", [(256, 400), (768, 400), (16, 1600), (64, 400)])
def test_attention_cost_is_chip_smokes(bh, t):
    q, v = torch.empty(bh, t, 32), torch.empty(bh, t, 64)
    want = chip_smoke.attention_cost(q.bfloat16(), v.bfloat16(), "bfloat16")
    assert costs.attention_cost(bh, t, 32, 64) == pytest.approx(want, rel=1e-3)


@pytest.mark.parametrize("scene,b,k", [("clustered", 128, 1024), ("uniform", 4, 2048),
                                       ("disjoint", 2, 256)])
def test_nms_cost_is_chip_smokes(scene, b, k):
    boxes, cls, valid = (torch.from_numpy(a) for a in nms_scene(np.random.default_rng(0), scene, b, k))
    assert costs.nms_cost(boxes, cls, valid) == chip_smoke.nms_cost(boxes, cls, valid)


def test_bound_is_chip_smokes():
    for nbytes, flops in ((1e6, 1e9), (1e9, 1e6)):
        assert costs._bound(nbytes, flops, costs.PEAK_F32) == chip_smoke._bound(nbytes, flops, 67e12)


@pytest.mark.parametrize("name", ["yolo11n", "yolo11x"])
def test_model_flops_and_conv_cost_are_rooflines(name):
    cfg = json.load(open(os.path.join(ROOT, "card_bench", "configs", name + ".json")))
    recs = roofline.trace_convs(cfg["program_size"], 640, 2)
    ours = [costs.conv_cost((r["in"][0], r["in"][3], r["in"][1], r["in"][2]),
                            (r["w"][3], r["w"][2], r["w"][0], r["w"][1]),
                            (r["out"][0], r["out"][3], r["out"][1], r["out"][2]))
            for r in recs if r["kind"] == "conv"]
    theirs = [roofline.conv_cost(r, False) for r in recs if r["kind"] == "conv"]
    assert ours == theirs
    total = sum(v[0] for v in roofline.stage_costs(recs, False).values())
    f = costs.model_flops(Spec(cfg), 2)
    assert f["conv"] + f["attention"] == total
    assert total / 2 / 1e9 == pytest.approx(cfg["gflop_per_image"], abs=0.005)
