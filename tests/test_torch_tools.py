"""The port's two tools against the JAX package's on the CPU:
`tpu_yolo_torch/roofline.py` against `tools/roofline.py` (the same conv
and attention records, hence the same per-stage FLOPs and bytes, as exact
integers, for every size, inference and training) and
`tpu_yolo_torch/parity_check.py` against `tools/parity_check.py` (the
same verdict keys and metric; mAP and mAP50 within 0.02 of the JAX
harness's on the same checkpoint and split, as
tests/test_torch_eval_cli.py holds `--test`; a verdict under
`--max-images` too, never a pass).

The harness's fixture is that file's: a seeded mini-COCO val split of 16
images at 128 px labelled with the checkpoint's own f32 detections
(seeded.label_from_detections), `seeded.eval_state` weights, two classes.
"""
import contextlib
import functools
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tools import parity_check as jax_parity
from tools import roofline as jax_roofline
from tpu_yolo_torch import parity_check, roofline
from tpu_yolo_torch.core.config import MODEL_CONFIGS, get_model_config, load_hyperparams
from tpu_yolo_torch.data.dataset import split_files
from tpu_yolo_torch.data.image import bgr_hwc_to_rgb, letterbox, load_image
from tpu_yolo_torch.io.checkpoint import save_checkpoint
from tpu_yolo_torch.io.weights import to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.ops.nn import ConvBN
from tpu_yolo_torch.seeded import eval_state, label_from_detections, write_mini_coco

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZES = sorted(MODEL_CONFIGS)
INPUT, BATCH = 640, 128
HARNESS_SIZE = 128
N_VAL = 16
MAP_TOL = 0.02


@functools.lru_cache(maxsize=None)
def _jax_records(size):
    return [dict(r) for r in jax_roofline.trace_convs(size, INPUT, BATCH)]


# -- the roofline ------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_roofline_records_equal_jax(size):
    """Every conv and attention record, in the order the forward runs it:
    path, NHWC in/out, HWIO weight, stride, groups; the products' FLOPs
    and bytes."""
    mine = roofline.trace_convs(size, INPUT, BATCH)
    assert mine == _jax_records(size)
    assert sum(r["kind"] == "dot" for r in mine) == get_model_config(size).depth[4]


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
@pytest.mark.parametrize("size", SIZES)
def test_roofline_stage_costs_equal_jax(size, train):
    """Per-stage FLOPs, bytes and record counts, exact integers, against
    tools/roofline.py's conv_cost summed by its stage_of."""
    want = {}
    for r in _jax_records(size):
        f, by = jax_roofline.conv_cost(r, train)
        s = want.setdefault(jax_roofline.stage_of(r["path"]), [0, 0, 0])
        s[0] += f
        s[1] += by
        s[2] += 1
    got = roofline.stage_costs(roofline.trace_convs(size, INPUT, BATCH), train)
    assert list(got) == list(want)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert all(isinstance(v, int) for row in got.values() for v in row)


def test_roofline_rows_and_bounds():
    """The rows' bound is the larger of the two times at the given peaks,
    TOTAL sums the stages, and measured times join by stage."""
    stages = roofline.stage_costs(roofline.trace_convs("n", INPUT, 8), False)
    rows = roofline.roofline_rows(stages, 989.4e12, 3.35e12,
                                  measured={"net/p1": 0.5, "(unattributed)": 0.25})
    assert [r["stage"] for r in rows] == [*stages, "TOTAL"]
    for r in rows:
        assert r["bound_ms"] == max(r["t_ops_ms"], r["t_bytes_ms"])
        assert r["bound_by"] == ("bytes" if r["t_bytes_ms"] > r["t_ops_ms"]
                                 else "operations")
    total = rows[-1]
    assert total["gflop"] * 1e9 == pytest.approx(sum(v[0] for v in stages.values()))
    assert total["t_ops_ms"] == pytest.approx(
        sum(v[0] for v in stages.values()) / 989.4e12 * 1e3)
    assert rows[0]["measured_ms"] == 0.5 and total["measured_ms"] == 0.75
    # the stem at 640 px: 2 * B * 320 * 320 * 16 * 27 FLOPs (tests/test_roofline.py)
    assert stages["net/p1"][0] == 2 * 8 * 320 * 320 * 16 * 27


def test_stage_ranges_cover_every_conv():
    """The modules --profile tags are the stages' whole: every ConvBN
    lies under exactly one of them, and they name the 14 stages."""
    model = YOLO(get_model_config("s"))
    tagged = [path for path, _ in roofline._stage_modules(model)]
    assert {roofline.stage_of(p) for p in tagged} == set(
        roofline.stage_costs(roofline.trace_convs("s", 64, 1), False))
    for name, m in model.named_modules():
        if isinstance(m, ConvBN):
            path = name.replace(".", "/")
            assert sum(path == p or path.startswith(p + "/") for p in tagged) == 1, path


def test_roofline_main_prints_and_writes_json(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = roofline.main(["--size", "x", "--batch", "4", "--train", "--json", str(out)])
    text = capsys.readouterr().out
    assert "v11-x @ 640px bs4 - train fwd+bwd" in text and "TOTAL" in text
    assert "989.4 TFLOP/s" in text
    assert json.loads(out.read_text())["rows"] == json.loads(json.dumps(rows))


def test_roofline_peaks_and_profile_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    card, flops, bw = roofline.card_peaks()
    assert card is None and (flops, bw) == roofline.H100_SXM
    assert roofline.card_peaks(500.0, 2000.0)[1:] == (500e12, 2000e9)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        roofline.main(["--size", "n", "--batch", "1", "--input", "64", "--profile"])
    with pytest.raises(SystemExit, match="drop --train"):
        roofline.main(["--train", "--profile"])


# -- the parity harness ------------------------------------------------------


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = write_mini_coco(str(tmp_path_factory.mktemp("coco")), 0, N_VAL, hw=(96, 128))
    cfg = get_model_config("n", 2)
    images = np.stack([bgr_hwc_to_rgb(letterbox(load_image(f, HARNESS_SIZE)[0],
                                                HARNESS_SIZE)[0])
                       for f in split_files(root, "val2017")])
    state = eval_state(cfg, 0, images, "cpu")
    ckpt = os.path.join(root, "yolo11n.ckpt")
    save_checkpoint(ckpt, {"params": to_jax_params(state)})
    label_from_detections(root, YOLO.from_state_dict(cfg, state), HARNESS_SIZE)
    hyp = load_hyperparams()
    hyp["names"] = {0: "red", 1: "blue"}
    hyp_path = os.path.join(root, "hyp.yaml")
    with open(hyp_path, "w") as f:
        yaml.safe_dump(hyp, f)
    return root, ckpt, hyp, hyp_path


@pytest.fixture(scope="module")
def jax_verdict(coco):
    """tools/parity_check.py on the split, in this process: its verdict
    (--expect 0, --tol 100: a pass whatever the mAP)."""
    root, ckpt, _, hyp_path = coco
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jax_parity.main(["--weights", ckpt, "--data-dir", root, "--input-size",
                              str(HARNESS_SIZE), "--val-batch-size", "4", "--workers", "2",
                              "--hyp", hyp_path, "--expect", "0", "--tol", "100"])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _harness(coco, *extra):
    """`python -m tpu_yolo_torch.parity_check --device cpu` in a process of
    its own: (exit code, the verdict of its last line)."""
    root, ckpt, _, hyp_path = coco
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_yolo_torch.parity_check", "--device", "cpu",
         "--weights", ckpt, "--data-dir", root, "--input-size", str(HARNESS_SIZE),
         "--val-batch-size", "4", "--workers", "2", "--hyp", hyp_path, *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert lines, proc.stderr[-4000:]
    return proc.returncode, json.loads(lines[-1])


def test_parity_check_full_split_verdict(coco, jax_verdict):
    """The full split: exit 0, `pass` true with --expect at the JAX
    harness's mAP and --tol at 0.02 mAP (2 points), the JAX harness's
    keys, metric and expectation."""
    want = jax_verdict["map"]
    rc, verdict = _harness(coco, "--expect", repr(want), "--tol", repr(MAP_TOL * 100))
    assert want > 5.0
    assert rc == 0 and verdict["pass"] is True and verdict["full_set"] is True
    assert set(verdict) == set(jax_verdict)
    assert verdict["metric"] == jax_verdict["metric"] == f"coco_val_map_v11n_{HARNESS_SIZE}"
    assert abs(verdict["map"] - want) <= MAP_TOL * 100
    assert abs(verdict["map50"] - jax_verdict["map50"]) <= MAP_TOL * 100


def test_parity_check_max_images_never_passes(coco, jax_verdict):
    """--max-images: a verdict all the same, `pass` false, exit 1, though
    the mAP is within --tol (the JAX harness under an 8-device mesh raises
    before its verdict at this cut: ROADMAP, JAX side)."""
    rc, verdict = _harness(coco, "--expect", repr(jax_verdict["map"]), "--tol", "100",
                           "--max-images", "8")
    assert rc == 1 and verdict["pass"] is False and verdict["full_set"] is False
    assert set(verdict) == set(jax_verdict)
    assert 0.0 <= verdict["map"] <= 100.0


@pytest.mark.parametrize("name", ["yolo11n.pt", "v11_s.ckpt", "best-x.npz", "yolo11t.pt",
                                  "weights/yolo11m.pt", "l.ckpt"])
def test_size_inference_equals_jax(name):
    assert parity_check.infer_size(name) == jax_parity.infer_size(name)


def test_layout_and_weights_checks(tmp_path):
    for check in (parity_check.check_layout, jax_parity.check_layout):
        with pytest.raises(SystemExit, match="val2017.txt"):
            check(str(tmp_path))
    (tmp_path / "val2017.txt").write_text("a.jpg\n")
    with pytest.raises(SystemExit, match="images/val2017"):
        parity_check.check_layout(str(tmp_path))
    with pytest.raises(SystemExit, match="weights not found"):
        parity_check.main(["--weights", str(tmp_path / "none.pt"), "--data-dir",
                           str(tmp_path)])
    assert parity_check.EXPECTED == jax_parity.EXPECTED
