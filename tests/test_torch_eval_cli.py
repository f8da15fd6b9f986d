"""`python -m tpu_yolo_torch.cli.main --test --device cpu` against
tpu_yolo's `run_test` on the same `.ckpt`, at the default bf16.

The fixture is a seeded mini-COCO val split of 16 images at 128 px whose
labels are the f32 detections of the checkpoint's own model
(seeded.label_from_detections, 30 an image, a third shifted, a third
with the other class), so that mAP is far from 0 and moves at every IoU
threshold. The weights are `seeded.eval_state`, whose class logits stay
far from the preimage of conf 0.001: the two packages' bf16 roundings
then leave every candidate on its side of the threshold, and the spill
certificates are identical.

mAP and mAP50 of the two bf16 runs agree within 0.02: measured 0.0073
and 0.0041 here (0.0138 and 0.0015 with 8 images, hence 16). The two
packages round their bf16 convolutions differently, and boxes a few
strides wide cross the high IoU thresholds with that.
"""
import argparse
import contextlib
import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tpu_yolo.cli.main import run_test as jax_run_test
from tpu_yolo.core.config import get_model_config as jax_config
from tpu_yolo_torch.cli import main as cli
from tpu_yolo_torch.core.config import get_model_config, load_hyperparams
from tpu_yolo_torch.data.dataset import split_files
from tpu_yolo_torch.data.image import bgr_hwc_to_rgb, letterbox, load_image
from tpu_yolo_torch.io.checkpoint import save_checkpoint
from tpu_yolo_torch.io.weights import to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.seeded import eval_state, label_from_detections, write_mini_coco

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = 128
N_VAL = 16
MAP_TOL = 0.02
LINE = re.compile(r"^mAP: (\d\.\d{3})  mAP@50: (\d\.\d{3})  Recall: (\d\.\d{3})  "
                  r"Precision: (\d\.\d{3})$")


def _line(result):
    """The metric line, as both packages' main() prints it."""
    m_ap, m_ap50, recall, precision = result
    return (f"mAP: {m_ap:.3f}  mAP@50: {m_ap50:.3f}  "
            f"Recall: {recall:.3f}  Precision: {precision:.3f}")


def _args(coco, **over):
    root, ckpt, _, _ = coco
    kw = dict(weights=ckpt, save_dir=root, data_dir=root, input_size=SIZE,
              val_batch_size=4, workers=2, native_eval="off", coco_metrics=False,
              plot=False, max_nms=2048, seed=0, device="cpu")
    kw.update(over)
    return argparse.Namespace(**kw)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = write_mini_coco(str(tmp_path_factory.mktemp("coco")), 0, N_VAL,
                           hw=(96, 128))
    cfg = get_model_config("n", 2)
    images = np.stack([bgr_hwc_to_rgb(letterbox(load_image(f, SIZE)[0], SIZE)[0])
                       for f in split_files(root, "val2017")])
    state = eval_state(cfg, 0, images, "cpu")
    ckpt = os.path.join(root, "eval.ckpt")
    save_checkpoint(ckpt, {"params": to_jax_params(state)})
    label_from_detections(root, YOLO.from_state_dict(cfg, state), SIZE)
    hyp = load_hyperparams()
    hyp["names"] = {0: "red", 1: "blue"}
    hyp_path = os.path.join(root, "hyp.yaml")
    with open(hyp_path, "w") as f:
        yaml.safe_dump(hyp, f)
    return root, ckpt, hyp, hyp_path


@pytest.fixture(scope="module")
def jax_run(coco):
    """tpu_yolo's run_test with the Python loader: (result, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = jax_run_test(_args(coco), coco[2], jax_config("n", 2))
    return result, out.getvalue()


@pytest.fixture(scope="module")
def port_cli(coco):
    """The port's CLI in a process of its own: its stdout lines."""
    root, ckpt, _, hyp_path = coco
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_yolo_torch.cli.main", "--test", "--device", "cpu",
         "--model-size", "n", "--input-size", str(SIZE), "--val-batch-size", "4",
         "--workers", "2", "--data-dir", root, "--weights", ckpt, "--hyp", hyp_path,
         "--native-eval", "off"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()


def _certificate(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("[eval] candidate envelope")]
    assert len(lines) == 1, text
    return lines[0]


def test_cli_prints_loader_certificate_and_metric_line(port_cli, jax_run):
    assert port_cli[0] == "[eval] loader: python"
    assert port_cli[1].startswith("[eval] candidate envelope: 0/16 images at spill risk")
    assert LINE.match(port_cli[-1]), port_cli[-1]
    assert LINE.match(_line(jax_run[0]))


def test_certificate_line_identical(port_cli, jax_run):
    assert _certificate("\n".join(port_cli)) == _certificate(jax_run[1])


def test_map_agrees_with_jax_at_bf16(coco, port_cli, jax_run):
    """The port's run_test in this process prints the CLI's line, and its
    mAP and mAP50 are within 0.02 of tpu_yolo's; the labels are met."""
    ref, _ = jax_run
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mine = cli.run_test(_args(coco), coco[2], get_model_config("n", 2))
    assert _line(mine) == port_cli[-1]
    assert ref[0] > 0.05 and ref[1] > 0.15
    assert abs(mine[0] - ref[0]) <= MAP_TOL and abs(mine[1] - ref[1]) <= MAP_TOL, (mine, ref)


def test_cli_reads_best_ckpt_and_prints_the_coco_table(coco, tmp_path, capsys):
    """Without --weights, --test reads save-dir/best.ckpt; --coco-metrics
    prints the 12-line COCO table and --plot writes the four curves."""
    root, ckpt, _, hyp_path = coco
    with open(ckpt, "rb") as src, open(tmp_path / "best.ckpt", "wb") as dst:
        dst.write(src.read())
    cli.main(["--test", "--device", "cpu", "--input-size", str(SIZE),
              "--val-batch-size", "8", "--workers", "2", "--data-dir", root,
              "--save-dir", str(tmp_path), "--hyp", hyp_path, "--native-eval", "off",
              "--coco-metrics", "--plot"])
    out = capsys.readouterr().out.strip().splitlines()
    table = [ln for ln in out if ln.startswith(" Average ")]
    assert len(table) == 12 and LINE.match(out[-1])
    assert float(table[0].rsplit("= ", 1)[1]) > 0.0
    for name in ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"):
        assert (tmp_path / name).stat().st_size > 5000


def test_cli_test_raises_without_a_card(coco):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run_test(_args(coco, device="cuda"), coco[2], get_model_config("n", 2))


def test_run_test_on_the_first_images(coco):
    """max_images: the first 8 images, with a label cache of their own
    (the full split's cache holds all 16), as tpu_yolo's run_test does."""
    root = coco[0]
    outs = []
    for run_test, cfg in ((cli.run_test, get_model_config("n", 2)),
                          (jax_run_test, jax_config("n", 2))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = run_test(_args(coco), coco[2], cfg, max_images=8)
        outs.append((result, _certificate(out.getvalue())))
    (mine, mine_cert), (ref, ref_cert) = outs
    assert mine_cert == ref_cert and "0/8 images" in mine_cert
    assert os.path.exists(os.path.join(root, "val2017.first8.cache.npy"))
    assert abs(mine[0] - ref[0]) <= MAP_TOL and abs(mine[1] - ref[1]) <= MAP_TOL, (mine, ref)
