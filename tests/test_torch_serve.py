"""The port's Detector against the JAX package's, on the CPU in f32:
batch results, single-image and streaming paths, the staged path with the
device letterbox, the presets, the device rule, checkpoint loading and
the `detect` entry point."""
import os
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_yolo.core.config import get_model_config as jax_config
from tpu_yolo.io.weights import save_torch_checkpoint
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.serve import Detector as JaxDetector
from tpu_yolo_torch.core.config import ModelConfig, get_model_config
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.io.weights import from_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.serve import Detector

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZE = 128


def _params(seed=0):
    """v11-n weights with class biases lifted to about -1, so that random
    images give candidates above conf."""
    rng = np.random.default_rng(seed)
    params = jax_yolo.init_params(seed, jax_config("n"))
    for level in params["head"]["cls"]:
        level[4]["b"] = rng.normal(-1.0, 0.5, level[4]["b"].shape).astype(np.float32)
    return params


def _model(params):
    cfg = get_model_config("n")
    return YOLO.from_state_dict(cfg, from_jax_params(params, cfg))


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, SIZE // 8, SIZE // 8, 3), dtype=np.uint8)
    return np.ascontiguousarray(img.repeat(8, 1).repeat(8, 2))


@pytest.fixture(scope="module")
def detector():
    return Detector(_model(_params()), input_size=SIZE, device="cpu",
                    compute_dtype=torch.float32, ranking="exact")


def test_detect_batch_matches_jax_detector(detector):
    params = _params()
    ref_det = JaxDetector(jax_yolo.fold_batchnorm(params), jax_config("n"),
                          input_size=SIZE, compute_dtype=jnp.float32,
                          ranking="exact")
    imgs = _images(2)
    ref = ref_det.detect_batch(imgs)
    mine = detector.detect_batch(imgs)
    np.testing.assert_array_equal(mine["count"].numpy(), np.asarray(ref["count"]))
    np.testing.assert_array_equal(mine["classes"].numpy(),
                                  np.asarray(ref["classes"]))
    v = np.asarray(ref["valid"])
    assert v.sum(1).min() > 0
    np.testing.assert_allclose(mine["boxes"].numpy()[v],
                               np.asarray(ref["boxes"])[v], atol=1e-3)
    np.testing.assert_allclose(mine["scores"].numpy()[v],
                               np.asarray(ref["scores"])[v], atol=1e-4)


def test_detect_one_array_equals_batch_row(detector):
    imgs = _images(2, seed=2)
    res = detector.detect_batch(imgs)
    for i in range(2):
        one = detector.detect_one(imgs[i], rescale=False)
        n = int(res["count"][i])
        assert len(one["boxes"]) == n > 0
        np.testing.assert_allclose(one["boxes"], res["boxes"][i, :n].numpy(),
                                   atol=1e-3)
        np.testing.assert_array_equal(one["classes"], res["classes"][i, :n].numpy())


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("torch_serve_jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(120, 160), (80, 60), (128, 128)]):
        img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), np.uint8),
                               (5, 5), 2)
        paths.append(str(root / f"im{i}.jpg"))
        cv2.imwrite(paths[-1], img)
    return paths


def test_stream_equals_detect_one(detector, jpegs):
    streamed = list(detector.stream(jpegs, batch_size=2))
    assert [r["path"] for r in streamed] == jpegs
    for r, path in zip(streamed, jpegs):
        one = detector.detect_one(path)
        np.testing.assert_allclose(r["boxes"], one["boxes"], atol=1e-3)
        np.testing.assert_allclose(r["scores"], one["scores"], atol=1e-5)
        np.testing.assert_array_equal(r["classes"], one["classes"])


def test_run_and_the_saved_program_stage_through_one_helper(tmp_path, monkeypatch):
    """`_run` and `load_compiled`'s `run` both copy their inputs through
    `Detector._stage`, and give the same detections."""
    cfg = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                      csp=(False, True), num_classes=8)
    state = YOLO.from_state_dict(cfg, from_jax_params(init_params(0, cfg), cfg)) \
        .fold_batchnorm().state_dict()
    live = Detector(YOLO.from_state_dict(cfg, state), input_size=SIZE, conf_thres=1e-6,
                    device="cpu", compute_dtype=torch.float32)
    loaded = Detector.load_compiled(live.save_compiled(str(tmp_path / "det.pt2z"), 2),
                                    state)
    staged, stage = [], Detector._stage

    def spy(self, inputs):
        staged.append((self, [tuple(x.shape) for x in inputs]))
        return stage(self, inputs)

    monkeypatch.setattr(Detector, "_stage", spy)
    imgs = _images(2, seed=3)
    want, got = live.detect_batch(imgs), loaded.detect_batch(imgs)
    assert staged == [(live, [(2, SIZE, SIZE, 3)]), (loaded, [(2, SIZE, SIZE, 3)])]
    assert int(want["count"].min()) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cpu_detector_passes_its_inputs_through(detector):
    """On a CPU Detector the staging helper hands the inputs back as they
    are, makes no copy stream or pinned ring, and counts no staging,
    under a profiler too."""
    from tpu_yolo_torch.utils import telemetry

    x = torch.from_numpy(_images(2, seed=4))
    hw = torch.ones((2, 2))
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = detector._stage([x, hw])
        detector.detect_batch(x)
    snap = telemetry.snapshot()
    telemetry.reset()
    assert out[0] is x and out[1] is hw
    assert snap["nms.images"] == 2
    assert not any(k.startswith("stage.") for k in snap)
    assert detector._copy_stream is None and not any(detector._ring)


def test_decode_and_rescale_match_jax(jpegs, monkeypatch):
    """Path decoding + letterbox where the native library does not load
    equal the JAX package's OpenCV path, and the rescale to original
    pixels equals its _emit on the same result."""
    from tpu_yolo.data.image import letterbox, load_image

    monkeypatch.setattr(native_loader, "available", lambda: False)
    detector = Detector(_model(_params()), input_size=SIZE, device="cpu",
                        compute_dtype=torch.float32, ranking="exact")
    imgs = np.zeros((len(jpegs), SIZE, SIZE, 3), np.uint8)
    metas = detector._decode_batch(jpegs, imgs)
    for i, path in enumerate(jpegs):
        img, (h, w) = load_image(path, SIZE)
        boxed, ratio, pad = letterbox(img, SIZE)
        np.testing.assert_array_equal(imgs[i], boxed[:, :, ::-1])
        np.testing.assert_allclose(
            metas[i], (ratio[0] * img.shape[1] / w, pad[0], pad[1], w, h))
    assert detector.stager == "cv2"

    res = detector.detect_batch(imgs)
    mine = list(detector._emit(detector._fetch(res), metas, jpegs, True))
    ref_det = JaxDetector(jax_yolo.fold_batchnorm(_params()), jax_config("n"),
                          input_size=SIZE)
    ref = list(ref_det._emit({k: v.numpy() for k, v in res.items()}, metas,
                             jpegs, True))
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["classes"], b["classes"])


def test_presets_and_explicit_knobs():
    det = Detector(_model(_params()), input_size=SIZE, device="cpu",
                   latency_mode=True)
    assert det._nms["multi_label"] is False and det._nms["max_nms"] == 256
    det = Detector(_model(_params()), input_size=SIZE, device="cpu",
                   latency_mode=True, max_nms=512, multi_label=True)
    assert det._nms["multi_label"] is True and det._nms["max_nms"] == 512
    det = Detector(_model(_params()), input_size=SIZE, device="cpu")
    assert det._nms == dict(conf_thres=0.25, iou_thres=0.65, max_det=300,
                            ranking="approx", max_nms=1024, multi_label=True)
    assert det.compute_dtype == torch.bfloat16


def test_no_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Detector(_model(_params()))


def test_from_checkpoint_ckpt_prefers_ema(tmp_path):
    path = str(tmp_path / "w.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": _params(3), "ema_params": _params(4),
                     "epoch": 1}, f)
    det = Detector.from_checkpoint(path, size="n", device="cpu",
                                   compute_dtype=torch.float32)
    want = _model(_params(4)).fold_batchnorm().state_dict()
    got = det.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_from_checkpoint_pt(tmp_path):
    path = str(tmp_path / "w.pt")
    save_torch_checkpoint(path, _params(5), jax_config("n"),
                          target_format="reference")
    det = Detector.from_checkpoint(path, size="n", device="cpu",
                                   compute_dtype=torch.float32)
    want = _model(_params(5)).fold_batchnorm().state_dict()
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- the staged path: device letterbox ----------------------------------------

STAGE = 160


@pytest.fixture(scope="module")
def staged_jpegs(tmp_path_factory):
    """JPEGs of mixed aspect ratios; the first is longer than STAGE, so
    the host pre-shrinks it and its axes get different ratios."""
    import cv2

    root = tmp_path_factory.mktemp("torch_serve_staged")
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate([(150, 333), (120, 90), (64, 100)]):
        img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), np.uint8), (5, 5), 2)
        paths.append(str(root / f"staged{i}.jpg"))
        cv2.imwrite(paths[-1], img)
    return paths


def test_metas_from_dims_match_jax():
    dims = np.array([[160, 72, 333, 150], [120, 90, 120, 90], [-1, 0, 0, 0],
                     [64, 100, 64, 100], [159, 160, 1000, 1003]], np.float32)
    for size in (128, 640):
        want = JaxDetector._metas_from_dims(dims, size)
        got = Detector._metas_from_dims(dims, size)
        np.testing.assert_array_equal(got, want)
    assert got[0, 0] != got[0, 5]


def test_staged_stream_matches_jax_detector(staged_jpegs):
    """Detector(device_letterbox=True).stream against tpu_yolo's staged
    Detector on the same JPEGs and weights, f32, exact ranking; batch 2
    over 3 images, so the last batch is padded."""
    params = _params()
    ref_det = JaxDetector(jax_yolo.fold_batchnorm(params), jax_config("n"),
                          input_size=SIZE, compute_dtype=jnp.float32,
                          ranking="exact", device_letterbox=True, stage_size=STAGE)
    det = Detector(_model(params), input_size=SIZE, device="cpu",
                   compute_dtype=torch.float32, ranking="exact",
                   device_letterbox=True, stage_size=STAGE)
    ref = list(ref_det.stream(staged_jpegs, batch_size=2))
    mine = list(det.stream(staged_jpegs, batch_size=2))
    assert det.stager == ("native" if native_loader.available() else "cv2")
    assert [r["path"] for r in mine] == staged_jpegs
    assert sum(len(r["boxes"]) for r in mine) > 0
    for a, b in zip(mine, ref):
        assert len(a["boxes"]) == len(b["boxes"]), a["path"]
        np.testing.assert_array_equal(a["classes"], b["classes"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)


def test_staged_stream_reports_failed_decodes(staged_jpegs, tmp_path):
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    det = Detector(_model(_params()), input_size=SIZE, device="cpu",
                   compute_dtype=torch.float32, device_letterbox=True,
                   stage_size=STAGE)
    out = list(det.stream([staged_jpegs[1], bad], batch_size=4))
    assert out[1]["error"] == "decode" and len(out[1]["boxes"]) == 0
    assert "error" not in out[0]


@pytest.mark.parametrize("extra", [["--device-letterbox"], ["--latency-mode"]])
def test_detect_entry_point_writes_annotated_files(staged_jpegs, tmp_path, extra):
    """`python -m tpu_yolo_torch.detect --device cpu` over the JPEGs: one
    annotated copy each, and a summary line."""
    import subprocess
    import sys

    import cv2

    weights = str(tmp_path / "w.ckpt")
    with open(weights, "wb") as f:
        pickle.dump({"params": _params()}, f)
    out_dir = tmp_path / "annotated"
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_yolo_torch.detect", "--device", "cpu",
         "--weights", weights, "--input-size", str(SIZE), "--batch-size", "2",
         "--out", str(out_dir), *extra, *staged_jpegs],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "done: " in proc.stdout and " over 3 images" in proc.stdout
    for p in staged_jpegs:
        img = cv2.imread(str(out_dir / os.path.basename(p)))
        assert img is not None and img.shape == cv2.imread(p).shape
    if extra == ["--device-letterbox"]:
        assert "stager: " in proc.stdout


def test_detect_raises_without_a_card_unless_cpu_is_asked(staged_jpegs, tmp_path,
                                                          monkeypatch):
    from tpu_yolo_torch import detect

    weights = str(tmp_path / "w.ckpt")
    with open(weights, "wb") as f:
        pickle.dump({"params": _params()}, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert detect.parse_args(["--weights", weights, "x.jpg"]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detect.main(["--weights", weights, "--device-letterbox", *staged_jpegs])
