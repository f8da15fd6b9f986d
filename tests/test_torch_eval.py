"""The port's eval slice against the JAX package's, on the CPU: the host
metrics and the COCO protocol bit for bit, the eval geometry, the val
loaders batch for batch, and `evaluate` end to end at f32 on a tiny
model."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.core.config import load_hyperparams as jax_hyp
from tpu_yolo.data import image as jax_image
from tpu_yolo.data import native_loader as jax_native
from tpu_yolo.data.dataset import DetectionDataset as JaxDataset
from tpu_yolo.data.loader import make_val_loader as jax_val_loader
from tpu_yolo.eval import coco_eval as jax_coco
from tpu_yolo.eval import evaluator as jax_evaluator
from tpu_yolo.eval import metrics as jax_metrics
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo_torch.core.config import ModelConfig, load_hyperparams
from tpu_yolo_torch.data import image, native_loader
from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
from tpu_yolo_torch.data.loader import DataLoader, make_val_loader
from tpu_yolo_torch.eval import coco_eval, evaluator, metrics
from tpu_yolo_torch.io.weights import from_jax_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.seeded import eval_state, seeded_images, write_mini_coco

torch.set_num_threads(1)

_TINY = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
             num_classes=2)
TINY, JTINY = ModelConfig(**_TINY), JaxConfig(**_TINY)
SIZE = 64


def _scene(rng, n_images=12, nc=4):
    """Per image, (det (N, 6), gt (M, 5)): GT boxes, detections jittered
    around some of them with right or wrong classes, strays, repeated
    confidences and empty images."""
    dets, gts = [], []
    for i in range(n_images):
        m = int(rng.integers(0, 6)) if i % 5 else 0
        xy = rng.uniform(0, 500, (m, 2))
        wh = rng.uniform(8, 200, (m, 2))
        gt = np.concatenate([rng.integers(0, nc, (m, 1)), xy, xy + wh], 1)
        rows = []
        for g in gt:
            for _ in range(int(rng.integers(0, 4))):
                box = g[1:] + rng.normal(0, 0.08 * (g[3] - g[1]), 4)
                cls = g[0] if rng.random() < 0.8 else rng.integers(0, nc)
                rows.append([*box, 0.0, cls])
        for _ in range(int(rng.integers(0, 8))):
            x, y = rng.uniform(0, 500, 2)
            rows.append([x, y, x + rng.uniform(4, 150), y + rng.uniform(4, 150),
                         0.0, rng.integers(0, nc)])
        det = np.asarray(rows, np.float32).reshape(-1, 6)
        det[:, 4] = np.round(rng.uniform(0.001, 1.0, len(det)), 2)  # ties
        dets.append(det)
        gts.append(gt.astype(np.float32))
    return dets, gts


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


def test_metrics_equal_on_the_golden(golden_dir):
    g = np.load(golden_dir / "metrics.npz")
    mine = metrics.match_predictions(g["output"][:, :6], g["target"], g["iou_v"])
    np.testing.assert_array_equal(mine, g["correct"])
    np.testing.assert_array_equal(
        mine, jax_metrics.match_predictions(g["output"][:, :6], g["target"], g["iou_v"]))
    args = (g["correct"], g["conf"], g["pred_cls"], g["target_cls"])
    res = metrics.average_precision(*(a.copy() for a in args))
    _same(res, jax_metrics.average_precision(*(a.copy() for a in args)))
    assert res["map50"] == pytest.approx(float(g["map50"]), abs=1e-9)
    assert res["map"] == pytest.approx(float(g["mean_ap"]), abs=1e-9)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_and_coco_equal_on_seeded_scenes(seed):
    """match_predictions per image, average_precision over the scene and
    the COCO 12-metric table: bit-equal to tpu_yolo's."""
    dets, gts = _scene(np.random.default_rng(seed))
    thr = evaluator.IOU_THRESHOLDS
    np.testing.assert_array_equal(thr, jax_evaluator.IOU_THRESHOLDS)
    tps = []
    for det, gt in zip(dets, gts):
        tp = metrics.match_predictions(det, gt, thr)
        np.testing.assert_array_equal(tp, jax_metrics.match_predictions(det, gt, thr))
        tps.append(tp)
    args = (np.concatenate(tps), np.concatenate([d[:, 4] for d in dets]),
            np.concatenate([d[:, 5] for d in dets]),
            np.concatenate([g[:, 0] for g in gts]))
    res = metrics.average_precision(*args)
    assert res["map50"] > 0.05
    _same(res, jax_metrics.average_precision(*args))

    mine, ref = coco_eval.CocoEvaluator(), jax_coco.CocoEvaluator()
    for det, gt in zip(dets, gts):
        mine.add_image(det, gt)
        ref.add_image(det, gt)
    table = mine.accumulate()
    _same(table, ref.accumulate())
    assert coco_eval.summarize(table) == jax_coco.summarize(table)


def test_smooth_equal():
    y = np.random.default_rng(0).random(1000)
    for f in (0.05, 0.1, 0.3):
        np.testing.assert_array_equal(metrics.smooth(y, f), jax_metrics.smooth(y, f))


def test_eval_geometry_equal():
    for h, w in ((1, 1), (33, 127), (480, 640), (640, 480), (1000, 40),
                 (64, 64), (100, 200), (427, 640), (612, 612)):
        for size in (64, 96, 320, 640, 1280):
            assert image.eval_geometry((h, w), size) == jax_image.eval_geometry((h, w), size)


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    root = write_mini_coco(str(tmp_path_factory.mktemp("val")), 0, 10, hw=(96, 128))
    return split_files(root, "val2017")


def _datasets(files, size=SIZE):
    hyp = load_hyperparams()
    return (DetectionDataset(files, size, hyp, augment=False),
            JaxDataset(files, size, jax_hyp(), augment=False))


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (ia, ta), (ib, tb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        assert ia.dtype == ib.dtype == np.uint8
        for k in ("cls", "box", "idx"):
            np.testing.assert_array_equal(ta[k], tb[k])


def test_python_val_loader_equal(val_split):
    mine, ref = _datasets(val_split)
    loader = make_val_loader(mine, 4, num_workers=2, native="off")
    assert type(loader) is DataLoader and len(loader) == 3
    _same_batches(loader, jax_val_loader(ref, 4, num_workers=2, native="off"))
    with pytest.raises(ValueError, match="auto"):
        make_val_loader(mine, 4, native="yes")


def test_native_val_loader(val_split, tmp_path):
    """The port's binding gives the JAX binding's batches bit for bit; its
    labels equal the Python loader's, its JPEG pixels are within the
    decoder's rounding of them, and through the cv2 fallback (PNG) its
    images are the Python loader's bit for bit."""
    if not native_loader.available():
        with pytest.raises(RuntimeError, match="the host data library is unavailable"):
            make_val_loader(_datasets(val_split)[0], 4, native="on")
        pytest.skip("the host data library cannot be built here")
    import cv2

    mine, ref = _datasets(val_split)
    loader = make_val_loader(mine, 4, num_workers=2, native="auto")
    assert isinstance(loader, native_loader.NativeEvalLoader)
    _same_batches(loader, jax_native.NativeEvalLoader(ref, 4, threads=2))
    python = list(make_val_loader(mine, 4, native="off"))
    for (ia, ta), (ib, tb) in zip(loader, python):
        for k in ("cls", "box", "idx"):
            np.testing.assert_array_equal(ta[k], tb[k])
        diff = np.abs(ia.astype(np.int16) - ib.astype(np.int16))
        assert diff.mean() < 1.5 and np.quantile(diff, 0.99) <= 6

    rng = np.random.default_rng(0)
    (tmp_path / "labels" / "val").mkdir(parents=True)
    (tmp_path / "images" / "val").mkdir(parents=True)
    pngs = []
    for i, (h, w) in enumerate(((48, 80), (96, 64), (64, 64), (33, 127), (200, 40))):
        pngs.append(str(tmp_path / "images" / "val" / f"im{i}.png"))
        cv2.imwrite(pngs[-1], rng.integers(0, 255, (h, w, 3), np.uint8))
        (tmp_path / "labels" / "val" / f"im{i}.txt").write_text(
            f"{i % 2} 0.375 0.375 0.25 0.25\n")
    ds = DetectionDataset(pngs, SIZE, load_hyperparams(), augment=False)
    _same_batches(make_val_loader(ds, 2, native="on"),
                  make_val_loader(ds, 2, native="off"))


# --- evaluate, end to end ----------------------------------------------

def _tiny_params(images):
    """A JAX-layout tree for the tiny model (unfolded): eval_state's
    weights set from `images`, so that detections depend on the image
    and boxes fit it."""
    return to_jax_params(eval_state(TINY, 0, images, "cpu"))


class _Loader:
    """Batches of 4, 4 and 2 images with the given per-image targets."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return 3

    def __iter__(self):
        for lo, n in ((0, 4), (4, 4), (8, 2)):
            rows = [(i, lab) for i in range(n) for lab in self.labels[lo + i]]
            yield self.images[lo:lo + n], {
                "cls": np.array([[r[1][0]] for r in rows], np.float32).reshape(-1, 1),
                "box": np.array([r[1][1:] for r in rows], np.float32).reshape(-1, 4),
                "idx": np.array([r[0] for r in rows], np.float32)}


def _labels_from(outs):
    """Per image, labels [cls, cx, cy, w, h] (normalized) from detections:
    of the first six, the 1st and 4th as they are, the 2nd and 5th
    shifted by a fifth of their width, the 3rd and 6th with the other
    class; the last image has none."""
    labels = []
    for out in outs:
        for b in range(out["boxes"].shape[0]):
            rows = []
            for j in range(min(6, int(out["count"][b]))):
                x1, y1, x2, y2 = (float(v) for v in out["boxes"][b, j])
                cls = int(out["classes"][b, j])
                if j % 3 == 1:
                    x1, x2 = x1 + (x2 - x1) / 5, x2 + (x2 - x1) / 5
                elif j % 3 == 2:
                    cls = 1 - cls
                rows.append([cls, (x1 + x2) / 2 / SIZE, (y1 + y2) / 2 / SIZE,
                             (x2 - x1) / SIZE, (y2 - y1) / SIZE])
            labels.append(rows)
    labels[-1] = []
    return labels[:10]


@pytest.fixture(scope="module")
def tiny_eval():
    """tpu_yolo's evaluate at f32 on 10 images in ragged batches, with
    labels made from its own predict_step's detections."""
    images = seeded_images(np.random.default_rng(7), 10, SIZE)
    params = _tiny_params(images)
    folded = jax_yolo.fold_batchnorm(params)
    first = [jax_evaluator.predict_step(folded, np.concatenate(
        [images[lo:lo + n], np.zeros((4 - n, SIZE, SIZE, 3), np.uint8)]),
        cfg=JTINY, compute_dtype=jnp.float32) for lo, n in ((0, 4), (4, 4), (8, 2))]
    labels = _labels_from([{k: np.asarray(v) for k, v in o.items()} for o in first])

    outs, env = [], {}
    real = jax_evaluator.predict_step

    def tap(*a, **k):
        out = real(*a, **k)
        outs.append({k: np.asarray(v) for k, v in out.items()})
        return out

    jax_evaluator.predict_step = tap
    try:
        result = jax_evaluator.evaluate(folded, _Loader(images, labels), JTINY, SIZE,
                                        compute_dtype=jnp.float32, envelope_stats=env)
    finally:
        jax_evaluator.predict_step = real
    return params, images, labels, outs, env, result


def _port_eval(tiny_eval, monkeypatch, predict=None):
    params, images, labels, _, _, _ = tiny_eval
    outs, env = [], {}
    real = predict or evaluator.predict_step

    def tap(*a, **k):
        out = real(*a, **k)
        outs.append({k: v.numpy() for k, v in out.items()})
        return out

    monkeypatch.setattr(evaluator, "predict_step", tap)
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    result = evaluator.evaluate(model, _Loader(images, labels), SIZE,
                                compute_dtype=torch.float32, envelope_stats=env,
                                device="cpu")
    return outs, env, result


def test_evaluate_matches_jax(tiny_eval, monkeypatch):
    """f32, ragged batches (4, 4, 2): the same envelope certificate, the
    same detections (counts and classes equal, boxes within 3e-2 px,
    scores within 3e-4) and the same four numbers within 1e-4.

    The limits are some three times what was measured (0.0104 px,
    8.1e-5, 1.5e-5): with BatchNorm set from the images, every layer's
    output has unit spread, and the two packages' f32 convolutions,
    which sum in different orders, leave the head's logits up to 7e-4
    apart. test_evaluate_host_side_is_exact shows that the host side
    adds nothing to that."""
    _, _, labels, ref_outs, ref_env, ref = tiny_eval
    outs, env, result = _port_eval(tiny_eval, monkeypatch)
    assert env == ref_env and env["images"] == 10 and env["at_risk"] == 0
    assert sum(len(lab) for lab in labels) >= 40
    for out, ref_out in zip(outs, ref_outs):
        np.testing.assert_array_equal(out["count"], ref_out["count"])
        np.testing.assert_array_equal(out["classes"], ref_out["classes"])
        np.testing.assert_array_equal(out["n_above_conf"], ref_out["n_above_conf"])
        assert out["candidate_budget"] == ref_out["candidate_budget"]
        np.testing.assert_allclose(out["boxes"], ref_out["boxes"], rtol=0, atol=3e-2)
        np.testing.assert_allclose(out["scores"], ref_out["scores"], rtol=0, atol=3e-4)
    assert all(isinstance(v, float) for v in result)
    assert ref[0] > 0.1 and ref[1] > ref[0]          # the labels are met
    np.testing.assert_allclose(result, ref, rtol=0, atol=1e-4)


def test_evaluate_host_side_is_exact(tiny_eval, monkeypatch):
    """Fed tpu_yolo's own detections, the port's matching and AP give
    tpu_yolo's four numbers exactly."""
    _, _, _, ref_outs, ref_env, ref = tiny_eval
    feed = iter(ref_outs)
    _, env, result = _port_eval(tiny_eval, monkeypatch, predict=lambda *a, **kw: {
        k: torch.from_numpy(np.array(v)) for k, v in next(feed).items()})
    assert env == ref_env
    assert result == ref


def test_evaluate_prints_the_certificate(tiny_eval, capsys):
    params, images, labels, _, _, _ = tiny_eval
    model = YOLO.from_state_dict(TINY, from_jax_params(params, TINY))
    env = {}
    evaluator.evaluate(model, _Loader(images, labels), SIZE, progress=True,
                       compute_dtype=torch.float32, envelope_stats=env,
                       max_nms=100, device="cpu")
    line = capsys.readouterr().out.strip()
    assert env["budget"] == 100 and env["at_risk"] > 0
    assert line == (f"[eval] candidate envelope: {env['at_risk']}/10 images at spill "
                    f"risk (budget K=100, max above-conf count {env['max_above_conf']}): "
                    "selection possible missed tail detections — raise --max-nms")


def test_evaluate_raises_without_a_card(tiny_eval):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluator.evaluate(YOLO(TINY), _Loader(*tiny_eval[1:3]), SIZE)
