"""The port's native train loader (tpu_yolo_torch/data/native_train.py),
the BGR form of `load_batch_scaled` and the trainer's --native-train
branch, against tpu_yolo's on the CPU: pixel assembly against cv2
oracles and JAX's functions, the loader's batches bit-equal to JAX's for
the same seed, and the auto/on/off branch with its `[train] loader:`
line."""
import argparse
import os

import cv2
import numpy as np
import pytest
import torch

from tpu_yolo.data import native_loader as jax_native
from tpu_yolo.data import native_train as jax_native_train
from tpu_yolo_torch.core.config import ModelConfig, load_hyperparams
from tpu_yolo_torch.data import native_loader
from tpu_yolo_torch.data.device_augment import _compose_affine, _mosaic_placement
from tpu_yolo_torch.data.image import letterbox
from tpu_yolo_torch.data.native_train import (NativeTrainLoader,
                                              assemble_pixels_mosaic,
                                              assemble_pixels_plain)
from tpu_yolo_torch.seeded import write_mini_coco
from tpu_yolo_torch.train import trainer

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(not native_loader.available(),
                                  reason="native library not built")

_HYP = {"scale": 0.5, "translate": 0.1, "flip_ud": 0.0, "flip_lr": 0.5,
        "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
        "mosaic": 1.0, "mix_up": 0.3, "degrees": 0.0, "shear": 0.0}
TINY = ModelConfig(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6,
                   csp=(False, True), num_classes=2)


@pytest.fixture(scope="module")
def train_mini_coco(tmp_path_factory):
    """tests/test_native_train.py's mini train set: PNG and JPEG forms of
    the same scenes (a PNG takes the cv2 fallback, a JPEG libjpeg)."""
    root = tmp_path_factory.mktemp("train_mini_coco")
    rng = np.random.default_rng(5)
    sets = {}
    for ext in ("png", "jpg"):
        img_dir = root / ext / "images" / "train2017"
        lbl_dir = root / ext / "labels" / "train2017"
        img_dir.mkdir(parents=True)
        lbl_dir.mkdir(parents=True)
        names = []
        for i, (h, w) in enumerate([(60, 100), (120, 80), (64, 64),
                                    (45, 150), (200, 50), (90, 90)]):
            img = rng.integers(0, 255, (h, w, 3), np.uint8)
            img[h // 4: h // 2, w // 4: w // 2] = (30, 200, 30)
            p = str(img_dir / f"im{i}.{ext}")
            cv2.imwrite(p, img)
            (lbl_dir / f"im{i}.txt").write_text(
                f"{i % 3} 0.375 0.375 0.25 0.25\n{(i + 1) % 3} 0.7 0.7 0.2 0.2\n")
            names.append(p)
        sets[ext] = names
    return sets


def test_pixel_assembly_mosaic_matches_manual_cv2_and_jax():
    """assemble_pixels_mosaic == an independent replay of the quadrant
    paste + one warpAffine, and == JAX's function, with and without a
    failed quadrant."""
    rng = np.random.default_rng(2)
    size = 64
    dims = np.array([[48, 64], [64, 40], [64, 64], [30, 64]], np.float32)
    staged = np.zeros((4, size, size, 3), np.uint8)
    for q, (h, w) in enumerate(dims.astype(int)):
        staged[q, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
    draw = {"xc": 70, "yc": 58, "s": 0.83, "tx": 0.47 * size, "ty": 0.55 * size,
            "flip_ud": False, "flip_lr": True, "gains": np.ones(3)}
    m = _compose_affine(draw["s"], 0, 0, 0, draw["tx"], draw["ty"], size, size)
    for failed in (frozenset(), frozenset({2})):
        got = assemble_pixels_mosaic(draw, staged, dims, size, failed=failed)
        canvas = np.zeros((size * 2, size * 2, 3), np.uint8)
        for q, (h, w) in enumerate(dims.astype(int)):
            if q in failed:
                continue
            (x1a, y1a, x2a, y2a), (x1b, y1b, x2b, y2b) = _mosaic_placement(
                q, draw["xc"], draw["yc"], w, h, size)
            canvas[y1a:y2a, x1a:x2a] = staged[q, y1b:y2b, x1b:x2b]
        want = cv2.warpAffine(canvas, m[:2], dsize=(size, size), borderValue=(0, 0, 0))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_native_train.assemble_pixels_mosaic(
            draw, staged, dims, size, failed=failed))


def test_pixel_assembly_plain_matches_letterbox_warp():
    """assemble_pixels_plain == letterbox(augment=True) + warpAffine of
    the same prescaled source, and == JAX's function."""
    rng = np.random.default_rng(3)
    size = 64
    for sh, sw in ((48, 64), (64, 33), (64, 64)):
        src = rng.integers(0, 256, (sh, sw, 3), np.uint8)
        staged = np.zeros((size, size, 3), np.uint8)
        staged[:sh, :sw] = src
        draw = {"s": 1.12, "tx": 0.51 * size, "ty": 0.44 * size}
        got = assemble_pixels_plain(draw, staged, sh, sw, size)
        lb, ratio, _ = letterbox(src, size, augment=True)
        assert lb.shape == (size, size, 3) and ratio[0] == 1.0
        m = _compose_affine(draw["s"], 0, 0, 0, draw["tx"], draw["ty"],
                            size / 2, size / 2)
        want = cv2.warpAffine(lb, m[:2], dsize=(size, size), borderValue=(0, 0, 0))
        np.testing.assert_array_equal(got, want, err_msg=f"{sh}x{sw}")
        np.testing.assert_array_equal(got, jax_native_train.assemble_pixels_plain(
            draw, staged, sh, sw, size))


@needs_native
def test_native_train_loader_contract_and_determinism(train_mini_coco):
    """The collate() contract, same-seed reproducibility, the epoch
    reshuffle and the mosaic cutoff's plain path."""
    loader = NativeTrainLoader(train_mini_coco["jpg"], 64, _HYP, batch_size=3,
                               threads=2, seed=0)
    assert len(loader) == 2
    b1, b2 = list(loader), list(loader)
    assert len(b1) == 2
    for (ia, ta), (ib, tb) in zip(b1, b2):
        np.testing.assert_array_equal(ia, ib)
        for k in ("cls", "box", "idx"):
            np.testing.assert_array_equal(ta[k], tb[k])
    for images, t in b1:
        assert images.shape == (3, 64, 64, 3) and images.dtype == np.uint8
        assert t["cls"].shape[1:] == (1,) and t["box"].shape[1:] == (4,)
        assert t["idx"].ndim == 1 and len(t["idx"]) == len(t["cls"])
        if len(t["box"]):
            assert (t["box"] >= 0).all() and (t["box"] <= 1).all()
            assert set(np.unique(t["idx"])) <= {0.0, 1.0, 2.0}
    loader.set_epoch(1)
    assert any(not np.array_equal(a[0], b[0]) for a, b in zip(b1, list(loader)))
    loader.mosaic = False
    loader.set_epoch(0)
    for images, _ in loader:
        assert images.shape == (3, 64, 64, 3)
    # a consumer that stops early leaves no producer behind
    next(iter(loader))


@needs_native
@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("interp", ["bilinear", "random"])
def test_native_train_loader_matches_jax(train_mini_coco, ext, interp):
    """The port's loader and tpu_yolo's, same files and seed, two epochs:
    images and targets bit-equal (JPEGs through libjpeg, PNGs through
    the cv2 fallback; random and bilinear prescale)."""
    kw = dict(batch_size=2, threads=2, seed=4, interp=interp)
    ours = NativeTrainLoader(train_mini_coco[ext], 64, _HYP, **kw)
    theirs = jax_native_train.NativeTrainLoader(train_mini_coco[ext], 64, _HYP, **kw)
    n = 0
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for (ia, ta), (ib, tb) in zip(ours, theirs):
            np.testing.assert_array_equal(ia, ib)
            for k in ("cls", "box", "idx"):
                np.testing.assert_array_equal(ta[k], tb[k])
            n += 1
    assert n == 2 * len(ours) == 6


@needs_native
@pytest.mark.parametrize("interps", [None, [3, 2, 1, 0, 4, 1]])
def test_load_batch_scaled_bgr_matches_jax(train_mini_coco, interps):
    """load_batch_scaled(bgr=True) against tpu_yolo's on JPEGs (libjpeg)
    and PNGs (the cv2 fallback through fb_scaled(bgr=True)): bytes and
    dims equal, and the BGR buffer is the RGB one with channels swapped.
    Cv2Pipeline's BGR form equals JAX's fallback fill on every image."""
    ours = native_loader.NativePipeline(64, threads=2)
    theirs = jax_native.NativePipeline(64, threads=2)
    for ext in ("jpg", "png"):
        files = train_mini_coco[ext]
        got, dims, nfail = ours.load_batch_scaled(files, 64, interps=interps, bgr=True)
        want, wdims, wfail = theirs.load_batch_scaled(files, 64, bgr=True, interps=interps)
        assert nfail == wfail == 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(dims, wdims)
        rgb, _, _ = ours.load_batch_scaled(files, 64, interps=interps)
        np.testing.assert_array_equal(got, rgb[..., ::-1])
    files = train_mini_coco["png"]
    got, dims, _ = native_loader.Cv2Pipeline(2).load_batch_scaled(
        files, 64, interps=interps, bgr=True)
    fill = theirs._fb_scaled(64, bgr=True, interps=interps)
    for i, path in enumerate(files):
        out, d = np.zeros((64, 64, 3), np.uint8), np.zeros(4, np.float32)
        fill(cv2.imread(path), out, d, i)
        np.testing.assert_array_equal(got[i], out)
        np.testing.assert_array_equal(dims[i], d)


# -- the trainer's --native-train branch -----------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_mini_coco(str(tmp_path_factory.mktemp("mini_coco")), 8)


def _args(data_dir, save_dir, **over):
    kw = dict(model_size="n", input_size=64, batch_size=4, epochs=1,
              data_dir=data_dir, save_dir=str(save_dir), resume="", weights="",
              workers=1, gt_bucket=0, remat=False, remat_level="stage",
              tensorboard=False, val_batch_size=4, native_eval="off", max_nms=2048,
              seed=0)
    kw.update(over)
    return argparse.Namespace(**kw)


def _hyp():
    h = load_hyperparams()
    h["names"] = {0: "red", 1: "blue"}
    return h


@needs_native
def test_trainer_takes_the_native_loader(data_dir, tmp_path, capsys):
    """--native-train on and auto train through NativeTrainLoader where
    the library loads, and say so; off keeps the host loader."""
    for mode, line in (("on", "native"), ("auto", "native"), ("off", "host")):
        state = trainer.train(_args(data_dir, tmp_path / mode, native_train=mode),
                              _hyp(), TINY, device="cpu")
        assert state.step == 2
        assert f"[train] loader: {line}\n" in capsys.readouterr().out


def test_trainer_without_the_library(data_dir, tmp_path, capsys, monkeypatch):
    """Without the library auto falls back to the host loader and says
    why, and on raises the JAX package's message."""
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "_why", "make -C native could not run: test")
    state = trainer.train(_args(data_dir, tmp_path / "auto", native_train="auto"),
                          _hyp(), TINY, device="cpu")
    assert state.step == 2
    assert ("[train] loader: host (--native-train auto: make -C native could not "
            "run: test)") in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="--native-train on requires "
                                           "native/libtpuyolo_data.so"):
        trainer.train(_args(data_dir, tmp_path / "on", native_train="on"),
                      _hyp(), TINY, device="cpu")
    with pytest.raises(RuntimeError, match="needs the native loader"):
        NativeTrainLoader([], 64, _HYP, batch_size=2)


@pytest.mark.parametrize("mode", ["on", "auto"])
def test_trainer_refuses_native_train_with_device_augment(data_dir, tmp_path, mode):
    with pytest.raises(ValueError, match="cannot be combined with --device-augment"):
        trainer.train(_args(data_dir, tmp_path, native_train=mode, device_augment=True),
                      _hyp(), TINY, device="cpu")


def test_trainer_names_the_device_loader(data_dir, tmp_path, capsys):
    trainer.train(_args(data_dir, tmp_path, device_augment=True), _hyp(), TINY,
                  device="cpu")
    assert "[train] loader: device\n" in capsys.readouterr().out


def test_cli_native_train_flag():
    from tpu_yolo_torch.cli import main as cli

    assert cli.parse_args(["--train"]).native_train == "off"
    for mode in ("auto", "on", "off"):
        assert cli.parse_args(["--train", "--native-train", mode]).native_train == mode
    with pytest.raises(SystemExit):
        cli.parse_args(["--native-train", "bilinear"])


@needs_native
def test_cli_trains_with_the_native_loader(data_dir, tmp_path, capsys):
    import yaml

    hyp_path = tmp_path / "hyp.yaml"
    hyp_path.write_text(yaml.safe_dump(_hyp()))
    from tpu_yolo_torch.cli import main as cli

    cli.main(["--train", "--native-train", "on", "--device", "cpu", "--input-size",
              "64", "--batch-size", "4", "--epochs", "1", "--data-dir", data_dir,
              "--save-dir", str(tmp_path / "w"), "--hyp", str(hyp_path),
              "--workers", "2"])
    assert "[train] loader: native\n" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "w" / "last.ckpt")
