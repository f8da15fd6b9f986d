"""The port's trainer and CLI on a synthetic mini-COCO, on the CPU, and
its checkpoints carried to the JAX package and back."""
import argparse
import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.io import checkpoint as jax_ckpt
from tpu_yolo.models import yolov11 as jax_yolo
from tpu_yolo.train import step as jax_step
from tpu_yolo.train import trainer as jax_trainer
from tpu_yolo_torch.cli import main as cli
from tpu_yolo_torch.core.config import ModelConfig, load_hyperparams
from tpu_yolo_torch.data.dataset import DetectionDataset, split_files
from tpu_yolo_torch.data.image import bgr_hwc_to_rgb, letterbox, load_image
from tpu_yolo_torch.data.loader import make_val_loader
from tpu_yolo_torch.eval.evaluator import evaluate
from tpu_yolo_torch.io import checkpoint as ckpt_io
from tpu_yolo_torch.io.weights import to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO
from tpu_yolo_torch.seeded import eval_state, label_from_detections, write_mini_coco
from tpu_yolo_torch.train import trainer
from tpu_yolo_torch.train.trainer import train

torch.set_num_threads(1)

_TINY = dict(width=(3, 8, 16, 32, 64, 128), depth=(1,) * 6, csp=(False, True),
             num_classes=2)
TINY, JTINY = ModelConfig(**_TINY), JaxConfig(**_TINY)
GAINS = np.asarray([7.5, 0.5, 1.5], np.float32)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_mini_coco(str(tmp_path_factory.mktemp("mini_coco")), 8)


@pytest.fixture
def hyp():
    h = load_hyperparams()
    h["names"] = {0: "red", 1: "blue"}
    return h


def _args(data_dir, save_dir, **over):
    kw = dict(model_size="n", input_size=64, batch_size=4, epochs=2,
              data_dir=data_dir, save_dir=str(save_dir), resume="", weights="",
              workers=1, gt_bucket=0, remat=False, remat_level="stage",
              tensorboard=False, val_batch_size=4, native_eval="off", max_nms=2048)
    kw.update(over)
    return argparse.Namespace(**kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


@pytest.fixture(scope="module")
def full_run(tmp_path_factory, data_dir):
    """Two epochs on the CPU with the final strip held back, so that
    last.ckpt stays a full training checkpoint."""
    save_dir = tmp_path_factory.mktemp("run")
    h = load_hyperparams()
    h["names"] = {0: "red", 1: "blue"}
    strip, trainer.ckpt_io.strip_checkpoint = trainer.ckpt_io.strip_checkpoint, lambda p: None
    try:
        state = train(_args(data_dir, save_dir), h, TINY, device="cpu")
    finally:
        trainer.ckpt_io.strip_checkpoint = strip
    return save_dir, state


def test_train_writes_its_files(full_run):
    save_dir, state = full_run
    # 8 images, batch 4: 2 steps an epoch; accumulate = 64 / 4 = 16, so the
    # one update is the step-0 one
    assert state.step == 4 and state.ema_updates == 1 and state.accum is not None
    with open(save_dir / "step.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["001", "002"]
    assert set(rows[0]) == {"epoch", "box", "cls", "dfl", "Recall", "Precision",
                            "mAP@50", "mAP"}
    assert all(np.isfinite(float(r[k])) for r in rows for k in ("box", "cls", "dfl"))
    assert rows[0]["mAP"] == "0.000"          # no val2017.txt: zeros
    for name in ("last.ckpt", "best.ckpt"):
        payload = ckpt_io.load_checkpoint(str(save_dir / name))
        assert set(payload) == {"epoch", "best", "meta", "params", "opt", "step",
                                "ema_updates", "ema_params"}
        assert payload["meta"] == {"size": "n", "num_classes": 2}
    assert payload["epoch"] == 2 and int(payload["step"]) == 4
    assert set(payload["opt"]) == {"momentum", "accum"}


def test_jax_package_resumes_from_the_ports_checkpoint(full_run):
    """tpu_yolo reads the port's last.ckpt into a train state whose tree
    equals its own, and takes a train step from it."""
    save_dir, state = full_run
    payload = jax_ckpt.load_checkpoint(str(save_dir / "last.ckpt"))
    jstate = {k: payload[k] for k in ("params", "opt", "step", "ema_updates",
                                      "ema_params")}
    fresh = jax_step.init_train_state(jax_yolo.init_params(0, JTINY), ema=True,
                                      accumulate=16)
    assert (jax.tree_util.tree_structure(jstate)
            == jax.tree_util.tree_structure(fresh))
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(fresh)):
        assert a.shape == b.shape and a.dtype == b.dtype
    want = _flat(to_jax_params(state.model.state_dict()))
    got = _flat(jstate["params"])
    assert all(np.array_equal(got[k], want[k]) for k in want)

    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    images = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3), np.uint8)
    gt = np.zeros((4, 32, 5), np.float32)
    gt[:, 0] = [1, 8.0, 8.0, 40.0, 40.0]
    jstate, m = jax_step.train_step(
        jstate, jnp.asarray(images), jnp.asarray(gt), 0.001, GAINS, 5e-4, 0.937,
        cfg=JTINY, accumulate=16, apply_update=False, compute_dtype=jnp.float32)
    assert int(jstate["step"]) == 5
    assert all(np.isfinite(float(v)) for v in m.values())


def test_resume_from_full_checkpoint(full_run, data_dir, hyp, tmp_path, capsys):
    save_dir, state = full_run
    resumed = train(_args(data_dir, tmp_path, epochs=3,
                          resume=str(save_dir / "last.ckpt")), hyp, TINY, device="cpu")
    assert "at epoch 2" in capsys.readouterr().out
    assert resumed.step == state.step + 2 and resumed.ema_updates == 1
    with open(tmp_path / "step.csv") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["003"]
    # the final strip: (EMA) params only, in fp16
    stripped = ckpt_io.load_checkpoint(str(tmp_path / "last.ckpt"))
    assert set(stripped) == {"epoch", "best", "params", "meta"}
    assert stripped["params"]["net"]["p1"][0]["w"].dtype == np.float16
    assert stripped["epoch"] == 3


def test_resume_from_stripped_checkpoint_is_a_fine_tune(full_run, data_dir, hyp,
                                                        tmp_path, capsys):
    save_dir, _ = full_run
    path = str(tmp_path / "stripped.ckpt")
    with open(save_dir / "last.ckpt", "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    ckpt_io.strip_checkpoint(path)
    state = train(_args(data_dir, tmp_path / "out", epochs=1, resume=path), hyp,
                  TINY, device="cpu")
    assert "fine-tuning from stripped checkpoint" in capsys.readouterr().out
    assert state.step == 2 and state.ema_updates == 1


def test_port_resumes_from_the_jax_packages_checkpoint(data_dir, hyp, tmp_path, capsys):
    """A train checkpoint that tpu_yolo wrote (its own _save_train_ckpt,
    after one of its train steps) resumes in the port with its step count,
    momentum and EMA."""
    jstate = jax_step.init_train_state(jax_yolo.init_params(7, JTINY), ema=True,
                                       accumulate=16)
    images = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3), np.uint8)
    gt = np.zeros((4, 32, 5), np.float32)
    gt[:, 0] = [1, 8.0, 8.0, 40.0, 40.0]
    jstate, _ = jax_step.train_step(
        jstate, jnp.asarray(images), jnp.asarray(gt), 0.001, GAINS, 5e-4, 0.937,
        cfg=JTINY, accumulate=16, apply_update=True, compute_dtype=jnp.float32)
    path = str(tmp_path / "jax_last.ckpt")
    jax_trainer._save_train_ckpt(path, jstate, epoch=0, best=0.0,
                                 meta={"size": "n", "num_classes": 2})

    seen = {}
    real = trainer.train_state_from_jax

    def tap(*a, **k):
        seen["state"] = real(*a, **k)
        seen["momentum"] = {n: t.clone() for n, t in seen["state"].momentum.items()}
        return seen["state"]

    trainer.train_state_from_jax = tap
    try:
        state = train(_args(data_dir, tmp_path / "out", resume=path), hyp, TINY,
                      device="cpu")
    finally:
        trainer.train_state_from_jax = real
    assert "at epoch 1" in capsys.readouterr().out
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate["opt"]["momentum"]))
    got = _flat(to_jax_params(seen["momentum"]))
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert max(np.abs(v).max() for v in got.values()) > 0
    assert state.step == 1 + 2 and state.ema_updates == 1   # one epoch left


@pytest.fixture(scope="module")
def val_run(tmp_path_factory):
    """Two epochs at 128 px on a split with 6 val images, fine-tuned from
    eval_state weights with val labels from their own detections (so that
    mAP is far from 0), each epoch's EMA state and eval result recorded.
    The LR is 0, so that only the BatchNorm statistics move (the one EMA
    update of these 2 steps is step 0's) and the labels stay met."""
    root = write_mini_coco(str(tmp_path_factory.mktemp("with_val")), 4, 6,
                           hw=(96, 128))
    images = np.stack([bgr_hwc_to_rgb(letterbox(load_image(f, 128)[0], 128)[0])
                       for f in split_files(root, "val2017")])
    state = eval_state(TINY, 0, images, "cpu")
    label_from_detections(root, YOLO.from_state_dict(TINY, state), 128, per_image=12)
    start = os.path.join(root, "start.ckpt")
    ckpt_io.save_checkpoint(start, {"params": to_jax_params(state)})
    h = load_hyperparams()
    h["names"] = {0: "red", 1: "blue"}
    h.update(max_lr=0.0, min_lr=0.0)
    seen = []
    real = trainer._run_eval

    def tap(args, hyp, cfg, state, device):
        ema = {k: v.clone() for k, v in state.ema.items()}
        seen.append((ema, real(args, hyp, cfg, state, device)))
        return seen[-1][1]

    save_dir = tmp_path_factory.mktemp("val_run")
    trainer._run_eval = tap
    try:
        train(_args(root, save_dir, resume=start, input_size=128), h, TINY,
              device="cpu")
    finally:
        trainer._run_eval = real
    return root, save_dir, h, seen


def test_per_epoch_eval_scores_the_ema_weights(val_run):
    """Each step.csv row holds the eval of that epoch's EMA weights: a
    direct evaluate of the recorded EMA state gives the same four numbers
    and the row's strings."""
    root, save_dir, hyp, seen = val_run
    with open(save_dir / "step.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(seen) == 2
    dataset = DetectionDataset(split_files(root, "val2017"), 128, hyp, augment=False)
    for row, (ema, result) in zip(rows, seen):
        direct = evaluate(YOLO.from_state_dict(TINY, ema),
                          make_val_loader(dataset, 4, num_workers=1, native="off"),
                          128, device="cpu")
        assert direct == result
        assert [row[k] for k in ("mAP", "mAP@50", "Recall", "Precision")] == [
            f"{v:.3f}" for v in direct]
        assert direct[0] > 0.05


def test_best_ckpt_follows_map(hyp, tmp_path, monkeypatch):
    """best.ckpt is written at each new best mAP and kept otherwise."""
    root = write_mini_coco(str(tmp_path / "coco"), 4, 2, hw=(48, 64))
    for epochs, best_epoch, best in ((2, 1, 0.2), (4, 3, 0.3)):
        maps = iter([0.2, 0.1, 0.3, 0.25])
        monkeypatch.setattr(trainer, "evaluate",
                            lambda *a, maps=maps, **k: (next(maps), 0.5, 0.5, 0.5))
        train(_args(root, tmp_path / f"run{epochs}", epochs=epochs), hyp, TINY,
              device="cpu")
        payload = ckpt_io.load_checkpoint(str(tmp_path / f"run{epochs}" / "best.ckpt"))
        last = ckpt_io.load_checkpoint(str(tmp_path / f"run{epochs}" / "last.ckpt"))
        assert (payload["epoch"], payload["best"]) == (best_epoch, best)
        assert (last["epoch"], last["best"]) == (epochs, best)


def test_divergence_guard_saves_crash_ckpt(data_dir, hyp, tmp_path):
    hyp.update(max_lr=1e12, min_lr=1e12, warmup_epochs=0.0)
    with pytest.raises(FloatingPointError, match="crash.ckpt"):
        train(_args(data_dir, tmp_path, epochs=4, batch_size=8), hyp, TINY,
              device="cpu")
    assert "opt" in ckpt_io.load_checkpoint(str(tmp_path / "crash.ckpt"))


def test_fixed_gt_bucket_truncates_and_says_so(data_dir, hyp, tmp_path, capsys):
    hyp["mosaic"] = 1.0     # four images a sample: more than one box each
    seen = []
    real = trainer.build_padded_targets
    trainer.build_padded_targets = lambda *a: seen.append(a[2]) or real(*a)
    try:
        train(_args(data_dir, tmp_path, epochs=1, gt_bucket=1), hyp, TINY, device="cpu")
        train(_args(data_dir, tmp_path, epochs=1), hyp, TINY, device="cpu")
    finally:
        trainer.build_padded_targets = real
    assert seen == [1, 1, 32, 32]
    assert "truncated" in capsys.readouterr().out


def test_remat_runs_through_the_trainer(data_dir, hyp, tmp_path):
    state = train(_args(data_dir, tmp_path, epochs=1, remat=True,
                        remat_level="blocks"), hyp, TINY, device="cpu")
    assert state.step == 2


def test_trainer_raises_without_a_card(data_dir, hyp, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_args(data_dir, tmp_path), hyp, TINY)


def test_gt_buckets_and_accumulate_rule():
    assert [trainer._gt_bucket(n) for n in (1, 32, 33, 200, 513)] == [32, 32, 64, 256, 512]
    assert [jax_trainer._gt_bucket(n) for n in (1, 32, 33, 200, 513)] == [32, 32, 64, 256, 512]


def test_cli_trains_on_the_cpu(data_dir, tmp_path):
    import yaml

    h = load_hyperparams()
    h["names"] = {0: "red", 1: "blue"}
    hyp_path = tmp_path / "hyp.yaml"
    hyp_path.write_text(yaml.safe_dump(h))
    cli.main(["--train", "--device", "cpu", "--model-size", "n", "--input-size", "64",
              "--batch-size", "4", "--epochs", "1", "--data-dir", data_dir,
              "--save-dir", str(tmp_path / "w"), "--hyp", str(hyp_path),
              "--workers", "2", "--seed", "3", "--gt-bucket", "32", "--remat"])
    assert os.path.exists(tmp_path / "w" / "last.ckpt")
    assert os.path.exists(tmp_path / "w" / "step.csv")


def test_cli_flags():
    args = cli.parse_args(["--train"])
    assert args.device == "cuda" and args.batch_size == 32 and args.epochs == 600
    assert args.remat_level == "stage" and args.gt_bucket == 0
    args = cli.parse_args(["--test"])
    assert args.test and args.val_batch_size == 32 and args.max_nms == 2048
    assert args.native_eval == "auto" and not args.coco_metrics and not args.plot
    assert not args.device_augment
    assert cli.parse_args(["--train", "--device-augment"]).device_augment
    assert cli.parse_args(["--profile"]).profile
    assert cli.parse_args(["--export"]).export == "torch"
    assert cli.parse_args(["--export", "onnx"]).export == "onnx"
    assert cli.parse_args(["--train"]).native_train == "off"
    assert cli.parse_args(["--train", "--distributed"]).distributed
    assert not cli.parse_args(["--train"]).distributed
    with pytest.raises(SystemExit):
        cli.parse_args(["--native-train", "bilinear"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--gt-bucket", "-1"])


# -- --device-augment ----------------------------------------------------------

def _tap_programs(mp, calls):
    """Record every call of the two default augmentation programs."""
    from tpu_yolo_torch.ops import augment_device as AD

    for name in ("augment_batch", "plain_augment_batch"):
        def tap(*a, _real=getattr(AD, name), _name=name, **kw):
            out = _real(*a, **kw)
            calls.setdefault(_name, []).append((a, kw, out))
            return out
        mp.setattr(AD, name, tap)


@pytest.fixture(scope="module")
def device_augment_runs(tmp_path_factory, data_dir):
    """--device-augment through the trainer on the CPU: two epochs with
    mosaic, two with hyp["mosaic"] = 0 (the plain program)."""
    runs = {}
    for mosaic in (1.0, 0.0):
        h = load_hyperparams()
        h["names"] = {0: "red", 1: "blue"}
        h["mosaic"] = mosaic
        save_dir = tmp_path_factory.mktemp(f"device_augment_{mosaic}")
        calls = {}
        with pytest.MonkeyPatch.context() as mp:
            _tap_programs(mp, calls)
            state = train(_args(data_dir, save_dir, device_augment=True, seed=0),
                          h, TINY, device="cpu")
        runs[mosaic] = (save_dir, state, calls)
    return runs


def test_device_augment_trains_through_both_programs(device_augment_runs):
    for mosaic, program in ((1.0, "augment_batch"), (0.0, "plain_augment_batch")):
        save_dir, state, calls = device_augment_runs[mosaic]
        assert set(calls) == {program} and len(calls[program]) == 4, mosaic
        assert state.step == 4
        for _, _, out in calls[program]:
            assert out.shape == (4, 64, 64, 3) and out.dtype == torch.uint8
        with open(save_dir / "step.csv") as f:
            rows = list(csv.DictReader(f))
        assert [r["epoch"] for r in rows] == ["001", "002"]
        assert all(np.isfinite(float(r[k])) for r in rows for k in ("box", "cls", "dfl"))
        payload = ckpt_io.load_checkpoint(str(save_dir / "last.ckpt"))
        assert payload["epoch"] == 2 and "params" in payload


def _jax_params(tree):
    """Device parameters as the trainer ships them (f32, flips 0/1) ->
    the JAX programs' dict (flips bool)."""
    return {k: (_jax_params(v) if isinstance(v, dict)
                else jnp.asarray(v.numpy() > 0.5) if k.startswith("flip")
                else jnp.asarray(v.numpy())) for k, v in tree.items()}


@pytest.mark.parametrize("mosaic", [1.0, 0.0])
def test_device_augment_first_batch_matches_jax(device_augment_runs, mosaic):
    """The trainer's first augmented batch equals JAX's program on the same
    staged sources and parameters (uint8 equal on >= 99.9%, mean |diff|
    under 0.01)."""
    from tpu_yolo.ops import augment_device as jad

    _, _, calls = device_augment_runs[mosaic]
    name = "augment_batch" if mosaic else "plain_augment_batch"
    args, kw, got = calls[name][0]
    *inputs, params = args
    want = np.asarray(getattr(jad, name)(*(jnp.asarray(t.numpy()) for t in inputs),
                                         _jax_params(params), **kw))
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert (diff == 0).mean() >= 0.999 and diff.mean() < 0.01, (diff == 0).mean()


def test_cli_trains_with_device_augment(data_dir, tmp_path, capsys):
    """python -m tpu_yolo_torch.cli.main --train --device-augment on the
    CPU, with mosaic at 0.5: both programs run, and the stager is named."""
    import yaml

    h = load_hyperparams()
    h["names"] = {0: "red", 1: "blue"}
    h["mosaic"] = 0.5
    hyp_path = tmp_path / "hyp.yaml"
    hyp_path.write_text(yaml.safe_dump(h))
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        _tap_programs(mp, calls)
        cli.main(["--train", "--device-augment", "--device", "cpu",
                  "--input-size", "64", "--batch-size", "4", "--epochs", "2",
                  "--data-dir", data_dir, "--save-dir", str(tmp_path / "w"),
                  "--hyp", str(hyp_path), "--workers", "2", "--seed", "1"])
    assert set(calls) == {"augment_batch", "plain_augment_batch"}
    assert sum(len(v) for v in calls.values()) == 4
    assert "[train] device augment: stager " in capsys.readouterr().out
    assert os.path.exists(tmp_path / "w" / "last.ckpt")
