"""The port's data parallelism across processes on the CPU (gloo), against
the JAX package's SPMD step on its 8 virtual CPU devices and against the
port's single process: `python -m tpu_yolo_torch.rehearsal` workers (a
tiny model at 64 px, f32), one process group per run rendezvousing on a
file in tmp_path, the CLI and the preflight under torchrun. The workers
import torch and the port only."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_yolo.core.config import ModelConfig as JaxConfig
from tpu_yolo.io import checkpoint as jax_ckpt
from tpu_yolo.parallel import DataParallel as JaxDataParallel
from tpu_yolo.parallel import make_mesh as jax_make_mesh
from tpu_yolo.train import loss as jax_loss
from tpu_yolo.train import step as jax_step
from tpu_yolo.train.trainer import _gt_bucket as jax_gt_bucket
from tpu_yolo_torch import parallel, rehearsal
from tpu_yolo_torch.cli import main as cli
from tpu_yolo_torch.core.config import get_model_config, load_hyperparams
from tpu_yolo_torch.data.dataset import split_files
from tpu_yolo_torch.data.image import bgr_hwc_to_rgb, letterbox, load_image
from tpu_yolo_torch.io.checkpoint import save_checkpoint
from tpu_yolo_torch.io.weights import from_jax_params, load_params, to_jax_params
from tpu_yolo_torch.models.yolov11 import YOLO, init_params
from tpu_yolo_torch.ops.nn import ConvBN
from tpu_yolo_torch.rehearsal import GAINS, TINY, make_global_batch
from tpu_yolo_torch.seeded import eval_state, label_from_detections, write_mini_coco

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JTINY = JaxConfig(width=TINY.width, depth=TINY.depth, csp=TINY.csp,
                  num_classes=TINY.num_classes)
TOL = 2e-4          # tests/test_multihost.py's tolerance between topologies
TIMEOUT = 300


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(n: int, extra, init: str | None):
    """n rehearsal processes; one process group on the file `init`, or a
    single process with no group when init is None."""
    group = ["--init-method", f"file://{init}"] if init else []
    return [subprocess.Popen(
        [sys.executable, "-m", "tpu_yolo_torch.rehearsal", "--device", "cpu",
         "--num-processes", str(n), "--process-id", str(i), *group, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(),
        cwd=ROOT) for i in range(n)]


def _collect(procs):
    outs, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            if p.returncode:
                errs.append(err[-4000:])
            else:
                outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not errs, "\n---\n".join(errs)
    return outs


@pytest.fixture(scope="module")
def runs(torchruns, tmp_path_factory):
    """Every rehearsal run of this file, started together: the single
    process with no group (the oracle), two ranks, one rank in a group,
    accumulate 2 both ways, two ranks with remat per block and with a
    fixed GT bucket, and the first
    half of a save -> kill -> resume cycle, whose second half follows;
    and JAX's losses at accumulate 1 and 2 ("jax")."""
    d = tmp_path_factory.mktemp("rehearsal")
    ckpt = str(d / "mid.ckpt")
    specs = {"oracle": (1, ["--eval-ap"], None),
             "two": (2, ["--eval-ap"], d / "two"),
             "one_rank": (1, [], d / "one_rank"),
             "oracle_acc2": (1, ["--accumulate", "2"], None),
             "two_acc2": (2, ["--accumulate", "2"], d / "two_acc2"),
             "two_remat": (2, ["--remat", "blocks"], d / "two_remat"),
             "two_bucket": (2, ["--gt-bucket", "32"], d / "two_bucket"),
             "first": (2, ["--steps", "2", "--ckpt", ckpt], d / "first")}
    started = {k: _start(n, extra, init and str(init)) for k, (n, extra, init)
               in specs.items()}
    try:   # JAX's compiles overlap the workers
        out = {"jax": {acc: _jax_steps(acc)[0] for acc in (1, 2)}}
    finally:
        out.update({k: _collect(p) for k, p in started.items()})
    out["resumed"] = _collect(_start(2, ["--steps", "2", "--start-step", "2",
                                         "--resume-from", ckpt], str(d / "resumed")))
    out["ckpt"] = ckpt
    return out


def _jax_steps(accumulate: int, steps=3, state=None, start=0):
    """JAX's train_step on DataParallel(make_mesh(n_data=2)) over the
    rehearsal's global batches of 8: the losses of each step, and the state."""
    dp = JaxDataParallel(jax_make_mesh(n_data=2))
    if state is None:
        state = jax_step.init_train_state(init_params(0, TINY), ema=True,
                                          accumulate=accumulate)
    state = dp.replicate(jax.tree_util.tree_map(jnp.asarray, state))
    losses = []
    for step in range(start, start + steps):
        images, targets = make_global_batch(step, 8, 64, TINY.num_classes)
        counts = np.bincount(targets["idx"].astype(np.int64), minlength=8)
        gt = jax_loss.build_padded_targets(targets, 8, jax_gt_bucket(int(counts.max())),
                                           (64, 64))
        state, m = jax_step.train_step(
            state, dp.shard_batch(jnp.asarray(images)), dp.shard_batch(jnp.asarray(gt)),
            0.01, jnp.asarray(GAINS, jnp.float32), 5e-4, 0.937, cfg=JTINY,
            accumulate=accumulate, apply_update=step % accumulate == 0,
            compute_dtype=jnp.float32)
        losses.append([float(m[k]) for k in ("loss_box", "loss_cls", "loss_dfl")])
    return np.asarray(losses), state


@pytest.mark.parametrize("accumulate", [1, 2])
def test_two_ranks_match_jax_and_one_process(runs, accumulate):
    """(a) 2 ranks x 4 images: each rank's losses and final state bit-equal
    to the other's; the losses within 2e-4 of JAX's SPMD step over the 8
    images on 2 devices and of the port's single process, at 3 steps."""
    two = runs["two" if accumulate == 1 else "two_acc2"]
    oracle = runs["oracle" if accumulate == 1 else "oracle_acc2"][0]
    assert [r["world"] for r in two] == [2, 2] and oracle["world"] == 1
    assert two[0]["losses"] == two[1]["losses"]
    assert two[0]["state_sha256"] == two[1]["state_sha256"]
    want = runs["jax"][accumulate]
    for got in (two[0]["losses"], oracle["losses"]):
        np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.asarray(two[0]["losses"]), np.asarray(oracle["losses"]),
                               rtol=TOL, atol=TOL)


def test_one_rank_equals_no_group_bit_for_bit(runs):
    """A process group of one runs every collective and changes no bit."""
    one, oracle = runs["one_rank"][0], runs["oracle"][0]
    assert one["world"] == 1
    assert one["losses"] == oracle["losses"]
    assert one["state_sha256"] == oracle["state_sha256"]
    assert one["eval_counts"] == oracle["eval_counts"]


def test_remat_recomputes_the_global_statistics(runs):
    """--remat blocks on 2 ranks: the checkpointed regions' second run
    reduces too (every rank recomputes alike), so the losses stay the
    global batch's."""
    remat, oracle = runs["two_remat"], runs["oracle"][0]
    assert remat[0]["losses"] == remat[1]["losses"]
    assert remat[0]["state_sha256"] == remat[1]["state_sha256"]
    np.testing.assert_allclose(np.asarray(remat[0]["losses"]),
                               np.asarray(oracle["losses"]), rtol=TOL, atol=TOL)


def test_fixed_gt_bucket_equals_the_adaptive_one(runs):
    """--gt-bucket 32 on 2 ranks: the bucket the adaptive rule picks for
    these GT counts, and padded rows are masked out of the loss, so the
    ranks take the adaptive run's steps bit for bit (no collective takes
    the GT's shape)."""
    fixed, two = runs["two_bucket"], runs["two"]
    assert fixed[0]["losses"] == fixed[1]["losses"] == two[0]["losses"]
    assert fixed[0]["state_sha256"] == two[0]["state_sha256"]


_BN_AND_LOSS = textwrap.dedent('''
    import json, sys
    import numpy as np, torch
    from tpu_yolo_torch import parallel
    from tpu_yolo_torch.ops.nn import ConvBN
    from tpu_yolo_torch.io.weights import from_jax_params
    from tpu_yolo_torch.models.yolov11 import YOLO, init_params
    from tpu_yolo_torch.rehearsal import GAINS, TINY
    from tpu_yolo_torch.train.step import loss_and_grads

    rank, init, data = int(sys.argv[1]), sys.argv[2], np.load(sys.argv[3])
    parallel.init_distributed("cpu", init_method="file://" + init, rank=rank,
                              world_size=2)
    rows = slice(2 * rank, 2 * rank + 2)
    torch.manual_seed(0)
    bn = ConvBN(3, 8, k=3, padding=1).train()
    with torch.no_grad():
        bn.w.copy_(torch.from_numpy(data["w"]))
    x = torch.from_numpy(data["x"][rows])
    y = bn(x)
    grads = torch.autograd.grad((y * torch.from_numpy(data["r"][rows])).sum(),
                                [bn.w, bn.gamma, bn.beta])
    grads = [g.clone() for g in grads]
    parallel.all_reduce_flat_(grads)

    model = YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY)).train()
    half = slice(4 * rank, 4 * rank + 4)
    losses, _ = loss_and_grads(model, torch.from_numpy(data["images"][half]),
                               torch.from_numpy(data["gt"][half]), GAINS, cfg=TINY)
    print(json.dumps({"y": y.tolist(), "mean": bn.mean.tolist(), "var": bn.var.tolist(),
                      "grads": [g.tolist() for g in grads],
                      "losses": [float(v) for v in losses]}))
    parallel.close_distributed()
''')


def test_batchnorm_and_loss_normalizer_are_global(tmp_path):
    """(b) one ConvBN in training mode on 2 ranks, each given half of a
    batch of 4: the output, the running statistics and the summed
    gradients within 1e-5 of one process on the whole batch. (c) a batch
    of 8 whose second half holds no GT: the 2 ranks' loss equals the
    whole batch's, which a per-rank clamp(min=1) of sum(target_scores)
    would not give (rank 1's normalizer would be 1)."""
    rng = np.random.default_rng(0)
    images, targets = make_global_batch(7, 8, 64, TINY.num_classes)
    gt = np.zeros((8, 8, 5), np.float32)
    gt[:4] = jax_loss.build_padded_targets(targets, 8, 8, (64, 64))[:4]
    data = {"x": rng.normal(size=(4, 3, 8, 8)).astype(np.float32),
            "w": rng.normal(size=(8, 3, 3, 3)).astype(np.float32) * 0.3,
            "r": rng.normal(size=(4, 8, 8, 8)).astype(np.float32),
            "images": images, "gt": gt}
    path = str(tmp_path / "data.npz")
    np.savez(path, **data)
    procs = [subprocess.Popen([sys.executable, "-c", _BN_AND_LOSS, str(r),
                               str(tmp_path / "init"), path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=ROOT) for r in range(2)]
    ranks = _collect(procs)

    bn = ConvBN(3, 8, k=3, padding=1).train()
    with torch.no_grad():
        bn.w.copy_(torch.from_numpy(data["w"]))
    y = bn(torch.from_numpy(data["x"]))
    grads = torch.autograd.grad((y * torch.from_numpy(data["r"])).sum(),
                                [bn.w, bn.gamma, bn.beta])
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]),
                               y.detach().numpy(), rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], bn.mean.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["var"], bn.var.numpy(), rtol=1e-5, atol=1e-5)
        for got, want in zip(r["grads"], grads):
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)

    from tpu_yolo_torch.train.step import loss_and_grads

    model = YOLO.from_state_dict(TINY, from_jax_params(init_params(0, TINY), TINY)).train()
    whole, _ = loss_and_grads(model, torch.from_numpy(images), torch.from_numpy(gt),
                              GAINS, cfg=TINY)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], [float(v) for v in whole], rtol=1e-5)


def test_save_kill_resume_across_two_ranks(runs):
    """(d) 2 ranks train 2 steps and save; 2 new processes resume for 2
    more: the stitched losses equal the uninterrupted run's at the 3
    steps they share, and tpu_yolo resumes from the same .ckpt to JAX's
    own step 2 within the same tolerance."""
    first, resumed, oracle = runs["first"], runs["resumed"], runs["oracle"][0]
    assert resumed[0]["losses"] == resumed[1]["losses"]
    assert resumed[0]["state_sha256"] == resumed[1]["state_sha256"]
    stitched = np.asarray(first[0]["losses"] + resumed[0]["losses"])
    np.testing.assert_allclose(stitched[:3], np.asarray(oracle["losses"]),
                               rtol=TOL, atol=TOL)
    payload = jax_ckpt.load_checkpoint(runs["ckpt"])
    state = {k: payload[k] for k in ("params", "opt", "step", "ema_updates", "ema_params")}
    assert int(state["step"]) == 2
    jax_losses, _ = _jax_steps(1, steps=1, state=state, start=2)
    np.testing.assert_allclose(np.asarray(resumed[0]["losses"][:1]), jax_losses,
                               rtol=TOL, atol=TOL)


def test_sharded_eval_gives_a_replicated_map(runs):
    """(e) --eval-ap: each rank evaluates its rows and gathers the rest;
    mAP is the same on both ranks, far from 0, and within 1e-6 of the
    single process's."""
    two, oracle = runs["two"], runs["oracle"][0]
    assert two[0]["map"] == two[1]["map"] and two[0]["map50"] == two[1]["map50"]
    assert two[0]["map"] > 0.3
    assert two[0]["map"] == pytest.approx(oracle["map"], abs=1e-6)
    assert two[0]["map50"] == pytest.approx(oracle["map50"], abs=1e-6)
    assert two[0]["eval_counts"] == two[1]["eval_counts"] == oracle["eval_counts"]


def test_train_takes_its_ranks_from_the_process_group(tmp_path, monkeypatch):
    """The all-reduces follow the process group, so train() refuses a
    group without a dp (each rank would train the whole batch and sum
    the gradients world times over), and a dp that does not span the
    group; rank_batch refuses a global batch that does not split evenly,
    and train() a step whose rows are not the rank's share, since ConvBN
    weights every rank's moments by 1/world."""
    from argparse import Namespace

    from tpu_yolo_torch.train import trainer
    from tpu_yolo_torch.train.trainer import rank_batch, train

    args = Namespace(save_dir=str(tmp_path / "w"), batch_size=4)
    cfg, hyp = TINY, load_hyperparams()
    two = parallel.DataParallel(parallel.Mesh((torch.device("cpu"),), 2, 0))
    with pytest.raises(ValueError, match="dp spans 2 processes"):
        train(args, hyp, cfg, device="cpu", dp=two)
    parallel.init_distributed("cpu", init_method=f"file://{tmp_path / 'init'}",
                              rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="a rank of a group of 1: pass dp="):
            train(args, hyp, cfg, device="cpu")
        with pytest.raises(ValueError, match="dp spans 2 processes"):
            train(args, hyp, cfg, device="cpu", dp=two)
    finally:
        parallel.close_distributed()
    assert rank_batch(8, 2) == 4 and rank_batch(3, 1) == 3
    for batch, world in ((3, 2), (1, 2), (10, 4)):
        with pytest.raises(ValueError, match=f"NOT EVEN: {batch % world} images"):
            rank_batch(batch, world)

    class ShortLoader(trainer.DataLoader):   # a batch one row short
        def __iter__(self):
            for images, targets in super().__iter__():
                yield images[1:], targets

    monkeypatch.setattr(trainer, "DataLoader", ShortLoader)
    data = write_mini_coco(str(tmp_path / "coco"), 4, hw=(48, 64))
    args = Namespace(model_size="n", input_size=64, batch_size=4, epochs=1,
                     data_dir=data, save_dir=str(tmp_path / "w"), resume="", weights="",
                     workers=1, native_train="off")
    with pytest.raises(ValueError, match="a batch of 3 rows on rank 0, which trains 4"):
        train(args, hyp, cfg, device="cpu")


# -- the CLI and the preflight under torchrun ---------------------------------


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A mini-COCO of 8 train and 8 val images, v11-n weights of 2 classes
    from eval_state at 128 px, and val labels from their own detections."""
    root = write_mini_coco(str(tmp_path_factory.mktemp("dp_coco")), 8, 8, hw=(96, 128))
    cfg = get_model_config("n", 2)
    images = np.stack([bgr_hwc_to_rgb(letterbox(load_image(f, 128)[0], 128)[0])
                       for f in split_files(root, "val2017")])
    state = eval_state(cfg, 0, images, "cpu")
    ckpt = os.path.join(root, "eval.ckpt")
    save_checkpoint(ckpt, {"params": to_jax_params(state)})
    label_from_detections(root, YOLO.from_state_dict(cfg, state), 128)
    hyp = load_hyperparams()
    hyp["names"] = {0: "red", 1: "blue"}
    import yaml

    hyp_path = os.path.join(root, "hyp.yaml")
    with open(hyp_path, "w") as f:
        yaml.safe_dump(hyp, f)
    return root, ckpt, hyp, hyp_path


def _torchrun(nproc: int, module: str, *argv):
    """Start `module` under torchrun with `nproc` ranks."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
         "--master-port", str(_free_port()), "-m", module, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def torchruns(coco, tmp_path_factory):
    """The torchrun commands of this file, started at once (the rehearsal
    runs start after them): the CLI's --train --test, the preflight on
    the mini-COCO and on a label set with an image of 513 boxes."""
    root, ckpt, _, hyp_path = coco
    d = tmp_path_factory.mktemp("torchruns")
    dense = write_mini_coco(str(d / "dense"), 2, hw=(96, 128))
    with open(os.path.join(dense, "labels", "train2017", "train2017_0.txt"), "w") as f:
        f.writelines(f"0 {0.01 + 0.0019 * i:.4f} 0.5 0.01 0.01\n" for i in range(513))
    preflight = ("tpu_yolo_torch.preflight", "--device", "cpu", "--batch-size", "4",
                 "--input-size", "64", "--data-dir")
    return {"save": d / "w",
            "cli": _torchrun(2, "tpu_yolo_torch.cli.main", "--train", "--test",
                             "--distributed", "--device", "cpu", "--data-dir", root,
                             "--save-dir", str(d / "w"), "--resume", ckpt,
                             "--weights", ckpt, "--hyp", hyp_path, "--input-size", "128",
                             "--batch-size", "4", "--val-batch-size", "4", "--epochs",
                             "1", "--workers", "1", "--native-eval", "off"),
            "preflight": _torchrun(2, *preflight, root, "--prewarm"),
            "dense": _torchrun(2, *preflight, dense)}


def test_cli_trains_and_tests_on_two_ranks(coco, torchruns):
    """(f) `--train --test --distributed --device cpu` under torchrun with
    2 ranks at 128 px: one epoch at a global batch of 4 fine-tuned from
    the eval weights (a params-only .ckpt given to --resume), then the
    sharded --test of those weights. Rank 0 alone prints and writes
    step.csv and last.ckpt, which tpu_yolo reads; the mAP line equals one
    process's run_test."""
    root, ckpt, hyp, _ = coco
    save = torchruns["save"]
    rc, out, err = _finish(torchruns["cli"])
    assert rc == 0, err[-4000:]
    lines = out.splitlines()
    assert len([ln for ln in lines if ln.startswith("epoch 1/1: ")]) == 1
    assert len([ln for ln in lines if ln.startswith("[train] loader: ")]) == 2
    mine = [ln for ln in lines if ln.startswith("mAP: ")]
    assert len(mine) == 1
    assert {"best.ckpt", "last.ckpt", "step.csv"} <= set(os.listdir(save)) <= {
        "best.ckpt", "last.ckpt", "step.csv", "lr.png"}
    with open(save / "step.csv") as f:
        assert len(f.read().strip().splitlines()) == 2

    last = jax_ckpt.load_checkpoint(str(save / "last.ckpt"))
    assert last["epoch"] == 1
    cfg = get_model_config("n", 2)
    got = from_jax_params(last["params"], cfg)
    for k, v in load_params(str(save / "last.ckpt"), cfg).items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy())

    import argparse

    args = argparse.Namespace(weights=ckpt, save_dir=str(save), data_dir=root,
                              input_size=128, val_batch_size=4, workers=1,
                              native_eval="off", coco_metrics=False, plot=False,
                              max_nms=2048, device="cpu")
    m_ap, m_ap50, recall, precision = cli.run_test(args, hyp, cfg)
    assert m_ap > 0.1
    assert mine[0] == (f"mAP: {m_ap:.3f}  mAP@50: {m_ap50:.3f}  "
                       f"Recall: {recall:.3f}  Precision: {precision:.3f}")


def test_preflight_on_two_ranks(torchruns):
    """(g) the preflight under torchrun with 2 ranks: every check passes,
    the prewarm's train step included; then a label set whose densest
    image holds 513 boxes fails the GT-bucket check and turns `ok` false."""
    rc, out, err = _finish(torchruns["preflight"])
    assert rc == 0, err[-4000:]
    verdicts = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert sorted(v["process_id"] for v in verdicts) == [0, 1]
    for v in verdicts:
        assert v["ok"] and v["checks"] == dict.fromkeys(
            ("rendezvous", "devices", "topology", "batch", "gt_bucket", "prewarm"), True)

    rc, out, err = _finish(torchruns["dense"])
    assert rc == 1, err[-4000:]
    verdicts = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(verdicts) == 2
    for v in verdicts:
        assert not v["ok"] and v["checks"]["gt_bucket"] is False
        assert v["checks"]["batch"] and v["checks"]["topology"]
    assert "hold more than 512 boxes" in out


def test_distributed_on_cuda_without_a_card_raises(tmp_path):
    """(h) --distributed with --device cuda takes NCCL on the card or
    raises; it never falls back to gloo or the CPU. The rehearsal worker
    runs on the card unless asked for the CPU, so without one it raises
    too, with a group or without."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed("cuda", init_method=f"file://{tmp_path / 'init'}",
                                  rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--train", "--distributed"])
    for group in ([], ["--init-method", f"file://{tmp_path / 'init2'}"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            rehearsal.main(group)
    assert not parallel.is_distributed()
